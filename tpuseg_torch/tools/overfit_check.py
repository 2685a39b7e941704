"""Training sanity: overfit one synthetic batch; the total cost must drop
(port of ``tools/overfit_check.py``).

    python -m tpuseg_torch.tools.overfit_check [--steps 40] [--device cpu]

Evidence that the glimpse-decoder training math (REINFORCE + pyramid
losses + BatchNorm / baseline state + the Adadelta chain) optimises: the
full-width CVPPP model from its flax-distributed init (seed
``cfg.train.seed``), two 256x256 scenes from ``make_scene`` seed 3, 40
float32 train steps (TF32 off, as the JAX tool computes them); the mean
cost of the last 5 must be below the first 5's.  Runs on the card unless
given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from tpuseg_torch import resolve_device
from tpuseg_torch.cli.common import init_model
from tpuseg_torch.configs import Config, cvppp_config
from tpuseg_torch.data.dataset import AlignCollate
from tpuseg_torch.data.synthetic import make_scene
from tpuseg_torch.runtime.predict import tf32_off
from tpuseg_torch.runtime.state import create_train_state
from tpuseg_torch.runtime.train import make_train_step


def overfit_batch(cfg: Config, res: int = 256) -> dict:
    """The recipe's batch: two scenes of ``make_scene`` seed 3 (4-8
    leaves) through the ``test`` collate at ``cfg``'s size."""
    from PIL import Image

    rng = np.random.default_rng(3)
    scenes = [make_scene(rng, res, res, min_leaves=4, max_leaves=8)
              for _ in range(2)]
    samples = [(Image.fromarray(s[0]), s[1], s[2], s[3]) for s in scenes]
    return AlignCollate("test", cfg.data, 2)(samples).asdict()


# float32 convolutions and matmuls, as the JAX recipe computes them: with
# PyTorch's default TF32 the recipe learns less (PERF.md §6)
@tf32_off()
def run(cfg: Config, steps: int = 40, device="cuda", res: int = 256
        ) -> List[float]:
    """The recipe on ``cfg``: returns the cost of every step (and asserts
    that the last 5 average below the first 5)."""
    dev = resolve_device(device)
    model = init_model(cfg, seed=cfg.train.seed)
    state = create_train_state(cfg, model, device=dev)
    batch = overfit_batch(cfg, res)
    step = make_train_step(cfg, model)
    gen = torch.Generator(device=dev).manual_seed(cfg.train.seed)
    costs = []
    t0 = time.time()
    for i in range(steps):
        state, m = step(state, batch, gen)
        c = float(m["cost"])  # forces sync
        costs.append(c)
        if i % 5 == 0 or i == steps - 1:
            print(f"step {i}: cost={c:.4f} ins={float(m['ins_cost']):.4f} "
                  f"ce={float(m['ce_cost']):.4f} "
                  f"dice={float(m['dice_cost']):.4f} "
                  f"({time.time()-t0:.0f}s)", flush=True)
    first, last = np.mean(costs[:5]), np.mean(costs[-5:])
    print(f"mean first-5 cost {first:.3f} -> mean last-5 cost {last:.3f}",
          flush=True)
    if not last < first:
        raise AssertionError("training cost did not decrease")
    print("OVERFIT CHECK PASSED", flush=True)
    return costs


def main(argv: Optional[List[str]] = None) -> List[float]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=40)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    return run(cvppp_config(), a.steps, a.device)


if __name__ == "__main__":
    main()
