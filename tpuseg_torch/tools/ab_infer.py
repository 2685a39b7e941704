"""Time the batched-inference main path of one checkout of the port.

    python tpuseg_torch/tools/ab_infer.py <tree root> [n_images] [repeats]

Imports ``tpuseg_torch`` from ``<tree root>`` (which also holds
``assets/synthetic_ckpt.msgpack``), builds its ``ir_chain`` kernel, and
runs ``Predictor.predict_batch_packed`` at B=32 in bfloat16 over synthetic
hard scenes: one warm-up batch, then ``repeats`` timed passes; prints the
img/s of each pass.  To compare two commits on one card, unpack the other
one with ``git archive`` into a directory ``.gitignore`` lists and run
parent, change, change, parent within one call: host-side time varies
between machines by more than most changes do.
"""

import os
import sys
import time


def main(argv) -> int:
    root = os.path.abspath(argv[1])
    n_images = int(argv[2]) if len(argv) > 2 else 128
    repeats = int(argv[3]) if len(argv) > 3 else 3
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import tpuseg_torch

    if not os.path.abspath(tpuseg_torch.__file__).startswith(root):
        raise RuntimeError(
            f"tpuseg_torch came from {tpuseg_torch.__file__}, not {root}")
    from tpuseg_torch.cli.common import load_model
    from tpuseg_torch.data.synthetic import make_scene
    from tpuseg_torch.kernels import build
    from tpuseg_torch.runtime.predict import Predictor
    from tpuseg_torch.settings import get_config
    from tpuseg_torch.utils.checkpoint_io import load_stop_params

    build.build(["ir_chain"])
    cfg, model = load_model(
        get_config("CVPPP"),
        os.path.join(root, "assets", "synthetic_ckpt.msgpack"))
    rng = np.random.default_rng(7)
    imgs = np.stack([make_scene(rng, 256, 256, hard=True)[0]
                     for _ in range(n_images)])
    pred = Predictor(cfg, model, batch_size=32, device="cuda",
                     stop_params=load_stop_params())
    batches = [imgs[i:i + 32] for i in range(0, n_images, 32)]
    pred.predict_batch_packed(batches[0])
    torch.cuda.synchronize()
    rates = []
    for _ in range(repeats):
        t = time.perf_counter()
        for b in batches:
            packed, counts = pred.predict_batch_packed(b)
            packed.cpu(), counts.cpu()
        torch.cuda.synchronize()
        rates.append(n_images / (time.perf_counter() - t))
    print(argv[1], "img/s", [round(r, 2) for r in rates], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
