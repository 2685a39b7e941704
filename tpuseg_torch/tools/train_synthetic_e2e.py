"""End-to-end learning evidence: train on synthetic leaves and show the
validation SBD / FG dice improve far beyond random init (port of
``tools/train_synthetic_e2e.py``).

    python -m tpuseg_torch.tools.train_synthetic_e2e [--epochs 200]
        [--res 128] [--seed 23] [--n_filters 32] [--out PATH]
        [--device cpu]

The full stack at a reduced resolution: records (``write_synthetic_records``
seeds 1 and 2) -> the augmented ``PrefetchLoader`` (4 workers) -> the
port's ``make_train_step`` (float32 with TF32 off, as the JAX recipe
computes it; Adadelta at lr 1.0) -> the weights of
the best evaluation -> batched instance extraction (``Predictor``, float32
with TF32 off, unwindowed as the JAX ``infer`` mode) -> SBD / FG dice.
The model starts from the JAX package's init distribution
(``cli/common.py::init_model``) at ``cfg.train.seed``, or ``--seed``,
which also seeds the loader and the step's generator.

``TPUSEG_RESUME=1`` starts from ``assets/synthetic_ckpt.msgpack`` instead,
merge-style.  The best weights are written as a flax msgpack to ``--out``
(default under ``tpuseg_torch_e2e`` in the temporary directory); ``--install_bar`` copies them
to ``--install_to`` (no default) when the best SBD clears the bar.  Runs
on the card unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import os
import shutil
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from tpuseg_torch import resolve_device
from tpuseg_torch.cli.common import init_model
from tpuseg_torch.configs import Config, cvppp_config
from tpuseg_torch.data.dataset import AlignCollate
from tpuseg_torch.data.loader import PrefetchLoader
from tpuseg_torch.data.records import SegRecordDataset
from tpuseg_torch.data.synthetic import write_synthetic_records
from tpuseg_torch.evalm.metrics import calc_dice, symmetric_best_dice_batch
from tpuseg_torch.runtime.predict import Predictor, tf32_off
from tpuseg_torch.runtime.state import create_train_state
from tpuseg_torch.runtime.train import make_train_step
from tpuseg_torch.utils.checkpoint_io import (
    merge_restore, read_msgpack, write_msgpack,
)
from tpuseg_torch.weights import load_flax, to_flax

ASSET = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                     os.pardir, "assets", "synthetic_ckpt.msgpack")
ROOT = os.path.join(tempfile.gettempdir(), "tpuseg_torch_e2e")


def gt_labels(batch: Dict, n_valid: Optional[int] = None) -> np.ndarray:
    """A collated batch's instance masks as (B, H, W) int32 id maps (slot j
    -> id j + 1, later slots over earlier ones); samples past ``n_valid``
    stay 0."""
    ins_all = batch["ins_masks"]
    out = np.zeros(ins_all.shape[:3], np.int32)
    for b in range(len(out) if n_valid is None else n_valid):
        for j in range(int(batch["n_objects"][b])):
            out[b][ins_all[b][:, :, j] > 0] = j + 1
    return out


def extract(cfg: Config, model, images: np.ndarray, stop_params=None,
            dtype: torch.dtype = torch.float32, device=None):
    """The JAX package's ``mode="infer"`` on a copy of ``model`` (which
    stays as it is), on ``device`` (default: the model's), float32 with
    TF32 off (or ``dtype``).  That mode's extraction decodes each glimpse over the whole
    canvas, so the predictor runs with ``extract_window`` 0 (the CLIs'
    windowed decode differs from it at sizes the window cuts).  -> (id
    maps (B, H, W) int32, counts (B,) int32) as numpy."""
    model = copy.deepcopy(model)
    model.decoder.cfg = dataclasses.replace(model.decoder.cfg,
                                            extract_window=0)
    p = Predictor(cfg, model, batch_size=len(images),
                  device=device or next(model.parameters()).device,
                  dtype=dtype, stop_params=stop_params)
    _, _, idmap, counts = p.predict_batch_arrays(images)
    return idmap.cpu().numpy(), counts.cpu().numpy()


def evaluate(cfg: Config, model, ds, n: int = 8, max_ids: int = 32,
             device=None):
    """Instance-extract on ``n`` val samples (on ``device``, default the
    model's); (mean SBD, mean fg dice, counts)."""
    collate = AlignCollate("test", cfg.data, n)
    batch = collate([ds[i % len(ds)] for i in range(n)]).asdict()
    idmap, counts = extract(cfg, model, batch["images"], device=device)
    gt_label = gt_labels(batch)
    sbd = float(symmetric_best_dice_batch(gt_label, idmap,
                                          max_ids=max_ids).mean())
    fg = float(np.mean([float(calc_dice(gt_label[b] > 0, idmap[b] > 0))
                        for b in range(n)]))
    return sbd, fg, counts


def recipe_config(res: int = 128, batch_size: int = 8, lr: float = 1.0,
                  seed: Optional[int] = None, cfg: Optional[Config] = None,
                  n_filters: int = 0) -> Config:
    """``cfg`` (default ``cvppp_config()``) at ``res``², 16 instance slots,
    the recipe's batch size and learning rate (and training seed, and
    ``n_filters`` when not 0)."""
    cfg = cfg or cvppp_config()
    train = dict(batch_size=batch_size, learning_rate=lr)
    if seed is not None:
        train["seed"] = seed
    model = dict(n_filters=n_filters) if n_filters else {}
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, image_height=res, image_width=res,
                                 max_n_objects=16),
        model=dataclasses.replace(cfg.model, **model),
        train=dataclasses.replace(cfg.train, **train),
    )


# float32 convolutions and matmuls, as the JAX recipe computes them: with
# PyTorch's default TF32 the recipe learns less (PERF.md §6)
@tf32_off()
def run(cfg: Config, epochs: int = 200, n_train: int = 32, n_val: int = 8,
        eval_every: int = 40, max_leaves: int = 8, out: str = "",
        install_bar: float = 0.0, install_to: str = "",
        root: str = ROOT, device="cuda", resume_from: str = ASSET,
        n_workers: int = 4, eval_device=None) -> Dict:
    """The recipe on ``cfg`` (``recipe_config``'s); returns its numbers:
    random-init and final SBD / FG, the best SBD and its epoch, steps,
    seconds of training and steps/s, the output path and the trained
    (final) model."""
    dev = resolve_device(device)
    res = cfg.data.image_height
    batch_size = cfg.train.batch_size
    os.makedirs(root, exist_ok=True)
    write_synthetic_records(f"{root}/train", n_train, seed=1, height=res,
                            width=res, min_leaves=3, max_leaves=max_leaves)
    write_synthetic_records(f"{root}/val", n_val, seed=2, height=res,
                            width=res, min_leaves=3, max_leaves=max_leaves)
    train_ds = SegRecordDataset(f"{root}/train")
    val_ds = SegRecordDataset(f"{root}/val")

    model = init_model(cfg, seed=cfg.train.seed)
    resumed = os.environ.get("TPUSEG_RESUME", "0") == "1"
    if resumed and os.path.isfile(resume_from):
        load_flax(model, merge_restore(to_flax(model),
                                       read_msgpack(resume_from)))
        print(f"resumed weights from {resume_from}", flush=True)
    state = create_train_state(cfg, model, device=dev)

    sbd0, fg0, c0 = evaluate(cfg, model, val_ds, n_val, device=eval_device)
    print(f"random init: SBD={sbd0:.4f} FG={fg0:.4f} counts={c0}", flush=True)

    best_sbd, best_epoch, best_payload = -1.0, -1, None
    loader = PrefetchLoader(
        train_ds, AlignCollate("training", cfg.data, batch_size), batch_size,
        shuffle=True, seed=cfg.train.seed, n_workers=n_workers,
    )
    step = make_train_step(cfg, model)
    gen = torch.Generator(device=dev).manual_seed(cfg.train.seed)
    n_steps, t_train = 0, 0.0
    t0 = time.time()
    for epoch in range(epochs):
        t_ep = time.perf_counter()
        ms = []
        for batch in loader.epoch(epoch):
            state, m = step(state, batch, gen)
            ms.append(m)
        costs, ces, dices = (torch.stack([m[k] for m in ms]).cpu().numpy()
                             for k in ("cost", "ce_cost", "dice_cost"))
        t_train += time.perf_counter() - t_ep
        n_steps += len(ms)
        if epoch % 10 == 0 or epoch == epochs - 1:
            print(f"epoch {epoch}: cost {np.mean(costs):.3f} "
                  f"sem_ce {np.mean(ces):.3f} sem_dice {np.mean(dices):.3f} "
                  f"({time.time()-t0:.0f}s)", flush=True)
        if (epoch + 1) % eval_every == 0:
            sbd, fg, counts = evaluate(cfg, model, val_ds, n_val,
                                       device=eval_device)
            print(f"  eval @{epoch}: SBD={sbd:.4f} FG={fg:.4f} "
                  f"counts={counts}", flush=True)
            if sbd > best_sbd:
                best_sbd, best_epoch = sbd, epoch
                best_payload = to_flax(model)
                print(f"  new best (SBD {sbd:.4f} @ {epoch})", flush=True)

    sbd1, fg1, c1 = evaluate(cfg, model, val_ds, n_val, device=eval_device)
    print(f"after {epochs} epochs: SBD={sbd1:.4f} FG={fg1:.4f} counts={c1}",
          flush=True)
    print(f"SBD {sbd0:.4f} -> {sbd1:.4f} ; FG dice {fg0:.4f} -> {fg1:.4f}",
          flush=True)
    result = {"sbd0": sbd0, "fg0": fg0, "sbd1": sbd1, "fg1": fg1,
              "steps": n_steps, "train_seconds": t_train,
              "steps_per_s": n_steps / t_train if t_train else 0.0}
    print(f"trained {n_steps} steps in {t_train:.1f} s "
          f"({result['steps_per_s']:.2f} steps/s with the loader, "
          f"evaluations excluded)", flush=True)

    # the best evaluation's weights (training can regress past its best),
    # outside assets/; an install target only when one is given
    if best_payload is None or sbd1 > best_sbd:
        best_sbd, best_epoch = sbd1, epochs - 1
        best_payload = to_flax(model)
    print(f"best eval: SBD {best_sbd:.4f} @ epoch {best_epoch}", flush=True)
    out = out or os.path.join(root, "trained_ckpt.msgpack")
    write_msgpack(out, best_payload)
    print(f"saved best weights to {out}", flush=True)
    if install_bar and best_sbd >= install_bar and install_to:
        shutil.copyfile(out, install_to)
        print(f"installed into {install_to} (SBD {best_sbd:.4f} >= "
              f"{install_bar})", flush=True)
    elif install_bar:
        why = "no --install_to" if not install_to else f"< bar {install_bar}"
        print(f"NOT installed: SBD {best_sbd:.4f} ({why})", flush=True)
    result.update(best_sbd=best_sbd, best_epoch=best_epoch, out=out,
                  model=model)

    if not (resumed or fg1 > fg0 + 0.1):
        raise AssertionError("fg dice did not improve enough")
    print("SYNTHETIC E2E TRAINING CHECK PASSED", flush=True)
    return result


def main(argv: Optional[List[str]] = None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--res", type=int, default=128)
    p.add_argument("--n_train", type=int, default=32)
    p.add_argument("--n_val", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--eval_every", type=int, default=40)
    p.add_argument("--lr", type=float, default=1.0)
    p.add_argument("--max_leaves", type=int, default=8)
    p.add_argument("--out", default="")
    p.add_argument("--install_bar", type=float, default=0.0)
    p.add_argument("--install_to", default="",
                   help="where --install_bar copies the best weights")
    p.add_argument("--seed", type=int, default=None,
                   help="training seed (default cfg.train.seed)")
    p.add_argument("--root", default=ROOT,
                   help="directory of the records and the default --out")
    p.add_argument("--n_filters", type=int, default=0,
                   help="the model's width (0: the configuration's)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--eval_device", default=None,
                   help="where the evaluations run (default --device); "
                        "cpu for a width the card's ir_chain kernel does "
                        "not cover (n_filters < 32)")
    a = p.parse_args(argv)
    cfg = recipe_config(a.res, a.batch_size, a.lr, a.seed,
                        n_filters=a.n_filters)
    return run(cfg, a.epochs, a.n_train, a.n_val, a.eval_every,
               a.max_leaves, a.out, a.install_bar, a.install_to, a.root,
               a.device, eval_device=a.eval_device)


if __name__ == "__main__":
    main()
