"""Fine-tune the flagship asset on the HARD synthetic preset (port of
``tools/train_hard_r3.py``).

    python -m tpuseg_torch.tools.train_hard_r3 [--epochs 300] [--res 128]
        [--eval_res 256] [--freeze_bn] [--freeze_subtrees NAMES]
        [--warm_opt N] [--swa_frac F] [--bf16] [--out PATH] [--device cpu]

Resumes merge-style from ``assets/synthetic_ckpt.msgpack`` (read only;
``--no_resume``: the init), trains on hard-preset records with the port's
train step, cosine-decays the plateau's learning rate from ``--lr0`` to
``--lr_min``, and selects on a ``--n_val``-image evaluation of the full
extraction chain under the installed stopping rule (SBD - dic_weight x
|DiC|), the resumed start being the incumbent to beat.

* ``--freeze_bn``: the resumed BatchNorm running statistics are put back
  after every step;
* ``--freeze_subtrees count_head,density_head``: those top-level subtrees'
  parameters and statistics likewise;
* ``--warm_opt N``: N epochs at learning rate 0 first, which fill the
  Adadelta accumulators without moving a weight, the statistics restored
  to their pre-warm-up values after each step;
* ``--swa_frac F``: the float64 mean of the last F of the epochs'
  parameters and statistics is evaluated as one more candidate.

The best weights go to ``--out`` (default
``hard_ckpt.msgpack`` under ``tpuseg_torch_r3`` in the temporary
directory) as a flax msgpack;
``--install_bar`` copies them to ``--install_to`` (no default).  Training
runs float32 with TF32 off unless given ``--bf16``.  Runs on the card
unless given ``--device cpu``.
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
from tpuseg_torch.runtime.predict import tf32_off
from tpuseg_torch.runtime.state import create_train_state
from tpuseg_torch.runtime.train import make_train_step
from tpuseg_torch.tools.train_synthetic_e2e import ASSET, extract, gt_labels
from tpuseg_torch.utils.checkpoint_io import (
    load_stop_params, merge_restore, read_msgpack, write_msgpack,
)
from tpuseg_torch.weights import load_flax, to_flax

ROOT = os.path.join(tempfile.gettempdir(), "tpuseg_torch_r3")


def evaluate_full(cfg: Config, model, ds, n: int, batch: int = 16,
                  max_ids: int = 32, dtype=torch.float32) -> Dict[str, float]:
    """The production extraction on ``n`` val samples under the installed
    stopping rule (``assets/stop_params.json``): mean SBD, FG dice and
    |DiC|."""
    sp = load_stop_params()
    collate = AlignCollate("test", cfg.data, batch)
    sbds, fgs, dics = [], [], []
    for start in range(0, n, batch):
        idxs = [min(start + j, len(ds) - 1) for j in range(batch)]
        b = collate([ds[i] for i in idxs]).asdict()
        idmap, counts = extract(cfg, model, b["images"], stop_params=sp,
                                dtype=dtype)
        n_valid = min(batch, n - start)
        gt_label = gt_labels(b, n_valid)
        sbd_b = symmetric_best_dice_batch(gt_label, idmap, max_ids=max_ids)
        for j in range(n_valid):
            sbds.append(float(sbd_b[j]))
            fgs.append(float(calc_dice(gt_label[j] > 0, idmap[j] > 0)))
            dics.append(abs(int(counts[j]) - int(b["n_objects"][j])))
    return {"sbd": float(np.mean(sbds)), "fg": float(np.mean(fgs)),
            "dic": float(np.mean(dics))}


def batch_stat_buffers(model) -> Dict[str, torch.Tensor]:
    """The model's batch statistics (the flax ``batch_stats``): every
    BatchNorm's running mean / var and update count, the masked BatchNorm's
    mean / var; not the decoder's REINFORCE baseline."""
    return {k: v for k, v in model.named_buffers()
            if not k.endswith("baseline")}


def snapshot(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in tensors.items()}


def restore_(model, saved: Dict[str, torch.Tensor]) -> None:
    """Copy ``saved`` (state-dict keys) back into the model's tensors."""
    live = dict(model.named_parameters())
    live.update(model.named_buffers())
    with torch.no_grad():
        for k, v in saved.items():
            live[k].copy_(v)


class TreeAverage:
    """Running float64 sum of flax trees (``params`` and ``batch_stats``
    snapshots); ``mean()`` is their average cast to float32."""

    def __init__(self):
        self.sum, self.n = None, 0

    def add(self, tree: Dict) -> None:
        def acc(s, x):
            if isinstance(x, dict):
                return {k: acc(None if s is None else s[k], v)
                        for k, v in x.items()}
            x = np.asarray(x, np.float64)
            return x.copy() if s is None else s + x
        self.sum = acc(self.sum, tree)
        self.n += 1

    def mean(self) -> Dict:
        def div(s):
            if isinstance(s, dict):
                return {k: div(v) for k, v in s.items()}
            return np.asarray(s / self.n, np.float32)
        return div(self.sum)


def warm_optimizer(state, step, loader, gen, epochs: int, t0: float) -> None:
    """``epochs`` epochs at plateau learning rate 0: the optimizer's
    accumulators fill from real gradients while no weight moves; the batch
    statistics go back to their values before the warm-up after every
    step."""
    model = state.model
    pre_warm = snapshot(batch_stat_buffers(model))
    for wepoch in range(epochs):
        state.plateau = dataclasses.replace(state.plateau, lr=0.0)
        for batch in loader.epoch(1000 + wepoch):
            step(state, batch, gen)
            restore_(model, pre_warm)
        print(f"opt-warmup epoch {wepoch} done ({time.time()-t0:.0f}s)",
              flush=True)


def recipe_config(res: int = 128, batch_size: int = 8, lr0: float = 0.3,
                  cfg: Optional[Config] = None) -> Config:
    cfg = cfg or cvppp_config()
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, image_height=res, image_width=res,
                                 max_n_objects=16),
        train=dataclasses.replace(cfg.train, batch_size=batch_size,
                                  learning_rate=lr0),
    )


# float32 convolutions and matmuls, as the JAX recipe computes them: with
# PyTorch's default TF32 the recipe learns less (PERF.md §6)
@tf32_off()
def run(cfg: Config, epochs: int = 300, n_train: int = 160, n_val: int = 32,
        eval_every: int = 10, lr_min: float = 0.02, max_leaves: int = 14,
        min_leaves: int = 3, dic_weight: float = 0.05, resume: bool = True,
        out: str = os.path.join(ROOT, "hard_ckpt.msgpack"),
        install_bar: float = 0.0, install_to: str = "", bf16: bool = False,
        seed: int = 31, swa_frac: float = 0.0, freeze_bn: bool = False,
        warm_opt: int = 0, eval_res: int = 0, freeze_subtrees: str = "",
        root: str = ROOT, device="cuda",
        resume_from: str = ASSET, n_workers: int = 4,
        eval_batch: int = 16) -> Dict:
    """The recipe on ``recipe_config``'s ``cfg``; returns the start and
    best metrics, the best epoch, whether ``out`` was written, the SWA
    candidate and the final train state."""
    dev = resolve_device(device)
    res = cfg.data.image_height
    lr0 = cfg.train.learning_rate
    batch_size = cfg.train.batch_size
    dtype = torch.bfloat16 if bf16 else None
    eval_dtype = torch.bfloat16 if bf16 else torch.float32
    # the selection val may run at another resolution than training
    eval_res = eval_res or res
    eval_cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, image_height=eval_res, image_width=eval_res))
    os.makedirs(root, exist_ok=True)
    write_synthetic_records(
        f"{root}/train", n_train, seed=seed, height=res, width=res,
        min_leaves=min_leaves, max_leaves=max_leaves, hard=True)
    write_synthetic_records(
        f"{root}/val", n_val, seed=32, height=eval_res, width=eval_res,
        min_leaves=min_leaves, max_leaves=max_leaves, hard=True)
    train_ds = SegRecordDataset(f"{root}/train")
    val_ds = SegRecordDataset(f"{root}/val")

    model = init_model(cfg, seed=cfg.train.seed)
    if resume and os.path.isfile(resume_from):
        load_flax(model, merge_restore(to_flax(model),
                                       read_msgpack(resume_from)))
        print(f"resumed weights from {resume_from}", flush=True)
    state = create_train_state(cfg, model, device=dev)
    print("train state created", flush=True)
    frozen_stats = snapshot(batch_stat_buffers(model)) if freeze_bn else None
    pin_names = [s for s in freeze_subtrees.split(",") if s]
    pinned = None
    if pin_names:
        pinned = snapshot({k: v for k, v in model.state_dict().items()
                           if k.split(".")[0] in pin_names})
        print(f"pinned subtrees: "
              f"{sorted({k.split('.')[0] for k in pinned})}", flush=True)

    def evaluate(m):
        return evaluate_full(eval_cfg, m, val_ds, n_val, batch=eval_batch,
                             dtype=eval_dtype)

    m0 = evaluate(model)
    print(f"start: SBD={m0['sbd']:.4f} FG={m0['fg']:.4f} "
          f"|DiC|={m0['dic']:.3f}", flush=True)

    # a fine-tune must beat the start point: the resumed asset is the
    # incumbent
    best_score = m0["sbd"] - dic_weight * m0["dic"] if resume else -1e9
    best_epoch, best_payload, best_m = -1, None, m0
    swa = TreeAverage()
    swa_start = int(epochs * (1.0 - swa_frac)) if swa_frac > 0 else epochs + 1
    loader = PrefetchLoader(
        train_ds, AlignCollate("training", cfg.data, batch_size), batch_size,
        shuffle=True, seed=cfg.train.seed, n_workers=n_workers,
    )
    step = make_train_step(cfg, model, dtype=dtype)
    gen = torch.Generator(device=dev).manual_seed(cfg.train.seed)
    t0 = time.time()
    warm_optimizer(state, step, loader, gen, warm_opt, t0)
    for epoch in range(epochs):
        lr = lr_min + 0.5 * (lr0 - lr_min) * (
            1.0 + np.cos(np.pi * epoch / max(epochs - 1, 1)))
        state.plateau = dataclasses.replace(
            state.plateau, lr=float(np.float32(lr)))
        ms = []
        for batch in loader.epoch(epoch):
            state, m = step(state, batch, gen)
            if frozen_stats is not None:
                restore_(model, frozen_stats)
            if pinned is not None:
                restore_(model, pinned)
            ms.append(m)
        if epoch % 10 == 0 or epoch == epochs - 1:
            costs = torch.stack([m["cost"] for m in ms]).cpu().numpy()
            ce = ""
            if "count_err" in ms[0]:
                cerrs = torch.stack([m["count_err"] for m in ms]).cpu()
                ce = f" count_err {float(cerrs.mean()):.2f}"
            print(f"epoch {epoch}: cost {np.mean(costs):.3f}{ce} lr {lr:.3f} "
                  f"({time.time()-t0:.0f}s)", flush=True)
        if epoch >= swa_start:
            cur = to_flax(model)
            swa.add({"params": cur["params"],
                     "batch_stats": cur["batch_stats"]})
        if (epoch + 1) % eval_every == 0 or epoch == epochs - 1:
            m = evaluate(model)
            score = m["sbd"] - dic_weight * m["dic"]
            print(f"  eval @{epoch}: SBD={m['sbd']:.4f} FG={m['fg']:.4f} "
                  f"|DiC|={m['dic']:.3f} score={score:.4f}", flush=True)
            if score > best_score:
                best_score, best_epoch, best_m = score, epoch, m
                best_payload = to_flax(model)
                # saved at once: a killed run keeps its best
                write_msgpack(out, best_payload)
                print(f"  new best @ {epoch} (saved to {out})", flush=True)

    swa_payload = None
    if swa.n >= 2:
        swa_payload = swa.mean()
        swa_payload["decoder_state"] = to_flax(model)["decoder_state"]
        candidate = load_flax(copy.deepcopy(model), swa_payload)
        m = evaluate(candidate)
        score = m["sbd"] - dic_weight * m["dic"]
        print(f"  SWA({swa.n} snapshots): SBD={m['sbd']:.4f} "
              f"FG={m['fg']:.4f} |DiC|={m['dic']:.3f} score={score:.4f}",
              flush=True)
        if score > best_score:
            best_score, best_epoch, best_m = score, epochs, m
            best_payload = swa_payload
            print("  SWA candidate wins", flush=True)

    result = {"start": m0, "best": best_m, "best_epoch": best_epoch,
              "saved": False, "out": out, "swa_payload": swa_payload,
              "swa_n": swa.n, "state": state}
    # the asset moves only on an actual win: under resume the incumbent
    # seeds best_score, and if no evaluation beat it nothing is written
    if best_payload is None:
        if resume:
            print("no eval beat the resumed incumbent — leaving the "
                  f"asset and {out} untouched", flush=True)
            return result
        best_payload = to_flax(model)
    print(f"best: epoch {best_epoch} SBD={best_m['sbd']:.4f} "
          f"FG={best_m['fg']:.4f} |DiC|={best_m['dic']:.3f}", flush=True)
    write_msgpack(out, best_payload)
    result["saved"] = True
    print(f"saved best weights to {out}", flush=True)
    if (install_bar and best_epoch >= 0 and best_m["sbd"] >= install_bar
            and install_to):
        shutil.copyfile(out, install_to)
        print(f"installed into {install_to} (SBD {best_m['sbd']:.4f} >= "
              f"{install_bar})", flush=True)
    elif install_bar:
        print(f"NOT installed: best_epoch={best_epoch} "
              f"SBD {best_m['sbd']:.4f} vs bar {install_bar}"
              + ("" if install_to else " (no --install_to)"), flush=True)
    return result


def main(argv: Optional[List[str]] = None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--res", type=int, default=128)
    p.add_argument("--n_train", type=int, default=160)
    p.add_argument("--n_val", type=int, default=32)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--eval_every", type=int, default=10)
    p.add_argument("--lr0", type=float, default=0.3)
    p.add_argument("--lr_min", type=float, default=0.02)
    p.add_argument("--max_leaves", type=int, default=14)
    p.add_argument("--min_leaves", type=int, default=3)
    p.add_argument("--dic_weight", type=float, default=0.05)
    p.add_argument("--no_resume", action="store_true")
    p.add_argument("--out", default=os.path.join(ROOT, "hard_ckpt.msgpack"))
    p.add_argument("--install_bar", type=float, default=0.0)
    p.add_argument("--install_to", default="",
                   help="where --install_bar copies the best weights")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--seed", type=int, default=31,
                   help="training scene-pool generator seed")
    p.add_argument("--swa_frac", type=float, default=0.0,
                   help="tail fraction of epochs to average into an SWA "
                        "candidate (0 disables)")
    p.add_argument("--freeze_bn", action="store_true",
                   help="keep the resumed asset's BN running stats")
    p.add_argument("--warm_opt", type=int, default=0,
                   help="optimizer-warmup epochs at lr=0 before training")
    p.add_argument("--freeze_subtrees", default="",
                   help="comma-separated top-level subtrees pinned to the "
                        "asset values (e.g. count_head,density_head)")
    p.add_argument("--eval_res", type=int, default=0,
                   help="selection-val resolution (0 = same as --res)")
    p.add_argument("--root", default=ROOT,
                   help="directory of the records")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    return run(recipe_config(a.res, a.batch_size, a.lr0), a.epochs,
               a.n_train, a.n_val, a.eval_every, a.lr_min, a.max_leaves,
               a.min_leaves, a.dic_weight, not a.no_resume, a.out,
               a.install_bar, a.install_to, a.bf16, a.seed, a.swa_frac,
               a.freeze_bn, a.warm_opt, a.eval_res, a.freeze_subtrees,
               a.root, a.device)


if __name__ == "__main__":
    main()
