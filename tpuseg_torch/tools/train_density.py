"""Train the density-regression counting head on the frozen flagship asset
(port of ``tools/train_density.py``).

    python -m tpuseg_torch.tools.train_density [--steps 3000]
        [--ckpt PATH] [--out PATH] [--install] [--calibrate-only]
        [--device cpu]

The head (``models/reseg.py::_DensityHead``) reads the UNet's 1/4 and 1/8
skips detached, so this run trains ONLY the head: the backbone runs in
eval mode (BatchNorm on its running statistics) under ``torch.no_grad``
and only ``density_head`` parameters reach the optimizer, so every other
leaf of the written checkpoint is the input's, bit for bit.

Streams augmented (D4) batches from a pool of hard and standard synthetic
scenes; clip(1.0) + Adam on a cosine schedule as optax's chain; a float64
SWA of the evaluations in the second half; then a closed-form affine count
calibration folded into ``out_gain`` / ``out_off`` (``--calibrate-only``:
only that, on the checkpoint's head).  Float32 with TF32 off, as the JAX
tool computes it.  ``--ckpt`` defaults to ``assets/synthetic_ckpt.msgpack``
(read only); ``--out`` to ``density_ckpt.msgpack`` under
``tpuseg_torch_r3`` in the temporary directory, where the scene pool is
cached too; ``--install`` copies the result over ``--ckpt`` and needs
``--ckpt`` given explicitly.  Runs on the card unless given
``--device cpu``.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import hashlib
import inspect
import math
import os
import shutil
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from tpuseg_torch import resolve_device
from tpuseg_torch.cli.common import init_model
from tpuseg_torch.configs import Config, cvppp_config
from tpuseg_torch.data import synthetic
from tpuseg_torch.data.synthetic import make_scene
from tpuseg_torch.models.reseg import DENSITY_SCALE
from tpuseg_torch.runtime.predict import Predictor, tf32_off
from tpuseg_torch.runtime.state import global_norm
from tpuseg_torch.tools.train_hard_r3 import ROOT, TreeAverage
from tpuseg_torch.utils.checkpoint_io import (
    merge_restore, read_msgpack, write_msgpack,
)
from tpuseg_torch.weights import load_flax, to_flax

ASSET = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                     os.pardir, "assets", "synthetic_ckpt.msgpack")


def make_pool(rng, n, res, max_slots, hard_frac=0.5, max_leaves=14):
    """Pre-generate scenes as (rgb, instance LABEL map uint8, count) — the
    label map is ~60x smaller than the per-slot mask stack, so a
    1500-scene pool fits comfortably; batches expand slots on the fly."""
    imgs = np.zeros((n, res, res, 3), np.uint8)
    labels = np.zeros((n, res, res), np.uint8)
    counts = np.zeros((n,), np.int32)
    for i in range(n):
        hard = bool(rng.random() < hard_frac)
        rgb, _, ins, cnt = make_scene(
            rng, res, res, hard=hard,
            max_leaves=max_leaves if hard else 12,
        )
        imgs[i] = rgb
        # the label map loses overlap pixels to the later instance; each
        # instance keeps its visible region, which is what the density
        # target needs (unit mass per instance over its support)
        for k in range(min(ins.shape[-1], max_slots)):
            labels[i][ins[:, :, k] > 0] = k + 1
        counts[i] = cnt
    return imgs, labels, counts


def pool_cache_path(cache_dir: str, pool: int, res: int, seed: int,
                    hard_frac: float, max_leaves: int) -> str:
    """The file that caches the training pool of these arguments.  Its
    name holds a hash of the arguments and of the code that draws the pool
    (:func:`make_pool` and ``data/synthetic.py``), so a pool drawn by other
    code or with other arguments is never loaded."""
    h = hashlib.sha256(repr((pool, res, seed, float(hard_frac), max_leaves,
                             16)).encode())
    h.update(inspect.getsource(make_pool).encode())
    h.update(inspect.getsource(synthetic).encode())
    return os.path.join(cache_dir, f"pool_{pool}_{res}_{seed}_"
                                   f"{h.hexdigest()[:16]}.npz")


def host_density_target(labels, counts, max_slots, scale):
    """GT density computed host-side in numpy, (B, H/4, W/4, 1): unit mass
    (times ``scale``) per instance, mass-preserving pooled onto the head's
    1/4-resolution grid."""
    b, h, w = labels.shape
    gt = np.zeros((b, h, w, 1), np.float32)
    for i in range(b):
        for k in range(1, min(int(counts[i]), max_slots) + 1):
            m = labels[i] == k
            a = m.sum()
            if a:
                gt[i, :, :, 0][m] += scale / a
    return gt.reshape(b, h // 4, 4, w // 4, 4, 1).sum(axis=(2, 4))


def d4_augment(rng, imgs, labels):
    """Count-invariant dihedral views (rot90 k, then a horizontal flip with
    probability 1/2) of each sample, in place, with the JAX tool's draws."""
    for j in range(len(imgs)):
        k = int(rng.integers(0, 4))
        if k:
            imgs[j] = np.rot90(imgs[j], k)
            labels[j] = np.rot90(labels[j], k)
        if rng.random() < 0.5:
            imgs[j] = imgs[j][:, ::-1]
            labels[j] = labels[j][:, ::-1]


def cosine_lr(lr: float, steps: int, count: int, alpha: float = 0.05):
    """``optax.cosine_decay_schedule(lr, steps, alpha)`` at ``count``."""
    count = min(count, steps)
    cosine = 0.5 * (1.0 + math.cos(math.pi * count / steps))
    return lr * ((1.0 - alpha) * cosine + alpha)


class ClippedAdam:
    """``optax.chain(clip_by_global_norm(clip), adam(cosine_decay_schedule(
    lr, steps, alpha)))`` over ``params``: each gradient becomes
    ``g / norm * clip`` when the global norm reaches ``clip`` (optax's
    formula, no epsilon), then Adam (0.9, 0.999, 1e-8) at the schedule's
    value for the update count before the step (the first update at
    ``lr``)."""

    def __init__(self, params, lr: float, steps: int, alpha: float = 0.05,
                 clip: float = 1.0):
        self.params = list(params)
        self.lr, self.steps, self.alpha, self.clip = lr, steps, alpha, clip
        self.count = 0
        self.opt = torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.999),
                                    eps=1e-8)

    def step(self) -> None:
        grads = [p.grad for p in self.params]
        norm = global_norm(grads)
        keep = norm < self.clip
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * self.clip))
        for group in self.opt.param_groups:
            group["lr"] = cosine_lr(self.lr, self.steps, self.count,
                                    self.alpha)
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.count += 1


def density_map(model, head, imgs_u8) -> torch.Tensor:
    """``head`` (the model's density head or a candidate copy) on the
    frozen backbone's skips: (B, 1, H/4, W/4) float32.  The backbone runs
    under ``torch.no_grad`` in whatever mode ``model`` is in (eval here)."""
    dev = next(model.parameters()).device
    x = torch.as_tensor(np.ascontiguousarray(imgs_u8)).to(dev)
    with torch.no_grad():
        skips = model.base(Predictor._standardize(x))[1]
    return head(skips)


def density_loss(model, head, imgs_u8, gt, counts, res: int):
    """The JAX tool's ``loss_fn``: the map's MSE scaled by (res/4)² / 16
    plus 0.1 x the squared count error; gt (B, H/4, W/4, 1) as
    ``host_density_target`` gives it.  -> (loss, est (B,))."""
    dens = density_map(model, head, imgs_u8)
    gt = torch.as_tensor(gt).to(dens.device).permute(0, 3, 1, 2)
    counts = torch.as_tensor(counts).to(dens.device)
    mse = (dens - gt).square().mean() * float(
        (res // 4) * (res // 4) / 16.0)
    est = dens.sum(dim=(1, 2, 3)) / DENSITY_SCALE
    cl = (est - counts.float()).square().mean()
    return mse + 0.1 * cl, est


def calibrate_counts(ests: np.ndarray, counts: np.ndarray):
    """The closed-form affine count calibration: least squares a, b of
    counts ~ a * ests + b, then b moved on a 41-point grid in [-0.5, 0.5]
    to the best rounded objective (MAE - 0.01 x exact share)."""
    A = np.stack([ests, np.ones_like(ests)], axis=1)
    coef = np.linalg.lstsq(A, counts.astype(np.float64), rcond=None)[0]
    a_fit, b_fit = float(coef[0]), float(coef[1])
    best_b, best_obj = float(b_fit), 1e9
    for db in np.linspace(-0.5, 0.5, 41):
        r = np.round(a_fit * ests + b_fit + db)
        obj = np.abs(r - counts).mean() - 0.01 * (r == counts).mean()
        if obj < best_obj:
            best_obj, best_b = obj, float(b_fit + db)
    return a_fit, best_b


def fold_calibration(head, a: float, b: float) -> None:
    """integral' = a * integral + b, folded into the head's two scalars,
    in float32 as the JAX tool's numpy arithmetic does."""
    with torch.no_grad():
        gain = head.out_gain.detach().cpu().numpy()
        off = head.out_off.detach().cpu().numpy()
        head.out_gain.copy_(torch.from_numpy(np.asarray(gain * a)))
        head.out_off.copy_(torch.from_numpy(np.asarray(off * a + b)))


def recipe_config(res: int = 256, cfg: Optional[Config] = None) -> Config:
    cfg = cfg or cvppp_config()
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, image_height=res, image_width=res,
                                 max_n_objects=16),
        model=dataclasses.replace(cfg.model, use_density_head=True),
    )


def load_asset(cfg: Config, ckpt: str, device):
    """The model of ``cfg`` with ``ckpt`` merged over the seed-0 init (the
    density head keeps that init when the checkpoint has none)."""
    model = init_model(cfg, seed=0)
    load_flax(model, merge_restore(to_flax(model), read_msgpack(ckpt)))
    print(f"resumed from {ckpt} (density head keeps fresh init)", flush=True)
    return model.to(device).float().eval()


# float32 convolutions, as the JAX tool computes them (PERF.md §6)
@tf32_off()
def run(cfg: Config, ckpt: str = ASSET,
        out: str = os.path.join(ROOT, "density_ckpt.msgpack"),
        steps: int = 3000, batch: int = 16, lr: float = 5e-4,
        eval_every: int = 250, n_val: int = 128, seed: int = 5,
        pool: int = 1500, max_leaves: int = 14, calibrate_only: bool = False,
        hard_frac: float = 0.5, install: bool = False, device="cuda",
        cache_dir: str = ROOT) -> Dict:
    """The recipe on ``recipe_config``'s ``cfg``; returns the best val MAE,
    the calibration and the output path."""
    dev = resolve_device(device)
    res = cfg.data.image_height
    model = load_asset(cfg, ckpt, dev)
    for p in model.parameters():
        p.requires_grad_(False)
    head = model.density_head
    for p in head.parameters():
        p.requires_grad_(True)
    # clip first: the 1/4-res map loss is large early and an unclipped
    # first few steps can slam the ReLU stack dead
    opt = ClippedAdam(head.parameters(), lr, max(steps, 1))

    def predict_counts(h, imgs):
        with torch.no_grad():
            dens = density_map(model, h, imgs)
            return (dens.sum(dim=(1, 2, 3)) / DENSITY_SCALE).cpu().numpy()

    rng = np.random.default_rng(seed)
    if not calibrate_only:
        cache = pool_cache_path(cache_dir, pool, res, seed, hard_frac,
                                max_leaves)
        if os.path.isfile(cache):
            d = np.load(cache)
            pi, pl, pc = d["pi"], d["pl"], d["pc"]
            print(f"loaded pool from {cache}", flush=True)
        else:
            print(f"generating {pool}-scene pool...", flush=True)
            pi, pl, pc = make_pool(rng, pool, res, 16, hard_frac=hard_frac,
                                   max_leaves=max_leaves)
            os.makedirs(os.path.dirname(cache), exist_ok=True)
            np.savez_compressed(cache, pi=pi, pl=pl, pc=pc)
    vi, vl, vc = make_pool(np.random.default_rng(999), n_val, res, 16,
                           hard_frac=hard_frac, max_leaves=max_leaves)

    def raw_ests(h, imgs):
        ests = []
        for s in range(0, len(imgs), batch):
            chunk = imgs[s:s + batch]
            nv = len(chunk)
            if nv < batch:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[:1], batch - nv, axis=0)])
            ests.append(predict_counts(h, chunk)[:nv])
        return np.concatenate(ests)

    def evaluate(h):
        err = np.round(raw_ests(h, vi)).astype(int) - vc
        return {"mae": float(np.abs(err).mean()),
                "exact": float((err == 0).mean()),
                "within1": float((np.abs(err) <= 1).mean()),
                "bias": float(err.mean())}

    def line(m):
        return (f"MAE {m['mae']:.3f} exact {m['exact']*100:.0f}% within1 "
                f"{m['within1']*100:.0f}% bias {m['bias']:+.2f}")

    best, best_mae = None, 1e9
    # tail-averaged (SWA) candidate over the second half's evaluations
    swa = TreeAverage()
    swa_start = int(steps * 0.5)
    if calibrate_only:
        best = copy.deepcopy(head)
        m = evaluate(head)
        print(f"pre-calibration val: {line(m)}", flush=True)
        best_mae = m["mae"]
        steps = 0
    t0 = time.time()
    for step in range(1, steps + 1):
        idx = rng.integers(0, pool, size=batch)
        imgs, labels, counts = pi[idx].copy(), pl[idx].copy(), pc[idx]
        d4_augment(rng, imgs, labels)
        gt = host_density_target(labels, counts, 16, DENSITY_SCALE)
        loss, est = density_loss(model, head, imgs, gt, counts, res)
        loss.backward()
        opt.step()
        err = (torch.round(est.detach())
               - torch.as_tensor(counts).to(est.device)).abs().float().mean()
        if step % 50 == 0:
            print(f"step {step}: loss {float(loss):.4f} "
                  f"train_mae {float(err):.3f} "
                  f"({(time.time()-t0):.0f}s)", flush=True)
        if step % eval_every == 0 or step == steps:
            m = evaluate(head)
            print(f"  val @{step}: {line(m)}", flush=True)
            if m["mae"] < best_mae:
                best_mae, best = m["mae"], copy.deepcopy(head)
                print("  new best", flush=True)
            if step >= swa_start:
                swa.add({k: v.cpu().numpy()
                         for k, v in head.state_dict().items()})

    if best is None:
        best = copy.deepcopy(head)
    if swa.n >= 2:
        swa_head = copy.deepcopy(head)
        swa_head.load_state_dict({k: torch.from_numpy(v)
                                  for k, v in swa.mean().items()})
        m_swa = evaluate(swa_head)
        print(f"SWA of last {swa.n} evals: val {line(m_swa)}", flush=True)
        if m_swa["mae"] < best_mae:
            best_mae, best = m_swa["mae"], swa_head
            print("SWA candidate wins", flush=True)

    a_fit, b_fit = calibrate_counts(raw_ests(best, vi), vc)
    fold_calibration(best, a_fit, b_fit)
    print(f"calibration: a={a_fit:.4f} b={b_fit:+.3f}", flush=True)

    # post-calibration numbers on second held-out sets, one per preset
    hi, _, hc = make_pool(np.random.default_rng(1234), n_val, res, 16,
                          hard_frac=1.0, max_leaves=max_leaves)
    si, _, sc = make_pool(np.random.default_rng(4321), n_val, res, 16,
                          hard_frac=0.0, max_leaves=max_leaves)
    calibrated = {}
    for name, imgs_h, counts_h in (("val", vi, vc), ("holdout-hard", hi, hc),
                                   ("holdout-std", si, sc)):
        err = np.round(raw_ests(best, imgs_h)).astype(int) - counts_h
        calibrated[name] = float(np.abs(err).mean())
        print(f"calibrated {name}: MAE {np.abs(err).mean():.3f} exact "
              f"{(err == 0).mean()*100:.0f}% within1 "
              f"{(np.abs(err) <= 1).mean()*100:.0f}% bias {err.mean():+.2f}",
              flush=True)

    model.density_head.load_state_dict(best.state_dict())
    write_msgpack(out, to_flax(model))
    print(f"saved {out} (best val MAE {best_mae:.3f})", flush=True)
    if install:
        shutil.copyfile(out, ckpt)
        print(f"installed into {ckpt}", flush=True)
    return {"best_mae": best_mae, "a": a_fit, "b": b_fit, "out": out,
            "calibrated_mae": calibrated, "steps": steps}


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint to start from (default "
                         "assets/synthetic_ckpt.msgpack, read only)")
    ap.add_argument("--out",
                    default=os.path.join(ROOT, "density_ckpt.msgpack"))
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--eval-every", type=int, default=250)
    ap.add_argument("--n-val", type=int, default=128)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--pool", type=int, default=1500)
    ap.add_argument("--max-leaves", type=int, default=14)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--install", action="store_true",
                    help="copy the result over --ckpt (which must be given)")
    ap.add_argument("--calibrate-only", action="store_true",
                    help="skip training: refit only the folded affine count "
                         "calibration of the checkpoint's existing head")
    ap.add_argument("--hard-frac", type=float, default=0.5,
                    help="hard-preset fraction of the calibration/val pool")
    args = ap.parse_args(argv)
    if args.install and args.ckpt is None:
        ap.error("--install copies over --ckpt: give --ckpt explicitly")
    return run(recipe_config(args.res), args.ckpt or ASSET, args.out, args.steps, args.batch, args.lr,
               args.eval_every, args.n_val, args.seed, args.pool,
               args.max_leaves, args.calibrate_only, args.hard_frac,
               args.install, args.device)


if __name__ == "__main__":
    main()
