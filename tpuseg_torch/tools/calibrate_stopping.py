"""Calibrate the extraction stopping rule against the count head (port of
``tools/calibrate_stopping.py``).

    python -m tpuseg_torch.tools.calibrate_stopping [--ckpt PATH] [--n 32]
        [--res 256] [--bf16] [--seed 77] [--out PATH]
        [--stop-params-out PATH] [--no-install] [--device cpu]

The stopping knobs (remaining-foreground fraction, consecutive-miss cutoff,
peak-suppression factor, stop fraction) are runtime values of the
extraction rounds, so each batch of hard-preset synthetic scenes is
prepped once (``Predictor._infer_prep``) and every grid point re-runs only
the rounds, one at a time from the carry, until every sample is done.
Each point is scored ``SBD - dic_weight * |DiC|``; the sorted table goes to
``--out`` (default ``CALIBRATION.md`` under ``tpuseg_torch_calib`` in the
temporary directory) and the best point to ``--stop-params-out`` (default
``stop_params.json`` beside it; ``--no-install``: none).  The default
grid is ``DEFAULT_GRID``.
Neither default is the repo's ``CALIBRATION.md`` or
``assets/stop_params.json``.  Runs on the card unless given
``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpuseg_torch import resolve_device
from tpuseg_torch.cli.common import load_model
from tpuseg_torch.configs import Config, cvppp_config
from tpuseg_torch.data.synthetic import make_scene
from tpuseg_torch.evalm.metrics import symmetric_best_dice_batch
from tpuseg_torch.runtime.predict import Predictor

ASSET = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                     os.pardir, "assets", "synthetic_ckpt.msgpack")
OUT_DIR = os.path.join(tempfile.gettempdir(), "tpuseg_torch_calib")
# (min_remaining_frac, max_extract_misses, peak_suppress_factor,
# stop_remaining_frac) values swept; a stop fraction <= 0 follows min_frac
DEFAULT_GRID = ((0.006, 0.012, 0.024), (2, 3), (0.0, 0.5, 0.7, 0.9, 1.1),
                (-1.0,))


def hard_scenes(n: int, res: int, seed: int, max_leaves: int = 14):
    """``n`` hard-preset scenes: (images (n, res, res, 3) uint8, GT id maps
    (n, res, res) int32, counts (n,))."""
    rng = np.random.default_rng(seed)
    imgs, gt_ids, gt_ns = [], [], []
    for _ in range(n):
        rgb, _, ins, k = make_scene(rng, res, res, hard=True,
                                    max_leaves=max_leaves)
        idmap = np.zeros((res, res), np.int32)
        for j in range(ins.shape[-1]):
            idmap[ins[..., j] > 0] = j + 1
        imgs.append(rgb)
        gt_ids.append(idmap)
        gt_ns.append(k)
    return np.stack(imgs).astype(np.uint8), np.stack(gt_ids), np.array(gt_ns)


def prep_batches(p: Predictor, imgs: np.ndarray):
    """Each batch of ``p.batch_size`` (the last padded with its first
    image) through ``_infer_prep`` once: [(prep, n_valid)]."""
    preps = []
    for s in range(0, len(imgs), p.batch_size):
        chunk = imgs[s:s + p.batch_size]
        n_valid = len(chunk)
        if n_valid < p.batch_size:
            pad = np.repeat(chunk[:1], p.batch_size - n_valid, axis=0)
            chunk = np.concatenate([chunk, pad])
        preps.append((p._infer_prep(p._to_device(chunk)), n_valid))
    return preps


def stop_tuple(min_frac, max_misses, suppress, stop_frac) -> Tuple:
    """One grid point as the JAX tool passes it: float32, int32, float32,
    float32."""
    return (np.float32(min_frac), np.int32(max_misses), np.float32(suppress),
            np.float32(stop_frac))


def sweep_point(p: Predictor, preps, gt_ids, gt_ns, sp: Sequence,
                dic_weight: float = 0.05) -> Dict:
    """The rounds of every prepped batch under the stopping rule ``sp``,
    one round a call from the carry until all are done (or the static
    budget is spent); -> the point's row (unrounded sbd / abs_dic / score,
    mean rounds to done, seconds)."""
    p.stop_params = sp
    pred_ids, pred_ns, rounds_used = [], [], []
    t0 = time.time()
    for prep, n_valid in preps:
        carry, used = None, 0
        while used < p.max_rounds:
            idmap, counts, carry = p._rounds(1, prep, carry)
            used += 1
            if bool(carry["done"].all()):
                break
        rounds_used.append(used)
        pred_ids.append(idmap.cpu().numpy()[:n_valid])
        pred_ns.append(counts.cpu().numpy()[:n_valid])
    pred_ids = np.concatenate(pred_ids).astype(np.int32)
    pred_ns = np.concatenate(pred_ns)
    sbd = float(symmetric_best_dice_batch(gt_ids, pred_ids).mean())
    dic = float(np.mean(np.abs(gt_ns - pred_ns)))
    return {"sbd": sbd, "abs_dic": dic, "score": sbd - dic_weight * dic,
            "rounds_to_done": float(np.mean(rounds_used)),
            "secs": time.time() - t0}


def sweep(p: Predictor, preps, gt_ids, gt_ns, grid_frac, grid_miss,
          grid_sup, grid_stop, dic_weight: float = 0.05) -> List[Dict]:
    """Every grid point's row, rounded as the JAX tool writes them, printed
    as it comes and sorted by score (best first, stable)."""
    rows = []
    for min_frac, max_misses, sup, stop_frac in itertools.product(
            grid_frac, grid_miss, grid_sup, grid_stop):
        r = sweep_point(p, preps, gt_ids, gt_ns,
                        stop_tuple(min_frac, max_misses, sup, stop_frac),
                        dic_weight)
        rows.append({
            "min_frac": min_frac, "max_misses": max_misses,
            "suppress": sup, "stop_frac": stop_frac,
            "sbd": round(r["sbd"], 4), "abs_dic": round(r["abs_dic"], 4),
            "score": round(r["score"], 4),
            "rounds_to_done": round(r["rounds_to_done"], 2),
            "secs": round(r["secs"], 1),
        })
        print(rows[-1], flush=True)
    rows.sort(key=lambda r: -r["score"])
    return rows


def report(rows, n: int, res: int, ckpt: str, dic_weight: float) -> str:
    best = rows[0]
    return (
        "# Extraction stopping-rule calibration\n\n"
        f"Sweep over (min_remaining_frac, max_extract_misses) on "
        f"{n} hard-preset synthetic images at {res}², "
        f"checkpoint `{ckpt}`, staged dispatch (prep computed "
        "once; each config re-runs only the round scan with runtime "
        "stop scalars).  Score = SBD - "
        f"{dic_weight}*|DiC|.\n\n"
        "| min_frac | max_misses | suppress | stop_frac | SBD "
        "| abs DiC | score | rounds |\n"
        "|---|---|---|---|---|---|---|---|\n"
        + "\n".join(
            f"| {r['min_frac']} | {r['max_misses']} | {r['suppress']} |"
            f" {r['stop_frac']} |"
            f" {r['sbd']} | {r['abs_dic']} | {r['score']} |"
            f" {r['rounds_to_done']} |"
            for r in rows
        )
        + f"\n\nBest: min_frac={best['min_frac']}, "
        f"max_misses={best['max_misses']}, "
        f"suppress={best['suppress']}, "
        f"stop_frac={best['stop_frac']} "
        f"(SBD {best['sbd']}, |DiC| {best['abs_dic']}).\n"
    )


def calibration_predictor(cfg: Config, ckpt: str, res: int, batch: int,
                          bf16: bool, device) -> Predictor:
    """The staged predictor of the checkpoint at ``res``² (float32 with
    TF32 off, or bfloat16)."""
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, image_height=res, image_width=res))
    cfg, model = load_model(cfg, ckpt)
    return Predictor(cfg, model, batch_size=batch, staged=True,
                     device=resolve_device(device),
                     dtype=torch.bfloat16 if bf16 else torch.float32)


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", default=ASSET)
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--max-leaves", type=int, default=14)
    ap.add_argument("--seed", type=int, default=77)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--dic-weight", type=float, default=0.05)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(OUT_DIR, "CALIBRATION.md"))
    ap.add_argument("--stop-params-out",
                    default=os.path.join(OUT_DIR, "stop_params.json"))
    for flag, values in zip(("--grid-frac", "--grid-miss", "--grid-sup",
                             "--grid-stop"), DEFAULT_GRID):
        ap.add_argument(flag, default=",".join(map(str, values)))
    ap.add_argument("--no-install", action="store_true",
                    help="report only; write no stop-params JSON")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    p = calibration_predictor(cvppp_config(), args.ckpt, args.res,
                              args.batch, args.bf16, device)
    imgs, gt_ids, gt_ns = hard_scenes(args.n, args.res, args.seed,
                                      args.max_leaves)
    preps = prep_batches(p, imgs)
    rows = sweep(p, preps, gt_ids, gt_ns,
                 [float(x) for x in args.grid_frac.split(",")],
                 [int(x) for x in args.grid_miss.split(",")],
                 [float(x) for x in args.grid_sup.split(",")],
                 [float(x) for x in args.grid_stop.split(",")],
                 args.dic_weight)
    best = rows[0]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(report(rows, args.n, args.res, args.ckpt, args.dic_weight))
    if not args.no_install:
        path = args.stop_params_out
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(
                {"min_remaining_frac": best["min_frac"],
                 "max_extract_misses": best["max_misses"],
                 "peak_suppress_factor": best["suppress"],
                 "stop_remaining_frac": best["stop_frac"],
                 "calibrated_on": f"hard{args.n}@{args.res} seed{args.seed}",
                 "ckpt": args.ckpt,
                 "sbd": best["sbd"], "abs_dic": best["abs_dic"]},
                f, indent=2,
            )
        print(f"wrote {path}")
    print(f"wrote {args.out}; best={best}")
    return rows


if __name__ == "__main__":
    main()
