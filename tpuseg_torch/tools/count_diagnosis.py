"""Diagnose where |DiC| comes from: the signed count-error distribution
(port of ``tools/count_diagnosis.py``).

    python -m tpuseg_torch.tools.count_diagnosis [--ckpt PATH] [--n 64]
        [--res 256] [--bf16] [--seed 99] [--stop-params F,M[,S]]
        [--device cpu]

For N hard-preset synthetic scenes, records per image the GT instance
count, the extracted count (the installed stopping rule,
``assets/stop_params.json``, unless ``--stop-params`` overrides it) and
the count-head budget, then prints the signed-error histograms, the count
head's own accuracy, the cross-tab of the two errors, how often extraction
hit the budget, the oracle table (|DiC| and SBD when the extraction's
budget is the head's, and when it is the GT count) and the worst images.
Runs on the card unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import collections
from typing import Dict, List, Optional

import numpy as np
import torch

from tpuseg_torch import resolve_device
from tpuseg_torch.configs import Config, cvppp_config
from tpuseg_torch.evalm.metrics import symmetric_best_dice_batch
from tpuseg_torch.tools.calibrate_stopping import (
    ASSET, calibration_predictor, hard_scenes,
)
from tpuseg_torch.utils.checkpoint_io import load_stop_params


def diagnose(cfg: Config, ckpt: str = ASSET, n: int = 64, res: int = 256,
             batch: int = 16, max_leaves: int = 14, seed: int = 99,
             bf16: bool = False, stop_params=None, device="cuda") -> Dict:
    """The staged extraction of ``n`` hard scenes under ``stop_params``
    (None: the installed rule); prints the diagnosis and returns the per
    image arrays (gt, extracted, budget, sbd)."""
    device = resolve_device(device)
    sp = stop_params if stop_params is not None else load_stop_params()
    print(f"stop_params: {sp}")
    imgs, gt_ids, gt_ns = hard_scenes(n, res, seed, max_leaves)
    p = calibration_predictor(cfg, ckpt, res, batch, bf16, device)
    p.stop_params = sp

    pred_ns, budgets, pred_ids, oracle_ns, oracle_ids = [], [], [], [], []
    for s in range(0, n, batch):
        chunk = imgs[s:s + batch]
        n_valid = len(chunk)
        if n_valid < batch:
            chunk = np.concatenate(
                [chunk, np.repeat(chunk[:1], batch - n_valid, axis=0)])
        prep = p._infer_prep(p._to_device(chunk))
        budgets.append(prep[2].cpu().numpy()[:n_valid])
        _, idmap, counts = p._extract_staged([prep], 0)[0]
        pred_ns.append(counts.cpu().numpy()[:n_valid])
        pred_ids.append(idmap.cpu().numpy()[:n_valid])
        # the oracle: the same extraction with the GT count as the budget
        gt_b = np.concatenate([gt_ns[s:s + n_valid],
                               np.repeat(gt_ns[s:s + 1], batch - n_valid)])
        gt_b = torch.as_tensor(gt_b, dtype=torch.int32, device=p.device)
        _, idmap, counts = p._extract_staged([prep[:2] + (gt_b,) + prep[3:]],
                                             0)[0]
        oracle_ns.append(counts.cpu().numpy()[:n_valid])
        oracle_ids.append(idmap.cpu().numpy()[:n_valid])
    pred_ns = np.concatenate(pred_ns)
    budgets = np.concatenate(budgets)
    pred_ids = np.concatenate(pred_ids).astype(np.int32)

    sbd_per = symmetric_best_dice_batch(gt_ids, pred_ids).numpy()
    err = pred_ns - gt_ns
    head_err = budgets - gt_ns

    print(f"\nGT counts:       min {gt_ns.min()} max {gt_ns.max()} "
          f"mean {gt_ns.mean():.2f}")
    print(f"extracted:       mean {pred_ns.mean():.2f}   "
          f"|DiC| {np.abs(err).mean():.3f}  bias {err.mean():+.3f}")
    print(f"count head:      mean {budgets.mean():.2f}   "
          f"|DiC| {np.abs(head_err).mean():.3f}  "
          f"bias {head_err.mean():+.3f}  "
          f"exact {np.mean(budgets == gt_ns) * 100:.0f}%  "
          f"within1 {np.mean(np.abs(head_err) <= 1) * 100:.0f}%")
    print(f"SBD:             {sbd_per.mean():.4f}")

    print("\nsigned extraction-count error histogram:")
    for v, c in sorted(collections.Counter(err.tolist()).items()):
        print(f"  {v:+d}: {'#' * c} ({c})")
    print("\nsigned count-head error histogram:")
    for v, c in sorted(collections.Counter(head_err.tolist()).items()):
        print(f"  {v:+d}: {'#' * c} ({c})")

    both = collections.Counter(zip(head_err.tolist(), err.tolist()))
    print("\n(head_err, extract_err) pairs:")
    for (h, e), c in sorted(both.items()):
        print(f"  head {h:+d} -> extract {e:+d}: {c}")

    print(f"\nextract == budget (cap active): "
          f"{np.mean(pred_ns == budgets) * 100:.0f}%")
    print(f"extract < budget (rule stopped first): "
          f"{np.mean(pred_ns < budgets) * 100:.0f}%")

    oracle_ns = np.concatenate(oracle_ns)
    oracle_sbd = symmetric_best_dice_batch(
        gt_ids, np.concatenate(oracle_ids).astype(np.int32)).numpy()
    print("\noracle (budget the extraction stops at: |DiC|, SBD):")
    print(f"  count head (this run): {np.abs(err).mean():.3f}  "
          f"{sbd_per.mean():.4f}")
    print(f"  GT count:              {np.abs(oracle_ns - gt_ns).mean():.3f}  "
          f"{oracle_sbd.mean():.4f}")

    worst = np.argsort(-np.abs(err))[:8]
    print("\nworst images (idx, gt, extracted, budget, sbd):")
    for i in worst:
        print(f"  {i}: gt={gt_ns[i]} ext={pred_ns[i]} bud={budgets[i]} "
              f"sbd={sbd_per[i]:.3f}")
    return {"gt": gt_ns, "extracted": pred_ns, "budget": budgets,
            "sbd": sbd_per, "oracle_extracted": oracle_ns,
            "oracle_sbd": oracle_sbd}


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", default=ASSET)
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--max-leaves", type=int, default=14)
    ap.add_argument("--seed", type=int, default=99)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--stop-params", default="",
                    help="override: min_frac,max_misses[,suppress]")
    args = ap.parse_args(argv)
    sp = None
    if args.stop_params:
        vals = [float(x) for x in args.stop_params.split(",")]
        sp = (vals[0], int(vals[1]), *vals[2:])
    return diagnose(cvppp_config(), args.ckpt, args.n, args.res, args.batch,
                    args.max_leaves, args.seed, args.bf16, sp, args.device)


if __name__ == "__main__":
    main()
