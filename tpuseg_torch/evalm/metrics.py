"""Evaluation metrics as tensor ops (port of ``tpuseg/evalm/metrics.py``):
SBD, best dice, |DiC|, foreground Dice.

All pairwise instance intersections come from one one-hot matmul per image
pair; best dice is the row/column max.  When either side has no instances
the best dice is 0 (the reference crashes on ``np.max([])``).
"""

from __future__ import annotations

import torch


def _t(x, dtype=None):
    return torch.as_tensor(x) if dtype is None else torch.as_tensor(x).to(dtype)


def calc_dic(n_objects_gt, n_objects_pred) -> torch.Tensor:
    """|DiC| — absolute count error."""
    return (_t(n_objects_gt, torch.int32) - _t(n_objects_pred, torch.int32)).abs()


def calc_dice(gt_seg, pred_seg) -> torch.Tensor:
    """Binary-mask Dice, raw ratio (no smoothing)."""
    g = _t(gt_seg, torch.float32)
    p = _t(pred_seg, torch.float32)
    return 2.0 * (g * p).sum() / (g.sum() + p.sum())


def dice_matrix(ins_a, ins_b, max_ids: int = 64):
    """All-pairs instance Dice of two (H, W) id maps over id slots
    1..max_ids: (D (max_ids, max_ids), valid_a, valid_b)."""
    a = _t(ins_a).reshape(-1)
    b = _t(ins_b).reshape(-1).to(a.device)
    ids = torch.arange(1, max_ids + 1, device=a.device)
    a_oh = (a[None, :] == ids[:, None]).to(torch.float32)
    b_oh = (b[None, :] == ids[:, None]).to(torch.float32)
    inter = a_oh @ b_oh.T
    area_a = a_oh.sum(dim=1)
    area_b = b_oh.sum(dim=1)
    d = 2.0 * inter / torch.clamp(area_a[:, None] + area_b[None, :], min=1.0)
    return d, area_a > 0, area_b > 0


def _best_dice(d, valid_rows, valid_cols):
    d = torch.where(valid_cols[None, :], d, torch.full_like(d, -float("inf")))
    row_best = d.max(dim=1).values
    row_best = torch.where(valid_rows & torch.isfinite(row_best), row_best,
                           torch.zeros_like(row_best))
    n = torch.clamp(valid_rows.sum(), min=1)
    return row_best.sum() / n


def calc_bd(ins_seg_gt, ins_seg_pred, max_ids: int = 64) -> torch.Tensor:
    """Best dice, gt rows vs pred columns."""
    return _best_dice(*dice_matrix(ins_seg_gt, ins_seg_pred, max_ids))


def calc_sbd(ins_seg_gt, ins_seg_pred, max_ids: int = 64) -> torch.Tensor:
    """Symmetric best dice."""
    d, vg, vp = dice_matrix(ins_seg_gt, ins_seg_pred, max_ids)
    return torch.minimum(_best_dice(d, vg, vp), _best_dice(d.T, vp, vg))


def symmetric_best_dice_batch(ins_gt, ins_pred, max_ids: int = 64):
    """(B, H, W) id maps each -> (B,) SBD."""
    ins_gt, ins_pred = _t(ins_gt), _t(ins_pred)
    return torch.stack([
        calc_sbd(g, p, max_ids) for g, p in zip(ins_gt, ins_pred)
    ])


def fg_dice_batch(fg_gt, fg_pred) -> torch.Tensor:
    """(B, H, W) binary masks each -> (B,) Dice."""
    g = _t(fg_gt, torch.float32)
    p = _t(fg_pred, torch.float32).to(g.device)
    g = g.reshape(g.shape[0], -1)
    p = p.reshape(p.shape[0], -1)
    return 2.0 * (g * p).sum(dim=1) / (g.sum(dim=1) + p.sum(dim=1))
