"""The glimpse decoder's dormant positive/negative point losses (port of
``tpuseg/decoder/pn_losses.py``): ``pn_loss``, ``pn_loss2`` and
``pn_loss3``, with the JAX package's guards (denominators clamped at 1)
and defaults (``pn_loss``'s focal term at weight 0, ``pn_loss2``'s
positive term a summed per-pixel BCE).  Maps are (B, 1, H, W) or flat
(B, HW); the sums run over every pixel of a sample either way."""

from __future__ import annotations

from typing import Callable, Optional

import torch

_EPS = 1e-7


def pn_loss(pred, advance, alpha, evaline, gold, focal_gamma: float = 2.0,
            focal_weight: float = 0.0) -> torch.Tensor:
    """softmax(pred * alpha) log-weighted by the advantage, plus
    ``focal_weight`` times a focal +/- term gated by alpha > evaline.
    pred / advance / alpha / gold (B, HW), evaline (B, 1) -> (B,)."""
    b = alpha.shape[0]
    gold = gold.reshape(b, -1)
    alpha = alpha.reshape(b, -1)
    p = torch.softmax(pred * alpha, dim=1)
    logp = torch.log(p.clamp(_EPS, 1 - _EPS))
    pnloss1 = -logp * advance
    if focal_weight:
        t = (alpha > evaline).to(pred.dtype)
        ratio = t.sum(1) / gold.sum(1).clamp_min(_EPS)
        pc = pred.clamp(_EPS, 1 - _EPS)
        pd = pc.detach()
        f1 = (-(2.0 - ratio)[:, None] * (1.0 - pd) ** focal_gamma
              * torch.log(pc) * t * gold)
        f0 = (-ratio[:, None] * pd ** focal_gamma
              * torch.log(1.0 - pc) * (1.0 - t) * gold)
        pnloss1 = pnloss1 + focal_weight * (f1 + f0)
    return pnloss1.sum(1) / b


def pn_loss2(pred, target, p_n, p_re, gold,
             ploss_fn: Optional[Callable] = None) -> torch.Tensor:
    """Positive loss (``ploss_fn``, default the summed per-pixel BCE of
    pred vs target) * 1.1 + the negative loss pushing ``p_n`` down at gold
    pixels whose attention ``p_re`` is below 1/|instance|.  -> (B,)."""
    b = pred.shape[0]
    if ploss_fn is None:
        pc = pred.clamp(_EPS, 1.0 - _EPS)
        ploss = -(target * torch.log(pc)
                  + (1.0 - target) * torch.log(1.0 - pc)).reshape(b, -1).sum(1)
    else:
        ploss = ploss_fn(pred, target)
    p_n = p_n * gold
    inv_n = 1.0 / gold.reshape(b, -1).sum(1).clamp_min(1.0)
    sel = (p_re.reshape(b, -1) < inv_n[:, None]).to(p_n.dtype)
    sel = (sel.reshape(gold.shape) * gold).detach()
    nloss = (-torch.log(1.0 - p_n + _EPS) * sel).reshape(b, -1).sum(1)
    denom = sel.reshape(b, -1).sum(1).clamp_min(1.0)
    return ploss * 1.1 + nloss / denom


def pn_loss3(alpha_maxidx, pro, alpha, evaline, gold) -> torch.Tensor:
    """Hinge on the raw score at the attention peak + the mean positive raw
    score at under-attended gold pixels.  evaline (B,) -> (B,)."""
    b = pro.shape[0]
    p = (pro * alpha_maxidx).reshape(b, -1).sum(1)
    ploss = torch.relu(-p)
    npoint = (alpha < evaline[:, None, None, None]).to(pro.dtype) * gold
    n_count = npoint.reshape(b, -1).sum(1).clamp_min(1.0)
    nloss = torch.relu(pro * npoint).reshape(b, -1).sum(1)
    return ploss + nloss / n_count
