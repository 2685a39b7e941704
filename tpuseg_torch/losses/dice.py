"""Soft-Dice losses (port of ``tpuseg/losses/dice.py``).

Layout: logits and targets are ``(B, C, H, W)``, the port's NCHW; the JAX
functions take ``(B, H, W, C)``.  Only the reduction axes differ.
``instance_dice_loss`` is not on the training path and comes later.
"""

from __future__ import annotations

from typing import Optional

import torch


def dice_coefficient(logits: torch.Tensor, target_onehot: torch.Tensor,
                     mask: Optional[torch.Tensor] = None,
                     smooth: float = 1.0, time: int = 2,
                     map_weight=0) -> torch.Tensor:
    """Per-class soft Dice of softmax(logits) against a one-hot target,
    (B, C).  ``time=2``: the denominator uses p^2 and g^2; ``time=1``: p
    and g.  ``map_weight`` enters every term as ``(w + 1)``; ``mask``
    multiplies every term."""
    probs = torch.softmax(logits, dim=1)
    tgt = target_onehot.to(probs.dtype)
    w = map_weight + 1
    num = probs * tgt * w
    den1 = (probs * w) if time == 1 else (probs * probs * w)
    den2 = (tgt * w) if time == 1 else (tgt * tgt * w)
    if mask is not None:
        num, den1, den2 = num * mask, den1 * mask, den2 * mask
    num, den1, den2 = (t.sum(dim=(2, 3)) for t in (num, den1, den2))
    return (2.0 * num + smooth) / (den1 + den2 + smooth)


def dice_loss(logits: torch.Tensor, target_onehot: torch.Tensor,
              optimize_bg: bool = False, weight=None, smooth: float = 1.0,
              size_average: bool = True, reduce: bool = True,
              mask: Optional[torch.Tensor] = None, time: int = 2,
              map_weight=0) -> torch.Tensor:
    """1 - mean foreground Dice.  Without ``optimize_bg`` class 0 is left
    out of the mean; class weights are renormalised to mean 1 over the
    kept classes.  (B,) if not ``reduce``, else a scalar (mean if
    ``size_average`` else sum)."""
    dice = dice_coefficient(logits, target_onehot, mask=mask, smooth=smooth,
                            time=time, map_weight=map_weight)
    if not optimize_bg:
        dice = dice[:, 1:]
    if weight is not None:
        weight = torch.as_tensor(weight, dtype=dice.dtype, device=dice.device)
        if not optimize_bg:
            weight = weight[1:]
        dice = dice * (weight.shape[0] * weight / weight.sum())
    loss = 1.0 - dice.mean(dim=1)
    if not reduce:
        return loss
    return loss.mean() if size_average else loss.sum()
