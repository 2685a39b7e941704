"""Focal and cross-entropy losses (port of ``tpuseg/losses/focal.py``).

``bce_loss`` is not on the training path and comes with a later slice.
"""

from __future__ import annotations

from typing import Optional

import torch

_EPS = 1e-7


def focal_loss(logits: torch.Tensor, targets: torch.Tensor,
               gamma: float = 2.0, alpha: float = 0.0,
               map_weight=0) -> torch.Tensor:
    """Two-class focal loss on flattened pixels: softmax over the last
    axis, a *detached* ``pt`` factor, ``(1 - alpha)`` on the positive and
    ``(1 + alpha)`` on the negative term, a ``(map_weight + 1)`` per-pixel
    multiplier.  logits (L, 2), targets (L,) in {0, 1} -> (L,) losses."""
    t = targets.to(logits.dtype)
    p = torch.softmax(logits, dim=1)
    pt = p.detach()
    p = p.clamp(_EPS, 1.0 - _EPS)
    w = map_weight + 1
    loss_1 = (-(1.0 - alpha) * (1.0 - pt[:, 1]) ** gamma
              * torch.log(p[:, 1]) * t * w)
    loss_0 = (-(1.0 + alpha) * (1.0 - pt[:, 0]) ** gamma
              * torch.log(p[:, 0]) * (1.0 - t) * w)
    return loss_1 + loss_0


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          class_weights: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Mean CE over flattened pixels, ``torch.nn.CrossEntropyLoss``
    semantics (weighted mean = sum(w_y * ce) / sum(w_y)).  logits (L, C),
    labels (L,) integer."""
    labels = labels.long()
    logp = torch.log_softmax(logits, dim=-1)
    ce = -logp.gather(1, labels[:, None])[:, 0]
    if class_weights is None:
        return ce.mean()
    w = torch.as_tensor(class_weights, dtype=logits.dtype,
                        device=logits.device)[labels]
    return (w * ce).sum() / w.sum()
