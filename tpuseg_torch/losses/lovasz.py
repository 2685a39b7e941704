"""Lovasz-Softmax / Jaccard hinge losses (port of
``tpuseg/losses/lovasz.py``).

Sorting-based and batched (no Python loop over pixels or images).  As in
the JAX package, the reference's ``ignore`` label filtering (dynamic
shapes) is expressed as weighting.  Sorts are stable, so tied errors keep
the JAX order.  None of these is on the training path.
"""

from __future__ import annotations

import torch


def lovasz_grad(gt_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovasz extension with respect to the sorted errors,
    along the last axis.  gt_sorted: (..., P) in {0, 1}, sorted by
    descending error."""
    g = gt_sorted.float()
    gts = g.sum(dim=-1, keepdim=True)
    intersection = gts - g.cumsum(dim=-1)
    union = gts + (1.0 - g).cumsum(dim=-1)
    jaccard = 1.0 - intersection / union
    if g.shape[-1] > 1:
        jaccard = torch.cat([jaccard[..., :1],
                             jaccard[..., 1:] - jaccard[..., :-1]], dim=-1)
    return jaccard


def _sorted_dot(errors: torch.Tensor, fg: torch.Tensor,
                relu: bool) -> torch.Tensor:
    """Per row of (R, P): the errors sorted by descending value (stable)
    dotted with ``lovasz_grad`` of the labels in that order."""
    order = torch.argsort(-errors, dim=-1, stable=True)
    e = errors.gather(-1, order)
    if relu:
        e = torch.relu(e)
    return (e * lovasz_grad(fg.gather(-1, order))).sum(dim=-1)


def lovasz_hinge(logits: torch.Tensor, labels: torch.Tensor,
                 per_image: bool = True) -> torch.Tensor:
    """Binary Lovasz hinge.  logits / labels: (B, ...)."""
    b = logits.shape[0]
    lg = logits.reshape(b, -1)
    lb = labels.reshape(b, -1)
    if not per_image:
        lg, lb = lg.reshape(1, -1), lb.reshape(1, -1)
    errors = 1.0 - lg * (2.0 * lb.to(lg.dtype) - 1.0)
    losses = _sorted_dot(errors, lb, relu=True)
    return losses.mean() if per_image else losses[0]


def stable_bce_loss(logits: torch.Tensor, targets: torch.Tensor,
                    reduction: bool = True) -> torch.Tensor:
    """Numerically stable BCE with logits."""
    loss = (logits.clamp(min=0) - logits * targets.to(logits.dtype)
            + torch.log1p(torch.exp(-logits.abs())))
    return loss.mean() if reduction else loss


def binary_xloss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy through ``stable_bce_loss``."""
    return stable_bce_loss(logits.reshape(-1), labels.reshape(-1))


def _lovasz_softmax_flat(probas: torch.Tensor, labels: torch.Tensor,
                         only_present: bool = False) -> torch.Tensor:
    """probas (P, C), labels (P,): the classes' losses, averaged (over the
    present classes with ``only_present``)."""
    c = probas.shape[1]
    classes = torch.arange(c, device=labels.device)[:, None]
    fg = (labels[None, :] == classes).to(probas.dtype)      # (C, P)
    errors = (fg - probas.t()).abs()
    losses = _sorted_dot(errors, fg, relu=False)
    if only_present:
        w = (fg.sum(dim=1) > 0).to(probas.dtype)
        return (losses * w).sum() / w.sum().clamp(min=1.0)
    return losses.mean()


def lovasz_softmax(probas: torch.Tensor, labels: torch.Tensor,
                   only_present: bool = False,
                   per_image: bool = False) -> torch.Tensor:
    """Multi-class Lovasz-Softmax.  probas (B, H, W, C) probabilities (the
    JAX package's layout); labels (B, H, W) integer."""
    b, c = probas.shape[0], probas.shape[-1]
    p = probas.reshape(b, -1, c)
    lb = labels.reshape(b, -1)
    if per_image:
        return torch.stack([_lovasz_softmax_flat(pp, ll, only_present)
                            for pp, ll in zip(p, lb)]).mean()
    return _lovasz_softmax_flat(p.reshape(-1, c), lb.reshape(-1),
                                only_present)


def iou_binary(preds: torch.Tensor, labels: torch.Tensor, empty: float = 1.0,
               per_image: bool = True) -> torch.Tensor:
    """Foreground IoU x 100, averaged over the images (or over one image
    made of the whole batch)."""
    if not per_image:
        preds, labels = preds.reshape(1, -1), labels.reshape(1, -1)
    b = preds.shape[0]
    p = preds.reshape(b, -1) == 1
    lb = labels.reshape(b, -1) == 1
    inter = (p & lb).sum(dim=1)
    union = (p | lb).sum(dim=1)
    iou = torch.where(union > 0, inter / union.clamp(min=1),
                      torch.full_like(inter, empty, dtype=torch.float32))
    return 100.0 * iou.mean()
