"""Discriminative (embedding) instance loss, De Brabandere et al. (port of
``tpuseg/losses/discriminative.py``): masked reductions over the padded
instance axis.  The loss is ``1.0 * variance + 0.005 * q-regularisation``
over L2-normalised means; the distance and the plain regularisation terms
are computed by their functions but not added, as in the JAX package."""

from __future__ import annotations

from typing import Tuple

import torch

_EPS = 1e-8


def _valid(n_objects: torch.Tensor, n: int, like: torch.Tensor):
    """(B, n) float: slot j < n_objects[b]."""
    ids = torch.arange(n, device=like.device)
    return (ids[None, :] < n_objects.to(like.device)[:, None]).to(like.dtype)


def calculate_means(pred: torch.Tensor, gt: torch.Tensor,
                    n_objects: torch.Tensor, normalize: bool = True
                    ) -> torch.Tensor:
    """pred (B, L, F), gt (B, L, N) in {0, 1}, n_objects (B,) -> (B, N, F)
    masked instance means (L2-normalised with ``normalize``), zero rows
    beyond n_objects."""
    gt = gt.to(pred.dtype)
    sums = torch.einsum("blf,bln->bnf", pred, gt)
    counts = gt.sum(1)[..., None]
    means = sums / counts.clamp_min(_EPS)
    if normalize:
        means = means / torch.linalg.vector_norm(
            means, dim=-1, keepdim=True).clamp_min(_EPS)
    return means * _valid(n_objects, gt.shape[2], means)[..., None]


def _dist(diff: torch.Tensor, norm: int) -> torch.Tensor:
    if norm == 1:
        return diff.abs().sum(-1)
    return torch.sqrt((diff * diff).sum(-1) + _EPS)


def calculate_variance_term(pred, gt, means, n_objects, delta_v: float,
                            norm: int = 2) -> torch.Tensor:
    """Clamped within-instance variance."""
    gt = gt.to(pred.dtype)
    dist = _dist(pred[:, :, None, :] - means[:, None, :, :], norm)
    var = (dist - delta_v).clamp_min(0.0) ** 2 * gt  # (B, L, N)
    valid = _valid(n_objects, gt.shape[2], pred)[:, None, :]
    num = (var * valid).sum((1, 2))
    den = (gt * valid).sum((1, 2))
    return (num / den.clamp_min(_EPS)).mean()


def calculate_distance_term(means, n_objects, delta_d: float,
                            norm: int = 2) -> torch.Tensor:
    """Between-instance hinge distance (not part of the loss)."""
    n = means.shape[1]
    dist = _dist(means[:, :, None, :] - means[:, None, :, :], norm)
    off = 1.0 - torch.eye(n, dtype=means.dtype, device=means.device)
    hinge = (2.0 * delta_d * off - dist).clamp_min(0.0) ** 2 * off
    valid = _valid(n_objects, n, means)
    per_sample = (hinge * valid[:, :, None] * valid[:, None, :]).sum((1, 2))
    cnt = n_objects.to(means.dtype).to(means.device)
    per_sample = torch.where(
        cnt > 1, per_sample / (cnt * (cnt - 1.0)).clamp_min(1.0),
        torch.zeros_like(per_sample))
    return per_sample.mean()


def calculate_regularization_term(means, n_objects,
                                  norm: int = 2) -> torch.Tensor:
    """Mean embedding norm of the valid instance means."""
    norms = means.abs().sum(-1) if norm == 1 else torch.linalg.vector_norm(
        means, dim=-1)
    valid = _valid(n_objects, means.shape[1], means)
    cnt = n_objects.to(means.dtype).to(means.device).clamp_min(1.0)
    return ((norms * valid).sum(1) / cnt).mean()


def calculate_q_regularization_term(pred, gt) -> torch.Tensor:
    """Unit-norm penalty on the foreground embeddings."""
    tgt = gt.to(pred.dtype).sum(2, keepdim=True)  # (B, L, 1)
    num = tgt.sum().clamp_min(1.0)
    l2 = torch.linalg.vector_norm(pred * tgt, dim=2)
    return ((l2 - 1.0) ** 2).sum() / num


def discriminative_loss(embeddings: torch.Tensor, target: torch.Tensor,
                        n_objects: torch.Tensor, delta_v: float = 0.5,
                        delta_d: float = 1.5, norm: int = 2
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """embeddings (B, F, H, W), target (B, N, H, W) one-hot instance stack,
    n_objects (B,).  Returns (loss, cluster means (B, N, F))."""
    alpha, gamma = 1.0, 0.005
    b, f = embeddings.shape[:2]
    n = target.shape[1]
    pred = embeddings.reshape(b, f, -1).transpose(1, 2)
    gt = target.reshape(b, n, -1).transpose(1, 2)
    means = calculate_means(pred, gt, n_objects, normalize=True)
    var_term = calculate_variance_term(pred, gt, means, n_objects, delta_v,
                                       norm)
    qreg = calculate_q_regularization_term(pred, gt)
    return alpha * var_term + gamma * qreg, means
