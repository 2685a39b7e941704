"""Masked KMeans over pixel embeddings, on the device (port of
``tpuseg/runtime/cluster.py``).

Weighted Lloyd iterations over *all* pixels with the foreground mask as the
weights (fixed shapes), a fixed iteration count, ``n_init`` restarts run
as one batched tensor program, and the restart of least inertia kept.
Seeds are drawn by Gumbel top-k over the foreground from an explicit
``torch.Generator``.  The distance matrix is a plain ``torch.matmul``.

``kmeans_cluster`` takes one image's embeddings ``(H, W, F)`` (the JAX
package's layout); ``kmeans_cluster_batch`` a batch ``(B, H, W, F)``.
"""

from __future__ import annotations

from typing import Tuple

import torch

_BIG = 1e30


def _sq_dist(emb: torch.Tensor, centers: torch.Tensor,
             valid_c: torch.Tensor) -> torch.Tensor:
    """(..., L, K) squared distances, ``_BIG`` at the inactive clusters."""
    d = ((emb * emb).sum(-1, keepdim=True)
         - 2.0 * emb @ centers.transpose(-1, -2)
         + (centers * centers).sum(-1)[..., None, :])
    return torch.where(valid_c[..., None, :], d, torch.full_like(d, _BIG))


def _lloyd(emb: torch.Tensor, weights: torch.Tensor,
           init_centers: torch.Tensor, k_valid, n_iter: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n_iter`` weighted Lloyd steps from ``init_centers``.

    emb (..., L, F); weights (..., L) 0/1; init_centers (..., K, F);
    k_valid: the active cluster count (an int or a tensor broadcasting
    against the leading axes).  Leading axes broadcast (restarts, images).
    Returns (assign (..., L) int64, inertia (...)).  Clusters at index >=
    ``k_valid`` never take a pixel; an empty cluster keeps its centre."""
    k = init_centers.shape[-2]
    k_valid = torch.as_tensor(k_valid, device=emb.device)
    valid_c = torch.arange(k, device=emb.device) < k_valid[..., None]
    w = weights.to(emb.dtype)[..., :, None]
    centers = init_centers
    for _ in range(n_iter):
        assign = _sq_dist(emb, centers, valid_c).argmin(dim=-1)
        onehot = torch.nn.functional.one_hot(assign, k).to(emb.dtype) * w
        counts = onehot.sum(dim=-2)[..., None]                 # (..., K, 1)
        sums = onehot.transpose(-1, -2) @ emb                  # (..., K, F)
        new = torch.where(counts > 0, sums / counts.clamp(min=1), centers)
        centers = torch.where(valid_c[..., None], new, centers)
    d = _sq_dist(emb, centers, valid_c)
    assign = d.argmin(dim=-1)
    inertia = (d.min(dim=-1).values * weights.to(emb.dtype)).sum(dim=-1)
    return assign, inertia


def _kmeans(emb: torch.Tensor, wts: torch.Tensor, n_clusters: torch.Tensor,
            generator: torch.Generator, max_clusters: int, n_iter: int,
            n_init: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """emb (B, L, F), wts (B, L), n_clusters (B,) -> (ids (B, L) int32,
    inertia (B,)); the B * n_init restarts as one program."""
    b, l, _ = emb.shape
    u = torch.rand((b, n_init, l), generator=generator, device=emb.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
    score = torch.where(wts[:, None] > 0, gumbel, torch.full_like(gumbel, -_BIG))
    seed_idx = score.topk(max_clusters, dim=-1).indices      # (B, R, K)
    rows = torch.arange(b, device=emb.device)[:, None, None]
    centers = emb[rows, seed_idx]                            # (B, R, K, F)
    assign, inertia = _lloyd(emb[:, None], wts[:, None], centers,
                             n_clusters.to(emb.device)[:, None], n_iter)
    best = inertia.argmin(dim=1)                             # (B,)
    pick = assign[torch.arange(b, device=emb.device), best]  # (B, L)
    ids = (pick + 1).to(torch.int32) * (wts > 0).to(torch.int32)
    return ids, inertia.gather(1, best[:, None])[:, 0]


def kmeans_cluster(embeddings: torch.Tensor, fg_mask: torch.Tensor,
                   n_clusters, generator: torch.Generator,
                   max_clusters: int = 32, n_iter: int = 50,
                   n_init: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cluster one image's foreground-pixel embeddings.

    embeddings (H, W, F) float; fg_mask (H, W) {0, 1}; n_clusters: the
    active cluster count (<= ``max_clusters``); ``generator`` on the
    embeddings' device draws the seeds.  Returns (instance ids (H, W) int32,
    1..n_clusters on the foreground and 0 elsewhere; the inertia of the
    best restart)."""
    h, w, f = embeddings.shape
    n = torch.as_tensor(n_clusters, device=embeddings.device).reshape(1)
    ids, inertia = _kmeans(embeddings.reshape(1, h * w, f),
                           fg_mask.reshape(1, h * w).to(embeddings.dtype), n,
                           generator, max_clusters, n_iter, n_init)
    return ids.reshape(h, w), inertia[0]


def kmeans_cluster_batch(embeddings: torch.Tensor, fg_masks: torch.Tensor,
                         n_clusters: torch.Tensor,
                         generator: torch.Generator, max_clusters: int = 32,
                         n_iter: int = 50, n_init: int = 8
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``kmeans_cluster`` over a batch: embeddings (B, H, W, F), fg_masks
    (B, H, W), n_clusters (B,) -> (ids (B, H, W) int32, inertia (B,))."""
    b, h, w, f = embeddings.shape
    ids, inertia = _kmeans(embeddings.reshape(b, h * w, f),
                           fg_masks.reshape(b, h * w).to(embeddings.dtype),
                           torch.as_tensor(n_clusters), generator,
                           max_clusters, n_iter, n_init)
    return ids.reshape(b, h, w), inertia
