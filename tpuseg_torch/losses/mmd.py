"""MMD / WAE loss family (port of ``tpuseg/losses/mmd.py``): the IMQ MMD
penalty, the weighted point-cloud MMD, the sampled decoder MMD, its pooled
variant and the gl rank-matching loss.

Each random function is a draw step and a deterministic core: the draws
(uniform maps) come from the caller's ``torch.Generator`` unless passed
in as ``draws``, so a test can hand the core the JAX package's exact
draws.  Ties are broken as JAX breaks them: ``_select_points`` keeps the
lowest flat indices among equal priorities (``lax.top_k``), and
``gl_loss`` ranks with stable sorts (``jnp.argsort``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

_IMQ_SCALES = (0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0)


def _sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    na = (a * a).sum(1, keepdim=True)
    nb = (b * b).sum(1, keepdim=True)
    return na + nb.T - 2.0 * (a @ b.T)


def _imq_base(pz: str, zdim: int) -> float:
    if pz == "normal":
        return 2.0 * zdim
    if pz == "sphere":
        return 2.0
    if pz == "uniform":
        return float(zdim)
    raise ValueError(pz)


def mmd_penalty(sample_qz: torch.Tensor, sample_pz: torch.Tensor,
                pz: str = "normal", zdim: int = 24,
                kernel: str = "IMQ") -> torch.Tensor:
    """Unweighted IMQ MMD between two point sets (rows)."""
    m, n = sample_pz.shape[0], sample_qz.shape[0]
    if m < 2 or n < 2:
        return sample_qz.new_zeros(())
    if kernel != "IMQ":
        raise ValueError(kernel)
    cbase = _imq_base(pz, zdim)
    d_pp = _sq_dists(sample_pz, sample_pz)
    d_qq = _sq_dists(sample_qz, sample_qz)
    d_qp = _sq_dists(sample_qz, sample_pz)
    off_q = 1.0 - torch.eye(n, device=d_qq.device)
    off_p = 1.0 - torch.eye(m, device=d_pp.device)
    stat = 0.0
    for scale in _IMQ_SCALES:
        c = cbase * scale
        res1 = (c / (c + d_qq) * off_q / (n ** 2 - n)).sum()
        res1 = res1 + (c / (c + d_pp) * off_p / (m ** 2 - m)).sum()
        res2 = (c / (c + d_qp)).sum() * 2.0 / (n * m)
        stat = stat + res1 - res2
    return stat


def mmd_penalty_with_p(sample_qz, sample_pz, q_w, p_w, kernel: str = "RBF",
                       sigma2_k: float = 64.0, pz: str = "normal",
                       zdim: int = 24) -> torch.Tensor:
    """Weighted MMD between point clouds; the weights (zeros for padded
    points) are normalised to sum 1."""
    q = q_w.reshape(-1, 1) / q_w.sum().clamp_min(1e-12)
    p = p_w.reshape(-1, 1) / p_w.sum().clamp_min(1e-12)
    d_qq = _sq_dists(sample_qz, sample_qz)
    d_pp = _sq_dists(sample_pz, sample_pz)
    d_qp = _sq_dists(sample_qz, sample_pz)
    if kernel == "RBF":
        res1 = (torch.exp(d_qq / -2.0 / sigma2_k) * q * q.T).sum() * 0.5
        res1 = res1 + (torch.exp(d_pp / -2.0 / sigma2_k) * p * p.T).sum() * 0.5
        res2 = (torch.exp(d_qp / -2.0 / sigma2_k) * q * p.T).sum()
        return res1 - res2
    if kernel == "IMQ":
        cbase = 2.0 * zdim if pz == "normal" else (
            2.0 if pz == "sphere" else float(zdim))
        stat = 0.0
        for scale in _IMQ_SCALES:
            c = cbase * scale
            res1 = (q * q.T * c / (c + d_qq)).sum()
            res1 = res1 + (p * c / (c + d_pp) * p.T).sum()
            res2 = (q * c / (c + d_qp) * p.T * 2.0).sum()
            stat = stat + res1 - res2
        return stat
    raise ValueError(kernel)


def select_points_draws(shape, generator: Optional[torch.Generator],
                        device=None) -> torch.Tensor:
    """The two uniform maps ``_select_points`` draws: (2, *shape)
    [acceptance, priority]."""
    return torch.rand((2, *shape), generator=generator, device=device)


def _select_points(prob_map: torch.Tensor, draws: torch.Tensor,
                   threshold, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-size point selection from a (H, W) map: pixels where value >
    draws[0] * threshold are accepted; at most ``k`` of them kept, by the
    priority draws[1] (the lowest index first among equal priorities, as
    ``lax.top_k`` takes them).  Returns ((k, 2) row/col coordinates, (k,)
    weights: the map's value, 0 for a slot no accepted pixel filled)."""
    h, w = prob_map.shape
    k = min(k, h * w)
    accept = prob_map > draws[0] * threshold
    prio = torch.where(accept, draws[1],
                       torch.full_like(draws[1], -float("inf"))).reshape(-1)
    idx = torch.sort(prio, descending=True, stable=True).indices[:k]
    valid = torch.isfinite(prio[idx])
    coords = torch.stack([(idx // w).float(), (idx % w).float()], dim=1)
    weights = prob_map.reshape(-1)[idx] * valid
    return coords, weights


def decoder_mmd_draws(b: int, h: int, w: int,
                      generator: Optional[torch.Generator],
                      device=None) -> torch.Tensor:
    """The draws of ``decoder_mmd_loss``: (B, 2, 2, H, W) = per sample, for
    the input and the target map, ``select_points_draws``."""
    return torch.rand((b, 2, 2, h, w), generator=generator, device=device)


def decoder_mmd_loss(inputs: torch.Tensor, targets: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     max_points: int = 300, kernel: str = "RBF",
                     sigma2_k: float = 64.0,
                     draws: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Point-cloud MMD between predicted and target (B, H, W) probability
    maps: thresholded random pixel selection from each, then the weighted
    MMD of the selected coordinate clouds, summed over the batch (0 for a
    sample where either cloud is empty)."""
    b, h, w = inputs.shape
    if draws is None:
        draws = decoder_mmd_draws(b, h, w, generator, inputs.device)
    th_in = inputs.mean() * h * w / 200.0
    th_tg = targets.mean() * h * w / 200.0
    total = inputs.new_zeros(())
    for i in range(b):
        ci, wi = _select_points(inputs[i], draws[i, 0], th_in, max_points)
        ct, wt = _select_points(targets[i], draws[i, 1], th_tg, max_points)
        loss = mmd_penalty_with_p(ci, ct, wi, wt, kernel=kernel,
                                  sigma2_k=sigma2_k)
        ok = (wi.sum() > 0) & (wt.sum() > 0)
        total = total + torch.where(ok, loss, torch.zeros_like(loss))
    return total


def _pool(x: torch.Tensor, f: int, mode: str) -> torch.Tensor:
    """(B, H, W) max / avg pooling by ``f``."""
    pool = F.max_pool2d if mode == "max" else F.avg_pool2d
    return pool(x[:, None], f, f)[:, 0]


def mmd_loss_pooled(inputs: torch.Tensor, targets: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    pool_factor: int = 4, sigma2_k: float = 64.0,
                    max_points: int = 256,
                    draws: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pooled sampled point-cloud RBF-MMD + area term, (B,): threshold-
    sample both maps (``draws`` (2, B, side, side) uniform, drawn when
    None), max-pool the selection and avg-pool the probabilities by
    ``pool_factor``, then per sample the weighted RBF MMD over the pooled
    grid plus the squared area difference.  inputs (B, L), L a square;
    targets (B, L) or (B, h, w)."""
    b = inputs.shape[0]
    side = int(inputs[0].numel() ** 0.5)
    x = inputs.reshape(b, side, side)
    t = targets.reshape(b, side, side).to(x.dtype)
    if draws is None:
        draws = torch.rand((2, b, side, side), generator=generator,
                           device=x.device)
    th_x = (x.mean() * side * side / 500.0).clamp_min(0.01)
    th_t = (t.mean() * side * side / 100.0).clamp_min(0.01)
    sel_x = _pool((x > draws[0] * th_x).to(x.dtype), pool_factor, "max")
    sel_t = _pool((t > draws[1] * th_t).to(x.dtype), pool_factor, "max")
    px = _pool(x, pool_factor, "avg")
    pt = _pool(t, pool_factor, "avg")
    hs = side // pool_factor
    rows, cols = torch.meshgrid(
        torch.arange(hs, dtype=torch.float32, device=x.device),
        torch.arange(hs, dtype=torch.float32, device=x.device), indexing="ij")
    coords = torch.stack([rows, cols], -1).reshape(-1, 2)
    losses = []
    for i in range(b):
        wx = (px[i] * sel_x[i]).reshape(-1)
        wt = (pt[i] * sel_t[i]).reshape(-1)
        loss = mmd_penalty_with_p(coords, coords, wx, wt, kernel="RBF",
                                  sigma2_k=sigma2_k)
        ok = (sel_x[i].sum() > 0) & (sel_t[i].sum() > 0)
        losses.append(torch.where(ok, loss, torch.zeros_like(loss)))
    area = (px.reshape(b, -1).sum(1) - pt.reshape(b, -1).sum(1)) ** 2 / (
        hs * hs)
    return torch.stack(losses) + area


def _descending_rank(d: torch.Tensor) -> torch.Tensor:
    """``argsort(argsort(-d))`` with stable sorts: equal values rank in
    index order."""
    order = torch.argsort(-d, stable=True)
    return torch.argsort(order, stable=True)


def gl_loss(encode: torch.Tensor, decode: torch.Tensor) -> torch.Tensor:
    """Rank-matching penalty between the latent and the decoded pairwise
    distances, weighted by the latent ones.  encode (B, Z); decode (B, ...)
    flattened per sample."""
    b = decode.shape[0]
    dec = decode.reshape(b, -1)
    en_d = _sq_dists(encode, encode).reshape(-1)
    de_d = _sq_dists(dec, dec).reshape(-1)
    en_rank = _descending_rank(en_d).to(encode.dtype)
    de_rank = _descending_rank(de_d).to(encode.dtype)
    denom = max(b * b - b, 1) * (64.0 * 34.0 ** 0.5)
    return ((de_rank - en_rank) * en_d).sum() / denom
