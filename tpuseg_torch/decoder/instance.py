"""Iterative hard-attention instance decoder, extraction path (port of
``tpuseg/decoder/instance.py``: ``_attend``, ``_prep``, ``_stop_scalars``,
``_disk``, the round body of ``_extract_step`` and ``_extract_rounds``).

Each extraction round picks ``G`` disk-suppressed attention peaks in the
remaining foreground, decodes all ``G`` masks in one pyramid pass with the
glimpses folded into the batch, and carves them out in peak order (an
earlier peak wins overlaps).  The JAX ``lax.scan`` over rounds becomes a
Python loop; by default it stops once every sample is done, which costs
one host sync per round (``sync_rounds=False`` runs every round without
syncing — a round in which every sample is done changes nothing).  Tie
rules follow the JAX package: ``argmax`` takes the first index and
``round`` is half-to-even.

The training path (per-instance softmax, glimpse sampling, losses) comes
with the training slice.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from tpuseg_torch.configs import DecoderConfig
from tpuseg_torch.decoder.pyramid import AttenDecoder
from tpuseg_torch.nn.attention import HardAttention, SpatialAttention

_NEG_INF = -1e30


def stop_scalars(cfg: DecoderConfig, stop_params: Optional[Sequence] = None):
    """(min_remaining_frac, max_extract_misses, peak_suppress_factor,
    stop_remaining_frac) from the override or the config defaults; a
    shorter override keeps the defaults for the trailing values, and a
    non-positive stop fraction follows ``min_remaining_frac``."""
    defaults = (
        cfg.min_remaining_frac, cfg.max_extract_misses,
        cfg.peak_suppress_factor, cfg.stop_remaining_frac,
    )
    vals = defaults if stop_params is None else (
        tuple(stop_params) + defaults[len(stop_params):]
    )
    min_frac, max_misses, suppress, stop_frac = vals
    min_frac = float(min_frac)
    stop_frac = float(stop_frac)
    if not stop_frac > 0:
        stop_frac = min_frac
    return min_frac, int(max_misses), float(suppress), stop_frac


def disk(s, h: int, w: int, radius) -> torch.Tensor:
    """(N, h*w) float disk of ``radius`` (N,) around flat points s (N,)."""
    yy = torch.arange(h, device=s.device)[None, :, None]
    xx = torch.arange(w, device=s.device)[None, None, :]
    pr = (s // w)[:, None, None]
    pc = (s % w)[:, None, None]
    r2 = (radius * radius).to(torch.int32)[:, None, None]
    return (((yy - pr) ** 2 + (xx - pc) ** 2) <= r2).to(
        torch.float32
    ).reshape(s.shape[0], h * w)


class _GlimpseStep(nn.Module):
    """Holds the pyramid decoder under the flax scan's module name."""

    def __init__(self, cfg: DecoderConfig, n_filters: int):
        super().__init__()
        self.bone = AttenDecoder(cfg, n_filters)


class InstanceDecoder(nn.Module):
    def __init__(self, cfg: DecoderConfig, max_n_objects: int = 32,
                 n_filters: int = 32):
        super().__init__()
        self.cfg = cfg
        self.max_n_objects = max_n_objects
        d = cfg.d_model
        self.s_sp = SpatialAttention(d, d, cfg.sp_reduction)
        self.attend = HardAttention(d, cfg.d_k)
        self.glimpse = _GlimpseStep(cfg, n_filters)
        # REINFORCE EMA baseline (training state; carried for the weights)
        self.register_buffer("baseline", torch.zeros(()))

    @property
    def bone(self) -> AttenDecoder:
        return self.glimpse.bone

    def attend_score(self, encode, sem_mask) -> torch.Tensor:
        """Merged hard-attention score (B, 1, H, W), float32."""
        sem = sem_mask.to(encode.dtype)
        return self.attend(self.s_sp(encode, sem), sem)

    def prep(self, encode, sem_mask, feats):
        """Glimpse-independent half of extraction, once per batch: the
        attention score and the per-level conv1 partials of the
        transformed skips + semantic mask."""
        score = self.attend_score(encode, sem_mask)
        bone = self.bone
        skips_t = bone.transform_skips(feats)
        partials = bone.conv1_partials(skips_t, sem_mask.to(encode.dtype))
        return score, partials

    @torch.no_grad()
    def extract_rounds(
        self, sem_mask, score, partials, max_instances: Optional[int] = None,
        count_budget=None, n_rounds: Optional[int] = None,
        stop_params=None, sync_rounds: bool = True,
    ) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """Extraction rounds from prepped (score, partials).

        sem_mask / score: (B, 1, H, W).  Returns (idmap (B, H, W) int32
        with 0 = background, counts (B,) int32, rounds run).  With
        ``sync_rounds`` the loop ends after the first round that leaves
        every sample done (one host sync per round)."""
        cfg = self.cfg
        b, _, h, w = sem_mask.shape
        hw = h * w
        dev = sem_mask.device
        k_static = max_instances or self.max_n_objects
        G = max(int(cfg.extract_group), 1)
        if n_rounds is None:
            n_rounds = -(-k_static // G)
        min_frac, max_misses, suppress, stop_frac = stop_scalars(
            cfg, stop_params
        )
        f32 = torch.float32
        sem = sem_mask.to(f32).reshape(b, hw)
        fg_px = sem.sum(dim=1)
        min_pixels = torch.clamp(fg_px * min_frac, min=1.0)
        stop_pixels = torch.clamp(fg_px * stop_frac, min=1.0)
        if count_budget is None:
            max_count = torch.full((b,), k_static, dtype=torch.int32,
                                   device=dev)
        else:
            max_count = torch.clamp(count_budget.to(torch.int32),
                                    max=k_static)
        remaining = sem.clone()
        idmap = torch.zeros((b, hw), dtype=torch.int32, device=dev)
        count = torch.zeros((b,), dtype=torch.int32, device=dev)
        misses = torch.zeros((b,), dtype=torch.int32, device=dev)
        done = fg_px <= stop_pixels

        radius = torch.clamp(torch.sqrt(min_pixels), min=3.0)
        est_r = torch.sqrt(
            fg_px / torch.clamp(max_count.to(f32), min=1.0) / math.pi
        )
        if suppress > 0:
            sel_radius = torch.maximum(suppress * est_r, radius).clamp(
                max=min(h, w) / 6.0
            )
        else:
            sel_radius = radius
        flat_score = score.to(f32).reshape(b, hw)
        flat_iota = torch.arange(hw, device=dev)
        bone = self.bone

        rounds = 0
        for _ in range(n_rounds):
            if sync_rounds and bool(done.all()):
                break
            rounds += 1
            # -- G peaks, a disk suppressed around each before the next
            sup = remaining
            points, peak_ok = [], []
            for g in range(G):
                masked = torch.where(
                    sup > 0, flat_score, torch.full_like(flat_score, _NEG_INF)
                )
                s_g = masked.argmax(dim=1)
                points.append(s_g)
                peak_ok.append(sup.gather(1, s_g[:, None])[:, 0] > 0)
                if g + 1 < G:
                    sup = sup * (1.0 - disk(s_g, h, w, sel_radius))
            # -- decode all G glimpses in one pyramid pass (B*G batch)
            pts = torch.stack(points, dim=1).reshape(b * G)
            preds = bone.decode_split(
                pts, partials, G, window=int(cfg.extract_window),
                window_stride=int(cfg.extract_window_stride),
            )
            p = preds[-1]
            m_all = (p[:, 1] > p[:, 0]).to(f32).reshape(b, G, hw)
            # -- resolve the G masks in peak order (earlier peak wins)
            for g in range(G):
                s_g = points[g]
                avail = ~done & peak_ok[g] & (count < max_count)
                still = remaining.gather(1, s_g[:, None])[:, 0] > 0
                live = avail & still
                # the glimpse pixel always joins its mask: progress
                point_plane = (flat_iota[None] == s_g[:, None]).to(f32)
                m_g = torch.clamp(
                    m_all[:, g] * remaining + point_plane * remaining, 0.0, 1.0
                )
                valid_inst = m_g.sum(dim=1) >= min_pixels
                emit = live & valid_inst
                # a degenerate mask: carve a small disk and retry elsewhere
                miss = live & ~valid_inst
                inst_id = (count + 1).to(torch.int32)
                take = emit[:, None] & (m_g > 0) & (idmap == 0)
                idmap = torch.where(take, inst_id[:, None], idmap)
                count = count + emit.to(torch.int32)
                carve = torch.where(
                    emit[:, None], m_g,
                    torch.where(miss[:, None], disk(s_g, h, w, radius),
                                torch.zeros_like(m_g)),
                )
                remaining = remaining * (1.0 - carve)
                misses = torch.where(emit, torch.zeros_like(misses),
                                     misses + miss.to(torch.int32))
                rem_px = remaining.sum(dim=1)
                done = (
                    done | (rem_px <= stop_pixels) | (misses >= max_misses)
                    | (count >= max_count)
                )
        return idmap.reshape(b, h, w), count, rounds
