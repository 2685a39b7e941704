"""Point-conditioned 5-level pyramid mask decoder, extraction path (port of
``tpuseg/decoder/pyramid.py``).

Eval-only: the glimpse-independent half (skip transforms and the conv1
partials of the skip + semantic-mask channels) runs once per batch; each
extraction round decodes only the per-glimpse channels at the folded
``B * group`` batch.  In every level the four ``dil*`` blocks run as ONE
``ir_chain`` call (the Hopper kernel on the card), with ``x1u`` as the
mid-chain skip on every level but the first.

Tensors are NCHW; the chain's activations are ``channels_last`` so the
kernel gets a contiguous NHWC view without a copy.  Window crops and
pastes gather/scatter by the selected origin (exact, like the JAX
package's one-hot selects).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpuseg_torch.configs import DecoderConfig
from tpuseg_torch.kernels.ir_chain import ir_chain, stack_chain_params
from tpuseg_torch.nn.blocks import Conv1x1BN, InvertedResidual
from tpuseg_torch.nn.heads import L0Head

_FACTORS = (16, 8, 4, 2, 1)
_CL = torch.channels_last


def level_channels(n_filters: int = 32) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(skip channels coarse->fine, level output channels)."""
    f = n_filters
    return (16 * f, 8 * f, 4 * f, 2 * f, f), (8 * f, 4 * f, 2 * f, f, f)


def n_position_extra(factor: int, use_mask: bool, position_type: int) -> int:
    return (2 * int(math.log2(factor)) if position_type else 0) + (
        2 if use_mask else 0
    )


def point_level_code(point_flat, full_hw, level_hw):
    """(row_l, col_l, code): level-resolution point coordinates and the
    (N, 2n+1) channel code of the position planes (row bits then col bits
    of the sub-pixel offset, MSB first, then a constant 1)."""
    H, W = full_hw
    h, _ = level_hw
    f = H // h
    n_bits = int(math.log2(f)) if f > 1 else 0
    row = point_flat // W
    col = point_flat % W
    row_l, col_l = row // f, col // f
    row_r, col_r = row % f, col % f
    vals = [((row_r >> (n_bits - 1 - t)) & 1) for t in range(n_bits)]
    vals += [((col_r >> (n_bits - 1 - t)) & 1) for t in range(n_bits)]
    vals.append(torch.ones_like(row))
    code = torch.stack(vals, dim=-1).to(torch.float32)
    return row_l, col_l, code


def _planes(row, col, code, h, w):
    yy = torch.arange(h, device=row.device)
    xx = torch.arange(w, device=row.device)
    onehot = (
        (yy[None, :, None] == row[:, None, None])
        & (xx[None, None, :] == col[:, None, None])
    ).to(torch.float32)  # (N, h, w)
    return onehot[:, None] * code[:, :, None, None]


def point_position_planes(point_flat, full_hw, level_hw) -> torch.Tensor:
    """(N, 2n+1, h, w) glimpse-position planes: the code written at the
    level-resolution point pixel."""
    row_l, col_l, code = point_level_code(point_flat, full_hw, level_hw)
    return _planes(row_l, col_l, code, *level_hw)


def point_position_planes_win(point_flat, full_hw, level_hw, origin_rl,
                              origin_cl, win_l: int) -> torch.Tensor:
    """Windowed ``point_position_planes``: the pixel at window-local
    coordinates (level coordinates minus the window origin)."""
    row_l, col_l, code = point_level_code(point_flat, full_hw, level_hw)
    return _planes(row_l - origin_rl, col_l - origin_cl, code, win_l, win_l)


def window_origin(point_flat, full_hw, win: int, stride: int = 0):
    """Decode-window origin per glimpse on a ``stride`` grid: the grid
    origin nearest the centred window.  Returns (ir, ic, onehot, n_r,
    n_c) with onehot (N, n_r*n_c)."""
    H, W = full_hw
    s = stride or (win // 2)
    n_r = max((H - win) // s + 1, 1)
    n_c = max((W - win) // s + 1, 1)
    row = point_flat // W
    col = point_flat % W
    ir = torch.clamp((row - win // 2 + s // 2) // s, 0, n_r - 1)
    ic = torch.clamp((col - win // 2 + s // 2) // s, 0, n_c - 1)
    onehot = F.one_hot(ir * n_c + ic, n_r * n_c).to(torch.float32)
    return ir, ic, onehot, n_r, n_c


def _crop(x, idx, onehot, n_c, wl, sl):
    """x[idx[i], :, r_i*sl : r_i*sl+wl, c_i*sl : c_i*sl+wl] for each row i
    of ``onehot`` (origin k = r*n_c + c)."""
    k = onehot.argmax(dim=1)
    rows = (k // n_c)[:, None] * sl + torch.arange(wl, device=x.device)
    cols = (k % n_c)[:, None] * sl + torch.arange(wl, device=x.device)
    out = x[idx[:, None, None], :, rows[:, :, None], cols[:, None, :]]
    return out.permute(0, 3, 1, 2)  # (N, wl, wl, C) -> (N, C, wl, wl)


def select_window(x, onehot, n_r: int, n_c: int, wl: int, sl: int):
    """Per-sample window crop.  x (N, C, h, w), onehot (N, n_r*n_c) ->
    (N, C, wl, wl)."""
    idx = torch.arange(x.shape[0], device=x.device)
    return _crop(x, idx, onehot, n_c, wl, sl).contiguous(memory_format=_CL)


def select_window_grouped(x, onehot, group: int, n_r: int, n_c: int,
                          wl: int, sl: int):
    """Crop of a batch-B tensor with per-(B, group) origins.
    x (B, C, h, w), onehot (B*group, K) -> (B, group, C, wl, wl)."""
    b = x.shape[0]
    idx = torch.arange(b, device=x.device).repeat_interleave(group)
    out = _crop(x, idx, onehot, n_c, wl, sl)
    return out.reshape(b, group, *out.shape[1:])


def paste_window(win_vals, onehot, n_r: int, n_c: int, full_hw, sl: int,
                 fill) -> torch.Tensor:
    """Paste per-sample windows onto the full canvas; pixels outside the
    window get ``fill`` (one value per channel).  win_vals (N, C, wl, wl)
    -> (N, C, H, W)."""
    n, c, wl, _ = win_vals.shape
    H, W = full_hw
    fill = torch.as_tensor(fill, dtype=win_vals.dtype, device=win_vals.device)
    out = fill[None, :, None, None].expand(n, c, H, W).clone()
    k = onehot.argmax(dim=1)
    rows = (k // n_c)[:, None] * sl + torch.arange(wl, device=out.device)
    cols = (k % n_c)[:, None] * sl + torch.arange(wl, device=out.device)
    idx = torch.arange(n, device=out.device)
    out[idx[:, None, None], :, rows[:, :, None], cols[:, None, :]] = (
        win_vals.permute(0, 2, 3, 1)
    )
    return out


def _maxpool(x, f: int):
    return x if f == 1 else F.max_pool2d(x, f, f)


def _prev_mask_gate(pred_logits_prev, hw) -> torch.Tensor:
    """Bilinear-resize the previous level's 2-class logits to this level
    (always a 2x upsample here) and take the foreground softmax."""
    m = F.interpolate(pred_logits_prev, size=tuple(hw), mode="bilinear",
                      align_corners=False)
    return torch.softmax(m, dim=1)[:, 1:2]


class _UpAttenLevel(nn.Module):
    """One pyramid level (reference ``UpAttenLayer``), eval-only."""

    def __init__(self, skip_ch: int, out_ch: int, prev_ch: int, factor: int,
                 is_first: bool, use_mask: bool = True,
                 position_type: int = 1):
        super().__init__()
        self.out_ch = out_ch
        self.factor = factor
        self.is_first = is_first
        n_extra = n_position_extra(factor, use_mask, position_type)
        self.S = out_ch - n_extra        # skip channels in the conv1 concat
        self.U = 0 if is_first else out_ch  # x1u channels in the concat
        if not is_first:
            self.up = nn.ConvTranspose2d(prev_ch, out_ch, 2, stride=2)
        self.cross1 = InvertedResidual(skip_ch, out_ch)
        self.cross2 = InvertedResidual(out_ch, self.S)
        self.conv1 = Conv1x1BN(out_ch + self.U, out_ch)
        self.dil1a = InvertedResidual(out_ch, out_ch)
        self.dil1b = InvertedResidual(out_ch, out_ch)
        self.dil2a = InvertedResidual(out_ch, out_ch)
        self.dil2b = InvertedResidual(out_ch, out_ch)
        self._folded = None

    def fold(self, dtype):
        """Fold the eval BNs once: conv1 as (kernel (out, in), scale,
        shift) in float32 and the dil chain as the kernel's stacked
        inputs (pointwise weights in ``dtype``).  Call again after
        loading new weights."""
        with torch.no_grad():
            bn = self.conv1._BN_0
            scale, shift = bn.folded()
            k = self.conv1.Conv_0.weight.float()[:, :, 0, 0]
            chain = stack_chain_params(
                [self.dil1a, self.dil1b, self.dil2a, self.dil2b], dtype=dtype
            )
        self._folded = {"dtype": dtype, "conv1": (k, scale, shift),
                        "chain": chain}

    def _params(self, dtype):
        f = self._folded
        if (f is None or f["dtype"] != dtype
                or f["conv1"][0].device != self.conv1.Conv_0.weight.device):
            self.fold(dtype)
        return self._folded

    def transform_skip(self, x_skip):
        """Glimpse-independent skip transform (``cross1 -> cross2``)."""
        return self.cross2(self.cross1(x_skip))

    def conv1_const(self, skip_t, mask_all) -> torch.Tensor:
        """Glimpse-independent conv1 partial (B, out_ch, h, w) with the BN
        scale and shift folded in; products of dtype-rounded operands,
        accumulated and scaled in float32 (the JAX f32 island), then cast
        back to the activations' dtype."""
        dt = skip_t.dtype
        k, scale, shift = self._params(dt)["conv1"]
        S, U = self.S, self.U
        kc = torch.cat([k[:, :S], k[:, S + U:S + U + 1]], dim=1)
        xc = torch.cat([skip_t, mask_all.to(dt)], dim=1)
        part = F.conv2d(xc.float(), kc.to(dt).float()[:, :, None, None])
        part = part * scale[:, None, None] + shift[:, None, None]
        return part.to(dt).contiguous(memory_format=_CL)

    def _conv1_variable(self, x_in, dt):
        """The per-glimpse half of conv1: the x1u and position channels
        with the BN scale folded into the kernel rows."""
        k, scale, _ = self._params(dt)["conv1"]
        S, U = self.S, self.U
        if self.is_first:
            kv = k[:, S + U + 1:]
        else:
            kv = torch.cat([k[:, S:S + U], k[:, S + U + 1:]], dim=1)
        kv = (kv * scale[:, None]).to(dt)[:, :, None, None]
        return F.conv2d(x_in, kv)

    def _chain(self, x, x1u):
        params = self._params(x.dtype)["chain"]
        nhwc = lambda t: t.permute(0, 2, 3, 1).contiguous()  # noqa: E731
        y = ir_chain(nhwc(x), None if x1u is None else nhwc(x1u), *params)
        return y.permute(0, 3, 1, 2)

    def call_split(self, x_prev, part, point_flat, mask_pre, group: int):
        """Per-round half of the level from its ``conv1_const`` partial.
        x_prev / mask_pre at the folded B*group batch, part at B."""
        b, _, h, w = part.shape
        dt = part.dtype
        bg = point_flat.shape[0]
        pos = point_position_planes(
            point_flat, (h * self.factor, w * self.factor), (h, w)
        ).to(dt)
        x1u = None
        if self.is_first:
            x_in = pos
        else:
            x1u = self.up(x_prev).contiguous(memory_format=_CL)
            gate = 1.0 if mask_pre is None else _prev_mask_gate(mask_pre, (h, w))
            x_in = torch.cat([(x1u * gate).to(dt), pos], dim=1)
        yv = self._conv1_variable(x_in, dt)
        x = F.relu(yv.reshape(b, group, self.out_ch, h, w) + part[:, None])
        x = x.reshape(bg, self.out_ch, h, w).contiguous(memory_format=_CL)
        return self._chain(x, x1u)

    def call_split_win(self, x_prev, part_win, point_flat, mask_pre,
                       group: int, origin_idx, full_hw, level_stride=0):
        """Windowed ``call_split``: the level decodes only each glimpse's
        window.  part_win (B, group, out_ch, wl, wl) is the partial cropped
        per glimpse; x_prev / mask_pre are window-aligned at the previous
        level; origin_idx = (ir, ic) grid indices from ``window_origin``."""
        b, g, _, wl, _ = part_win.shape
        dt = part_win.dtype
        bg = point_flat.shape[0]
        ir, ic = origin_idx
        sl = level_stride or (wl // 2)
        pos = point_position_planes_win(
            point_flat, full_hw,
            (full_hw[0] // self.factor, full_hw[1] // self.factor),
            ir * sl, ic * sl, wl,
        ).to(dt)
        x1u = self.up(x_prev).contiguous(memory_format=_CL)
        gate = 1.0 if mask_pre is None else _prev_mask_gate(mask_pre, (wl, wl))
        x_in = torch.cat([(x1u * gate).to(dt), pos], dim=1)
        yv = self._conv1_variable(x_in, dt)
        x = F.relu(yv.reshape(b, g, self.out_ch, wl, wl) + part_win)
        x = x.reshape(bg, self.out_ch, wl, wl).contiguous(memory_format=_CL)
        return self._chain(x, x1u)


class AttenDecoder(nn.Module):
    """5-level decoder (reference ``AttenDecoder``), extraction path."""

    def __init__(self, cfg: DecoderConfig, n_filters: int = 32):
        super().__init__()
        skips, outs = level_channels(n_filters)
        for i, (f, sc, oc) in enumerate(zip(_FACTORS, skips, outs)):
            self.add_module(f"up_atten{i}", _UpAttenLevel(
                sc, oc, outs[i - 1] if i else 0, f, is_first=(i == 0),
                use_mask=cfg.use_mask, position_type=cfg.position_type,
            ))
        for i, oc in enumerate(outs):
            self.add_module(f"pred{i}", L0Head(oc))

    @property
    def levels(self) -> List[_UpAttenLevel]:
        return [getattr(self, f"up_atten{i}") for i in range(5)]

    @property
    def heads(self) -> List[L0Head]:
        return [getattr(self, f"pred{i}") for i in range(5)]

    def transform_skips(self, feats) -> List[torch.Tensor]:
        """feats: UNet skips x1..x5 (fine->coarse) -> transformed skips
        coarse->fine, one per level."""
        return [lvl.transform_skip(s)
                for lvl, s in zip(self.levels, reversed(feats))]

    def conv1_partials(self, skips_t, sem_mask) -> List[torch.Tensor]:
        """Per-level glimpse-independent conv1 partials at batch B."""
        H = sem_mask.shape[2]
        return [
            lvl.conv1_const(st, _maxpool(sem_mask, H // st.shape[2]))
            for lvl, st in zip(self.levels, skips_t)
        ]

    def decode_split(self, point_flat, partials, group: int, window: int = 0,
                     window_stride: int = 0) -> List[torch.Tensor]:
        """Per-round pyramid decode from ``conv1_partials``: point_flat at
        the folded B*group batch, partials at B.  Returns the 5 per-level
        2-class logits (N, 2, h, w).

        ``window > 0`` decodes the two finest levels (factor <= 2) only in
        a per-glimpse ``window``-square crop.  Only ``preds[-1]`` is then
        full-resolution: it is pasted back onto the canvas with background
        logits (1, -1) outside the window.  The windowed level's
        intermediate ``preds[-2]`` stays window-sized — extraction consumes
        only the last."""
        H = partials[-1].shape[2] * _FACTORS[-1]
        W = partials[-1].shape[3] * _FACTORS[-1]
        use_win = bool(window) and H == W
        if use_win:
            stride = window_stride or (window // 2)
            if H != 256:
                # the window is calibrated at the 256 canvas
                window = window * H // 256
                stride = max(stride * H // 256, 4)
            use_win = (
                window % 4 == 0 and stride % 4 == 0 and 0 < window < H
                and (H - window) % stride == 0 and (W - window) % stride == 0
            )
        if use_win:
            ir, ic, onehot, n_r, n_c = window_origin(
                point_flat, (H, W), window, stride
            )
        preds: List[torch.Tensor] = []
        x = prev_pred = None
        levels = self.levels
        for i, (lvl, head, part) in enumerate(
            zip(levels, self.heads, partials)
        ):
            f = lvl.factor
            if not (use_win and f <= 2):
                x = lvl.call_split(x, part, point_flat, prev_pred, group)
            else:
                wl, sl = window // f, stride // f
                if levels[i - 1].factor > 2:
                    # first windowed level: crop the previous level's
                    # full-canvas output and logits to the aligned window
                    pf = levels[i - 1].factor
                    wp, sp = window // pf, stride // pf
                    x = select_window(x, onehot, n_r, n_c, wp, sp)
                    prev_pred = select_window(prev_pred, onehot, n_r, n_c,
                                              wp, sp)
                part_win = select_window_grouped(part, onehot, group, n_r,
                                                 n_c, wl, sl)
                x = lvl.call_split_win(x, part_win, point_flat, prev_pred,
                                       group, (ir, ic), (H, W), sl)
            pred_l = head(x)
            preds.append(pred_l)
            prev_pred = pred_l
        if use_win:
            preds[-1] = paste_window(preds[-1], onehot, n_r, n_c, (H, W),
                                     stride, fill=[1.0, -1.0])
        return preds
