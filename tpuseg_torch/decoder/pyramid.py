"""Point-conditioned 5-level pyramid mask decoder (port of
``tpuseg/decoder/pyramid.py``).

Two ways through a level.  The extraction path (eval only): the
glimpse-independent half (skip transforms and the conv1 partials of the
skip + semantic-mask channels) runs once per batch; each extraction round
decodes only the per-glimpse channels at the folded ``B * group`` batch
(``call_split``).  The loss path (``forward`` / ``decode``, train and
eval): one glimpse per sample on the full canvas, with the pooled gold
masks per level as targets and, in training, channel dropout.

In eval mode the four ``dil*`` blocks of a level run as ONE ``ir_chain``
call (the Hopper kernel on the card), with ``x1u`` as the mid-chain skip on
every level but the first.  In train mode their BatchNorms use batch
statistics and cannot be folded, so the blocks run as modules.

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


def channel_dropout_mask(b: int, c: int, rate: float, generator,
                         device) -> Optional[torch.Tensor]:
    """(b, c, 1, 1) multiplier of a channel dropout (one draw per sample and
    channel, shared over the pixels): 0 or ``1 / (1 - rate)``.  None when
    nothing is dropped."""
    if not rate > 0:
        return None
    keep = 1.0 - rate
    kept = torch.rand((b, c, 1, 1), generator=generator, device=device) < keep
    return kept.to(torch.float32) / keep


class _UpAttenLevel(nn.Module):
    """One pyramid level (reference ``UpAttenLayer``)."""

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

    def train(self, mode: bool = True):
        self._folded = None  # the weights are about to move: fold anew
        return super().train(mode)

    def transform_skip(self, x_skip, drop=None):
        """Glimpse-independent skip transform (``cross1 -> cross2``) with
        the channel-dropout multiplier ``drop`` between the two."""
        y = self.cross1(x_skip)
        if drop is not None:
            y = y * drop.to(y.dtype)
        return self.cross2(y)

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
        y = ir_chain(nhwc(x), None if x1u is None else nhwc(x1u.to(x.dtype)),
                     *params)
        return y.permute(0, 3, 1, 2)

    def forward(self, x_prev, skip_t, point_flat, mask_pre, mask_all,
                drops=(None, None)):
        """The level on the full canvas, one glimpse per sample.  skip_t:
        this level's ``transform_skip`` output; mask_all: the semantic mask
        pooled to the level; ``drops``: the two channel-dropout multipliers
        (after conv1 and before ``dil2a``), None in eval mode."""
        h, w = skip_t.shape[2:]
        full = (h * self.factor, w * self.factor)
        if self.is_first:
            x, x1u = skip_t, None
        else:
            x1u = self.up(x_prev)
            gate = 1.0 if mask_pre is None else _prev_mask_gate(mask_pre, (h, w))
            x = torch.cat([skip_t, (x1u * gate).to(skip_t.dtype)], dim=1)
        pos = point_position_planes(point_flat, full, (h, w))
        x = torch.cat([x, mask_all.to(x.dtype), pos.to(x.dtype)], dim=1)
        x = self.conv1(x)
        if not self.training:
            return self._chain(x.contiguous(memory_format=_CL), x1u)
        if drops[0] is not None:
            x = x * drops[0].to(x.dtype)
        x = self.dil1b(self.dil1a(x))
        if x1u is not None:
            x = x + x1u
        if drops[1] is not None:
            x = x * drops[1].to(x.dtype)
        return self.dil2b(self.dil2a(x))

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
    """5-level decoder (reference ``AttenDecoder``).

    ``forward(point_flat, feats, sem_mask, gold)`` transforms the skips and
    decodes one glimpse per sample; ``transform_skips`` / ``decode`` are
    the two halves, so a loop over glimpses transforms once.  Both return
    ``(targets, preds)``: the 5 per-level gold masks (or Nones) and the 5
    per-level 2-class logits, coarse to fine."""

    def __init__(self, cfg: DecoderConfig, n_filters: int = 32):
        super().__init__()
        self.drop_rate = float(cfg.drop_rate)
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

    def draw_dropout(self, b: int, generator, device, part: str):
        """The channel-dropout multipliers of one train-mode pass, drawn
        from ``generator``: ``part="skips"`` -> one per level for
        ``transform_skips``; ``part="decode"`` -> a pair per level for
        ``decode``.  None in eval mode or at ``drop_rate`` 0."""
        if not (self.training and self.drop_rate > 0):
            return None
        draw = lambda c: channel_dropout_mask(  # noqa: E731
            b, c, self.drop_rate, generator, device)
        if part == "skips":
            return [draw(lvl.out_ch) for lvl in self.levels]
        return [(draw(lvl.out_ch), draw(lvl.out_ch)) for lvl in self.levels]

    def transform_skips(self, feats, drops=None) -> List[torch.Tensor]:
        """feats: UNet skips x1..x5 (fine->coarse) -> transformed skips
        coarse->fine, one per level."""
        drops = drops or [None] * 5
        return [lvl.transform_skip(s, d)
                for lvl, s, d in zip(self.levels, reversed(feats), drops)]

    def decode(self, point_flat, skips_t, sem_mask, gold=None, drops=None):
        """One full-canvas pyramid pass from transformed skips.  sem_mask
        and gold are (B, 1, H, W); each level sees them max-pooled to its
        resolution."""
        H = sem_mask.shape[2]
        drops = drops or [(None, None)] * 5
        preds: List[torch.Tensor] = []
        targets: List[Optional[torch.Tensor]] = []
        x = prev_pred = None
        for lvl, head, skip_t, d in zip(self.levels, self.heads, skips_t,
                                        drops):
            f = H // skip_t.shape[2]
            targets.append(None if gold is None else _maxpool(gold, f))
            x = lvl(x, skip_t, point_flat, prev_pred, _maxpool(sem_mask, f), d)
            prev_pred = head(x)
            preds.append(prev_pred)
        return targets, preds

    def forward(self, point_flat, feats, sem_mask, gold=None, skips_t=None,
                drops=None, skip_drops=None):
        if skips_t is None:
            skips_t = self.transform_skips(feats, skip_drops)
        return self.decode(point_flat, list(skips_t), sem_mask, gold, drops)

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
