"""Transformer attention stack of the legacy decoder lineage (port of
``tpuseg/nn/transformer.py``).

Attention is written with matmuls and a softmax, as the JAX code is (a
mask sets a logit to -1e30; the dropouts draw from the caller's
generator in train mode).  Feature maps are NCHW; sequences are (B, L, D).

Kept from the JAX package: ``ScalePDAttention`` folds the heads into the
batch sample-major (``b * nh + h``) but tiles ``nomask`` head-major
(``h * B + b``), so with B >= 2 and nh >= 2 a head of one sample reads
another sample's mask.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpuseg_torch.nn.aspp import FLAX_NORM_EPS, instance_norm

_NEG = -1e30


def _dropout(x, rate: float, train: bool, generator):
    """flax ``Dropout`` (elementwise, kept values scaled by 1 / keep)."""
    if not (train and rate > 0):
        return x
    keep = 1.0 - rate
    kept = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return x * (kept.to(x.dtype) / keep)


def make_position_encoding(batch: int, length: int, n_units: int,
                           f: float = 10000.0, device=None) -> torch.Tensor:
    """Sinusoidal position encoding (B, n_units, L): sines then cosines."""
    if n_units % 2:
        raise ValueError("make_position_encoding needs an even n_units")
    half = n_units // 2
    position = torch.arange(length, dtype=torch.float32, device=device)
    unit = torch.arange(half, dtype=torch.float32, device=device)
    rad = position[None, :] / f ** (unit[:, None] / half)
    pe = torch.cat([torch.sin(rad), torch.cos(rad)], dim=0)
    return pe[None].expand(batch, -1, -1).contiguous()


class ScaledDotProductAttention(nn.Module):
    def __init__(self, temperature: float, attn_dropout: float = 0.1):
        super().__init__()
        self.temperature = temperature
        self.attn_dropout = attn_dropout

    def forward(self, q, k, v, mask=None, last: bool = False,
                train: bool = False, generator=None):
        """q (B, Lq, D), k (B, Lk, D), v (B, Lk, Dv); mask > 0 hides a key.
        ``last``: the raw q . k products alone."""
        attn = q @ k.transpose(1, 2)
        if last:
            return attn
        attn = attn / self.temperature
        if mask is not None:
            attn = torch.where(mask > 0, torch.full_like(attn, _NEG), attn)
        attn = torch.softmax(attn, dim=2)
        attn = _dropout(attn, self.attn_dropout, train, generator)
        return attn @ v, attn


class MultiHeadAttention(nn.Module):
    """Heads folded head-major into the batch.  ``project`` builds the
    output projection and LayerNorm; a module only ever called with
    ``last=True`` has neither (flax creates none), and returns
    ``(sigmoid(q . k) of the first query, None)``."""

    def __init__(self, n_head: int, d_model: int, d_k: int, d_v: int,
                 dropout: float = 0.1, project: bool = True):
        super().__init__()
        self.n_head, self.d_k, self.d_v = n_head, d_k, d_v
        self.dropout = dropout
        self.w_qs = nn.Linear(d_model, n_head * d_k)
        self.w_ks = nn.Linear(d_model, n_head * d_k)
        self.w_vs = nn.Linear(d_model, n_head * d_v)
        self.attention = ScaledDotProductAttention(d_k ** 0.5)
        if project:
            self.fc = nn.Linear(n_head * d_v, d_model)
            self.layer_norm = nn.LayerNorm(d_model, eps=FLAX_NORM_EPS)

    def forward(self, q, k, v, mask=None, last: bool = False,
                train: bool = False, generator=None):
        nh, d_k, d_v = self.n_head, self.d_k, self.d_v
        b, lq, _ = q.shape
        residual = q

        def heads(t, d):  # (B, L, nh*d) -> (nh*B, L, d)
            return t.reshape(b, -1, nh, d).permute(2, 0, 1, 3).reshape(
                nh * b, -1, d)

        qs = heads(self.w_qs(q), d_k)
        ks = heads(self.w_ks(k), d_k)
        vs = heads(self.w_vs(v), d_v)
        if mask is not None:
            mask = mask.repeat(nh, 1, 1)
        if last:
            corr = self.attention(qs, ks, vs, mask=mask, last=True)
            return torch.sigmoid(corr)[:, 0, :], None
        out, attn = self.attention(qs, ks, vs, mask=mask, train=train,
                                   generator=generator)
        out = out.reshape(nh, b, lq, d_v).permute(1, 2, 0, 3).reshape(
            b, lq, nh * d_v)
        out = _dropout(self.fc(out), self.dropout, train, generator)
        return self.layer_norm(out + residual), attn


class PositionwiseFeedForward(nn.Module):
    def __init__(self, d_in: int, d_hid: int, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.w_1 = nn.Linear(d_in, d_hid)
        self.w_2 = nn.Linear(d_hid, d_in)
        self.layer_norm = nn.LayerNorm(d_in, eps=FLAX_NORM_EPS)

    def forward(self, x, train: bool = False, generator=None):
        y = self.w_2(F.relu(self.w_1(x)))
        y = _dropout(y, self.dropout, train, generator)
        return self.layer_norm(y + x)


class TransformerDecoderLayer(nn.Module):
    """Self-attention, encoder attention (masked by ``1 - mask``) and the
    feed-forward; ``last``: one head and the encoder attention's sigmoid
    correlation instead."""

    def __init__(self, d_model: int, d_inner: int, n_head: int, d_k: int,
                 d_v: int, dropout: float = 0.1, last: bool = False):
        super().__init__()
        self.last = last
        nh = 1 if last else n_head
        self.slf_attn = MultiHeadAttention(nh, d_model, d_k, d_v, dropout)
        self.enc_attn = MultiHeadAttention(nh, d_model, d_k, d_v, dropout,
                                           project=not last)
        if not last:
            self.pos_ffn = PositionwiseFeedForward(d_model, d_inner, dropout)

    def forward(self, dec_input, enc_output, mask, train: bool = False,
                generator=None):
        slf_attn_mask = 1 - mask[:, None, :] if mask is not None else None
        out, dec_slf = self.slf_attn(dec_input, dec_input, dec_input,
                                     train=train, generator=generator)
        out2, dec_enc = self.enc_attn(out, enc_output, enc_output,
                                      mask=slf_attn_mask, last=self.last,
                                      train=train, generator=generator)
        if self.last:
            return out2, dec_slf, None
        return self.pos_ffn(out2, train, generator), dec_slf, dec_enc


def _gather9(x: torch.Tensor, d: int) -> torch.Tensor:
    """The dilated 3x3 neighbourhood: (N, C, H, W) -> (N, 9, C, H, W)."""
    h, w = x.shape[2], x.shape[3]
    xp = F.pad(x, (d, d, d, d))
    return torch.stack([
        xp[:, :, (i // 3) * d:(i // 3) * d + h, (i % 3) * d:(i % 3) * d + w]
        for i in range(9)], dim=1)


class ScalePDAttention(nn.Module):
    """Dilated 3x3-window local attention: per pixel, attend over its 9
    dilated neighbours (``nomask`` > 0 hides one), heads by channel
    splitting; the output projection plus residual is instance-normed."""

    def __init__(self, c: int, d_k: int, d_v: int, d_model: int,
                 dilation: int, n_head: int = 2, c_v: int = 0):
        super().__init__()
        self.n_head, self.d_v, self.dilation = n_head, d_v, dilation
        self.qk_w = nn.Conv2d(c // n_head, 2 * d_k, 1)
        self.v_w = nn.Conv2d((c_v or c) // n_head, d_v, 1)
        self.fc = nn.Conv2d(n_head * d_v, d_model, 1)

    def forward(self, qk, v, nomask=None):
        """qk (B, C, H, W), v (B, Cv, H, W), nomask (B, 1, H, W) or None."""
        b, c, h, w = qk.shape
        nh = self.n_head

        def split_heads(t):  # (B, C, H, W) -> (B*nh, C/nh, H, W)
            return t.reshape(b * nh, t.shape[1] // nh, h, w)

        qk_h = split_heads(qk)
        q, k = torch.chunk(self.qk_w(qk_h), 2, dim=1)
        vp = self.v_w(split_heads(v))
        k9 = _gather9(k, self.dilation)       # (B*nh, 9, dk, H, W)
        v9 = _gather9(vp, self.dilation)      # (B*nh, 9, dv, H, W)
        inner = (k9 * q[:, None]).sum(2) * (qk_h.shape[1] ** -0.5)
        if nomask is not None:
            nm9 = _gather9(nomask.repeat(nh, 1, 1, 1), self.dilation)[:, :, 0]
            inner = torch.where(nm9 > 0, torch.full_like(inner, _NEG), inner)
        p = torch.softmax(inner, dim=1)
        p = torch.where(torch.isnan(p), torch.zeros_like(p), p)
        att = (p[:, :, None] * v9).sum(1)     # (B*nh, dv, H, W)
        att = att.reshape(b, nh * self.d_v, h, w)
        return instance_norm(self.fc(att) + qk)


class NonLocalLayer(nn.Module):
    """Non-local block of a feature map and a vector: "Dot", "Embedded
    Gaussian" or "Concatenation" pairing, ``f * g + fmap``."""

    def __init__(self, fmap_ch: int, x_dim: int, in_ch: int, out_ch: int,
                 mode: str = "Concatenation"):
        super().__init__()
        self.mode = mode
        self.g_net = nn.Conv2d(fmap_ch, out_ch, 1)
        self.sita = nn.Linear(x_dim, in_ch)
        self.fi = nn.Conv2d(fmap_ch, in_ch, 1)
        if mode not in ("Dot", "Embedded Gaussian"):
            self.F = nn.Conv2d(2 * in_ch, 1, 1)

    def forward(self, fmap, x):
        g = self.g_net(fmap)
        i = self.sita(x)  # (B, C)
        js = self.fi(fmap)
        if self.mode in ("Dot", "Embedded Gaussian"):
            f = torch.einsum("bc,bchw->bhw", i, js)[:, None]
            if self.mode == "Embedded Gaussian":
                f = torch.exp(f)
        else:
            ii = i[:, :, None, None].expand_as(js)
            f = F.relu(self.F(torch.cat([ii, js], dim=1)))
        return f * g + fmap
