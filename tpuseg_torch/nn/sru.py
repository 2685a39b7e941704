"""SRU (Simple Recurrent Unit), port of ``tpuseg/nn/sru.py``.

Lei et al., "Simple Recurrent Units for Highly Parallelizable Recurrence".
The fused 3/4-way GEMM ``U = x @ W`` is ``torch.matmul``; the elementwise
recurrence over time is

* ``sru_recurrence`` — a plain PyTorch loop over time, differentiated by
  autograd: the counterpart of the JAX ``lax.scan`` and the plain version
  of the ``sru_scan`` kernels;
* ``tpuseg_torch.kernels.sru_scan`` — the Hopper kernels, forward and
  backward.

``SRUCell`` and ``SRU`` take the kernels for CUDA tensors and the plain
loop for CPU tensors: the device decides, there is no switch.

Recurrence, per direction (direction 1 scans time reversed):
  f_t = sigmoid(u1_t + fb + c_{t-1} * fw)
  r_t = sigmoid(u2_t + rb + c_{t-1} * rw)
  c_t = u0_t + (c_{t-1} - u0_t) * f_t
  h_t = x'_t + (g(c_t) * mask_c - x'_t) * r_t        (with skip term)
      = g(c_t) * mask_c * r_t                         (without)
where x' = u3 (k=4) or x * scale_x (k=3), g = id/tanh/relu.  A padded step
(``mask_pad`` 1) keeps ``c`` and emits 0.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from tpuseg_torch.kernels.sru_scan import sru_scan

_ACTS = {0: lambda c: c, 1: torch.tanh, 2: torch.relu}


def _sru_dir(u, x_prime, fw, rw, fb, rb, c0, activation, mask_pad, mask_c,
             reverse):
    """One direction: u (L, B, d, k), x_prime (L, B, d) or None, vectors
    (d,), c0 (B, d), mask_pad (L, B, 1) or None, mask_c (B, d) or 1.
    Returns (h (L, B, d), c_final (B, d), c_all (L, B, d))."""
    act = _ACTS[activation]
    length = u.shape[0]
    hs, cs = [None] * length, [None] * length
    c = c0
    for s in range(length):
        t = length - 1 - s if reverse else s
        u_t = u[t]
        f_t = torch.sigmoid(u_t[..., 1] + fb + c * fw)
        r_t = torch.sigmoid(u_t[..., 2] + rb + c * rw)
        c_t = u_t[..., 0] + (c - u_t[..., 0]) * f_t
        if mask_pad is not None:
            c_t = c_t * (1 - mask_pad[t]) + c * mask_pad[t]
        g = act(c_t)
        if x_prime is not None:
            h_t = x_prime[t] + (g * mask_c - x_prime[t]) * r_t
        else:
            h_t = g * mask_c * r_t
        if mask_pad is not None:
            h_t = h_t * (1 - mask_pad[t])
        hs[t], cs[t], c = h_t, c_t, c_t
    return torch.stack(hs), c, torch.stack(cs)


def sru_states(
    u: torch.Tensor,         # (L, B, bidir*d*k)
    x: torch.Tensor,         # (L, B, n_in)
    weight_c: torch.Tensor,  # (2*bidir*d,)
    bias: torch.Tensor,      # (2*bidir*d,)
    c0: Optional[torch.Tensor] = None,   # (B, bidir*d)
    d: int = 0,
    activation: int = 0,
    bidirectional: bool = False,
    has_skip_term: bool = True,
    scale_x: float = 1.0,
    mask_pad: Optional[torch.Tensor] = None,  # (L, B)
    mask_c: Optional[torch.Tensor] = None,    # (B, bidir*d)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``sru_recurrence`` that also returns every step's cell state:
    (h (L, B, bidir*d), c_final (B, bidir*d), c_all (L, B, bidir*d)), with
    ``c_all[t]`` the state after step ``t`` in either direction."""
    length, batch = x.shape[0], x.shape[1]
    bidir = 2 if bidirectional else 1
    k = u.shape[-1] // d // bidir
    u = u.reshape(length, batch, bidir, d, k)
    wc = weight_c.reshape(2, bidir, d)
    b = bias.reshape(2, bidir, d)
    if c0 is None:
        c0 = u.new_zeros((batch, bidir * d))
    c0 = c0.reshape(batch, bidir, d)
    mp = None if mask_pad is None else mask_pad.reshape(
        length, batch, 1).to(u.dtype)

    if not has_skip_term:
        x_prime_all = None
    elif k == 3:
        xp = x.reshape(length, batch, bidir, d)
        x_prime_all = xp * scale_x if scale_x != 1 else xp
    else:
        x_prime_all = u[..., 3]

    hs, cs, call = [], [], []
    for di in range(bidir):
        mc = 1.0 if mask_c is None else mask_c.reshape(batch, bidir, d)[:, di]
        xp_d = None if x_prime_all is None else x_prime_all[:, :, di]
        h, c, c_all = _sru_dir(
            u[:, :, di], xp_d, wc[0, di], wc[1, di], b[0, di], b[1, di],
            c0[:, di], activation, mp, mc, reverse=(di == 1),
        )
        hs.append(h)
        cs.append(c)
        call.append(c_all)
    h = torch.stack(hs, dim=2).reshape(length, batch, bidir * d)
    c_final = torch.stack(cs, dim=1).reshape(batch, bidir * d)
    c_all = torch.stack(call, dim=2).reshape(length, batch, bidir * d)
    return h, c_final, c_all


def sru_recurrence(u, x, weight_c, bias, c0=None, d: int = 0,
                   activation: int = 0, bidirectional: bool = False,
                   has_skip_term: bool = True, scale_x: float = 1.0,
                   mask_pad=None, mask_c=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (h (L, B, bidir*d), c_final (B, bidir*d)); the arguments as
    in ``tpuseg.nn.sru.sru_recurrence``."""
    h, c_final, _ = sru_states(
        u, x, weight_c, bias, c0, d=d, activation=activation,
        bidirectional=bidirectional, has_skip_term=has_skip_term,
        scale_x=scale_x, mask_pad=mask_pad, mask_c=mask_c)
    return h, c_final


def _uniform(shape, bound, generator):
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


def _dropout_mask(shape, rate, like, generator):
    keep = 1 - rate
    probs = torch.full(shape, keep, dtype=like.dtype, device=like.device)
    return torch.bernoulli(probs, generator=generator) / keep


class SRUCell(nn.Module):
    """One SRU layer (counterpart of ``tpuseg.nn.sru.SRUCell``) with its
    init recipe: uniform(+-sqrt(3/rows)) weights, sqrt(0.5) rescale of the
    gate columns and of weight_c, the highway-bias offset, and the
    ``scale_x = sqrt(1+2e^b)`` highway rescale.  Parameters ``weight``
    (rows, bidir*n_out*k, used as ``x @ weight``), ``weight_c``, ``bias``
    and, with a projection, ``weight_proj`` (n_in, n_proj).

    ``generator`` draws the init (and nothing else); the dropout masks of a
    training-mode forward come from the generator passed to ``forward``."""

    def __init__(self, n_in: int, n_out: int, dropout: float = 0.0,
                 rnn_dropout: float = 0.0, bidirectional: bool = False,
                 n_proj: int = 0, activation: int = 0,
                 highway_bias: float = 0.0, has_skip_term: bool = True,
                 rescale: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if activation not in _ACTS:
            raise ValueError(f"SRUCell: unknown activation {activation}")
        self.n_in, self.n_out = n_in, n_out
        self.dropout, self.rnn_dropout = dropout, rnn_dropout
        self.bidirectional = bidirectional
        self.activation = activation
        self.highway_bias = highway_bias
        self.has_skip_term, self.rescale = has_skip_term, rescale
        bidir = 2 if bidirectional else 1
        self.n_proj = n_proj if 0 < n_proj < min(n_in, n_out) else 0
        w_rows = self.n_proj or n_in
        self.weight = nn.Parameter(
            torch.empty(w_rows, n_out * self._k() * bidir))
        self.weight_c = nn.Parameter(torch.empty(n_out * 2 * bidir))
        self.bias = nn.Parameter(torch.empty(n_out * 2 * bidir))
        if self.n_proj:
            self.weight_proj = nn.Parameter(torch.empty(n_in, self.n_proj))
        self.reset_parameters(generator)

    def _k(self) -> int:
        out_size = self.n_out * 2 if self.bidirectional else self.n_out
        return 4 if self.has_skip_term and self.n_in != out_size else 3

    @property
    def scale_x(self) -> float:
        if not self.rescale:
            return 1.0
        return (1 + math.exp(self.highway_bias) * 2) ** 0.5

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        k = self._k()
        rows = self.weight.shape[0]
        w = _uniform(self.weight.shape, (3.0 / rows) ** 0.5, generator)
        scale = torch.ones(k)
        scale[1] = scale[2] = 0.5 ** 0.5
        if self.rescale and k == 4:
            scale[3] = self.scale_x
        if self.rescale and self.dropout > 0:
            scale[0] *= (1 - self.dropout) ** 0.5
        w = w.reshape(rows, -1, self.n_out, k) * scale
        if self.rescale and self.rnn_dropout > 0:
            w = w * (1 - self.rnn_dropout) ** 0.5
        self.weight.copy_(w.reshape(self.weight.shape))
        self.weight_c.copy_(
            _uniform(self.weight_c.shape, 3.0 ** 0.5, generator) * 0.5 ** 0.5)
        self.bias.zero_()
        self.bias[self.bias.shape[0] // 2:] = self.highway_bias
        if self.n_proj:
            self.weight_proj.copy_(_uniform(
                self.weight_proj.shape, (3.0 / self.n_in) ** 0.5, generator))

    def forward(self, x: torch.Tensor, c0: Optional[torch.Tensor] = None,
                mask_pad: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (L, B, n_in) -> (h (L, B, bidir*n_out), c_final (B,
        bidir*n_out)).  In training mode ``rnn_dropout`` drops input
        features and ``dropout`` output features, one mask per sequence,
        drawn from ``generator``."""
        length, batch = x.shape[0], x.shape[1]
        bidir = 2 if self.bidirectional else 1
        xin = x
        if self.training and self.rnn_dropout > 0:
            xin = x * _dropout_mask((batch, self.n_in), self.rnn_dropout, x,
                                    generator)[None]
        x2d = xin.reshape(-1, self.n_in)
        if self.n_proj:
            u = (x2d @ self.weight_proj) @ self.weight
        else:
            u = x2d @ self.weight
        u = u.reshape(length, batch, -1)
        mask_c = None
        if self.training and self.dropout > 0:
            mask_c = _dropout_mask((batch, self.n_out * bidir), self.dropout,
                                   x, generator)
        return sru_scan(
            u, x, self.weight_c, self.bias, c0, d=self.n_out,
            activation=self.activation, bidirectional=self.bidirectional,
            has_skip_term=self.has_skip_term, scale_x=self.scale_x,
            mask_pad=mask_pad, mask_c=mask_c)


class SRU(nn.Module):
    """Multi-layer SRU stack (counterpart of ``tpuseg.nn.sru.SRU``):
    layers ``cell{i}``, each followed by ``ln{i}`` (LayerNorm, eps 1e-6 as
    flax's) when ``use_layer_norm``.  ``forward`` returns the last layer's
    ``h`` and every layer's final ``c``, stacked."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 2,
                 dropout: float = 0.0, rnn_dropout: float = 0.0,
                 bidirectional: bool = False, n_proj: int = 0,
                 activation: int = 0, highway_bias: float = 0.0,
                 use_layer_norm: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers = num_layers
        self.use_layer_norm = use_layer_norm
        bidir = 2 if bidirectional else 1
        for i in range(num_layers):
            self.add_module(f"cell{i}", SRUCell(
                n_in=input_size if i == 0 else hidden_size * bidir,
                n_out=hidden_size, dropout=dropout, rnn_dropout=rnn_dropout,
                bidirectional=bidirectional, n_proj=n_proj,
                activation=activation, highway_bias=highway_bias,
                generator=generator))
            if use_layer_norm:
                self.add_module(f"ln{i}",
                                nn.LayerNorm(hidden_size * bidir, eps=1e-6))

    def forward(self, x: torch.Tensor, c0: Optional[torch.Tensor] = None,
                mask_pad: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (L, B, input_size), c0 (num_layers, B, bidir*hidden) or None
        -> (h (L, B, bidir*hidden), c (num_layers, B, bidir*hidden))."""
        cs = []
        h = x
        for i in range(self.num_layers):
            h, c = getattr(self, f"cell{i}")(
                h, None if c0 is None else c0[i], mask_pad, generator)
            if self.use_layer_norm:
                h = getattr(self, f"ln{i}")(h)
            cs.append(c)
        return h, torch.stack(cs)
