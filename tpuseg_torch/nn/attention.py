"""Attention layers and masked batch-norm, eval mode (port of
``tpuseg/nn/attention.py``), NCHW.

``HardAttention`` returns the merged score map only — the extraction path
consumes nothing else.  The per-instance masked softmax comes with the
training slice and its ``masked_softmax`` kernel; asking for it raises.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

_NEG_INF = -1e30


def avg_pool_3x3_same(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 average pooling, zero padding, divisor fixed at 9."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


class SqueezeExcite(nn.Module):
    def __init__(self, c: int, reduction: int = 2):
        super().__init__()
        self.Dense_0 = nn.Linear(c, c // reduction)
        self.Dense_1 = nn.Linear(c // reduction, c)

    def forward(self, x):
        y = x.mean(dim=(2, 3))
        y = torch.sigmoid(self.Dense_1(F.relu(self.Dense_0(y))))
        return x * y[:, :, None, None]


class SpatialAttention(nn.Module):
    """Foreground-masked spatial softmax attention with an add-paste
    residual (live-path semantics: ``h_t`` = masked spatial mean)."""

    def __init__(self, c: int, d_model: int, reduction: int = 2):
        super().__init__()
        r = d_model // reduction
        self.Conv_0 = nn.Conv2d(c, r, 1)
        self.Dense_0 = nn.Linear(c, r, bias=False)
        self.Conv_1 = nn.Conv2d(r, 1, 1)
        self.BatchNorm_0 = nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)

    def forward(self, base, y):
        b = base.shape[0]
        masked = base * y
        h_t = self.Dense_0(masked.mean(dim=(2, 3)))
        z = self.Conv_0(masked) + h_t[:, :, None, None]
        beta = self.Conv_1(torch.tanh(z))  # (b, 1, h, w)
        logits = torch.where(y > 0, beta, torch.full_like(beta, _NEG_INF))
        y_sum = y.sum(dim=(1, 2, 3)).reshape(b, 1)
        p = torch.softmax(logits.reshape(b, -1), dim=1)
        p = torch.where(y_sum > 0, p, torch.zeros_like(p))  # empty-mask guard
        beta = (p * y_sum).reshape(beta.shape)
        return base + self.BatchNorm_0(base * beta) * y


class MaskedBatchNorm(nn.Module):
    """Batch-norm whose statistics only ever saw mask=1 pixels; at eval it
    normalises with the running statistics, in float32."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x):
        v = lambda t: t.float()[None, :, None, None]  # noqa: E731
        y = (x.float() - v(self.mean)) * torch.rsqrt(v(self.var) + self.eps)
        return y * v(self.scale) + v(self.bias)


class HardAttention(nn.Module):
    """Hard-attention score head: smooth, project to one channel,
    masked-BN against the semantic mask, smooth again, gate by the mask."""

    def __init__(self, c: int, d_k: int = 12):
        super().__init__()
        self.Conv_0 = nn.Conv2d(c, d_k, 1)
        self.Conv_1 = nn.Conv2d(d_k, 1, 3, padding=1)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(1)

    def forward(self, s, sem_seg, ins_seg=None):
        """Returns the merged score ``e`` (B, 1, H, W), float32."""
        if ins_seg is not None:
            raise NotImplementedError(
                "per-instance hard-attention softmax is not ported yet: it "
                "comes with the training slice and its masked_softmax kernel"
            )
        e = torch.tanh(self.Conv_0(avg_pool_3x3_same(s)))
        e = self.MaskedBatchNorm_0(self.Conv_1(e))
        return avg_pool_3x3_same(e) * sem_seg.float()
