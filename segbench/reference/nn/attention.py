"""Attention layers and masked batch-norm (port of
``tpuseg/nn/attention.py``), NCHW, train and eval mode.

``HardAttention`` returns the merged score map alone when no instance
masks are given (all the extraction path consumes); with them it also
returns the per-instance distributions the training loss samples its
glimpses from, through the ``masked_softmax`` kernel on the card and its
plain version on the CPU.

Under spatial sharding (``parallel/spatial.py``) every mean, sum and
softmax over the pixels is one over the ranks' rows, the 3x3 convolution
and pooling read a row of halo, and the per-instance softmax runs the
kernel's split entry points.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from segbench.reference.kernels.masked_softmax import masked_softmax
from segbench.reference.nn.blocks import batch_norm, running_stats_frozen
from segbench.reference.parallel import spatial
from segbench.reference.parallel.mesh import batch_mean

_NEG_INF = -1e30


def avg_pool_3x3_same(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 average pooling, zero padding, divisor fixed at 9."""
    return spatial.avg_pool_3x3(x)


class SqueezeExcite(nn.Module):
    def __init__(self, c: int, reduction: int = 2):
        super().__init__()
        self.Dense_0 = nn.Linear(c, c // reduction)
        self.Dense_1 = nn.Linear(c // reduction, c)

    def forward(self, x):
        y = spatial.space_mean(x, (2, 3))
        y = torch.sigmoid(self.Dense_1(F.relu(self.Dense_0(y))))
        return x * y[:, :, None, None]


class ChannelAttention(nn.Module):
    """Masked channel attention: a softmax over the channels of the masked
    spatial mean (plus a projection of ``h_t`` when the module is built
    with ``h_dim``), scaled by ``d_model``; with ``multiply`` the
    BatchNorm'd re-weighted map is added back.  flax names the layers in
    call order, so the last Dense is ``Dense_2`` with ``h_t`` and
    ``Dense_1`` without."""

    def __init__(self, c: int, d_model: int, reduction: int = 2,
                 multiply: bool = True, h_dim: int = 0):
        super().__init__()
        r = d_model // reduction
        self.h_dim = h_dim
        self.multiply = multiply
        self.Dense_0 = nn.Linear(c, r)
        if h_dim:
            self.Dense_1 = nn.Linear(h_dim, r, bias=False)
        self.add_module(f"Dense_{2 if h_dim else 1}", nn.Linear(r, d_model))
        if multiply:
            self.BatchNorm_0 = nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)

    def forward(self, base, y, h_t=None):
        """base (B, C, H, W), y (B, 1, H, W) mask, h_t (B, h_dim) or None
        (exactly when built without ``h_dim``)."""
        if (h_t is None) != (not self.h_dim):
            raise ValueError("ChannelAttention: h_t must be given exactly "
                             "when the module is built with h_dim")
        z = self.Dense_0((base * y).mean(dim=(2, 3)))
        if self.h_dim:
            z = z + self.Dense_1(h_t)
            last = self.Dense_2
        else:
            last = self.Dense_1
        alpha = torch.softmax(last(torch.tanh(z)), dim=1) * last.out_features
        if not self.multiply:
            return alpha
        return base + batch_norm(self.BatchNorm_0,
                                 base * alpha[:, :, None, None])


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
        h_t = self.Dense_0(spatial.space_mean(masked, (2, 3)))
        z = self.Conv_0(masked) + h_t[:, :, None, None]
        beta = self.Conv_1(torch.tanh(z))  # (b, 1, h, w)
        logits = torch.where(y > 0, beta, torch.full_like(beta, _NEG_INF))
        y_sum = spatial.space_sum(y, (1, 2, 3)).reshape(b, 1)
        p = spatial.softmax_flat(logits.reshape(b, -1))
        p = torch.where(y_sum > 0, p, torch.zeros_like(p))  # empty-mask guard
        beta = (p * y_sum).reshape(beta.shape)
        return base + batch_norm(self.BatchNorm_0, base * beta) * y


class MaskedBatchNorm(nn.Module):
    """Batch-norm whose statistics only see mask=1 pixels, in float32.

    Train mode: per-channel mean and variance are the batch average of
    per-sample masked moments (denominator ``|mask| + 1``), applied to all
    pixels; the running statistics follow the reversed EMA
    ``running = momentum * running + (1 - momentum) * batch`` with
    ``momentum`` 0.1, so they track the latest batch closely (eval-time
    behaviour depends on it).  Eval mode normalises with the running
    statistics.  Under data parallelism the batch averages run over the
    global batch (``parallel/mesh.py::batch_mean``); under spatial
    sharding the per-sample masked moments sum over the ranks' rows."""

    def __init__(self, c: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x, mask=None):
        v = lambda t: t.float()[None, :, None, None]  # noqa: E731
        xf = x.float()
        if self.training:
            if mask is None:
                raise ValueError("MaskedBatchNorm needs the mask in train mode")
            m = mask.float()  # (B, 1, H, W), broadcast over channels
            cnt = spatial.space_sum(m, (1, 2, 3)) + 1.0  # (B,)
            mean = batch_mean(spatial.space_sum(xf * m, (2, 3)) / cnt[:, None])
            sq = (xf - v(mean)) ** 2
            var = batch_mean(spatial.space_sum(sq * m, (2, 3)) / cnt[:, None])
            if not running_stats_frozen():
                with torch.no_grad():
                    mo = self.momentum
                    self.mean.mul_(mo).add_(mean.detach(), alpha=1 - mo)
                    self.var.mul_(mo).add_(var.detach(), alpha=1 - mo)
        else:
            mean, var = self.mean, self.var
        y = (xf - v(mean)) * torch.rsqrt(v(var) + self.eps)
        return y * v(self.scale) + v(self.bias)


class HardAttention(nn.Module):
    """Hard-attention score head: smooth, project to one channel,
    masked-BN against the semantic mask, smooth again, gate by the mask;
    then, given instance masks, one softmax per instance over its pixels."""

    def __init__(self, c: int, d_k: int = 12):
        super().__init__()
        self.Conv_0 = nn.Conv2d(c, d_k, 1)
        self.Conv_1 = nn.Conv2d(d_k, 1, 3, padding=1)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(1)

    def forward(self, s, sem_seg, ins_seg=None):
        """The merged score ``e`` (B, 1, H, W), float32; with ``ins_seg``
        (B, N, H, W) the pair ``(per_instance (B, N, H, W), e)``, empty
        instances all zero.  The gradient reaches ``e``, not the masks."""
        e = torch.tanh(self.Conv_0(avg_pool_3x3_same(s)))
        e = self.MaskedBatchNorm_0(spatial.conv2d(self.Conv_1, e), sem_seg)
        e = avg_pool_3x3_same(e) * sem_seg.float()
        if ins_seg is None:
            return e
        b, n, h, w = ins_seg.shape
        softmax = spatial.masked_softmax if spatial.sharded() else masked_softmax
        p = softmax(e.reshape(b, h * w).contiguous(),
                    ins_seg.float().contiguous().reshape(b, n, h * w))
        return p.reshape(b, n, h, w), e
