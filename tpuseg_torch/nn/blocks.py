"""Depthwise-separable building blocks (port of ``tpuseg/nn/blocks.py``).

NCHW ``nn.Module``s whose submodule names are the flax auto-names
(``Conv_0``, ``_BN_1``...), so a checkpoint leaf's torch key is its flax
path (``tpuseg_torch/weights.py``).

BatchNorm follows flax in train mode (``batch_norm``): the running variance
takes the *biased* batch variance, where ``torch.nn.BatchNorm2d`` would store
the unbiased one, so a train step ends with the running statistics the JAX
package ends with.  ``running_stats`` lets a caller stop the update (a
recomputed forward under activation checkpointing) or let one update stand
for several identical ones (skip transforms hoisted out of the glimpse loop).
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


def relu6(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(0.0, 6.0)


# how train-mode BatchNorms treat their running statistics right now
_RUNNING = {"frozen": False, "repeats": 1}


@contextlib.contextmanager
def running_stats(frozen: Optional[bool] = None,
                  repeats: Optional[int] = None):
    """Within the block, train-mode BatchNorms leave their running
    statistics alone (``frozen``) or apply one update as ``repeats``
    identical ones: ``ra + (batch - ra) * (1 - (1 - momentum)**repeats)``."""
    old = dict(_RUNNING)
    if frozen is not None:
        _RUNNING["frozen"] = frozen
    if repeats is not None:
        _RUNNING["repeats"] = repeats
    try:
        yield
    finally:
        _RUNNING.update(old)


def running_stats_frozen() -> bool:
    return _RUNNING["frozen"]


def batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """``bn(x)`` with flax's running-statistics rule in train mode: batch
    mean and *biased* batch variance, ``ra = (1 - m) * ra + m * batch``
    with ``m`` torch's momentum (0.1, flax's 0.9)."""
    if not bn.training:
        return bn(x)
    mean = torch.zeros_like(bn.running_mean)
    var = torch.ones_like(bn.running_var)
    # momentum 1 leaves the batch mean and the unbiased batch variance
    y = F.batch_norm(x, mean, var, bn.weight, bn.bias, True, 1.0, bn.eps)
    if not _RUNNING["frozen"]:
        n = x.numel() // x.shape[1]
        w = 1.0 - (1.0 - bn.momentum) ** _RUNNING["repeats"]
        with torch.no_grad():
            bn.running_mean.lerp_(mean, w)
            bn.running_var.lerp_(var * ((n - 1) / n), w)
    return y


class _BN(nn.Module):
    """BatchNorm matching torch defaults (eps 1e-5, momentum 0.1) with
    flax's running variance (``batch_norm``); the wrapper level mirrors the
    flax ``_BN/BatchNorm_0`` nesting."""

    def __init__(self, c: int):
        super().__init__()
        self.BatchNorm_0 = nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)

    def forward(self, x):
        return batch_norm(self.BatchNorm_0, x)

    def folded(self):
        """Inference affine ``(scale, shift)`` in float32."""
        bn = self.BatchNorm_0
        scale = bn.weight.float() / torch.sqrt(bn.running_var.float() + bn.eps)
        shift = bn.bias.float() - bn.running_mean.float() * scale
        return scale, shift


class ConvBN(nn.Module):
    """3x3 conv + BN + ReLU."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, features, 3, stride=stride, padding=1,
                                bias=False)
        self._BN_0 = _BN(features)

    def forward(self, x):
        return F.relu(self._BN_0(self.Conv_0(x)))


class Conv1x1BN(nn.Module):
    """1x1 conv + BN + ReLU."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, features, 1, bias=False)
        self._BN_0 = _BN(features)

    def forward(self, x):
        return F.relu(self._BN_0(self.Conv_0(x)))


class InvertedV1Residual(nn.Module):
    """dw3x3 -> BN -> ReLU6 -> pw1x1 -> BN (+ residual when shapes match)."""

    def __init__(self, cin: int, features: int, dilation: int = 1,
                 with_relu: bool = False):
        super().__init__()
        self.use_res = cin == features
        self.with_relu = with_relu
        self.Conv_0 = nn.Conv2d(cin, cin, 3, groups=cin, padding=dilation,
                                dilation=dilation, bias=False)
        self._BN_0 = _BN(cin)
        self.Conv_1 = nn.Conv2d(cin, features, 1, bias=False)
        self._BN_1 = _BN(features)

    def forward(self, x):
        y = relu6(self._BN_0(self.Conv_0(x)))
        y = self._BN_1(self.Conv_1(y))
        if self.with_relu:
            y = relu6(y)
        return x + y if self.use_res else y


class InvertedResidual(nn.Module):
    """MobileNetV2 block: pw-expand -> dw3x3 -> pw-linear, each with BN."""

    def __init__(self, cin: int, features: int, expand_ratio: int = 2):
        super().__init__()
        hidden = cin * expand_ratio
        self.use_res = cin == features
        self.Conv_0 = nn.Conv2d(cin, hidden, 1, bias=False)
        self._BN_0 = _BN(hidden)
        self.Conv_1 = nn.Conv2d(hidden, hidden, 3, groups=hidden, padding=1,
                                bias=False)
        self._BN_1 = _BN(hidden)
        self.Conv_2 = nn.Conv2d(hidden, features, 1, bias=False)
        self._BN_2 = _BN(features)

    def forward(self, x):
        y = relu6(self._BN_0(self.Conv_0(x)))
        y = relu6(self._BN_1(self.Conv_1(y)))
        y = self._BN_2(self.Conv_2(y))
        return x + y if self.use_res else y


class DoubleConv(nn.Module):
    """Two chained InvertedV1Residual blocks."""

    def __init__(self, cin: int, features: int,
                 dilation_rates: Sequence[int] = (1, 1)):
        super().__init__()
        for i, rate in enumerate(dilation_rates):
            self.add_module(
                f"InvertedV1Residual_{i}",
                InvertedV1Residual(cin if i == 0 else features, features,
                                   dilation=rate),
            )

    def forward(self, x):
        for block in self.children():
            x = block(x)
        return x
