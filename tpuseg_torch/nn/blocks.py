"""Depthwise-separable building blocks (port of ``tpuseg/nn/blocks.py``).

NCHW ``nn.Module``s whose submodule names are the flax auto-names
(``Conv_0``, ``_BN_1``...), so a checkpoint leaf's torch key is its flax
path (``tpuseg_torch/weights.py``).  Eval-mode inference: BatchNorm uses
its running statistics.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


def relu6(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(0.0, 6.0)


class _BN(nn.Module):
    """BatchNorm matching torch defaults (eps 1e-5, momentum 0.1); the
    wrapper level mirrors the flax ``_BN/BatchNorm_0`` nesting."""

    def __init__(self, c: int):
        super().__init__()
        self.BatchNorm_0 = nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)

    def forward(self, x):
        return self.BatchNorm_0(x)

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
