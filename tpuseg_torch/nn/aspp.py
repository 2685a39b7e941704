"""DenseASPP blocks and the dilated MobileNetV2 feature extractor (port of
``tpuseg/nn/aspp.py``), NCHW.

The blocks' instance norm is flax ``GroupNorm(group_size=1)`` without
scale or bias, at flax's eps 1e-6 (torch's norms default to 1e-5).  The
dropout broadcast over the pixels is a channel dropout drawn from the
caller's generator in train mode.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpuseg_torch.nn.blocks import Conv1x1BN, ConvBN, InvertedResidual

FLAX_NORM_EPS = 1e-6


def instance_norm(x: torch.Tensor) -> torch.Tensor:
    """flax ``GroupNorm(group_size=1, use_scale=False, use_bias=False)``."""
    return F.group_norm(x, x.shape[1], eps=FLAX_NORM_EPS)


def channel_dropout(x: torch.Tensor, rate: float, train: bool,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``Dropout(rate, broadcast_dims=(1, 2))`` on NCHW ``x``: one draw
    per sample and channel in train mode, the identity in eval mode."""
    if not (train and rate > 0):
        return x
    keep = 1.0 - rate
    kept = torch.rand((x.shape[0], x.shape[1], 1, 1), generator=generator,
                      device=x.device) < keep
    return x * (kept.to(x.dtype) / keep)


class DenseAsppBlock(nn.Module):
    """InstanceNorm -> ReLU -> 1x1 -> InstanceNorm -> ReLU -> dilated 3x3
    (+ channel dropout)."""

    def __init__(self, cin: int, num1: int, num2: int, dilation_rate: int,
                 drop_out: float = 0.1, norm_start: bool = True):
        super().__init__()
        self.drop_out = drop_out
        self.norm_start = norm_start
        self.conv_1 = nn.Conv2d(cin, num1, 1)
        self.conv_2 = nn.Conv2d(num1, num2, 3, padding=dilation_rate,
                                dilation=dilation_rate)

    def forward(self, x, train: bool = False, generator=None):
        if self.norm_start:
            x = instance_norm(x)
        x = self.conv_1(F.relu(x))
        x = self.conv_2(F.relu(instance_norm(x)))
        if self.drop_out > 0:
            x = channel_dropout(x, self.drop_out, train, generator)
        return x


class MaskedAsppEncoder(nn.Module):
    """Masked dense-ASPP feature encoder: each block sees the running
    concatenation masked by the foreground; a dropout + 1x1 head projects
    back to ``d_model``."""

    def __init__(self, cin: int, d_model: int, aspp_rates: Sequence[int],
                 d_features0: int = 20, d_features1: int = 10,
                 dropout0: float = 0.1, dropout1: float = 0.1):
        super().__init__()
        self.n_blocks = len(aspp_rates)
        self.dropout1 = dropout1
        c = cin
        for i, rate in enumerate(aspp_rates):
            self.add_module(f"aspp{i}", DenseAsppBlock(
                c, d_features0, d_features1, rate, drop_out=dropout0,
                norm_start=(i != 0)))
            c += d_features1
        self.last = nn.Conv2d(c, d_model, 1)

    def forward(self, x, mask, train: bool = False, generator=None):
        """x (B, C, H, W), mask (B, 1, H, W)."""
        features = x
        for i in range(self.n_blocks):
            features = features * mask
            aspp = getattr(self, f"aspp{i}")(features, train, generator)
            features = torch.cat([aspp, features], dim=1)
        features = channel_dropout(features * mask, self.dropout1, train,
                                   generator)
        return self.last(features)


class DilatedMobileNetV2(nn.Module):
    """Inverted-residual stages with output-stride-controlled dilation,
    emitting the features after stages 3, 10, 16 and the final 1x1."""

    def __init__(self, in_channels: int = 3, width_mult: float = 1.0,
                 output_stride: int = 8, last_channel: int = 256):
        super().__init__()
        scale = output_stride
        d = max(int(2 / scale), 1)
        settings = [
            # t, c, n, s, dilate
            (1, 16, 1, 1, 1),
            (6, 24, 2, 1, 1),
            (6, 32, 3, 2, 1),
            (6, 64, 4, int(scale), d),
            (6, 96, 3, 2, d),
            (6, 160, 3, 1, d),
            (6, 320, 1, 2, d),
        ]
        c = int(32 * width_mult)
        self.ConvBN_0 = ConvBN(in_channels, c)
        i = 0
        for t, ch, n, s, dilate in settings:
            oc = int(ch * width_mult)
            for j in range(n):
                self.add_module(f"InvertedResidual_{i}", InvertedResidual(
                    c, oc, stride=(s if j == 0 else 1), expand_ratio=t,
                    dilation=dilate))
                c, i = oc, i + 1
        self.n_blocks = i
        self.Conv1x1BN_0 = Conv1x1BN(c, last_channel)

    def forward(self, x) -> List[torch.Tensor]:
        taps = {3, 10, 16}
        outs: List[torch.Tensor] = []
        x = self.ConvBN_0(x)
        for i in range(self.n_blocks):
            x = getattr(self, f"InvertedResidual_{i}")(x)
            if i + 1 in taps:
                outs.append(x)
        outs.append(self.Conv1x1BN_0(x))
        return outs


class DenseASPP(nn.Module):
    """Multi-scale feature wrapper around ``DilatedMobileNetV2``."""

    def __init__(self, in_channels: int = 3, output_stride: int = 8):
        super().__init__()
        self.features = DilatedMobileNetV2(in_channels,
                                           output_stride=output_stride)

    def forward(self, x) -> List[torch.Tensor]:
        return self.features(x)
