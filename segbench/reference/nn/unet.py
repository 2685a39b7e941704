"""5-level depthwise UNet (port of ``tpuseg/nn/unet.py``), NCHW.

``down``: 2x2 average pooling (== bilinear 0.5x, align_corners=False),
DoubleConv to ``out - in`` channels, concat with the pooled input.
``up``: 2x2 stride-2 transposed conv, concat ``[skip, up]``, DoubleConv.

Under spatial sharding (``parallel/spatial.py``) each level runs at the
rows of ``spatial.level(factor)``: a pool whose shard rows do not divide
(or a level with too few rows a rank) replicates the coarser levels, and
the transposed conv reads a replicated level's rows for a sharded one.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from segbench.reference.nn.blocks import DoubleConv
from segbench.reference.parallel import spatial


def _downsample2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 0.5x with align_corners=False == 2x2 mean pooling."""
    return F.avg_pool2d(x, 2, 2)


class _Down(nn.Module):
    def __init__(self, cin: int, out_features: int):
        super().__init__()
        self.DoubleConv_0 = DoubleConv(cin, out_features - cin)

    def forward(self, x, factor: int = 1):
        """x at ``factor`` -> the level at ``2 * factor``."""
        dst = spatial.level_rows(2 * factor)
        x_bili = spatial.pool_rows(x, lambda t, k: _downsample2x(t), 2,
                                   spatial.level_rows(factor), dst)
        with spatial.at_rows(dst):
            return torch.cat([self.DoubleConv_0(x_bili), x_bili], dim=1)


class _Up(nn.Module):
    def __init__(self, cin: int, skip_ch: int, out_features: int):
        super().__init__()
        self.ConvTranspose_0 = nn.ConvTranspose2d(cin, cin // 2, 2, stride=2)
        self.DoubleConv_0 = DoubleConv(skip_ch + cin // 2, out_features)

    def forward(self, x1, x2, factor: int = 1):
        """x1 at ``2 * factor``, the skip x2 at ``factor``."""
        dst = spatial.level_rows(factor)
        x1 = spatial.upsample_rows(x1, self.ConvTranspose_0, 2,
                                   spatial.level_rows(2 * factor), dst)
        if x1.shape[2:] != x2.shape[2:]:
            raise ValueError(f"UNet level shapes differ: {x1.shape} {x2.shape}")
        with spatial.at_rows(dst):
            return self.DoubleConv_0(torch.cat([x2, x1], dim=1))


class UNet(nn.Module):
    """Returns ``(x_dec, skips)``; with ``use_encode`` the skips are the
    encoder outputs x1..x5 (channels f, 2f, 4f, 8f, 16f)."""

    def __init__(self, in_ch: int = 21, n_filters: int = 32,
                 use_encode: bool = True):
        super().__init__()
        f = n_filters
        self.use_encode = use_encode
        self.inc = DoubleConv(in_ch, f)
        self.down1 = _Down(f, 2 * f)
        self.down2 = _Down(2 * f, 4 * f)
        self.down3 = _Down(4 * f, 8 * f)
        self.down4 = _Down(8 * f, 16 * f)
        self.up1 = _Up(16 * f, 8 * f, 8 * f)
        self.up2 = _Up(8 * f, 4 * f, 4 * f)
        self.up3 = _Up(4 * f, 2 * f, 2 * f)
        self.up4 = _Up(2 * f, f, f)

    def forward(self, x) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        with spatial.level(1):
            x1 = self.inc(x)
        x2 = self.down1(x1, 1)
        x3 = self.down2(x2, 2)
        x4 = self.down3(x3, 4)
        x5 = self.down4(x4, 8)
        y4 = self.up1(x5, x4, 8)
        y3 = self.up2(y4, x3, 4)
        y2 = self.up3(y3, x2, 2)
        y1 = self.up4(y2, x1, 1)
        if self.use_encode:
            return y1, (x1, x2, x3, x4, x5)
        return y1, (y1, y2, y3, y4, x5)
