"""Per-pyramid-level prediction head (port of ``tpuseg/nn/heads.py``)."""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from segbench.reference.parallel import spatial


class L0Head(nn.Module):
    """Conv3x3(c -> c/r) -> LeakyReLU(0.01) -> Conv3x3(-> 2 logits)."""

    def __init__(self, c: int, reduction: int = 2, out_channels: int = 2):
        super().__init__()
        self.Conv_0 = nn.Conv2d(c, c // reduction, 3, padding=1)
        self.Conv_1 = nn.Conv2d(c // reduction, out_channels, 3, padding=1)

    def forward(self, x):
        y = F.leaky_relu(spatial.conv2d(self.Conv_0, x), negative_slope=0.01)
        return spatial.conv2d(self.Conv_1, y)
