"""DCGAN-style mask decoder of the WAE match loss (port of
``tpuseg/nn/dcgan_decoder.py``): latent -> Dense -> ConvTranspose(5x5,
stride 2) stack with affine instance norm -> sigmoid mask.

The Dense output is laid out NHWC, as flax reshapes it, then permuted to
NCHW; the transposed convolutions are flax's SAME ones
(``coord_conv.conv_transpose_same``); the instance norm is flax
``GroupNorm(group_size=1)`` at eps 1e-6.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpuseg_torch.nn.aspp import FLAX_NORM_EPS
from tpuseg_torch.nn.coord_conv import conv_transpose_same


class DcganDecoder(nn.Module):
    def __init__(self, coding: int = 24, num_units: int = 64,
                 num_layers: int = 3,
                 out_shape: Tuple[int, int, int] = (64, 64, 1)):
        super().__init__()
        self.num_units = num_units
        self.num_layers = num_layers
        self.out_shape = tuple(out_shape)
        self.h0 = out_shape[0] // 2 ** (num_layers - 1)
        self.w0 = out_shape[1] // 2 ** (num_layers - 1)
        self.Dense_0 = nn.Linear(coding, num_units * self.h0 * self.w0)
        units = num_units
        for i in range(num_layers - 1):
            self.add_module(f"ConvTranspose_{i}", nn.ConvTranspose2d(
                units, units // 2, 5, stride=2))
            self.add_module(f"GroupNorm_{i}", nn.GroupNorm(
                units // 2, units // 2, eps=FLAX_NORM_EPS))
            units //= 2
        self.add_module(f"ConvTranspose_{num_layers - 1}",
                        nn.ConvTranspose2d(units, out_shape[2], 5, stride=1))

    def forward(self, z):
        """z (B, coding) -> (B, H, W) mask in (0, 1), or (B, C, H, W) when
        the output has C > 1 channels."""
        x = self.Dense_0(z).reshape(-1, self.h0, self.w0, self.num_units)
        x = F.relu(x.permute(0, 3, 1, 2))
        for i in range(self.num_layers - 1):
            x = conv_transpose_same(x, getattr(self, f"ConvTranspose_{i}"))
            x = F.relu(getattr(self, f"GroupNorm_{i}")(x))
        x = torch.sigmoid(conv_transpose_same(
            x, getattr(self, f"ConvTranspose_{self.num_layers - 1}")))
        return x[:, 0] if self.out_shape[2] == 1 else x
