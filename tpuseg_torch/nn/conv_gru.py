"""Convolutional GRU cell (Ballas et al. 2016), port of
``tpuseg/nn/conv_gru.py``: gates from one convolution over [x, h], the
candidate from one over [x, r*h], optionally CoordConvs (with r)."""

from __future__ import annotations

import torch
import torch.nn as nn

from tpuseg_torch.nn.coord_conv import CoordConv


def conv_or_coord(cin: int, features: int, kernel_size: int,
                  use_coordinates: bool) -> nn.Module:
    """A ``kernel_size`` convolution with SAME padding, or the CoordConv
    (with r) of it."""
    pad = kernel_size // 2
    if use_coordinates:
        return CoordConv(cin, features, kernel_size, padding=pad,
                         with_r=True)
    return nn.Conv2d(cin, features, kernel_size, padding=pad)


class ConvGRUCell(nn.Module):
    def __init__(self, cin: int, hidden_size: int, kernel_size: int = 3,
                 use_coordinates: bool = False):
        super().__init__()
        self.hidden_size = hidden_size
        self.conv_gates = conv_or_coord(cin + hidden_size, 2 * hidden_size,
                                        kernel_size, use_coordinates)
        self.conv_ct = conv_or_coord(cin + hidden_size, hidden_size,
                                     kernel_size, use_coordinates)

    def forward(self, x, hidden=None):
        b, _, h, w = x.shape
        if hidden is None:
            hidden = x.new_zeros((b, self.hidden_size, h, w))
        c1 = self.conv_gates(torch.cat([x, hidden], dim=1))
        rt, ut = torch.split(c1, self.hidden_size, dim=1)
        reset = torch.sigmoid(rt)
        update = torch.sigmoid(ut)
        ct = torch.tanh(self.conv_ct(torch.cat([x, reset * hidden], dim=1)))
        return update * hidden + (1.0 - update) * ct
