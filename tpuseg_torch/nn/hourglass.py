"""Recurrent Hourglass (Payer et al. 2018), port of
``tpuseg/nn/hourglass.py``: ``n_levels`` of pre-conv + ConvGRU unrolling
(one cell shared across the levels), then a reverse pass of post-convs
with additive skips; ``StackedRecurrentHourglass`` chains them and adds a
semantic and an embedding head."""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from tpuseg_torch.nn.conv_gru import ConvGRUCell, conv_or_coord


class RecurrentHourglass(nn.Module):
    def __init__(self, cin: int, hidden_n_filters: int, kernel_size: int,
                 n_levels: int, embedding_size: int,
                 use_coordinates: bool = False):
        super().__init__()
        if n_levels < 1:
            raise ValueError("RecurrentHourglass needs n_levels >= 1")
        self.n_levels = n_levels
        hid = hidden_n_filters
        self.convgru_cell = ConvGRUCell(hid, hid, kernel_size,
                                        use_coordinates)
        for i in range(n_levels):
            self.add_module(f"pre_conv{i}", conv_or_coord(
                cin if i == 0 else hid, hid, kernel_size, use_coordinates))
        for i in range(n_levels - 1, -1, -1):
            self.add_module(f"post_conv{i}", conv_or_coord(
                hid, embedding_size if i == 0 else hid, kernel_size,
                use_coordinates))

    def forward(self, x):
        outputs = []
        hidden = None
        for i in range(self.n_levels):
            x = F.relu(getattr(self, f"pre_conv{i}")(x))
            hidden = self.convgru_cell(x, hidden)
            outputs.append(hidden)
        n = self.n_levels
        post = F.relu(getattr(self, f"post_conv{n - 1}")(outputs[-1]))
        for i in range(n - 2, -1, -1):
            post = F.relu(getattr(self, f"post_conv{i}")(post + outputs[i]))
        return post


class StackedRecurrentHourglass(nn.Module):
    """``n_stacks`` chained hourglasses over the input, then 1x1 heads for
    ``n_classes`` semantic logits and an ``embedding_size`` embedding map.
    Returns (sem, emb), NCHW."""

    def __init__(self, in_channels: int = 3, n_stacks: int = 2,
                 hidden_n_filters: int = 64, kernel_size: int = 3,
                 n_levels: int = 4, embedding_size: int = 32,
                 n_classes: int = 2, use_coordinates: bool = False):
        super().__init__()
        self.n_stacks = n_stacks
        for s in range(n_stacks):
            self.add_module(f"hourglass{s}", RecurrentHourglass(
                in_channels if s == 0 else embedding_size, hidden_n_filters,
                kernel_size, n_levels, embedding_size, use_coordinates))
        self.sem_head = nn.Conv2d(embedding_size, n_classes, 1)
        self.emb_head = nn.Conv2d(embedding_size, embedding_size, 1)

    def forward(self, x):
        for s in range(self.n_stacks):
            x = getattr(self, f"hourglass{s}")(x)
        return self.sem_head(x), self.emb_head(x)
