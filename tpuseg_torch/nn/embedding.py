"""Distance-map positional embedding (port of ``tpuseg/nn/embedding.py``):
``cal_position`` builds per-sample |col|, |row| distance planes to the
glimpse point; ``Embedding`` zero-pads them to ``d_model`` channels and
adds them to the feature map, scaled by a learned sigma head."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def cal_position(shape_hw: Tuple[int, int], points: torch.Tensor
                 ) -> torch.Tensor:
    """points (B, 2) integer (row, col) -> (B, 2, H, W): the absolute column
    distance, then the absolute row distance, to the point."""
    h, w = shape_hw
    dev = points.device
    rows = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    cols = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    pr = points[:, 0].float()[:, None, None]
    pc = points[:, 1].float()[:, None, None]
    dist_r = (rows[None] - pr).abs().expand(-1, h, w)
    dist_c = (cols[None] - pc).abs().expand(-1, h, w)
    return torch.stack([dist_c, dist_r], dim=1)


class Embedding(nn.Module):
    """``o_map + planes * 2 * sigmoid(Dense_1(tanh(Dense_0(h))))``, the
    planes (no gradient) zero-padded to ``d_model`` channels."""

    def __init__(self, h_dim: int, d_model: int, reduction: int = 2):
        super().__init__()
        self.d_model = d_model
        self.Dense_0 = nn.Linear(h_dim, d_model // reduction)
        self.Dense_1 = nn.Linear(d_model // reduction, 1)

    def forward(self, o_map, points, h):
        """o_map (B, d_model, H, W), points (B, 2), h (B, h_dim)."""
        fi = cal_position(o_map.shape[2:], points).detach()
        fi = F.pad(fi, (0, 0, 0, 0, 0, self.d_model - 2))
        sigma = torch.sigmoid(self.Dense_1(torch.tanh(self.Dense_0(h))))
        return o_map + fi.to(o_map.dtype) * sigma.reshape(-1, 1, 1, 1) * 2.0
