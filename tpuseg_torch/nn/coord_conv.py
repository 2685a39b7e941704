"""CoordConv (Liu et al. 2018), port of ``tpuseg/nn/coord_conv.py``: the
coordinate planes, ``CoordConv``, ``CoordConvTranspose``, the
``CoordConvNet`` retrofit runner and its weight surgery on a port
``state_dict``.

``conv_transpose_same`` is flax's ``ConvTranspose`` with its default
``padding="SAME"`` (``transpose_kernel=False``): the full transposed
convolution, then the window of ``lax.conv_transpose``'s SAME rule.  No
symmetric ``padding`` / ``output_padding`` of ``conv_transpose2d`` gives it
when the kernel is larger than the stride.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F


def add_coordinates(x: torch.Tensor, with_r: bool = False) -> torch.Tensor:
    """Prepend y / x coordinate planes (and with ``with_r`` the radius
    plane) to the channels of NCHW ``x``: y and x scaled to [-1, 1] with
    the origin at the centre, r the distance from the centre scaled to
    [0, 1].  Coordinates come first, as in the JAX package."""
    b, _, h, w = x.shape
    yy = torch.arange(h, dtype=torch.float32, device=x.device)
    xx = torch.arange(w, dtype=torch.float32, device=x.device)
    y = (2.0 * yy / (h - 1.0) - 1.0)[:, None].expand(h, w)
    xc = (2.0 * xx / (w - 1.0) - 1.0)[None, :].expand(h, w)
    planes = [y, xc]
    if with_r:
        r = torch.sqrt(y * y + xc * xc)
        planes.append(r / r.max())
    coords = torch.stack(planes).to(x.dtype)[None].expand(b, -1, h, w)
    return torch.cat([coords, x], dim=1)


def n_coordinates(with_r: bool) -> int:
    return 3 if with_r else 2


def _same_window(k: int, s: int) -> int:
    """First output index of ``lax.conv_transpose``'s SAME padding inside
    the full transposed convolution (length ``(n-1)*s + k``); the window is
    ``n*s`` long."""
    pad_a = k - 1 if s > k - 1 else math.ceil((k + s - 2) / 2)
    return k - 1 - pad_a


def conv_transpose_same(x: torch.Tensor, conv: nn.ConvTranspose2d
                        ) -> torch.Tensor:
    """flax ``ConvTranspose(padding="SAME")`` with the weight
    ``weights.py`` makes of its kernel: (N, C, H, W) -> (N, O, H*s, W*s)."""
    (kh, kw), (sh, sw) = conv.kernel_size, conv.stride
    h, w = x.shape[2], x.shape[3]
    y = F.conv_transpose2d(x, conv.weight, None, conv.stride)
    a_h, a_w = _same_window(kh, sh), _same_window(kw, sw)
    # negative pads crop; positive ones (a stride beyond the kernel) add
    # the zero rows the SAME window reaches past the full output
    y = F.pad(y, (-a_w, w * sw - (y.shape[3] - a_w),
                  -a_h, h * sh - (y.shape[2] - a_h)))
    if conv.bias is not None:
        y = y + conv.bias[None, :, None, None]
    return y


class CoordConv(nn.Module):
    """Coordinate planes, then a convolution (``Conv_0``)."""

    def __init__(self, cin: int, features: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 with_r: bool = False, use_bias: bool = True):
        super().__init__()
        self.with_r = with_r
        self.Conv_0 = nn.Conv2d(cin + n_coordinates(with_r), features,
                                kernel_size, stride=stride, padding=padding,
                                dilation=dilation, bias=use_bias)

    def forward(self, x):
        return self.Conv_0(add_coordinates(x, self.with_r))


class CoordConvTranspose(nn.Module):
    """Coordinate planes, then flax's SAME transposed convolution
    (``ConvTranspose_0``)."""

    def __init__(self, cin: int, features: int, kernel_size: int = 3,
                 stride: int = 2, with_r: bool = False,
                 use_bias: bool = True):
        super().__init__()
        self.with_r = with_r
        self.ConvTranspose_0 = nn.ConvTranspose2d(
            cin + n_coordinates(with_r), features, kernel_size,
            stride=stride, bias=use_bias)

    def forward(self, x):
        return conv_transpose_same(add_coordinates(x, self.with_r),
                                   self.ConvTranspose_0)


def retrofit_coordconv_params(state_dict, with_r: bool = True):
    """CoordConvNet weight surgery on a port ``state_dict``: every
    ``conv*`` convolution weight (OIHW) gains ``2 (+1 with_r)`` zero input
    channels in front (``dim=1``), where ``add_coordinates`` puts the
    planes, so the retrofitted net starts out equal to the original.
    Apply to a ``VGG16(use_coordinates=False)`` state, then load it into
    ``VGG16(use_coordinates=True)`` or ``CoordConvNet``."""
    extra = n_coordinates(with_r)
    out = {}
    for key, v in state_dict.items():
        parts = key.split(".")
        if (len(parts) > 1 and parts[-2].startswith("conv")
                and parts[-1] == "weight" and v.ndim == 4):
            pad = v.new_zeros((v.shape[0], extra) + tuple(v.shape[2:]))
            v = torch.cat([pad, v], dim=1)
        out[key] = v
    return out


class CoordConvNet(nn.Module):
    """A VGG16-style stack whose every convolution sees prepended
    coordinate planes; returns every layer's output.  Pair with
    ``retrofit_coordconv_params``."""

    def __init__(self, in_channels: int = 3, n_layers: Optional[int] = None,
                 with_r: bool = True):
        super().__init__()
        from tpuseg_torch.nn.vgg16 import _layer_types

        types = _layer_types()
        self.types = types[:n_layers if n_layers is not None else len(types)]
        self.with_r = with_r
        cin, conv_i = in_channels, 0
        for t in self.types:
            if t.startswith("conv"):
                feats = int(t[4:])
                self.add_module(f"conv{conv_i}", nn.Conv2d(
                    cin + n_coordinates(with_r), feats, 3, padding=1))
                cin, conv_i = feats, conv_i + 1

    def forward(self, x) -> List[torch.Tensor]:
        outs, conv_i = [], 0
        for t in self.types:
            if t == "pool":
                x = F.max_pool2d(x, 2, 2)
            elif t == "relu":
                x = F.relu(x)
            else:
                x = getattr(self, f"conv{conv_i}")(
                    add_coordinates(x, self.with_r))
                conv_i += 1
            outs.append(x)
        return outs
