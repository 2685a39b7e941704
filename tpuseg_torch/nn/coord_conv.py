"""Coordinate planes (port of ``tpuseg/nn/coord_conv.py::add_coordinates``;
the ``CoordConv`` modules are not ported)."""

from __future__ import annotations

import torch


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
