"""21-channel colour-space expansion on the device (port of
``tpuseg/data/colorspace.py``).

Batched channel-last tensors ``(..., H, W, 3)`` uint8 in, ``(..., H, W,
21)`` float32 out: [RGB (raw 0..255), LAB, HSV, YUV, YCbCr, HED, YIQ].
The reference's raw-scale quirks are spec and kept: the RGB block stays
0..255, LAB has L in 0..100, YCbCr is 16..240, and the standardiser only
applies ``(x - 0.5) * 2`` — no per-channel rescale.
"""

from __future__ import annotations

import numpy as np
import torch

_XYZ_FROM_RGB = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ],
    dtype=np.float32,
)
_D65_WHITE = np.array([0.95047, 1.0, 1.08883], dtype=np.float32)
_YUV_FROM_RGB = np.array(
    [
        [0.299, 0.587, 0.114],
        [-0.14714119, -0.28886916, 0.43601035],
        [0.61497538, -0.51496512, -0.10001026],
    ],
    dtype=np.float32,
)
_YIQ_FROM_RGB = np.array(
    [
        [0.299, 0.587, 0.114],
        [0.59590059, -0.27455667, -0.32134392],
        [0.21153661, -0.52273617, 0.31119955],
    ],
    dtype=np.float32,
)
_YCBCR_FROM_RGB = np.array(
    [
        [65.481, 128.553, 24.966],
        [-37.797, -74.203, 112.0],
        [112.0, -93.786, -18.214],
    ],
    dtype=np.float32,
)
_YCBCR_OFFSET = np.array([16.0, 128.0, 128.0], dtype=np.float32)
_RGB_FROM_HED = np.array(
    [[0.65, 0.70, 0.29], [0.07, 0.99, 0.11], [0.27, 0.57, 0.78]],
    dtype=np.float32,
)
_HED_FROM_RGB = np.linalg.inv(_RGB_FROM_HED).astype(np.float32)


def _const(m: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(m, dtype=torch.float32, device=like.device)


def _matmul_c(rgb01: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    return rgb01 @ _const(m, rgb01).T


def rgb2yuv(rgb01):
    return _matmul_c(rgb01, _YUV_FROM_RGB)


def rgb2yiq(rgb01):
    return _matmul_c(rgb01, _YIQ_FROM_RGB)


def rgb2ycbcr(rgb01):
    return _matmul_c(rgb01, _YCBCR_FROM_RGB) + _const(_YCBCR_OFFSET, rgb01)


def rgb2hsv(rgb01):
    r, g, b = rgb01[..., 0], rgb01[..., 1], rgb01[..., 2]
    v = rgb01.amax(dim=-1)
    mn = rgb01.amin(dim=-1)
    delta = v - mn
    safe = torch.where(delta == 0, torch.ones_like(delta), delta)
    s = torch.where(
        v == 0, torch.zeros_like(v),
        delta / torch.where(v == 0, torch.ones_like(v), v),
    )
    h_r = torch.remainder((g - b) / safe, 6.0)
    h_g = (b - r) / safe + 2.0
    h_b = (r - g) / safe + 4.0
    h = torch.where(v == r, h_r, torch.where(v == g, h_g, h_b))
    h = torch.where(delta == 0, torch.zeros_like(h), h / 6.0)
    return torch.stack([h, s, v], dim=-1)


def rgb2lab(rgb01):
    srgb = rgb01.clamp(0.0, 1.0)
    lin = torch.where(
        srgb > 0.04045, ((srgb + 0.055) / 1.055) ** 2.4, srgb / 12.92
    )
    xyz = _matmul_c(lin, _XYZ_FROM_RGB) / _const(_D65_WHITE, rgb01)
    eps = 0.008856
    # cube root of the positive branch (torch has no cbrt; xyz > eps > 0)
    f = torch.where(
        xyz > eps, xyz.clamp_min(eps) ** (1.0 / 3.0), 7.787 * xyz + 16.0 / 116.0
    )
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    return torch.stack(
        [116.0 * fy - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz)], dim=-1
    )


def rgb2hed(rgb01):
    rgb = rgb01.clamp_min(1e-6)
    log_adjust = float(np.log(1e-6))
    stains = (torch.log(rgb) / log_adjust) @ _const(_HED_FROM_RGB, rgb01)
    return stains.clamp_min(0.0)


def expand21(rgb_u8: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) RGB 0..255 -> the reference's 21 channels
    (``lib/utils.py:100-110`` order)."""
    rgb_f = rgb_u8.to(torch.float32)
    rgb01 = rgb_f / 255.0
    return torch.cat(
        [
            rgb_f, rgb2lab(rgb01), rgb2hsv(rgb01), rgb2yuv(rgb01),
            rgb2ycbcr(rgb01), rgb2hed(rgb01), rgb2yiq(rgb01),
        ],
        dim=-1,
    )


def image_ex_standardize(rgb_u8: torch.Tensor) -> torch.Tensor:
    """ImageEx + Standardization (``lib/utils.py:82-83``): expand to 21
    channels, then ``(x - 0.5) * 2``."""
    return (expand21(rgb_u8) - 0.5) * 2.0
