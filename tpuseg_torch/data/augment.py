"""Host-side augmentation primitives (own copy of ``tpuseg/data/augment.py``).

The reference's geometric and photometric transforms (``lib/
preprocess.py``), on PIL images or numpy arrays.  Every random draw comes
from the ``numpy.random.Generator`` passed in, in the JAX package's order,
so one generator state gives the same result bit for bit in both packages.
Pillow is imported when a transform runs, not with the module.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# Pillow's resampling filters (``PIL.Image.Resampling``) by value, so the
# defaults below need no Pillow at import
NEAREST = 0
LANCZOS = 1
BILINEAR = 2
# ``PIL.Image.Transpose`` members used here
_FLIP_LEFT_RIGHT, _FLIP_TOP_BOTTOM, _TRANSPOSE = 0, 1, 5


def to_pil(img):
    from PIL import Image

    return img if isinstance(img, Image.Image) else Image.fromarray(img)


def _transpose(img, method: int):
    was_np = isinstance(img, np.ndarray)
    out = to_pil(img).transpose(method)
    return np.array(out) if was_np else out


def hflip(img):
    """preprocess.py:153-176"""
    return _transpose(img, _FLIP_LEFT_RIGHT)


def vflip(img):
    """preprocess.py:200-223"""
    return _transpose(img, _FLIP_TOP_BOTTOM)


def transpose(img):
    """preprocess.py:268-291"""
    return _transpose(img, _TRANSPOSE)


def rotate(img, angle, resample=BILINEAR, expand=True):
    """preprocess.py:311-328"""
    was_np = isinstance(img, np.ndarray)
    out = to_pil(img).rotate(angle, resample=resample, expand=expand)
    return np.array(out) if was_np else out


def rotate_with_random_bg(img, angle, rng: np.random.Generator,
                          resample=BILINEAR, expand=True):
    """Rotate and fill the exposed corners with a white, black, mean or
    median background (preprocess.py:330-365)."""
    from PIL import Image

    was_np = isinstance(img, np.ndarray)
    pil = to_pil(img)
    img_np = np.array(pil)
    rgba = pil.convert("RGBA").rotate(angle, resample=resample, expand=expand)
    key = int(rng.integers(0, 4))
    if key == 0:
        bg_color = (255, 255, 255, 255)
    elif key == 1:
        bg_color = (0, 0, 0, 255)
    else:
        flat = img_np.reshape(-1, img_np.shape[-1])
        m = (flat.mean(0) if key == 2 else np.median(flat, 0)).astype(int)
        bg_color = (int(m[0]), int(m[1]), int(m[2]), 255)
    bg = Image.new("RGBA", rgba.size, bg_color)
    out = Image.composite(rgba, bg, rgba).convert("RGB")
    return np.array(out) if was_np else out


def center_cut(img, center: Tuple[int, int], h: int, w: int):
    """Crop a 2h x 2w window around ``center``, clamped to the image
    (preprocess.py:239-264).  Returns (crop, has_obj)."""
    from PIL import Image

    was_np = isinstance(img, np.ndarray)
    arr = img if was_np else np.array(img)
    hh, ww = 2 * h, 2 * w
    H, W = arr.shape[0], arr.shape[1]
    if center[0] - hh // 2 < 0:
        h0 = 0
    elif center[0] + hh // 2 > H:
        h0 = max(0, H - hh)
    else:
        h0 = center[0] - hh // 2
    if center[1] - ww // 2 < 0:
        w0 = 0
    elif center[1] + ww // 2 > W:
        w0 = max(0, W - ww)
    else:
        w0 = center[1] - ww // 2
    out = arr[h0:h0 + min(H, hh), w0:w0 + min(W, ww)]
    has_obj = out.sum() > 30
    if not was_np:
        out = Image.fromarray(out)
    return out, has_obj


def swap_channels(img, rng: np.random.Generator):
    """Channels drawn with replacement (preprocess.py:381-390)."""
    from PIL import Image

    arr = np.array(to_pil(img))
    idx = rng.choice([0, 1, 2], 3, replace=True)
    return Image.fromarray(arr[:, :, idx])


def adjust_gamma(img, gamma: float, gain: float = 1.0):
    """preprocess.py:405-427"""
    table = [255 * gain * pow(v / 255.0, gamma) for v in range(256)] * 3
    return to_pil(img).point(table)


def degrade_resolution(img, ratio: float):
    """Down-up resize (preprocess.py:443-454)."""
    pil = to_pil(img)
    size = np.array(pil.size)
    new_size = (size * ratio).astype(int)
    return pil.resize(tuple(new_size), LANCZOS).resize(tuple(size), LANCZOS)


def color_jitter(img, rng: np.random.Generator, brightness=0.4, contrast=0.4,
                 saturation=0.4, hue=0.2):
    """torchvision-style jitter (reference lib/utils.py:58-59): PIL
    enhancers and an HSV hue shift, applied in random order.

    Each enhancer draws its factor, but all of them enhance by the last
    factor drawn: the JAX package's enhancer closures read the shared
    variable when they run (``tpuseg/data/augment.py:136-143``).  Kept so
    one generator state gives the same image in both packages."""
    from PIL import Image, ImageEnhance

    pil = to_pil(img)
    ops = []
    if brightness:
        f = 1 + rng.uniform(-brightness, brightness)
        ops.append(lambda im: ImageEnhance.Brightness(im).enhance(f))
    if contrast:
        f = 1 + rng.uniform(-contrast, contrast)
        ops.append(lambda im: ImageEnhance.Contrast(im).enhance(f))
    if saturation:
        f = 1 + rng.uniform(-saturation, saturation)
        ops.append(lambda im: ImageEnhance.Color(im).enhance(f))
    if hue:
        shift = rng.uniform(-hue, hue)

        def hue_op(im, shift=shift):
            hsv = np.array(im.convert("HSV"), dtype=np.int16)
            hsv[..., 0] = (hsv[..., 0] + int(shift * 255)) % 256
            return Image.fromarray(hsv.astype(np.uint8), "HSV").convert("RGB")

        ops.append(hue_op)
    for i in rng.permutation(len(ops)):
        pil = ops[i](pil)
    return pil


def grayscale(img, rng: np.random.Generator, p: float = 0.3):
    """RandomGrayscale (3-channel output)."""
    if rng.random() >= p:
        return to_pil(img)
    return to_pil(img).convert("L").convert("RGB")


def resize(img, height: int, width: int, interpolation=BILINEAR):
    return to_pil(img).resize((width, height), interpolation)


def random_resized_crop_params(size_wh: Tuple[int, int],
                               rng: np.random.Generator, scale=(0.08, 1.0),
                               ratio=(3.0 / 4.0, 4.0 / 3.0)):
    """(i, j, h, w) of a random-area, random-aspect crop with a centre
    square fallback (reference RandomResizedCrop.get_params,
    preprocess.py:107-138)."""
    w_img, h_img = size_wh
    area = w_img * h_img
    for _ in range(10):
        target_area = rng.uniform(*scale) * area
        aspect = rng.uniform(*ratio)
        w = int(round((target_area * aspect) ** 0.5))
        h = int(round((target_area / aspect) ** 0.5))
        if rng.random() < 0.5:
            w, h = h, w
        if w <= w_img and h <= h_img:
            i = int(rng.integers(0, h_img - h + 1))
            j = int(rng.integers(0, w_img - w + 1))
            return i, j, h, w
    w = min(w_img, h_img)
    return (h_img - w) // 2, (w_img - w) // 2, w, w


def random_resized_crop(img, out_height: int, out_width: int,
                        rng: np.random.Generator, interpolation=BILINEAR,
                        params=None):
    """Crop to a random size and aspect, then resize (reference
    RandomResizedCrop, preprocess.py:90-148).  The same ``params`` give the
    masks the same crop.  Returns (image, params)."""
    pil = to_pil(img)
    if params is None:
        params = random_resized_crop_params(pil.size, rng)
    i, j, h, w = params
    crop = pil.crop((j, i, j + w, i + h))
    return crop.resize((out_width, out_height), interpolation), params
