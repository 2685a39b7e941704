"""Debug-image dumps of the training loop (port of
``tpuseg/utils/debug_images.py``; the same files from the same arrays).

Per dump, for one batch sample: ``p_<level>.jpg`` (the level's binary
mask), ``pred_<level>.jpg`` (its foreground softmax), ``target_<level>.jpg``
(the pooled gold mask), ``proall.jpg`` (the merged attention score over
the foreground), ``pro.jpg`` (the glimpse distribution, the glimpse pixel
marked) and ``mas.jpg`` (the foreground mask).  Arrays are numpy in the
JAX package's NHWC layout.  Pillow is imported inside the functions.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def _to_u8(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32)
    mn, mx = float(x.min()), float(x.max())
    if mx > mn:
        x = (x - mn) / (mx - mn)
    return (x * 255).astype(np.uint8)


def write_pro_jpg(prob: np.ndarray, background: np.ndarray, path: str,
                  point: Optional[int] = None) -> None:
    """A probability map normalised over the background's foreground
    (0 elsewhere), grey, with the flat pixel ``point`` marked blue."""
    from PIL import Image

    h, w = prob.shape[-2:] if prob.ndim > 2 else prob.shape
    pro = np.asarray(prob, np.float32).reshape(h, w)
    back = np.asarray(background, np.float32).reshape(h, w)
    masked = np.where(back > 0, pro, np.nan)
    mn, mx = np.nanmin(masked), np.nanmax(masked)
    denom = (mx - mn) if mx > mn else 1.0
    norm = np.where(back > 0, (pro - mn) / denom, 0.0)
    rgb = np.stack([norm] * 3, axis=-1)
    if point is not None:
        rgb[point // w, point % w] = [0, 0, 1]
    Image.fromarray((rgb * 255).astype(np.uint8)).save(path)


def write_pn_jpg(p_n: np.ndarray, background: np.ndarray, path: str) -> None:
    """A square background in grey with ``p_n > 0.5`` in its blue channel."""
    from PIL import Image

    back = np.asarray(background, np.float32)
    side = int(back.size ** 0.5)
    back = back.reshape(side, side) * 255
    pn = (np.asarray(p_n, np.float32).reshape(side, side) > 0.5) * back
    rgb = np.stack([back, back, pn], axis=-1).astype(np.uint8)
    Image.fromarray(rgb).save(path)


def dump_pyramid_debug(
    out_dir: str,
    preds: Sequence[np.ndarray],     # per level (B, h, w, 2) logits
    targets: Sequence[np.ndarray],   # per level (B, h, w, 1)
    pro: np.ndarray,                 # (B, H, W, 1) merged attention
    mask: np.ndarray,                # (B, H, W, 1) fg mask
    alpha: Optional[np.ndarray] = None,
    sample_idx: int = 0,
    point: Optional[int] = None,
) -> None:
    """The per-level binary / softmax / target dumps and the attention
    maps of sample ``sample_idx``, into ``out_dir`` (made if missing)."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    b = min(sample_idx, preds[0].shape[0] - 1)
    for f, (p, t) in enumerate(zip(preds, targets)):
        binary = (p[b, :, :, 1] > p[b, :, :, 0]).astype(np.uint8) * 255
        Image.fromarray(binary).save(os.path.join(out_dir, f"p_{f}.jpg"))
        e = np.exp(p[b] - p[b].max(-1, keepdims=True))
        soft = (e / e.sum(-1, keepdims=True))[:, :, 1]
        Image.fromarray(_to_u8(soft)).save(os.path.join(out_dir,
                                                        f"pred_{f}.jpg"))
        Image.fromarray(_to_u8(t[b, :, :, 0])).save(
            os.path.join(out_dir, f"target_{f}.jpg"))
    write_pro_jpg(pro[b, :, :, 0], mask[b, :, :, 0],
                  os.path.join(out_dir, "proall.jpg"))
    if alpha is not None:
        write_pro_jpg(alpha[b].reshape(pro.shape[1], pro.shape[2]),
                      mask[b, :, :, 0], os.path.join(out_dir, "pro.jpg"),
                      point)
    Image.fromarray(
        (np.asarray(mask[b, :, :, 0]) * 255).astype(np.uint8)
    ).save(os.path.join(out_dir, "mas.jpg"))
