"""Synthetic CVPPP-style scenes (numpy only; own copy of
``tpuseg/data/synthetic.py::make_scene``).

Randomly placed and rotated ellipse "leaves" around a rosette centre with
exact per-instance masks, so a run on the card has inputs with ground
truth and needs no image files and no PIL.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def make_scene(
    rng: np.random.Generator,
    height: int = 256,
    width: int = 256,
    min_leaves: int = 3,
    max_leaves: int = 12,
    hard: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Returns (rgb uint8 (H,W,3), semantic (H,W) {0,1}, instances
    (H,W,N) {0,1}, n).  ``hard=True``: off-centre plants, wider leaf-size
    variance, wavy boundaries and tighter packing.  Draws the same random
    stream as the JAX package's copy, so one seed gives the same scene."""
    n = int(rng.integers(min_leaves, max_leaves + 1))
    yy, xx = np.mgrid[0:height, 0:width]
    cy, cx = height / 2.0, width / 2.0
    if hard:
        cy += rng.uniform(-0.15, 0.15) * height
        cx += rng.uniform(-0.15, 0.15) * width
    img = np.zeros((height, width, 3), np.float32)
    img[..., 0] = 60 + 20 * rng.random((height, width))
    img[..., 1] = 45 + 15 * rng.random((height, width))
    img[..., 2] = 35 + 12 * rng.random((height, width))
    instances = []
    for _ in range(n):
        ang = rng.random() * 2 * np.pi
        dmax = 0.26 if hard else 0.32
        dist = rng.uniform(0.08, dmax) * min(height, width)
        ecy = cy + np.sin(ang) * dist
        ecx = cx + np.cos(ang) * dist
        lo, hi = (0.04, 0.20) if hard else (0.06, 0.16)
        a = rng.uniform(lo, hi) * min(height, width)
        b = a * rng.uniform(0.35, 0.7)
        ca, sa = np.cos(ang), np.sin(ang)
        u = (xx - ecx) * ca + (yy - ecy) * sa
        v = -(xx - ecx) * sa + (yy - ecy) * ca
        r2 = (u / a) ** 2 + (v / b) ** 2
        if hard:
            theta = np.arctan2(v / max(b, 1e-6), u / max(a, 1e-6))
            wav = 1.0 + rng.uniform(0.05, 0.18) * np.sin(
                rng.integers(3, 7) * theta + rng.random() * 2 * np.pi
            )
            mask = r2 <= wav
        else:
            mask = r2 <= 1.0
        instances.append(mask.astype(np.uint8))
        g = rng.uniform(110, 200)
        shade = 1.0 - 0.5 * np.clip(r2, 0, 1)
        img[mask, 0] = (30 + 25 * rng.random()) * shade[mask]
        img[mask, 1] = g * (0.6 + 0.4 * shade[mask])
        img[mask, 2] = (25 + 30 * rng.random()) * shade[mask]
    instance = np.stack(instances, axis=-1)
    # later leaves occlude earlier ones
    claim = np.zeros((height, width), bool)
    for i in range(n - 1, -1, -1):
        m = instance[..., i].astype(bool) & ~claim
        instance[..., i] = m.astype(np.uint8)
        claim |= m
    keep = [i for i in range(n) if instance[..., i].sum() > 8]
    instance = instance[..., keep] if keep else np.zeros(
        (height, width, 1), np.uint8
    )
    n = instance.shape[-1]
    semantic = (instance.sum(-1) > 0).astype(np.uint8)
    rgb = np.clip(img + rng.normal(0, 3, img.shape), 0, 255).astype(np.uint8)
    return rgb, semantic, instance, n


def label_map(instances: np.ndarray) -> np.ndarray:
    """(H, W, N) instance masks -> (H, W) uint8 id map (1..N, 0 = bg)."""
    label = np.zeros(instances.shape[:2], np.uint8)
    for j in range(instances.shape[-1]):
        label[instances[..., j] > 0] = j + 1
    return label
