"""The one traffic generator: synthetic plant scenes, drawn from a seed by
the parameters of a mix file (``traffic/<mix>.json``).

A mix file holds:

- ``scene``: the arguments of :func:`make_scene` (``height``, ``width``,
  ``hard``, ``min_leaves``, ``max_leaves``);
- ``pool``: how many base scenes are drawn; their leaf counts run
  ``min_leaves`` .. ``max_leaves`` in turn (spread evenly over the range
  where the pool is smaller than it);
- ``pool_seed`` (optional): the seed the base scenes are drawn from, the
  same for every run seed, so that every seed asks the same work of the
  extraction rounds (whose number follows the scenes).  Without it the
  base scenes are drawn from the run seed;
- ``seeded_pool`` and ``seeded_batches`` (optional): a second pool of
  that many scenes, drawn from the run seed with leaf counts spread over
  the same range, and the batches made from it after the others.  They
  are timed with the rest and checked first, so that the seeds check
  different scenes while the fixed pool keeps the work steady;
- ``canvas`` (optional): ``[H, W]`` of the canvas each scene is
  zero-padded onto at its top left, as the program's bucketed inference
  pads a native-size image;
- ``labels``: whether a batch carries the training targets
  (``sem_onehot``, ``ins_masks``, ``n_objects``) beside the images.

The run seed draws the batches: the pool's scenes come in a stream of
seeded orders, each order holding every scene once, and the stream is cut
into batches, so that every run holds each scene equally often.  A
scene's every appearance takes the next of the flips and rotations that
keep its shape (8 for a square scene, 4 otherwise), so the rows of the
first batches all differ.

:func:`make_scene` is a frozen copy of the program's synthetic scene
(``data/synthetic.py::make_scene``): one seed gives the same scene.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np

TRAFFIC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "traffic")


def make_scene(rng: np.random.Generator, height: int = 256, width: int = 256,
               min_leaves: int = 3, max_leaves: int = 12, hard: bool = False
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """(rgb uint8 (H, W, 3), semantic (H, W) {0, 1}, instances (H, W, N)
    {0, 1}, N): ellipse leaves around a rosette centre, later leaves
    occluding earlier ones.  ``hard``: off-centre plants, a wider spread
    of leaf sizes, wavy boundaries and tighter packing."""
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


def load_mix(name: str) -> Dict:
    with open(os.path.join(TRAFFIC_DIR, name + ".json")) as f:
        return json.load(f)


def leaf_counts(mix: Dict, n: int = 0) -> List[int]:
    """The leaf counts of a pool of ``n`` (default ``pool``) scenes: the
    range in turn, or spread evenly over it where ``n`` is smaller."""
    s = mix["scene"]
    lo, hi = int(s["min_leaves"]), int(s["max_leaves"])
    n = n or int(mix["pool"])
    if n >= hi - lo + 1 or n < 2:
        return [lo + i % (hi - lo + 1) for i in range(n)]
    return [lo + int(round(i * (hi - lo) / (n - 1))) for i in range(n)]


def draw_scenes(rng: np.random.Generator, mix: Dict, counts) -> List[Tuple]:
    """The scenes of ``counts`` in an order ``rng`` draws, each drawn from
    ``rng`` with its count fixed."""
    s = mix["scene"]
    return [make_scene(rng, int(s["height"]), int(s["width"]),
                       min_leaves=int(n), max_leaves=int(n),
                       hard=bool(s["hard"]))
            for n in rng.permutation(counts)]


def draw_pool(mix: Dict, seed: int = 0) -> List[Tuple]:
    """The base scenes: from ``pool_seed`` where the mix fixes it, else
    from the run ``seed``."""
    fixed = mix.get("pool_seed")
    rng = np.random.default_rng(int(fixed) if fixed is not None
                                else [int(seed), 0])
    return draw_scenes(rng, mix, leaf_counts(mix))


def draw_seeded_pool(mix: Dict, seed: int) -> List[Tuple]:
    """The second pool (``seeded_pool`` scenes), always from the run
    seed."""
    rng = np.random.default_rng([int(seed), 3])
    return draw_scenes(rng, mix, leaf_counts(mix, int(mix["seeded_pool"])))


def n_transforms(height: int, width: int) -> int:
    return 8 if height == width else 4


def transform(a: np.ndarray, k: int) -> np.ndarray:
    """Transform ``k`` of an (H, W, ...) array: a quarter turn ``k % 4``
    times (only for ``k`` < 8 on a square array) or a flip; transforms
    0-3 keep any shape (none, up-down, left-right, both)."""
    if k == 0:
        return a
    if k < 4:
        return np.ascontiguousarray(a[::-1 if k & 1 else 1,
                                      ::-1 if k & 2 else 1])
    turned = np.rot90(a, 1, axes=(0, 1))
    return np.ascontiguousarray(transform(turned, k - 4))


def draw_rows(mix: Dict, seed: int, batch: int, n_batches: int,
              n_pool: int = 0, stream: int = 1) -> np.ndarray:
    """(n_batches, batch, 2) pairs (scene, transform), drawn from
    ``seed``: the stream of seeded orders of the ``n_pool`` (default
    ``pool``) scenes cut into batches; scene i's ``r``-th appearance takes
    transform ``(offset_i + r) % T``.  ``stream`` tells apart the draws
    of two pools from one seed."""
    s = mix["scene"]
    t = n_transforms(int(s["height"]), int(s["width"]))
    n_pool = n_pool or int(mix["pool"])
    rng = np.random.default_rng([int(seed), int(stream)])
    offset = rng.integers(0, t, n_pool)
    seen = np.zeros(n_pool, np.int64)
    flat: List[Tuple[int, int]] = []
    while len(flat) < n_batches * batch:
        for i in rng.permutation(n_pool):
            flat.append((int(i), int((offset[i] + seen[i]) % t)))
            seen[i] += 1
    return np.asarray(flat[:n_batches * batch], np.int64).reshape(
        n_batches, batch, 2)


def _canvas(mix: Dict, rgb: np.ndarray) -> np.ndarray:
    canvas = mix.get("canvas")
    if not canvas:
        return rgb
    out = np.zeros((canvas[0], canvas[1], 3), np.uint8)
    out[:rgb.shape[0], :rgb.shape[1]] = rgb
    return out


def _batches(mix: Dict, pool: List[Tuple], rows: np.ndarray, batch: int,
             max_n_objects: int, seeded: bool) -> List[Dict]:
    out = []
    for part in rows:
        imgs = np.stack([_canvas(mix, transform(pool[i][0], k))
                         for i, k in part])
        b = {"images": imgs, "rows": part,
             "seeded": np.full(len(part), seeded)}
        if mix.get("labels"):
            h, w = imgs.shape[1:3]
            sem = np.zeros((batch, h, w, 2), np.float32)
            ins = np.zeros((batch, h, w, max_n_objects), np.float32)
            n_obj = np.zeros((batch,), np.int32)
            for r, (i, k) in enumerate(part):
                _, semantic, instance, n = pool[i]
                n = min(n, max_n_objects)
                sem[r] = np.eye(2, dtype=np.float32)[transform(semantic, k)]
                ins[r, :, :, :n] = transform(instance, k)[..., :n]
                n_obj[r] = n
            b.update(sem_onehot=sem, ins_masks=ins, n_objects=n_obj)
        out.append(b)
    return out


def make_batches(mix: Dict, seed: int, batch: int, n_batches: int,
                 max_n_objects: int = 32) -> List[Dict]:
    """``n_batches`` host batches of ``batch`` rows from the base pool,
    then ``seeded_batches`` from the seeded pool: ``images`` (B, H, W, 3)
    uint8, ``rows`` (B, 2) (scene, transform), ``seeded`` (B,) bool
    (whether a row is the seeded pool's) and, for
    a mix with labels, ``sem_onehot`` (B, H, W, 2) float32, ``ins_masks``
    (B, H, W, max_n_objects) float32 and ``n_objects`` (B,) int32, the
    program's training layout."""
    rows = draw_rows(mix, seed, batch, n_batches)
    out = _batches(mix, draw_pool(mix, seed), rows, batch, max_n_objects,
                   False)
    extra = int(mix.get("seeded_batches", 0))
    if extra:
        n = int(mix["seeded_pool"])
        rows = draw_rows(mix, seed, batch, extra, n_pool=n, stream=4)
        out += _batches(mix, draw_seeded_pool(mix, seed), rows, batch,
                        max_n_objects, True)
    return out
