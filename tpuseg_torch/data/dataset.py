"""Batch assembly (own copy of ``tpuseg/data/dataset.py``): the reference's
``AlignCollate`` (``lib/dataset.py:98-379``).

Training mode runs the host augmentation stack per sample (resolution
degrade, flips, transpose, 90-degree and small rotations, centre cut,
photometric jitter), then resizes the image (bilinear) and every instance
mask (nearest) to the target size, pads the instance axis to
``max_n_objects`` and pads a short batch by repeating sample 0.  Outputs
are NHWC numpy arrays, the layout ``runtime/train.py`` takes: images
``(B, H, W, 3)`` uint8 (the 21-channel expansion runs on the device),
``sem_onehot (B, H, W, n_classes)`` and ``ins_masks (B, H, W, max_n)``
float32, ``n_objects (B,)`` int32.  All randomness flows from one
``numpy.random.Generator``, drawn in the JAX package's order.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Optional

import numpy as np

from tpuseg_torch.configs import DataConfig
from tpuseg_torch.data import augment as A


@dataclasses.dataclass
class Batch:
    images: np.ndarray      # (B, H, W, 3) uint8
    sem_onehot: np.ndarray  # (B, H, W, n_classes) float32
    ins_masks: np.ndarray   # (B, H, W, max_n) float32
    n_objects: np.ndarray   # (B,) int32

    def asdict(self):
        return {
            "images": self.images,
            "sem_onehot": self.sem_onehot,
            "ins_masks": self.ins_masks,
            "n_objects": self.n_objects,
        }


def otsu_threshold(gray: np.ndarray) -> float:
    """Otsu's threshold of a grayscale [0, 1] image (the reference uses
    skimage.filters.threshold_otsu, dataset.py:86-88)."""
    hist, edges = np.histogram(gray.reshape(-1), bins=256, range=(0.0, 1.0))
    hist = hist.astype(np.float64)
    centers = (edges[:-1] + edges[1:]) / 2
    w0 = np.cumsum(hist)
    w1 = w0[-1] - w0
    m0 = np.cumsum(hist * centers)
    mu0 = np.where(w0 > 0, m0 / np.maximum(w0, 1e-12), 0)
    mu1 = np.where(w1 > 0, (m0[-1] - m0) / np.maximum(w1, 1e-12), 0)
    between = w0 * w1 * (mu0 - mu1) ** 2
    return float(centers[int(np.argmax(between))])


class TransferDataset:
    """An image folder whose foreground masks come from an Otsu threshold
    (the reference's domain-transfer ``TransferDataset``,
    dataset.py:78-95); one instance per image."""

    EXTS = (".png", ".jpg", ".jpeg", ".bmp")

    def __init__(self, img_path: str):
        self.samples = sorted(
            os.path.join(root, f)
            for root, _, files in os.walk(img_path)
            for f in files
            if f.lower().endswith(self.EXTS)
        )

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i: int):
        from PIL import Image

        img = Image.open(self.samples[i]).convert("RGB")
        arr = np.asarray(img, np.float32) / 255.0
        gray = arr @ np.array([0.2125, 0.7154, 0.0721], np.float32)
        semantic = (gray >= otsu_threshold(gray)).astype(np.uint8)
        return img, semantic, semantic[:, :, None], 1


class AlignCollate:
    """``mode``:

    * ``"training"``: the full host augmentation stack;
    * ``"test"``: resize and pad only;
    * ``"training_host_only"``: only the transforms whose output shape
      depends on the draw (resolution degrade, small rotation with a random
      background, centre cut), for a step that runs the rest on the device
      (``data/device_aug.py``).  A non-square target keeps transpose and
      rot90 here too, since the device path needs H == W."""

    def __init__(self, mode: str, cfg: DataConfig, batch_size: int):
        if mode not in ("training", "test", "training_host_only"):
            raise ValueError(f"unknown AlignCollate mode {mode!r}")
        self.mode = mode
        self.cfg = cfg
        self.batch_size = batch_size

    def _preprocess(self, image, semantic, instance, rng: np.random.Generator):
        """One sample (reference dataset.py:175-325)."""
        cfg = self.cfg
        H, W = cfg.image_height, cfg.image_width
        if self.mode in ("training", "training_host_only"):
            full = self.mode == "training"
            host_sq = full or H != W
            anns: List[np.ndarray] = [instance[:, :, i]
                                      for i in range(instance.shape[2])]

            def each(fn, *args, **kw):
                nonlocal anns, semantic
                anns = [fn(a, *args, **kw) for a in anns]
                semantic = fn(semantic, *args, **kw)

            if cfg.resolution:
                ratio = float(rng.choice(np.arange(0.7, 1.3, 0.05)))
                image = A.degrade_resolution(image, ratio)
            if full and cfg.hflip and rng.random() < 0.5:
                image = A.hflip(image)
                each(A.hflip)
            if full and cfg.vflip and rng.random() < 0.5:
                image = A.vflip(image)
                each(A.vflip)
            if host_sq and cfg.transpose and rng.random() < 0.5:
                image = A.transpose(image)
                each(A.transpose)
            if host_sq and cfg.rot90:
                angle = int(rng.choice([0, 90, 180, 270]))
                image = A.rotate(image, angle, A.BILINEAR, expand=True)
                each(A.rotate, angle, A.NEAREST, expand=True)
            if cfg.rotation:
                angle = int(rng.random() * 10)
                if rng.random() >= 0.5:
                    angle = -angle
                image = A.rotate_with_random_bg(image, angle, rng, A.BILINEAR,
                                                True)
                each(A.rotate, angle, A.NEAREST, expand=True)
            if cfg.center_cut:
                ins_all = np.sum(np.stack(anns, -1).astype(np.float32), axis=-1)
                centers = np.argwhere(ins_all == 1)
                if len(centers):
                    center = tuple(centers[int(rng.integers(len(centers)))])
                    image, _ = A.center_cut(image, center, H, W)
                    kept = []
                    for a in anns:
                        a2, has_obj = A.center_cut(a, center, H, W)
                        if has_obj:
                            kept.append(a2)
                    anns = kept
                    semantic, _ = A.center_cut(semantic, center, H, W)
            if full and cfg.color_jitter:
                image = A.color_jitter(image, rng)
            if full and cfg.gamma:
                image = A.adjust_gamma(image, rng.random() * 0.6 + 0.7)
            if full and cfg.channel_swap and rng.random() < 0.5:
                image = A.swap_channels(image, rng)
            if full and cfg.grayscale:
                image = A.grayscale(image, rng, p=0.3)
            instance = (
                np.stack(anns, axis=-1) if anns
                else np.zeros((*np.array(semantic).shape[:2], 0), np.uint8)
            )

        n_objects = instance.shape[2]
        image = np.array(A.resize(image, H, W, A.BILINEAR).convert("RGB"))
        ins_resized = [np.array(A.resize(instance[:, :, i], H, W, A.NEAREST))
                       for i in range(n_objects)]
        for _ in range(cfg.max_n_objects - n_objects):
            ins_resized.append(np.zeros((H, W), np.uint8))
        instance = np.stack(ins_resized[:cfg.max_n_objects], axis=-1)
        semantic = np.array(A.resize(np.asarray(semantic), H, W, A.NEAREST))
        return image, semantic, instance, min(n_objects, cfg.max_n_objects)

    def __call__(self, samples,
                 rng: Optional[np.random.Generator] = None) -> Batch:
        """samples: a sequence of (PIL image, semantic, instance,
        n_objects)."""
        rng = rng or np.random.default_rng()
        samples = list(samples)
        while len(samples) < self.batch_size:  # dataset.py:330-333
            samples.append(samples[0])
        out = [self._preprocess(img, sem, ins, rng)
               for img, sem, ins, _ in samples]
        images, sems, inss, n_objs = zip(*out)
        sem_idx = np.stack(sems).astype(np.int64)
        onehot = np.eye(self.cfg.n_classes, dtype=np.float32)[
            np.clip(sem_idx, 0, self.cfg.n_classes - 1)]
        return Batch(
            images=np.stack(images).astype(np.uint8),
            sem_onehot=onehot,
            ins_masks=np.stack(inss).astype(np.float32),
            n_objects=np.asarray(n_objs, np.int32),
        )


def batches(dataset, collate: AlignCollate, batch_size: int, shuffle: bool,
            seed: int, epoch: int = 0,
            drop_last: bool = False) -> Iterator[dict]:
    """A deterministic epoch over an indexable dataset, in one thread."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
    order = np.arange(len(dataset))
    if shuffle:
        rng.shuffle(order)
    for start in range(0, len(order), batch_size):
        idx = order[start:start + batch_size]
        if drop_last and len(idx) < batch_size:
            return
        yield collate([dataset[int(i)] for i in idx], rng=rng).asdict()
