"""Input validation and numerical guards (port of
``tpuseg/utils/validation.py``): shape and dtype checks at the API
boundary, with the JAX package's messages, and finiteness guards on
tensors.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


class ValidationError(ValueError):
    pass


def _check(cond: bool, msg: str):
    if not cond:
        raise ValidationError(msg)


def _dtype_name(x) -> str:
    return str(x.dtype).replace("torch.", "")


def check_image_batch(images, n_channels=(3, 21)) -> None:
    """images: (B, H, W, C), numpy or tensor, with C in n_channels; uint8
    for C=3."""
    shape = tuple(images.shape)
    _check(images.ndim == 4, f"images must be (B,H,W,C), got {shape}")
    _check(shape[-1] in n_channels,
           f"images channels {shape[-1]} not in {n_channels}")
    if shape[-1] == 3:
        _check(images.dtype in (np.uint8, torch.uint8),
               f"raw RGB batches must be uint8, got {_dtype_name(images)}")


def check_batch(batch: Dict, n_classes: int, max_n_objects: int) -> None:
    """Validate a training batch (the collate output)."""
    for key in ("images", "sem_onehot", "ins_masks", "n_objects"):
        _check(key in batch, f"batch missing '{key}'")
    check_image_batch(batch["images"])
    b, h, w, _ = tuple(batch["images"].shape)
    sem, ins = tuple(batch["sem_onehot"].shape), tuple(batch["ins_masks"].shape)
    _check(sem == (b, h, w, n_classes),
           f"sem_onehot shape {sem} != {(b, h, w, n_classes)}")
    _check(ins == (b, h, w, max_n_objects),
           f"ins_masks shape {ins} != {(b, h, w, max_n_objects)}")
    _check(tuple(batch["n_objects"].shape) == (b,), "n_objects must be (B,)")
    _check(int(np.max(np.asarray(batch["n_objects"]))) <= max_n_objects,
           "n_objects exceeds max_n_objects")


def assert_finite(x: torch.Tensor, name: str = "tensor") -> torch.Tensor:
    """Raise ``FloatingPointError`` when ``x`` holds a NaN or an infinity
    (one host sync); returns ``x``."""
    if not bool(torch.isfinite(x).all()):
        raise FloatingPointError(f"non-finite values in {name}")
    return x


def nan_guard(x: torch.Tensor, value: float = 0.0) -> torch.Tensor:
    """NaNs replaced by ``value``."""
    return torch.where(torch.isnan(x), torch.full_like(x, value), x)
