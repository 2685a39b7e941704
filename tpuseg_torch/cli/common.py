"""CLI plumbing: model construction and loading, instance colouring."""

from __future__ import annotations

import os

import numpy as np
import torch

from tpuseg_torch.configs import Config
from tpuseg_torch.models import ReSeg
from tpuseg_torch.utils.checkpoint_io import adapt_cfg_to_checkpoint
from tpuseg_torch.weights import load_checkpoint

# matplotlib's "Spectral" colormap: 11 control colours, 256-entry table
_SPECTRAL = np.array([
    (0.6196078431372549, 0.00392156862745098, 0.25882352941176473),
    (0.8352941176470589, 0.24313725490196078, 0.30980392156862746),
    (0.9568627450980393, 0.42745098039215684, 0.2627450980392157),
    (0.9921568627450981, 0.6823529411764706, 0.3803921568627451),
    (0.996078431372549, 0.8784313725490196, 0.5450980392156862),
    (1.0, 1.0, 0.7490196078431373),
    (0.9019607843137255, 0.9607843137254902, 0.596078431372549),
    (0.6705882352941176, 0.8666666666666667, 0.6431372549019608),
    (0.4, 0.7607843137254902, 0.6470588235294118),
    (0.19607843137254902, 0.5333333333333333, 0.7411764705882353),
    (0.3686274509803922, 0.30980392156862746, 0.6352941176470588),
])
_LUT_N = 256


def load_model(cfg: Config, model_path: str):
    """(cfg adapted to the checkpoint, float32 ``ReSeg``).  A ``.msgpack``
    checkpoint is loaded strictly; any other path gives a seeded random
    init, as the JAX CLI's does."""
    if model_path.endswith(".msgpack") and os.path.isfile(model_path):
        cfg = adapt_cfg_to_checkpoint(cfg, model_path)
        print(f"Loading model from {model_path}")
        return cfg, load_checkpoint(ReSeg(cfg), model_path)
    print(f"  [load] no checkpoint at {model_path!r} — random init (seed 0)")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return cfg, ReSeg(cfg)


def spectral_colors(n: int) -> np.ndarray:
    """``plt.cm.Spectral(np.linspace(0, 1, n))`` as uint8 RGB, without
    matplotlib: the colormap's 256-entry table, indexed as it indexes."""
    if n <= 0:
        return np.zeros((0, 3), np.uint8)
    xp = np.linspace(0.0, 1.0, len(_SPECTRAL))
    grid = np.linspace(0.0, 1.0, _LUT_N)
    lut = np.stack([np.interp(grid, xp, _SPECTRAL[:, k]) for k in range(3)],
                   axis=-1)
    idx = np.clip((np.linspace(0, 1, n) * _LUT_N).astype(int), 0, _LUT_N - 1)
    return (lut[idx] * 255).astype(np.uint8)


def colorize_instances(ins_mask: np.ndarray) -> np.ndarray:
    """Each instance id painted with its Spectral colour (ids sorted)."""
    ids = sorted(set(np.unique(ins_mask).tolist()) - {0})
    colors = spectral_colors(len(ids))
    out = np.zeros((*ins_mask.shape, 3), np.uint8)
    for i, idx in enumerate(ids):
        out[ins_mask == idx] = colors[i]
    return out
