"""CLI plumbing: model construction and loading, instance colouring."""

from __future__ import annotations

import os

import numpy as np
import torch

from tpuseg_torch.configs import Config
from tpuseg_torch.models import ReSeg
from tpuseg_torch.runtime.checkpoint import read_model_state
from tpuseg_torch.utils.checkpoint_io import (
    adapt_cfg_to_checkpoint, adapt_cfg_to_heads, flatten, merge_restore,
    nest, read_msgpack,
)
from tpuseg_torch.weights import load_flax, to_flax

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


def _seeded_model(cfg: Config, seed: int = 0) -> ReSeg:
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return ReSeg(cfg)


def load_model(cfg: Config, model_path: str):
    """(cfg adapted to the checkpoint, float32 ``ReSeg``), loaded
    merge-style as the JAX CLIs' ``load_variables`` does: from a flax
    ``.msgpack`` file or from a train state ``runtime/checkpoint
    .save_checkpoint`` wrote, every stored leaf whose path and shape match
    overlays the init of the JAX package's distribution
    (:func:`init_model` at seed 0; ``utils/checkpoint_io.merge_restore``),
    and any other leaf keeps that init with a printed warning.  A path
    that does not exist gives torch's seeded random init (seed 0); any
    other file raises ``ValueError``."""
    if not os.path.exists(model_path):
        print(f"  [load] no checkpoint at {model_path!r} — random init "
              "(seed 0)")
        return cfg, _seeded_model(cfg)
    print(f"Loading model from {model_path}")
    if model_path.endswith(".msgpack") and os.path.isfile(model_path):
        cfg = adapt_cfg_to_checkpoint(cfg, model_path)
        model = init_model(cfg)
        return cfg, load_flax(model, merge_restore(to_flax(model),
                                                   read_msgpack(model_path)))
    state = read_model_state(model_path)
    cfg = adapt_cfg_to_heads(cfg, {k.split(".")[0] for k in state})
    model = init_model(cfg)
    init = {k: v.numpy() for k, v in model.state_dict().items()}
    merged = flatten(merge_restore(nest(init), nest(
        {k: v.numpy() for k, v in state.items()})))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in merged.items()})
    return cfg, model


def init_model(cfg: Config, seed: int = 0) -> ReSeg:
    """A float32 ``ReSeg`` whose every variable is drawn from the
    distribution the JAX package's ``init_variables`` draws it from (flax's
    defaults: each ``kernel`` truncated normal within 2 sigma with variance
    1 / fan_in, fan_in the product of all but its last axis; biases 0,
    BatchNorm scales 1, ``MaskedBatchNorm`` scales uniform in [0, 1), the
    density head's ``out_gain`` 1 and ``out_off`` 0, running means 0 and
    variances 1, the REINFORCE baseline 0), from ``numpy``'s generator
    seeded with ``seed``.  (``ReSeg(cfg)`` alone draws torch's default
    initialisation, another distribution.)"""
    model = _seeded_model(cfg, seed)
    rng = np.random.default_rng(seed)
    tree = to_flax(model)

    def draw(path, a):
        leaf, owner = path[-1], path[-2] if len(path) > 1 else ""
        if leaf == "kernel":
            std = np.sqrt(1.0 / np.prod(a.shape[:-1])) / .87962566103423978
            x = rng.standard_normal(a.shape)
            bad = np.abs(x) > 2.0
            while bad.any():
                x[bad] = rng.standard_normal(int(bad.sum()))
                bad = np.abs(x) > 2.0
            return (x * std).astype(np.float32)
        if leaf == "scale" and owner.startswith("MaskedBatchNorm"):
            return rng.random(a.shape).astype(np.float32)
        if leaf in ("scale", "var", "out_gain"):
            return np.ones_like(a)
        return np.zeros_like(a)

    def walk(node, path=()):
        return {k: walk(v, path + (k,)) if isinstance(v, dict)
                else draw(path + (k,), v) for k, v in node.items()}

    return load_flax(model, walk(tree))


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
