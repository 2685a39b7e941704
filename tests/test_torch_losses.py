"""The port's losses against the JAX functions (rtol 1e-5): focal, cross
entropy, dice, and the decoder's mask / pyramid / entropy / eval pieces.
The port's image-shaped arguments are NCHW, the JAX package's NHWC.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.configs import cvppp_config as jax_cvppp_config
from tpuseg.decoder import instance as jins
from tpuseg.losses import dice as jdice
from tpuseg.losses import focal as jfocal
from tpuseg_torch.configs import cvppp_config
from tpuseg_torch.decoder import instance as tins
from tpuseg_torch.losses import dice as tdice
from tpuseg_torch.losses import focal as tfocal

RTOL = 1e-5


def _nchw(a):
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=1e-7)


@pytest.mark.parametrize("alpha,map_weight", [(0.0, 0), (0.25, 2.0)])
def test_focal_loss(alpha, map_weight):
    rng = np.random.default_rng(0)
    logits = (4 * rng.normal(size=(300, 2))).astype(np.float32)
    logits[:3] = [[40.0, -40.0], [-40.0, 40.0], [0.0, 0.0]]  # the 1e-7 clip
    t = (rng.random(300) > 0.5).astype(np.float32)
    want = jfocal.focal_loss(jnp.asarray(logits), jnp.asarray(t), gamma=2.0,
                             alpha=alpha, map_weight=map_weight)
    got = tfocal.focal_loss(torch.from_numpy(logits), torch.from_numpy(t),
                            gamma=2.0, alpha=alpha, map_weight=map_weight)
    _close(got, want)


@pytest.mark.parametrize("weights", [None, (0.3, 1.7, 1.0)])
def test_softmax_cross_entropy(weights):
    rng = np.random.default_rng(1)
    logits = (3 * rng.normal(size=(200, 3))).astype(np.float32)
    labels = rng.integers(0, 3, size=200).astype(np.int32)
    want = jfocal.softmax_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels),
        None if weights is None else jnp.asarray(weights))
    got = tfocal.softmax_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels), weights)
    _close(got, want)


@pytest.mark.parametrize("time", [1, 2])
@pytest.mark.parametrize("reduce", [True, False])
def test_dice_loss(time, reduce):
    rng = np.random.default_rng(2)
    logits = (2 * rng.normal(size=(3, 8, 8, 3))).astype(np.float32)
    onehot = np.eye(3, dtype=np.float32)[rng.integers(0, 3, size=(3, 8, 8))]
    mw = rng.random((3, 8, 8, 1)).astype(np.float32)
    for kw_j, kw_t in [
        ({}, {}),
        ({"map_weight": jnp.asarray(mw)}, {"map_weight": _nchw(mw)}),
        ({"optimize_bg": True, "weight": jnp.asarray([1.0, 2.0, 0.5])},
         {"optimize_bg": True, "weight": [1.0, 2.0, 0.5]}),
    ]:
        want = jdice.dice_loss(jnp.asarray(logits), jnp.asarray(onehot),
                               time=time, reduce=reduce, smooth=1.0, **kw_j)
        got = tdice.dice_loss(_nchw(logits), _nchw(onehot), time=time,
                              reduce=reduce, smooth=1.0, **kw_t)
        _close(got, want)
    want = jdice.dice_coefficient(jnp.asarray(logits), jnp.asarray(onehot),
                                  mask=jnp.asarray(mw), time=time)
    got = tdice.dice_coefficient(_nchw(logits), _nchw(onehot), mask=_nchw(mw),
                                 time=time)
    _close(got, want)


def test_decoder_loss_pieces():
    jcfg, tcfg = jax_cvppp_config().decoder, cvppp_config().decoder
    rng = np.random.default_rng(3)
    sizes = (2, 4, 8, 16, 32)
    preds = [(2 * rng.normal(size=(2, s, s, 2))).astype(np.float32)
             for s in sizes]
    targets = [(rng.random((2, s, s, 1)) > 0.6).astype(np.float32)
               for s in sizes]
    alpha = rng.random((2, 1024)).astype(np.float32)
    alpha[0, :5] = [0.0, 1.0, 1e-9, 1.0 - 1e-9, 0.5]  # the entropy clamp
    mask = (rng.random((2, 1024)) > 0.5).astype(np.float32)

    @jax.jit  # one compile instead of one per eager op
    def jax_side(preds, targets, alpha, mask):
        return {
            "mask_loss": jins.mask_loss(jcfg, preds[2], targets[2]),
            "pred_loss": jins.pred_loss(jcfg, preds, targets),
            "evaluate_1": jins.evaluate_masks(preds[-1], targets[-1], time=1),
            "evaluate_2": jins.evaluate_masks(preds[-1], targets[-1], time=2),
            "alpha_entropy": (jins.alpha_entropy(jcfg, alpha, mask),),
        }

    want = jax_side([jnp.asarray(p) for p in preds],
                    [jnp.asarray(t) for t in targets], jnp.asarray(alpha),
                    jnp.asarray(mask))
    t_preds, t_targets = [_nchw(p) for p in preds], [_nchw(t) for t in targets]
    got = {
        "mask_loss": tins.mask_loss(tcfg, t_preds[2], t_targets[2]),
        "pred_loss": tins.pred_loss(tcfg, t_preds, t_targets),
        "evaluate_1": tins.evaluate_masks(t_preds[-1], t_targets[-1], time=1),
        "evaluate_2": tins.evaluate_masks(t_preds[-1], t_targets[-1], time=2),
        "alpha_entropy": (tins.alpha_entropy(
            tcfg, torch.from_numpy(alpha), torch.from_numpy(mask)),),
    }
    for name in want:
        for g, w in zip(got[name], want[name]):
            _close(g, w)
