"""The port's inference slice as a whole against the JAX package: the
monolithic ``Predictor`` on ``tests/test_staged_extraction.py``'s small
configuration (64x64, n_filters=8, max_n_objects=8; the 192 window scales
to 48 with stride 16, so the windowed decode runs), float32 on the CPU.

Weights: the JAX init's shapes, every leaf drawn from a seeded numpy
stream at the init's scales (BN statistics not the trivial 0/1).  Both
sides get the same tree.  Id maps must agree on >= 99.9% of pixels (the
slack is for near-tie flips; exact equality is expected), fg and counts
exactly.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tpuseg.cli.common import build_model, init_variables
from tpuseg.configs import cvppp_config as jax_cvppp_config
from tpuseg.data.synthetic import make_scene
from tpuseg.evalm import metrics as jmetrics
from tpuseg.runtime.predict import Predictor as JaxPredictor
from tpuseg_torch.configs import cvppp_config
from tpuseg_torch.evalm import metrics as tmetrics
from tpuseg_torch.models import ReSeg
from tpuseg_torch.runtime.predict import Predictor, pack_masks, unpack_masks
from tpuseg_torch.utils.checkpoint_io import load_stop_params
from tpuseg_torch.weights import load_flax


def _small(cfg, **model_kw):
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, image_height=64, image_width=64,
                                 max_n_objects=8),
        model=dataclasses.replace(cfg.model, n_filters=8, **model_kw),
    )


def _draw(shapes, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(v.shape[:-1]))
            a = rng.normal(size=v.shape) / np.sqrt(fan_in)
        elif name == "var":
            a = rng.uniform(0.5, 1.5, v.shape)
        elif name in ("scale", "out_gain"):
            a = 1.0 + 0.1 * rng.normal(size=v.shape)
        else:
            a = 0.1 * rng.normal(size=v.shape)
        return a.astype(v.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def setup():
    cfg = _small(jax_cvppp_config())
    model = build_model(cfg)
    shapes = jax.eval_shape(lambda: init_variables(cfg, model, 0))
    variables = _draw(shapes, seed=0)
    rng = np.random.default_rng(0)
    imgs = np.stack([make_scene(rng, 64, 64, hard=True)[0]
                     for _ in range(4)]).astype(np.uint8)
    return variables, imgs


def _compare(variables, imgs, jax_model_kw, stop_params):
    jcfg = _small(jax_cvppp_config(), **jax_model_kw)
    jp = JaxPredictor(jcfg, build_model(jcfg), variables, batch_size=4,
                      staged=False, stop_params=stop_params)
    _, fg0, id0, n0 = jp.predict_batch_arrays(imgs, with_probs=False)
    fg0, id0, n0 = map(np.asarray, (fg0, id0, n0))

    tcfg = _small(cvppp_config(), **jax_model_kw)
    tree = variables
    if jax_model_kw:  # heads the configuration drops carry no weights
        tree = {col: {k: v for k, v in t.items()
                      if k not in ("count_head", "density_head")}
                for col, t in variables.items()}
    tp = Predictor(tcfg, load_flax(ReSeg(tcfg), tree), batch_size=4,
                   device="cpu", stop_params=stop_params)
    assert tp.dtype == torch.float32
    _, fg1, id1, n1 = tp.predict_batch_arrays(imgs)
    np.testing.assert_array_equal(fg1.numpy(), fg0)
    np.testing.assert_array_equal(n1.numpy(), n0)
    assert (id1.numpy() == id0).mean() >= 0.999
    return tp, id1, n1


def test_predictor_matches_jax(setup):
    variables, imgs = setup
    tp, _, n1 = _compare(variables, imgs, {}, None)
    assert tp.rounds_run >= 1 and int(n1.sum()) > 0


def test_predictor_matches_jax_with_stop_params_no_heads(setup):
    """Calibrated stopping rule (size-aware suppression) and the static
    budget: more rounds, every sample's extraction through the window."""
    variables, imgs = setup
    sp = load_stop_params()
    tp, id1, n1 = _compare(
        variables, imgs, dict(use_count_head=False, use_density_head=False),
        sp,
    )
    assert tp.rounds_run == 2  # ceil(8 / 4), nobody done after round 1
    # running every round without the per-round sync changes nothing
    tp.sync_rounds = False
    _, _, id2, n2 = tp.predict_batch_arrays(imgs)
    assert torch.equal(id1, id2) and torch.equal(n1, n2)


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(1)
    fg = torch.from_numpy(rng.integers(0, 2, (2, 8, 8)).astype(np.uint8))
    idmap = torch.from_numpy(rng.integers(0, 128, (2, 8, 8)).astype(np.uint8))
    fg1, id1 = unpack_masks(pack_masks(fg, idmap).numpy())
    np.testing.assert_array_equal(fg1, fg.numpy())
    np.testing.assert_array_equal(id1, idmap.numpy())


def test_metrics_match_jax():
    rng = np.random.default_rng(2)
    gt = rng.integers(0, 6, (3, 32, 32)).astype(np.int32)
    pred = np.where(rng.random((3, 32, 32)) < 0.8, gt,
                    rng.integers(0, 7, (3, 32, 32))).astype(np.int32)
    pred[2] = 0  # no predicted instances
    np.testing.assert_allclose(
        tmetrics.symmetric_best_dice_batch(gt, pred).numpy(),
        np.asarray(jmetrics.symmetric_best_dice_batch(gt, pred)), atol=1e-6)
    np.testing.assert_allclose(
        tmetrics.fg_dice_batch(gt > 0, pred > 0).numpy(),
        np.asarray(jmetrics.fg_dice_batch(gt > 0, pred > 0)), atol=1e-6)
    np.testing.assert_allclose(
        float(tmetrics.calc_sbd(gt[0], pred[0])),
        float(jmetrics.calc_sbd(gt[0], pred[0])), atol=1e-6)
    np.testing.assert_allclose(
        float(tmetrics.calc_dice(gt[1] > 0, pred[1] > 0)),
        float(jmetrics.calc_dice(gt[1] > 0, pred[1] > 0)), atol=1e-6)
    assert int(tmetrics.calc_dic(7, 4)) == int(jmetrics.calc_dic(7, 4)) == 3


def test_instance_colours_match_the_jax_cli():
    from tpuseg.cli.common import colorize_instances as jax_colorize
    from tpuseg_torch.cli.common import colorize_instances

    ins = np.random.default_rng(3).integers(0, 14, (16, 16)).astype(np.uint8)
    np.testing.assert_array_equal(colorize_instances(ins), jax_colorize(ins))
