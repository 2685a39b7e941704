"""The port's staged extraction dispatch against the JAX package's, on
``tests/test_staged_extraction.py``'s configuration (64x64, n_filters=8,
max_n_objects=8, G=4: two rounds at most; the 192 window scales to 48 with
stride 16, so the windowed decode runs), float32 on the CPU.

Both packages load one weight tree (``test_torch_predict._draw``: the JAX
init's shapes, leaves from a seeded numpy stream).  Tolerances: fg masks,
id maps, counts and every carry entry exactly equal (the carry's
``remaining`` is a 0/1 float map); staged equal to the port's monolithic
dispatch exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_predict import _draw

from tpuseg.cli.common import build_model, init_variables
from tpuseg.configs import cvppp_config as jax_cvppp_config
from tpuseg.data.synthetic import make_scene
from tpuseg.runtime.predict import Predictor as JaxPredictor
from tpuseg_torch.configs import cvppp_config
from tpuseg_torch.models import ReSeg
from tpuseg_torch.runtime.predict import Predictor, unpack_masks
from tpuseg_torch.weights import load_flax

torch.set_num_threads(2)

NO_HEADS = dict(use_count_head=False, use_density_head=False)


def _small(cfg, **model_kw):
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, image_height=64, image_width=64,
                                 max_n_objects=8),
        model=dataclasses.replace(cfg.model, n_filters=8, **model_kw),
    )


def _scenes(seed, n):
    rng = np.random.default_rng(seed)
    return np.stack([make_scene(rng, 64, 64, hard=True)[0]
                     for _ in range(n)]).astype(np.uint8)


@pytest.fixture(scope="module")
def weights():
    cfg = _small(jax_cvppp_config())
    shapes = jax.eval_shape(lambda: init_variables(cfg, build_model(cfg), 0))
    return _draw(shapes, seed=0)


def _pair(variables, staged, model_kw=None, batch_size=4):
    """(JAX predictor, port predictor) on one weight tree."""
    model_kw = model_kw or {}
    jcfg = _small(jax_cvppp_config(), **model_kw)
    jp = JaxPredictor(jcfg, build_model(jcfg), variables,
                      batch_size=batch_size, staged=staged)
    tree = variables
    if model_kw:  # heads the configuration drops carry no weights
        tree = {col: {k: v for k, v in t.items()
                      if k not in ("count_head", "density_head")}
                for col, t in variables.items()}
    tcfg = _small(cvppp_config(), **model_kw)
    tp = Predictor(tcfg, load_flax(ReSeg(tcfg), tree), batch_size=batch_size,
                   device="cpu", staged=staged)
    return jp, tp


def _port(variables, staged, batch_size=4):
    return _pair(variables, staged, batch_size=batch_size)[1]


def _equal(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.numpy() if torch.is_tensor(g) else np.asarray(g)
        assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


def test_staged_matches_jax_staged_and_port_monolithic(weights):
    imgs = _scenes(0, 4)
    jp, tp = _pair(weights, staged=True)
    want = jp.predict_batch_arrays(imgs, with_probs=False)
    got = tp.predict_batch_arrays(imgs, with_probs=False)
    assert got[0] is None and want[0] is None
    _equal(got[1:], want[1:])
    assert int(got[3].sum()) > 0  # instances were extracted
    plain = _port(weights, staged=False)
    _equal(got[1:], plain.predict_batch_arrays(imgs, with_probs=False)[1:])
    # the chunk sizes asked for are the JAX package's compiled round counts
    assert tp.round_chunks == set(jp._rounds_cache)
    # staged reads the budget once, then one done flag per continuation
    assert tp.host_syncs >= 1


def test_carry_after_one_round_equals_jax(weights):
    imgs = _scenes(1, 4)
    jp, tp = _pair(weights, staged=True)
    x = jnp.asarray(imgs)
    fg, sem_mask, budget, score, skips_t = jp._infer_prep(jp.variables, x)
    id_j, n_j, carry_j = jp._rounds_fn(1)(jp._decoder_variables(), sem_mask,
                                           score, skips_t, budget, None)
    prep = tp._infer_prep(torch.from_numpy(imgs))
    np.testing.assert_array_equal(prep[0].numpy(), np.asarray(fg))
    np.testing.assert_array_equal(prep[2].numpy(), np.asarray(budget))
    id_t, n_t, carry_t = tp._rounds(1, prep, None)
    _equal([id_t, n_t], [id_j, n_j])
    assert set(carry_t) == set(carry_j)
    for k, v in carry_j.items():
        v = np.asarray(v)
        got = carry_t[k].numpy()
        assert got.dtype == v.dtype, (k, got.dtype, v.dtype)
        np.testing.assert_array_equal(got, v.reshape(got.shape), err_msg=k)


def test_continuation_equals_one_shot(weights):
    """One round, then the rest from the carry, equals one call of every
    round, and both equal the JAX package's one shot."""
    imgs = _scenes(1, 4)
    jp, tp = _pair(weights, staged=True)
    rounds = tp.max_rounds
    assert rounds == 2
    prep = tp._infer_prep(torch.from_numpy(imgs))
    id_full, n_full, carry_full = tp._rounds(rounds, prep, None)
    _, _, carry = tp._rounds(1, prep, None)
    id2, n2, carry2 = tp._rounds(rounds - 1, prep, carry)
    assert torch.equal(id_full, id2) and torch.equal(n_full, n2)
    for k in carry_full:
        assert torch.equal(carry_full[k], carry2[k]), k
    fg, sem_mask, budget, score, skips_t = jp._infer_prep(
        jp.variables, jnp.asarray(imgs))
    id_j, n_j, _ = jp._rounds_fn(rounds)(jp._decoder_variables(), sem_mask,
                                          score, skips_t, budget, None)
    _equal([id_full, n_full], [id_j, n_j])


def test_staged_without_count_heads(weights):
    """No count or density head: the budget is the static cap, one chunk
    of every round; staged equals JAX staged and the port's monolithic."""
    imgs = _scenes(2, 2)
    jp, tp = _pair(weights, staged=True, model_kw=NO_HEADS, batch_size=2)
    want = jp.predict_batch_arrays(imgs, with_probs=False)
    got = tp.predict_batch_arrays(imgs, with_probs=False)
    _equal(got[1:], want[1:])
    assert tp.round_chunks == set(jp._rounds_cache) == {tp.max_rounds}
    assert tp.host_syncs == 1  # the budget alone
    tcfg = _small(cvppp_config(), **NO_HEADS)
    tree = {col: {k: v for k, v in t.items()
                  if k not in ("count_head", "density_head")}
            for col, t in weights.items()}
    plain = Predictor(tcfg, load_flax(ReSeg(tcfg), tree), batch_size=2,
                      device="cpu")
    _equal(got[1:], plain.predict_batch_arrays(imgs, with_probs=False)[1:])


@pytest.mark.parametrize("packed", [False, True])
def test_predict_batches_staged_matches_monolithic(weights, packed):
    """A window of three batches: one budget readback, one done readback
    a chunk; each batch's outputs equal the monolithic dispatch's and the
    JAX package's window."""
    batches = [_scenes(3, 4), _scenes(7, 4), _scenes(8, 4)]
    jp, tp = _pair(weights, staged=True)
    plain = _port(weights, staged=False)
    outs = tp.predict_batches_staged(batches, packed=packed)
    want = jp.predict_batches_staged([jnp.asarray(b) for b in batches],
                                     packed=packed)
    assert len(outs) == len(want) == 3
    # one budget readback, then one per continuation chunk of the window
    assert 1 <= tp.host_syncs <= tp.max_rounds
    for b, got, w in zip(batches, outs, want):
        _equal(got, w)
        if packed:
            fg, idmap = unpack_masks(got[0].numpy())
            counts = got[1]
        else:
            fg, idmap, counts = (t.numpy() for t in got)
        _, fg0, id0, n0 = plain.predict_batch_arrays(b, with_probs=False)
        np.testing.assert_array_equal(fg, fg0.numpy())
        np.testing.assert_array_equal(idmap, id0.numpy())
        np.testing.assert_array_equal(np.asarray(counts), n0.numpy())
    assert tp.round_chunks == set(jp._rounds_cache)


def test_predict_paths_window_two(weights, tmp_path):
    """``predict_paths(window=2)`` over 10 images (batches of 4, so two
    windows and a padded last batch) yields the monolithic path's results
    and the JAX package's staged ones, in order."""
    from PIL import Image

    imgs = _scenes(11, 10)
    paths = []
    for i, arr in enumerate(imgs):
        p = tmp_path / f"img_{i}.png"
        Image.fromarray(arr).save(p)
        paths.append(str(p))
    jp, tp = _pair(weights, staged=True)
    plain = _port(weights, staged=False)
    r_t = list(tp.predict_paths(paths, window=2))
    r_p = list(plain.predict_paths(paths, window=2))
    r_j = list(jp.predict_paths(paths, window=2))
    assert [r["path"] for r in r_t] == [r["path"] for r in r_j] == paths
    for a, b, c in zip(r_t, r_p, r_j):
        for k in ("fg_mask", "ins_mask", "image"):
            np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(a[k], c[k])
        assert a["n_objects"] == b["n_objects"] == c["n_objects"]
