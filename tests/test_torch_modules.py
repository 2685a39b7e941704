"""Each module of the port's inference slice against its JAX counterpart,
at n_filters=8 and 32x32 / 64x64, in float32.

Weights are flax inits with every leaf redrawn from a seeded numpy stream
(so BN statistics are not the trivial 0/1) and carried across with
``from_flax``.  Tolerance: |got - want| <= 1e-4 * max(1, max|want|) —
float32 summation order only.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg import configs as jax_configs
from tpuseg.data import colorspace as jcs
from tpuseg.decoder import pyramid as jpy
from tpuseg.nn import attention as jatt
from tpuseg.nn import blocks as jblk
from tpuseg.nn.heads import L0Head as JL0Head
from tpuseg.nn.unet import UNet as JUNet
from tpuseg_torch import configs as t_configs
from tpuseg_torch.data import colorspace as tcs
from tpuseg_torch.decoder import pyramid as tpy
from tpuseg_torch.nn import attention as tatt
from tpuseg_torch.nn import blocks as tblk
from tpuseg_torch.nn.heads import L0Head
from tpuseg_torch.nn.unet import UNet
from tpuseg_torch.weights import load_flax


def _close(got, want, tol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _init(flax_mod, seed, *inputs, **kw):
    """Variables of ``flax_mod`` with every leaf drawn from numpy: N(0, 0.3)
    weights, variances in [0.5, 1.5].  Only the init's shapes are used."""
    shapes = jax.eval_shape(
        lambda *a: flax_mod.init(jax.random.PRNGKey(0), *a, **kw), *inputs
    )
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, v.shape).astype(v.dtype)
        return (0.3 * rng.normal(size=v.shape)).astype(v.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _nchw(a):
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2)


def _pair(flax_mod, torch_mod, *inputs, seed=0, **kw):
    """Drawn variables for ``flax_mod``, loaded into ``torch_mod``:
    (flax variables, torch module in eval mode)."""
    variables = _init(flax_mod, seed, *inputs, **kw)
    return variables, load_flax(torch_mod, variables).eval()


def test_configs_are_the_same_tree():
    assert dataclasses.asdict(t_configs.cvppp_config()) == dataclasses.asdict(
        jax_configs.cvppp_config())


def test_expand21_and_standardize():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(2, 32, 32, 3), dtype=np.uint8)
    img[0, :4, :4] = 0  # black and grey pixels hit the HSV edge cases
    img[0, 4:8, :4] = 128
    want = np.asarray(jcs.expand21(jnp.asarray(img)))
    got = tcs.expand21(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    want = np.asarray(jcs.image_ex_standardize(jnp.asarray(img)))
    got = tcs.image_ex_standardize(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


@pytest.mark.parametrize("name", [
    "ConvBN", "Conv1x1BN", "InvertedV1Residual", "InvertedResidual",
    "DoubleConv",
])
def test_blocks(name):
    x = np.random.default_rng(1).normal(size=(2, 16, 16, 8)).astype(np.float32)
    flax_mod = getattr(jblk, name)(8)
    torch_mod = getattr(tblk, name)(8, 8)
    variables, tm = _pair(flax_mod, torch_mod, jnp.asarray(x))
    want = flax_mod.apply(variables, jnp.asarray(x), False)
    with torch.no_grad():
        _close(_nhwc(tm(_nchw(x))), want)


def test_unet():
    x = np.random.default_rng(2).normal(size=(2, 32, 32, 21)).astype(np.float32)
    variables, tm = _pair(JUNet(n_filters=8), UNet(21, 8), jnp.asarray(x))
    want_dec, want_skips = jax.jit(JUNet(n_filters=8).apply)(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got_dec, got_skips = tm(_nchw(x))
    _close(_nhwc(got_dec), want_dec)
    for g, w in zip(got_skips, want_skips):
        _close(_nhwc(g), w)


def test_squeeze_excite_and_l0_head():
    x = np.random.default_rng(3).normal(size=(2, 16, 16, 8)).astype(np.float32)
    variables, tm = _pair(jatt.SqueezeExcite(), tatt.SqueezeExcite(8),
                          jnp.asarray(x))
    with torch.no_grad():
        _close(_nhwc(tm(_nchw(x))),
               jatt.SqueezeExcite().apply(variables, jnp.asarray(x)))
    variables, tm = _pair(JL0Head(), L0Head(8), jnp.asarray(x))
    with torch.no_grad():
        _close(_nhwc(tm(_nchw(x))), JL0Head().apply(variables, jnp.asarray(x)))


def test_spatial_and_hard_attention_score():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 32, 32, 24)).astype(np.float32)
    sem = (rng.random((2, 32, 32, 1)) > 0.4).astype(np.float32)
    sem[1] = 0.0  # empty-mask guard
    sp = jatt.SpatialAttention(d_model=24, reduction=2)
    v_sp, t_sp = _pair(sp, tatt.SpatialAttention(24, 24, 2), jnp.asarray(x),
                       jnp.asarray(sem))
    want_s = sp.apply(v_sp, jnp.asarray(x), jnp.asarray(sem))
    with torch.no_grad():
        got_s = t_sp(_nchw(x), _nchw(sem))
    _close(_nhwc(got_s), want_s)

    ha = jatt.HardAttention(d_k=12)
    v_ha, t_ha = _pair(ha, tatt.HardAttention(24, 12), want_s,
                       jnp.asarray(sem), jnp.asarray(sem), seed=5)
    want_p, want_e = ha.apply(v_ha, want_s, jnp.asarray(sem), jnp.asarray(sem))
    with torch.no_grad():
        got_e = t_ha(_nchw(np.asarray(want_s)), _nchw(sem))
        # given instance masks, the per-instance distributions come too
        got_p, got_e2 = t_ha(_nchw(np.asarray(want_s)), _nchw(sem), _nchw(sem))
    _close(_nhwc(got_e), want_e)
    assert torch.equal(got_e, got_e2)
    np.testing.assert_allclose(_nhwc(got_p), np.asarray(want_p), atol=1e-6,
                               rtol=0)


def test_prev_mask_gate_is_torch_bilinear_upsample():
    logits = np.random.default_rng(6).normal(size=(3, 12, 12, 2)).astype(
        np.float32) * 3
    want = jpy._prev_mask_gate(jnp.asarray(logits), (24, 24))
    got = tpy._prev_mask_gate(_nchw(logits), (24, 24))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-6, rtol=0)


def test_pyramid_helpers():
    rng = np.random.default_rng(7)
    full = (64, 64)
    pts = rng.integers(0, 64 * 64, size=6)
    jp, tp = jnp.asarray(pts, jnp.int32), torch.from_numpy(pts)
    for lvl_hw in [(4, 4), (16, 16), (64, 64)]:
        want = jpy.point_position_planes(jp, full, lvl_hw)
        np.testing.assert_array_equal(
            _nhwc(tpy.point_position_planes(tp, full, lvl_hw)), want)
    assert jpy.level_channels(8) == tpy.level_channels(8)
    assert jpy.n_position_extra(8, True, 1) == tpy.n_position_extra(8, True, 1)

    jw = jpy.window_origin(jp, full, 48, 16)
    tw = tpy.window_origin(tp, full, 48, 16)
    for a, b in zip(jw[:3], tw[:3]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert jw[3:] == tw[3:]
    _, _, onehot, n_r, n_c = jw
    toh = tw[2]
    ir, ic = tw[0], tw[1]
    want = jpy.point_position_planes_win(jp, full, (32, 32), jw[0] * 8,
                                         jw[1] * 8, 24)
    got = tpy.point_position_planes_win(tp, full, (32, 32), ir * 8, ic * 8, 24)
    np.testing.assert_array_equal(_nhwc(got), want)

    x = rng.normal(size=(6, 32, 32, 5)).astype(np.float32)
    want = jpy.select_window(jnp.asarray(x), onehot, n_r, n_c, 24, 8)
    got = tpy.select_window(_nchw(x), toh, n_r, n_c, 24, 8)
    np.testing.assert_array_equal(_nhwc(got), want)

    xb = rng.normal(size=(3, 32, 32, 5)).astype(np.float32)
    want = jpy.select_window_grouped(jnp.asarray(xb), onehot, 2, n_r, n_c,
                                     24, 8)
    got = tpy.select_window_grouped(_nchw(xb), toh, 2, n_r, n_c, 24, 8)
    np.testing.assert_array_equal(got.permute(0, 1, 3, 4, 2).numpy(), want)

    win = rng.normal(size=(6, 48, 48, 2)).astype(np.float32)
    want = jpy.paste_window(jnp.asarray(win), onehot, n_r, n_c, full, 16,
                            fill=jnp.asarray([1.0, -1.0]))
    got = tpy.paste_window(_nchw(win), toh, n_r, n_c, full, 16, [1.0, -1.0])
    np.testing.assert_array_equal(_nhwc(got), want)


@pytest.fixture(scope="module")
def decoder_pair():
    """A flax AttenDecoder (n_filters=8) and the port's, same weights."""
    cfg = jax_configs.cvppp_config().decoder
    rng = np.random.default_rng(8)
    b, H = 2, 64
    feats = [
        rng.normal(size=(b, H // f, H // f, c)).astype(np.float32)
        for f, c in zip((1, 2, 4, 8, 16), (8, 16, 32, 64, 128))
    ]
    sem = (rng.random((b, H, H, 1)) > 0.5).astype(np.float32)
    jdec = jpy.AttenDecoder(cfg=cfg, n_filters=8)
    pts0 = jnp.zeros((b,), jnp.int32)
    variables = _init(jdec, 9, pts0, [jnp.asarray(f) for f in feats],
                      jnp.asarray(sem))
    tdec = load_flax(
        tpy.AttenDecoder(t_configs.cvppp_config().decoder, 8), variables
    ).eval()
    return jdec, variables, tdec, feats, sem


@pytest.mark.parametrize("window", [0, 192])
def test_decode_split(decoder_pair, window):
    """transform_skips -> conv1_partials -> decode_split, with and without
    the windowed finest levels (192 at 256 scales to 48 at 64)."""
    jdec, variables, tdec, feats, sem = decoder_pair
    group = 2
    pts = np.array([5 * 64 + 7, 40 * 64 + 50, 63 * 64 + 63, 31 * 64 + 1])

    @jax.jit
    def run(variables, feats, sem, pts):
        skips_t = jdec.apply(variables, feats, method=jdec.transform_skips)
        parts = jdec.apply(variables, skips_t, sem,
                           method=jdec.conv1_partials)
        preds = jdec.apply(variables, pts, parts, group, window=window,
                           window_stride=64 if window else 0,
                           method=jdec.decode_split)
        return skips_t, parts, preds

    skips_t, parts, want = run(variables, [jnp.asarray(f) for f in feats],
                               jnp.asarray(sem), jnp.asarray(pts, jnp.int32))
    with torch.no_grad():
        t_skips = tdec.transform_skips([_nchw(f) for f in feats])
        for g, w in zip(t_skips, skips_t):
            _close(_nhwc(g), w)
        t_parts = tdec.conv1_partials(t_skips, _nchw(sem))
        for g, w in zip(t_parts, parts):
            _close(_nhwc(g), w)
        got = tdec.decode_split(torch.from_numpy(pts), t_parts, group,
                                window=window,
                                window_stride=64 if window else 0)
    assert len(got) == 5
    for g, w in zip(got, want):
        _close(_nhwc(g), w)
    assert got[-1].shape[2:] == (64, 64)
