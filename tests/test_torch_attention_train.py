"""The port's attention layers and BatchNorm in train mode against flax:
outputs and the running statistics a step leaves behind (atol 1e-5: float32
summation order).  NCHW on the port's side, NHWC on flax's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.nn import attention as jatt
from tpuseg.nn import blocks as jblk
from tpuseg_torch.nn import attention as tatt
from tpuseg_torch.nn import blocks as tblk
from tpuseg_torch.weights import load_flax, to_flax


def _init(flax_mod, seed, *inputs, **kw):
    shapes = jax.eval_shape(
        lambda *a: flax_mod.init(jax.random.PRNGKey(0), *a, **kw), *inputs)
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, v.shape).astype(v.dtype)
        return (0.3 * rng.normal(size=v.shape)).astype(v.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _nchw(a):
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _same_tree(got, want, atol=1e-5):
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(flat_w) == len(flat_g)
    for path, w in flat_w:
        np.testing.assert_allclose(
            flat_g[path], np.asarray(w), atol=atol, rtol=0,
            err_msg=jax.tree_util.keystr(path))


def test_bn_train_mode_keeps_the_biased_variance():
    """flax BatchNorm(momentum=0.9) stores the biased batch variance; at
    B=2 and 4x4 (n = 32) the unbiased one torch would store differs by
    3%."""
    x = (np.random.default_rng(0).normal(size=(2, 4, 4, 6)) * 2 + 1).astype(
        np.float32)
    mod = jblk.ConvBN(6)
    variables = _init(mod, 1, jnp.asarray(x))
    want, mut = mod.apply(variables, jnp.asarray(x), True,
                          mutable=["batch_stats"])
    tm = load_flax(tblk.ConvBN(6, 6), variables).train()
    got = tm(_nchw(x))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5, rtol=0)
    _same_tree(to_flax(tm)["batch_stats"], mut["batch_stats"])
    # torch's own BatchNorm2d would have stored the unbiased variance
    bn = torch.nn.BatchNorm2d(6).train()
    bn.load_state_dict(tm._BN_0.BatchNorm_0.state_dict())
    var0 = torch.from_numpy(np.array(
        variables["batch_stats"]["_BN_0"]["BatchNorm_0"]["var"]))
    bn.running_var.copy_(var0)
    bn(tm.Conv_0(_nchw(x)))
    assert (bn.running_var - tm._BN_0.BatchNorm_0.running_var).abs().max() > 1e-3


def test_running_stats_frozen_and_repeats():
    x = np.random.default_rng(2).normal(size=(2, 4, 4, 6)).astype(np.float32)
    mod = jblk.ConvBN(6)
    variables = _init(mod, 3, jnp.asarray(x))
    # K identical flax updates == one update under repeats=K
    v = variables
    for _ in range(3):
        _, mut = mod.apply(v, jnp.asarray(x), True, mutable=["batch_stats"])
        v = {"params": variables["params"], "batch_stats": mut["batch_stats"]}
    tm = load_flax(tblk.ConvBN(6, 6), variables).train()
    with tblk.running_stats(repeats=3):
        tm(_nchw(x))
    _same_tree(to_flax(tm)["batch_stats"], v["batch_stats"])
    before = {k: t.clone() for k, t in tm.state_dict().items()}
    with tblk.running_stats(frozen=True):
        tm(_nchw(x))
    for k, t in tm.state_dict().items():
        assert torch.equal(t, before[k]), k


def test_masked_batch_norm_train():
    """Masked moments with denominator |mask| + 1 and the reversed EMA
    ``running = 0.1 * running + 0.9 * batch``."""
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(2, 8, 8, 3)) + 0.5).astype(np.float32)
    mask = (rng.random((2, 8, 8, 1)) > 0.4).astype(np.float32)
    mask[1] = 0.0  # a sample with no foreground
    mod = jatt.MaskedBatchNorm()
    variables = _init(mod, 5, jnp.asarray(x), jnp.asarray(mask))
    want, mut = mod.apply(variables, jnp.asarray(x), jnp.asarray(mask), True,
                          mutable=["batch_stats"])
    # the bridge maps leaves by their module's name: nest under one
    holder = torch.nn.Module()
    holder.MaskedBatchNorm_0 = tatt.MaskedBatchNorm(3)
    load_flax(holder, {c: {"MaskedBatchNorm_0": t}
                       for c, t in variables.items()})
    tm = holder.MaskedBatchNorm_0.train()
    got = tm(_nchw(x), _nchw(mask))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-5, rtol=0)
    stats = to_flax(holder)["batch_stats"]["MaskedBatchNorm_0"]
    _same_tree(stats, mut["batch_stats"])
    # the usual way round (0.9 * running + 0.1 * batch) would be far off
    old = np.asarray(variables["batch_stats"]["mean"])
    new = stats["mean"]
    batch = (new - 0.1 * old) / 0.9
    assert np.abs((0.9 * old + 0.1 * batch) - new).max() > 1e-2
    with pytest.raises(ValueError):
        tm(_nchw(x))


def test_spatial_and_hard_attention_train():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 16, 16, 24)).astype(np.float32)
    sem = np.zeros((2, 16, 16, 1), np.float32)
    sem[:, 3:13, 2:14] = 1.0
    ins = np.zeros((2, 16, 16, 4), np.float32)
    ins[:, 3:8, 2:14, 0] = 1.0
    ins[:, 8:13, 2:8, 1] = 1.0
    ins[0, 8:13, 8:14, 2] = 1.0  # slot 3 empty everywhere, slot 2 in sample 1

    sp = jatt.SpatialAttention(d_model=24, reduction=2)
    v_sp = _init(sp, 7, jnp.asarray(x), jnp.asarray(sem))
    want_s, mut = sp.apply(v_sp, jnp.asarray(x), jnp.asarray(sem), train=True,
                           mutable=["batch_stats"])
    t_sp = load_flax(tatt.SpatialAttention(24, 24, 2), v_sp).train()
    got_s = t_sp(_nchw(x), _nchw(sem))
    np.testing.assert_allclose(_nhwc(got_s), np.asarray(want_s), atol=1e-5,
                               rtol=0)
    _same_tree(to_flax(t_sp)["batch_stats"], mut["batch_stats"])

    ha = jatt.HardAttention(d_k=12)
    v_ha = _init(ha, 8, want_s, jnp.asarray(sem), jnp.asarray(ins))
    (want_p, want_e), mut = ha.apply(
        v_ha, want_s, jnp.asarray(sem), jnp.asarray(ins), train=True,
        mutable=["batch_stats"])
    t_ha = load_flax(tatt.HardAttention(24, 12), v_ha).train()
    got_p, got_e = t_ha(_nchw(np.asarray(want_s)), _nchw(sem), _nchw(ins))
    np.testing.assert_allclose(_nhwc(got_e), np.asarray(want_e), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(_nhwc(got_p), np.asarray(want_p), atol=1e-6,
                               rtol=0)
    _same_tree(to_flax(t_ha)["batch_stats"], mut["batch_stats"])
    sums = got_p.sum(dim=(2, 3)).detach().numpy()
    np.testing.assert_allclose(sums[:, :2], 1.0, atol=1e-5)
    assert sums[1, 2] == 0.0 and (sums[:, 3] == 0.0).all()
