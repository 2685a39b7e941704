"""The port's checkpoint reader and flax -> torch weight bridge."""

from pathlib import Path

import flax.linen as fnn
import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg_torch.configs import cvppp_config
from tpuseg_torch.models import ReSeg
from tpuseg_torch.utils.checkpoint_io import (
    adapt_cfg_to_checkpoint,
    load_stop_params,
    read_msgpack,
)
from tpuseg_torch.weights import from_flax, grads_to_flax, load_flax, to_flax

CKPT = Path(__file__).resolve().parents[1] / "assets" / "synthetic_ckpt.msgpack"


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def test_reader_matches_flax_msgpack_restore():
    want = dict(_leaves(flax.serialization.msgpack_restore(CKPT.read_bytes())))
    got = dict(_leaves(read_msgpack(CKPT)))
    assert len(got) == 757
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == w.dtype, path
        assert g.tobytes() == np.asarray(w).tobytes(), path


def test_reader_reads_numpy_scalar_leaves():
    """flax packs a numpy scalar leaf as ext type 3 holding the (shape,
    dtype, bytes) triple of its 0-d array."""
    tree = {"a": {"s": np.float32(1.5), "i": np.int32(-7)},
            "b": np.arange(6, dtype=np.float32).reshape(2, 3)}
    want = flax.serialization.msgpack_restore(
        flax.serialization.to_bytes(tree))
    got = read_msgpack(flax.serialization.to_bytes(tree))
    for path, w in _leaves(want):
        g = dict(_leaves(got))[path]
        assert type(g) is type(w) and g.dtype == w.dtype, path
        assert np.asarray(g).tobytes() == np.asarray(w).tobytes(), path


def test_checkpoint_loads_every_leaf_into_reseg():
    ckpt = read_msgpack(CKPT)
    sd = from_flax(ckpt)
    model = ReSeg(cvppp_config())
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert missing == [] and unexpected == []
    # every flax leaf became exactly one entry (plus a BN step counter
    # per torch BatchNorm, which flax does not keep)
    n_bn = sum(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())
    assert len(sd) == 757 + n_bn
    w = ckpt["params"]["decoder"]["glimpse"]["bone"]["up_atten1"]["dil1a"][
        "Conv_0"]["kernel"]
    got = model.decoder.bone.up_atten1.dil1a.Conv_0.weight.detach().numpy()
    np.testing.assert_array_equal(got[:, :, 0, 0], w[0, 0].T)


def test_to_flax_is_the_inverse_of_load_flax():
    """``to_flax(load_flax(m, v))`` equals ``v`` leaf for leaf (names,
    shapes, dtypes, bytes), and ``grads_to_flax`` gives the ``params``
    tree's structure with the same layout map."""
    ckpt = read_msgpack(CKPT)
    model = load_flax(ReSeg(cvppp_config()), ckpt)
    want, got = dict(_leaves(ckpt)), dict(_leaves(to_flax(model)))
    assert got.keys() == want.keys() and len(got) == 757
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == w.dtype, path
        assert g.tobytes() == np.ascontiguousarray(w).tobytes(), path
    up = model.decoder.bone.up_atten1.up.weight  # ConvTranspose (in, out, kh, kw)
    up.grad = torch.arange(up.numel(), dtype=torch.float32).reshape(up.shape)
    grads = dict(_leaves(grads_to_flax(model)))
    assert grads.keys() == dict(_leaves(ckpt["params"])).keys()
    g = grads[("decoder", "glimpse", "bone", "up_atten1", "up", "kernel")]
    np.testing.assert_array_equal(
        g, up.grad.numpy()[:, :, ::-1, ::-1].transpose(2, 3, 0, 1))
    assert not grads[("base", "inc", "InvertedV1Residual_0", "Conv_0",
                      "kernel")].any()  # no gradient yet: zeros


def test_adapt_cfg_and_stop_params_match_jax_helpers():
    from tpuseg.cli.common import adapt_cfg_to_checkpoint as jax_adapt
    from tpuseg.cli.common import load_stop_params as jax_stop
    from tpuseg.configs import cvppp_config as jax_cfg

    assert load_stop_params() == jax_stop() == (0.006, 6, 1.3, -1.0)
    got = adapt_cfg_to_checkpoint(cvppp_config(), str(CKPT)).model
    want = jax_adapt(jax_cfg(), str(CKPT)).model
    assert (got.use_count_head, got.use_density_head) == (
        want.use_count_head, want.use_density_head) == (True, True)


class _FlaxUp(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return fnn.ConvTranspose(5, (2, 2), strides=(2, 2))(x)


class _TorchUp(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.ConvTranspose_0 = torch.nn.ConvTranspose2d(3, 5, 2, stride=2)

    def forward(self, x):
        return self.ConvTranspose_0(x)


def test_conv_transpose_needs_the_spatial_flip():
    x = np.random.default_rng(0).normal(size=(2, 4, 6, 3)).astype(np.float32)
    variables = _FlaxUp().init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(_FlaxUp().apply(variables, jnp.asarray(x)))
    variables = jax.tree.map(np.asarray, variables)
    model = load_flax(_TorchUp(), variables)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = model(xt).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        # the same kernel without the flip gives another function
        model.ConvTranspose_0.weight.copy_(
            model.ConvTranspose_0.weight.flip(2, 3))
        unflipped = model(xt).permute(0, 2, 3, 1).numpy()
    assert np.abs(unflipped - want).max() > 1e-2


def _sru_variables(kind):
    """(flax variables of a JAX SRU module from its ``init``, the port's
    module of the same configuration)."""
    from tpuseg.nn import sru as jsru
    from tpuseg_torch.nn import SRU, SRUCell

    if kind == "sru-cell":
        kw, jmod, tmod = dict(n_in=6, n_out=4), jsru.SRUCell, SRUCell
    elif kind == "sru-uni":
        kw = dict(input_size=6, hidden_size=6, num_layers=2)
        jmod, tmod = jsru.SRU, SRU
    else:
        kw = dict(input_size=6, hidden_size=5, num_layers=2,
                  bidirectional=True, n_proj=3, use_layer_norm=True)
        jmod, tmod = jsru.SRU, SRU
    x = jnp.zeros((3, 2, 6), jnp.float32)
    variables = jax.jit(jmod(**kw).init)(jax.random.PRNGKey(4), x)
    return jax.tree.map(np.asarray, variables), tmod(**kw)


@pytest.mark.parametrize("kind", ["reseg", "sru-cell", "sru-uni",
                                  "sru-bi-proj-ln"])
def test_round_trip_leaf_for_leaf(kind):
    """``to_flax(load_flax(m, v))`` equals ``v`` (names, shapes, dtypes,
    bytes) for the ``ReSeg`` checkpoint, as before the SRU leaves were
    taught, and for SRU trees: a bare cell (leaves at the root), a stack,
    and a bidirectional stack with projections and LayerNorms."""
    if kind == "reseg":
        variables, model = read_msgpack(CKPT), ReSeg(cvppp_config())
    else:
        variables, model = _sru_variables(kind)
    model = load_flax(model, variables)
    want, got = dict(_leaves(variables)), dict(_leaves(to_flax(model)))
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == w.dtype, path
        assert g.tobytes() == np.ascontiguousarray(w).tobytes(), path
    grads = dict(_leaves(grads_to_flax(model)))
    assert grads.keys() == dict(_leaves(variables["params"])).keys()


def test_sru_leaves_map_untransposed_and_layer_norm_scale_to_weight():
    """An SRU cell's ``weight`` is used as ``x @ weight`` on both sides, so
    it passes as it is (a Dense ``kernel`` would be transposed); ``ln{i}``'s
    ``scale`` becomes ``weight``; the LayerNorm keeps flax's eps 1e-6."""
    variables, model = _sru_variables("sru-bi-proj-ln")
    sd = from_flax(variables)
    p = variables["params"]
    np.testing.assert_array_equal(sd["cell0.weight"].numpy(),
                                  p["cell0"]["weight"])
    np.testing.assert_array_equal(sd["cell1.weight_proj"].numpy(),
                                  p["cell1"]["weight_proj"])
    np.testing.assert_array_equal(sd["ln1.weight"].numpy(), p["ln1"]["scale"])
    assert "ln1.scale" not in sd and model.ln1.eps == 1e-6
    assert sd["cell0.weight"].shape == (3, 2 * 5 * 4)  # rows, bidir*d*k
    model.load_state_dict(sd, strict=True)
