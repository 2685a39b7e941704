"""The port's checkpoint reader and flax -> torch weight bridge."""

from pathlib import Path

import flax.linen as fnn
import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import torch

from tpuseg_torch.configs import cvppp_config
from tpuseg_torch.models import ReSeg
from tpuseg_torch.utils.checkpoint_io import (
    adapt_cfg_to_checkpoint,
    load_stop_params,
    read_msgpack,
)
from tpuseg_torch.weights import from_flax, load_flax

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
