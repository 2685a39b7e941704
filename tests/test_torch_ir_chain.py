"""``ir_chain`` in the port: the plain version against the JAX kernel (Pallas
interpret mode) and the flax ``dil1a..dil2b`` blocks, on the committed
checkpoint's real decoder weights at full widths (C = 256/128/64/32/32) and
small spatial sizes; the Hopper kernel against the plain version on the
card.

JAX is imported inside the tests that use it, so the card test runs where
JAX is absent: ``pytest --noconftest -m cuda tests/test_torch_ir_chain.py``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from tpuseg_torch.kernels.ir_chain import (
    ir_chain,
    ir_chain_plain,
    stack_chain_params,
)
from tpuseg_torch.nn.blocks import InvertedResidual
from tpuseg_torch.utils.checkpoint_io import read_msgpack
from tpuseg_torch.weights import load_flax

CKPT = Path(__file__).resolve().parents[1] / "assets" / "synthetic_ckpt.msgpack"
CHANNELS = (256, 128, 64, 32, 32)
BLOCKS = ("dil1a", "dil1b", "dil2a", "dil2b")
# (pyramid level, H, W); 13 rows is not a multiple of any tile height
SHAPES = [(0, 8, 8), (1, 8, 16), (2, 13, 12), (3, 16, 16), (4, 24, 24)]
# (N, H, W) at every width on the card: H, W not multiples of the tiles
# (8 x 8, 8 x 16 and 16 x 16 at some width), one image smaller than a
# tile, and N = 1 with fewer tiles than a persistent grid has blocks
RAGGED = [(5, 20, 28), (3, 40, 24), (1, 20, 28), (2, 13, 11), (1, 5, 3)]


@pytest.fixture(scope="module")
def ckpt():
    return read_msgpack(CKPT)


def _block_vars(ckpt, lvl, name):
    def sub(col):
        return ckpt[col]["decoder"]["glimpse"]["bone"][f"up_atten{lvl}"][name]

    return {"params": sub("params"), "batch_stats": sub("batch_stats")}


def _torch_params(ckpt, lvl, dtype=torch.float32):
    c = CHANNELS[lvl]
    blocks = []
    for name in BLOCKS:
        b = load_flax(InvertedResidual(c, c), _block_vars(ckpt, lvl, name))
        blocks.append(b.eval())
    return stack_chain_params(blocks, dtype=dtype)


def _inputs(lvl, n, h, w, seed):
    rng = np.random.default_rng(seed)
    c = CHANNELS[lvl]
    x = rng.normal(size=(n, h, w, c)).astype(np.float32)
    # level 0 is the pyramid's first level: no mid-chain skip
    x1u = rng.normal(size=(n, h, w, c)).astype(np.float32) if lvl else None
    return x, x1u


@pytest.mark.parametrize("lvl,h,w", SHAPES)
def test_plain_matches_jax_kernel_and_flax_blocks(ckpt, lvl, h, w):
    import jax.numpy as jnp

    from tpuseg.kernels.ir_chain import ir_chain as jax_ir_chain
    from tpuseg.kernels.ir_chain import stack_chain_params as jax_stack
    from tpuseg.nn.blocks import InvertedResidual as FlaxIR

    c = CHANNELS[lvl]
    x, x1u = _inputs(lvl, 2, h, w, seed=lvl)
    vars_list = [_block_vars(ckpt, lvl, name) for name in BLOCKS]
    jparams = jax_stack(vars_list, dtype=jnp.float32)
    want_kernel = np.asarray(jax_ir_chain(
        jnp.asarray(x), None if x1u is None else jnp.asarray(x1u), *jparams,
        interpret=True,
    ))
    v = jnp.asarray(x)
    for i, block_vars in enumerate(vars_list):
        if i == 2 and x1u is not None:
            v = v + jnp.asarray(x1u)
        v = FlaxIR(c).apply(block_vars, v, False)
    want_flax = np.asarray(v)

    got = ir_chain(
        torch.from_numpy(x), None if x1u is None else torch.from_numpy(x1u),
        *_torch_params(ckpt, lvl),
    ).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want_kernel, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, want_flax, atol=1e-4, rtol=0)


def test_wrapper_takes_plain_on_cpu_without_counting(ckpt):
    x, x1u = _inputs(3, 1, 8, 8, seed=0)
    params = _torch_params(ckpt, 3)
    before = ir_chain.launches
    got = ir_chain(torch.from_numpy(x), torch.from_numpy(x1u), *params)
    want = ir_chain_plain(torch.from_numpy(x), torch.from_numpy(x1u), *params)
    assert ir_chain.launches == before
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_card(ckpt, dtype):
    """f32: |err| <= 1e-4 max|y| (3xTF32 products, summation order).  bf16
    storage: against the f32 plain result on the same rounded inputs, <=
    2e-2 max|y|.  The main-path levels at small sizes, then ``RAGGED`` at
    each width (levels 0-3) with and without the mid-chain skip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    cases = [(lvl, 3, h, w, lvl > 0)
             for lvl, h, w in SHAPES + [(2, 64, 64), (4, 96, 96)]]
    cases += [(lvl, n, h, w, skip) for lvl in range(4)
              for n, h, w in RAGGED for skip in (False, True)]
    for lvl, n, h, w, with_skip in cases:
        x, x1u = _inputs(lvl, n, h, w, seed=10 + lvl)
        if with_skip and x1u is None:
            x1u = np.random.default_rng(lvl).normal(
                size=x.shape).astype(np.float32)
        if not with_skip:
            x1u = None
        params = [t.to(dev) for t in _torch_params(ckpt, lvl, dtype)]
        xs = torch.from_numpy(x).to(dev, dtype)
        x1s = None if x1u is None else torch.from_numpy(x1u).to(dev, dtype)
        got = ir_chain(xs, x1s, *params)
        torch.cuda.synchronize()
        want = ir_chain_plain(
            xs.float(), None if x1s is None else x1s.float(),
            *[t.float() for t in params],
        )
        err = (got.float() - want).abs().max().item()
        scale = want.abs().max().item()
        assert err <= tol * scale, (lvl, n, h, w, with_skip, dtype, err,
                                    scale)
