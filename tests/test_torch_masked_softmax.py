"""``masked_softmax`` in the port: the plain version against the JAX Pallas
kernel (interpret mode on the CPU, as ``tests/test_hard_attention_pallas.py``
runs it) and the ``jnp`` path of ``HardAttention``; its autograd gradient
against ``jax.grad`` of the ``jnp`` path; the backward kernels' formula
against autograd; the Hopper kernels against the plain version on the card.

The port's layout is ``mask (B, N, HW)``, the JAX package's ``(B, HW, N)``.
JAX is imported inside the tests that use it, so the card test runs where
JAX is absent:
``pytest --noconftest -m cuda tests/test_torch_masked_softmax.py``.
"""

import numpy as np
import pytest
import torch

from tpuseg_torch.kernels.masked_softmax import (
    BACKWARD_LAUNCHES,
    FORWARD_LAUNCHES,
    masked_softmax,
    masked_softmax_backward_plain,
    masked_softmax_plain,
)


def _inputs(b, n, hw, seed, empty=True):
    """Scores and disjoint instance masks; with ``empty`` the last instance
    of every sample has no pixel and one instance has a single pixel."""
    rng = np.random.default_rng(seed)
    e = (3.0 * rng.normal(size=(b, hw))).astype(np.float32)
    owner = rng.integers(0, n + 1, size=(b, hw))  # n = background
    if empty:
        owner[owner == n - 1] = n
        owner[:, 0] = 0
        owner[owner == 1] = n
        owner[:, 1] = 1
    mask = (owner[:, None, :] == np.arange(n)[None, :, None])
    return e, mask.astype(np.float32)


def _jnp_path(e, mask_bhwn):
    """The JAX package's differentiable path (``tpuseg/nn/attention.py``,
    ``HardAttention``), on (B, HW) scores and a (B, HW, N) mask."""
    import jax
    import jax.numpy as jnp

    logits = jnp.where(mask_bhwn > 0, e[:, :, None], -1e30)
    p = jax.nn.softmax(logits, axis=1)
    nonempty = jnp.sum(mask_bhwn, axis=1, keepdims=True) > 0
    return jnp.where(nonempty, p, 0.0)


@pytest.mark.parametrize("b,n,hw", [(2, 4, 1024), (1, 5, 300), (3, 3, 129)])
def test_plain_matches_pallas_kernel_and_jnp_path(b, n, hw):
    """atol 1e-6: probabilities <= 1, float32 summation order only.  HW 300
    and 129 are no multiples of the TPU kernel's 128 lanes."""
    import jax.numpy as jnp

    from tpuseg.kernels.masked_softmax import masked_softmax_pallas

    e, mask = _inputs(b, n, hw, seed=hw)
    mask_j = jnp.asarray(mask.transpose(0, 2, 1))
    want_kernel = np.asarray(
        masked_softmax_pallas(jnp.asarray(e), mask_j, interpret=True)
    ).transpose(0, 2, 1)
    want_jnp = np.asarray(_jnp_path(jnp.asarray(e), mask_j)).transpose(0, 2, 1)
    got = masked_softmax_plain(torch.from_numpy(e), torch.from_numpy(mask))
    assert got.shape == (b, n, hw)
    np.testing.assert_allclose(got.numpy(), want_kernel, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.numpy(), want_jnp, atol=1e-6, rtol=0)
    # the empty instance is all zero (not NaN); the others sum to one
    sums = got.sum(dim=-1).numpy()
    np.testing.assert_array_equal(sums[:, n - 1], 0.0)
    np.testing.assert_allclose(sums[:, : n - 1], 1.0, atol=1e-5)


def test_plain_gradient_matches_jax_grad():
    """d/de of sum(p * cotangent): autograd of the plain version against
    ``jax.grad`` of the jnp path (rtol 1e-5 of max|de|); the mask gets no
    gradient and an empty instance contributes none."""
    import jax
    import jax.numpy as jnp

    b, n, hw = 2, 4, 520
    e, mask = _inputs(b, n, hw, seed=7)
    cot = np.random.default_rng(8).normal(size=(b, n, hw)).astype(np.float32)
    mask_j = jnp.asarray(mask.transpose(0, 2, 1))
    cot_j = jnp.asarray(cot.transpose(0, 2, 1))
    want = np.asarray(jax.grad(
        lambda x: jnp.sum(_jnp_path(x, mask_j) * cot_j))(jnp.asarray(e)))

    et = torch.from_numpy(e).requires_grad_()
    mt = torch.from_numpy(mask).requires_grad_()
    p = masked_softmax(et, mt)  # CPU tensors: the plain version
    (p * torch.from_numpy(cot)).sum().backward()
    assert mt.grad is None or not mt.grad.any()
    assert np.isfinite(et.grad.numpy()).all()
    np.testing.assert_allclose(et.grad.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # the formula the backward kernels implement gives the same gradient
    de = masked_softmax_backward_plain(p.detach(), torch.from_numpy(cot))
    np.testing.assert_allclose(de.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_backward_formula_against_autograd_float64():
    """``torch.autograd.gradcheck`` of the plain version in float64 at a
    tiny size, and the hand-written backward formula against autograd."""
    e, mask = _inputs(2, 3, 24, seed=3)
    et = torch.from_numpy(e).double().requires_grad_()
    mt = torch.from_numpy(mask).double()
    assert torch.autograd.gradcheck(
        lambda x: masked_softmax_plain(x, mt), (et,), eps=1e-6, atol=1e-6)
    g = torch.from_numpy(
        np.random.default_rng(4).normal(size=(2, 3, 24))).double()
    p = masked_softmax_plain(et, mt)
    (want,) = torch.autograd.grad(p, et, g)
    got = masked_softmax_backward_plain(p.detach(), g)
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-12)


def test_wrapper_takes_plain_on_cpu_without_counting():
    e, mask = _inputs(1, 3, 64, seed=5)
    before = masked_softmax.launches
    got = masked_softmax(torch.from_numpy(e), torch.from_numpy(mask))
    assert masked_softmax.launches == before
    assert torch.equal(
        got, masked_softmax_plain(torch.from_numpy(e), torch.from_numpy(mask)))


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """Forward: max|p err| <= 1e-6.  Backward: max|de err| <= 1e-5 max|de|.
    HW 65536 (vector path), 4100 and 4099 (a ragged tail and the scalar
    path); launches counted per direction."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    for b, n, hw in [(2, 32, 65536), (3, 5, 4100), (2, 7, 4099), (1, 1, 5)]:
        e, mask = _inputs(b, n, hw, seed=hw % 1000, empty=n >= 3)
        cot = np.random.default_rng(1).normal(size=(b, n, hw)).astype(
            np.float32)
        et = torch.from_numpy(e).to(dev).requires_grad_()
        mt = torch.from_numpy(mask).to(dev)
        gt = torch.from_numpy(cot).to(dev)
        before = (masked_softmax.forward_launches,
                  masked_softmax.backward_launches)
        p = masked_softmax(et, mt)
        (p * gt).sum().backward()
        torch.cuda.synchronize()
        assert masked_softmax.forward_launches == before[0] + FORWARD_LAUNCHES
        assert masked_softmax.backward_launches == before[1] + BACKWARD_LAUNCHES
        er = torch.from_numpy(e).to(dev).requires_grad_()
        pr = masked_softmax_plain(er, mt)
        (pr * gt).sum().backward()
        assert torch.isfinite(p).all() and torch.isfinite(et.grad).all()
        err = (p - pr).abs().max().item()
        assert err <= 1e-6, (b, n, hw, err)
        derr = (et.grad - er.grad).abs().max().item()
        scale = er.grad.abs().max().item()
        assert derr <= 1e-5 * scale, (b, n, hw, derr, scale)
    with pytest.raises(ValueError):
        masked_softmax(torch.zeros(2, 8, device=dev),
                       torch.zeros(2, 3, 9, device=dev))
    with pytest.raises(ValueError):  # one mask type: float32
        masked_softmax(torch.zeros(2, 8, device=dev),
                       torch.zeros(2, 3, 8, device=dev, dtype=torch.uint8))
