"""``masked_softmax`` in the port: the plain version against the JAX Pallas
kernel (interpret mode on the CPU, as ``tests/test_hard_attention_pallas.py``
runs it) and the ``jnp`` path of ``HardAttention``; its autograd gradient
against ``jax.grad`` of the ``jnp`` path; the backward kernels' formula
against autograd; the Hopper kernels against the plain version on the card,
and the split-row entry points of spatial training (two halves of each row
combined) against the whole-row plain version on the card.

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


def _cotangent(mask, kind, seed, k=2):
    """A cotangent of p (B, N, HW): "dense", N(0, 1) everywhere; "main", as
    the training loss gives it: ``k`` rows per sample, picked by a seeded
    permutation among the non-empty instances, N(0, 1), the rest exact
    zeros; "empty", the same but one picked row is an empty instance."""
    rng = np.random.default_rng(seed)
    cot = rng.normal(size=mask.shape).astype(np.float32)
    if kind == "dense":
        return cot
    keep = np.zeros(mask.shape[:2], bool)
    for i, m in enumerate(mask):
        rows = np.flatnonzero(m.sum(axis=-1) > 0)
        keep[i, rng.permutation(rows)[:k]] = True
        if kind == "empty":
            keep[i, np.flatnonzero(m.sum(axis=-1) == 0)[0]] = True
    return np.where(keep[..., None], cot, np.float32(0))


@pytest.mark.parametrize("b,n,hw,kind", [
    (2, 6, 1024, "main"), (3, 5, 1023, "main"), (2, 4, 258, "dense"),
    (2, 6, 513, "empty"), (1, 32, 4096, "main")])
def test_plain_backward_matches_jax_grad_sparse_g(b, n, hw, kind):
    """The backward as training feeds it (few rows of g nonzero), at odd
    HW and with empty instance slots: p within 1e-6 of the jnp path, the
    backward formula and autograd within 1e-5 max|de| of ``jax.grad``."""
    import jax
    import jax.numpy as jnp

    e, mask = _inputs(b, n, hw, seed=hw + n)
    cot = _cotangent(mask, kind, seed=hw)
    mask_j = jnp.asarray(mask.transpose(0, 2, 1))
    cot_j = jnp.asarray(cot.transpose(0, 2, 1))
    want_p = np.asarray(_jnp_path(jnp.asarray(e), mask_j)).transpose(0, 2, 1)
    want = np.asarray(jax.grad(
        lambda x: jnp.sum(_jnp_path(x, mask_j) * cot_j))(jnp.asarray(e)))
    assert np.abs(want).max() > 0

    et = torch.from_numpy(e).requires_grad_()
    p = masked_softmax_plain(et, torch.from_numpy(mask))
    np.testing.assert_allclose(p.detach().numpy(), want_p, atol=1e-6, rtol=0)
    (p * torch.from_numpy(cot)).sum().backward()
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(et.grad.numpy(), want, rtol=0, atol=tol)
    de = masked_softmax_backward_plain(p.detach(), torch.from_numpy(cot))
    np.testing.assert_allclose(de.numpy(), want, rtol=0, atol=tol)


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


@pytest.mark.cuda
def test_kernel_branches_on_card():
    """The kernels' branches: g with few nonzero rows (the training path's),
    a picked row that is an empty instance, a NaN in an otherwise zero row
    (counted as nonzero), all-empty rows (zeros without a read), and odd
    HW, whose rows start at every alignment (scalar head, float4 body,
    scalar tail).  Forward within 1e-6, backward within 1e-5 max|de|; de
    bit-equal from run to run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tpuseg_torch.kernels.masked_softmax import masked_softmax_backward

    dev = torch.device("cuda")
    for b, n, hw, kind in [(2, 32, 65536, "main"), (3, 6, 4099, "main"),
                           (2, 5, 1030, "empty"), (2, 7, 1031, "dense"),
                           (1, 3, 3, "dense"), (2, 4, 65025, "main")]:
        e, mask = _inputs(b, n, hw, seed=hw % 997, empty=n >= 3)
        cot = _cotangent(mask, kind, seed=hw % 991)
        et = torch.from_numpy(e).to(dev)
        mt = torch.from_numpy(mask).to(dev)
        gt = torch.from_numpy(cot).to(dev)
        p = masked_softmax(et, mt)
        pr = masked_softmax_plain(et, mt)
        assert (p - pr).abs().max().item() <= 1e-6, (b, n, hw)
        empty = mt.sum(dim=-1) == 0
        assert torch.equal(p[empty], torch.zeros_like(p[empty]))
        de = masked_softmax_backward(p, gt)
        de2 = masked_softmax_backward(p, gt)
        want = masked_softmax_backward_plain(pr, gt)
        torch.cuda.synchronize()
        assert torch.equal(de, de2)
        scale = want.abs().max().item()
        assert (de - want).abs().max().item() <= 1e-5 * scale, (b, n, hw)
    # a NaN in an otherwise zero row of g reaches de as the plain formula
    # carries it
    e, mask = _inputs(2, 4, 1024, seed=9)
    cot = _cotangent(mask, "main", seed=9, k=1)
    row = int(np.flatnonzero(np.abs(cot[0]).sum(axis=-1) == 0)[0])
    cot[0, row, 17] = np.nan
    p = masked_softmax(torch.from_numpy(e).to(dev),
                       torch.from_numpy(mask).to(dev))
    gt = torch.from_numpy(cot).to(dev)
    de = masked_softmax_backward(p, gt)
    want = masked_softmax_backward_plain(p, gt)
    assert torch.equal(torch.isnan(de), torch.isnan(want))
    assert torch.isnan(de[0]).any() and not torch.isnan(de[1]).any()
    ok = ~torch.isnan(want)
    assert (de[ok] - want[ok]).abs().max().item() <= 1e-5 * want[ok].abs().max()


@pytest.mark.cuda
def test_split_entry_points_match_plain_on_card():
    """The split-row entry points (``masked_softmax_stats`` / ``_apply`` /
    ``_row_dots`` / ``_tiles``) on the card, each against its plain
    version, and over the two halves of every row, combined as the ranks
    of ``parallel/spatial.py`` combine them, against the whole-row plain
    version: p within 1e-6, de within 1e-5 max|de|; 2 launches a direction
    and half."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tpuseg_torch.kernels import masked_softmax as ms
    from tpuseg_torch.parallel.spatial import _combine_stats

    dev = torch.device("cuda")
    for b, n, hw in [(2, 32, 65536), (3, 5, 4100), (2, 7, 4098)]:
        e, mask = _inputs(b, n, hw, seed=hw % 1000)
        cot = _cotangent(mask, "main", seed=hw % 991)
        et, mt, gt = (torch.from_numpy(a).to(dev) for a in (e, mask, cot))
        cut = [slice(0, hw // 2), slice(hw // 2, hw)]
        halves = [(et[:, c].contiguous(), mt[:, :, c].contiguous(),
                   gt[:, :, c].contiguous()) for c in cut]
        before = (ms.masked_softmax.split_forward_launches,
                  ms.masked_softmax.split_backward_launches)
        parts = [ms.masked_softmax_stats(eh, mh) for eh, mh, _ in halves]
        for (eh, mh, _), part in zip(halves, parts):
            want = ms.masked_softmax_stats_plain(eh, mh)
            torch.testing.assert_close(part, want, rtol=1e-5, atol=1e-6)
        stats = _combine_stats(parts)
        ps = [ms.masked_softmax_apply(eh, mh, stats) for eh, mh, _ in halves]
        for (eh, mh, _), p in zip(halves, ps):
            torch.testing.assert_close(
                p, ms.masked_softmax_apply_plain(eh, mh, stats), rtol=0,
                atol=1e-6)
        dots = sum(ms.masked_softmax_row_dots(p, gh)
                   for p, (_, _, gh) in zip(ps, halves))
        des = [ms.masked_softmax_tiles(p, gh, dots)
               for p, (_, _, gh) in zip(ps, halves)]
        torch.cuda.synchronize()
        assert (ms.masked_softmax.split_forward_launches,
                ms.masked_softmax.split_backward_launches) == (
            before[0] + 4, before[1] + 4)
        er = et.clone().requires_grad_()
        pr = masked_softmax_plain(er, mt)
        (pr * gt).sum().backward()
        p = torch.cat(ps, dim=2)
        de = torch.cat(des, dim=1)
        assert torch.isfinite(p).all() and torch.isfinite(de).all()
        assert (p - pr).abs().max().item() <= 1e-6, (b, n, hw)
        scale = er.grad.abs().max().item()
        assert (de - er.grad).abs().max().item() <= 1e-5 * scale, (b, n, hw)
