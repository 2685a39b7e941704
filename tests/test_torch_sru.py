"""The SRU path of the port against the JAX package, on the CPU: the plain
recurrence against ``tpuseg.nn.sru.sru_recurrence`` and the Pallas kernel
(interpret mode, as ``tests/test_sru.py`` runs it); its gradients, and the
backward kernel's formula (``sru_scan_backward_plain``), against
``jax.grad`` through ``sru_scan_fused`` (the Pallas backward) or, with
``mask_pad``, through the scan; ``SRUCell`` and ``SRU`` against
``Module.apply`` from the same variables; the init recipe; the Hopper
kernels against the plain versions on a card.

Tolerances are those of ``tests/test_sru.py``: forward rtol = atol = 2e-5,
gradients rtol 3e-4 / atol 3e-5.  Shapes are small (L <= 8, d <= 8).
JAX is imported inside the tests that use it, so the card test runs where
JAX is absent: ``pytest --noconftest -m cuda tests/test_torch_sru.py``.
"""

import numpy as np
import pytest
import torch

from tpuseg_torch.kernels.sru_scan import (
    BACKWARD_LAUNCHES,
    FORWARD_LAUNCHES,
    sru_scan,
    sru_scan_backward,
    sru_scan_backward_plain,
    sru_scan_forward,
)
from tpuseg_torch.nn import SRU, SRUCell, sru_recurrence
from tpuseg_torch.nn.sru import sru_states
from tpuseg_torch.weights import grads_to_flax, load_flax, to_flax

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
BWD_TOL = dict(rtol=3e-4, atol=3e-5)
SCALE_X = 1.3


def _inputs(length, batch, d, k, bidir, seed, mask_c=False, mask_pad=False):
    """Numpy inputs of one scan; k = 3 takes its skip term from x, so then
    n_in = bidir * d.  ``mask_pad`` pads the ends of ragged sequences (one
    of them not at all); ``mask_c`` is a dropout mask scaled by 1/keep."""
    rng = np.random.default_rng(seed)
    n_in = bidir * d if k == 3 else 7
    f32 = np.float32
    a = dict(
        u=rng.normal(size=(length, batch, bidir * d * k)).astype(f32),
        x=rng.normal(size=(length, batch, n_in)).astype(f32),
        weight_c=rng.normal(size=(2 * bidir * d,)).astype(f32),
        bias=rng.normal(size=(2 * bidir * d,)).astype(f32),
        c0=rng.normal(size=(batch, bidir * d)).astype(f32),
        mask_c=None, mask_pad=None,
    )
    if mask_c:
        keep = rng.binomial(1, 0.8, (batch, bidir * d))
        a["mask_c"] = (keep / 0.8).astype(f32)
    if mask_pad:
        lengths = np.concatenate([[length],
                                  rng.integers(1, length, batch - 1)])
        a["mask_pad"] = (np.arange(length)[:, None]
                         >= lengths[None]).astype(f32)
    return a


def _torch(a, requires_grad=()):
    out = {}
    for key, v in a.items():
        t = None if v is None else torch.from_numpy(v.copy())
        if t is not None and key in requires_grad:
            t.requires_grad_()
        out[key] = t
    return out


def _jax(a):
    import jax.numpy as jnp

    return {key: None if v is None else jnp.asarray(v) for key, v in a.items()}


def _kw(d, activation, bidir, has_skip):
    return dict(d=d, activation=activation, bidirectional=bidir == 2,
                has_skip_term=has_skip, scale_x=SCALE_X)


# (bidir, k, activation, mask_c, has_skip_term)
FWD_CASES = [
    (1, 3, 0, False, True),
    (1, 4, 1, True, True),
    (2, 3, 2, True, True),
    (2, 4, 1, False, True),
    (1, 4, 2, False, False),
    (2, 3, 0, True, False),
]


def _ids(cases):
    return ["bi{}-k{}-act{}-mc{}-skip{}".format(*c) for c in cases]


@pytest.mark.parametrize("bidir,k,activation,mask_c,has_skip", FWD_CASES,
                         ids=_ids(FWD_CASES))
def test_recurrence_matches_jax_scan_and_pallas(bidir, k, activation, mask_c,
                                                has_skip):
    """h and c_final of the port's plain loop against the JAX scan and the
    Pallas forward kernel (interpret mode)."""
    import jax

    from tpuseg.kernels.sru_scan import sru_scan_pallas
    from tpuseg.nn.sru import sru_recurrence as jax_recurrence

    d = 5
    a = _inputs(6, 3, d, k, bidir, seed=10 * bidir + k + activation,
                mask_c=mask_c)
    kw = _kw(d, activation, bidir, has_skip)
    t = _torch(a)
    h, c = sru_recurrence(t["u"], t["x"], t["weight_c"], t["bias"], t["c0"],
                          mask_c=t["mask_c"], **kw)
    h0, _ = sru_recurrence(t["u"], t["x"], t["weight_c"], t["bias"], None,
                           mask_c=t["mask_c"], **kw)
    j = _jax(a)

    @jax.jit
    def reference(u, x, wc, b, c0, mc):
        hp, cp = sru_scan_pallas(u, x, wc, b, c0, mask_c=mc, interpret=True,
                                 **kw)
        # c0 None is zeros on both sides
        hj0, _ = jax_recurrence(u, x, wc, b, None, mask_c=mc, **kw)
        return jax_recurrence(u, x, wc, b, c0, mask_c=mc, **kw), (hp, cp), hj0

    (hj, cj), (hp, cp), hj0 = reference(j["u"], j["x"], j["weight_c"],
                                        j["bias"], j["c0"], j["mask_c"])
    for want_h, want_c in ((hj, cj), (hp, cp)):
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **FWD_TOL)
        np.testing.assert_allclose(c.numpy(), np.asarray(want_c), **FWD_TOL)
    np.testing.assert_allclose(h0.numpy(), np.asarray(hj0), **FWD_TOL)


@pytest.mark.parametrize("bidir", [1, 2])
def test_recurrence_with_mask_pad_matches_jax(bidir):
    """Padded steps keep c and emit 0, in both directions."""
    from tpuseg.nn.sru import sru_recurrence as jax_recurrence

    d, k = 4, 3
    a = _inputs(7, 3, d, k, bidir, seed=20 + bidir, mask_c=True,
                mask_pad=True)
    kw = _kw(d, 1, bidir, True)
    t, j = _torch(a), _jax(a)
    h, c = sru_recurrence(t["u"], t["x"], t["weight_c"], t["bias"], t["c0"],
                          mask_pad=t["mask_pad"], mask_c=t["mask_c"], **kw)
    hj, cj = jax_recurrence(j["u"], j["x"], j["weight_c"], j["bias"],
                            j["c0"], mask_pad=j["mask_pad"],
                            mask_c=j["mask_c"], **kw)
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), **FWD_TOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(cj), **FWD_TOL)
    padded = torch.from_numpy(a["mask_pad"]).bool()
    assert padded.any() and not h[padded].any()


def _port_grads(a, kw, gh, gcf):
    """(autograd through the plain loop, the written-out backward), each a
    dict of u, x, weight_c, bias, c0 gradients (numpy; zeros where the
    input is not used)."""
    names = ("u", "x", "weight_c", "bias", "c0")
    t = _torch(a, requires_grad=names)
    h, c, c_all = sru_states(t["u"], t["x"], t["weight_c"], t["bias"],
                             t["c0"], mask_pad=t["mask_pad"],
                             mask_c=t["mask_c"], **kw)
    (h * gh).sum().add((c * gcf).sum()).backward()
    auto = {n: np.zeros_like(a[n]) if t[n].grad is None
            else t[n].grad.numpy() for n in names}
    formula = sru_scan_backward_plain(
        t["u"].detach(), t["x"].detach(), t["weight_c"].detach(),
        t["bias"].detach(), t["c0"].detach(), t["mask_c"], t["mask_pad"],
        c_all.detach(), gh, gcf, kw["d"], kw["activation"],
        kw["bidirectional"], kw["has_skip_term"], kw["scale_x"])
    formula = dict(zip(names, formula))
    if formula["x"] is None:
        formula["x"] = torch.zeros_like(t["x"])
    return auto, {n: v.numpy() for n, v in formula.items()}


def _cotangents(a, seed):
    rng = np.random.default_rng(seed)
    gh = rng.normal(size=(a["u"].shape[0], a["u"].shape[1],
                          a["c0"].shape[1])).astype(np.float32)
    gcf = rng.normal(size=a["c0"].shape).astype(np.float32)
    return gh, gcf


# (bidir, k, activation, mask_c, has_skip_term)
BWD_CASES = [
    (1, 3, 0, True, True),
    (1, 4, 2, True, True),
    (2, 3, 1, True, True),
    (2, 4, 1, False, True),
    (1, 4, 1, True, False),
]


@pytest.mark.parametrize("bidir,k,activation,mask_c,has_skip", BWD_CASES,
                         ids=_ids(BWD_CASES))
def test_gradients_match_jax_pallas_backward(bidir, k, activation, mask_c,
                                             has_skip):
    """Autograd through the plain loop, and the backward kernel's formula,
    against ``jax.grad`` through ``sru_scan_fused`` (Pallas forward +
    backward kernels, interpret mode): du, dx, d weight_c, d bias, dc0."""
    import jax
    import jax.numpy as jnp

    from tpuseg.kernels.sru_scan import sru_scan_fused

    d = 5
    a = _inputs(6, 2, d, k, bidir, seed=30 + 10 * bidir + k, mask_c=mask_c)
    gh, gcf = _cotangents(a, seed=31)
    kw = _kw(d, activation, bidir, has_skip)
    j = _jax(a)
    mc = (j["mask_c"] if mask_c
          else jnp.ones(a["c0"].shape, jnp.float32))

    def loss(u, x, wc, b, c0):
        h, c = sru_scan_fused(u, x, wc, b, c0, mc, d, activation,
                              bidir == 2, has_skip, SCALE_X, True)
        return jnp.sum(h * gh) + jnp.sum(c * gcf)

    names = ("u", "x", "weight_c", "bias", "c0")
    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(
        *(j[n] for n in names))
    auto, formula = _port_grads(a, kw, torch.from_numpy(gh),
                                torch.from_numpy(gcf))
    for n, w in zip(names, want):
        np.testing.assert_allclose(auto[n], np.asarray(w), err_msg=n,
                                   **BWD_TOL)
        np.testing.assert_allclose(formula[n], np.asarray(w), err_msg=n,
                                   **BWD_TOL)


@pytest.mark.parametrize("bidir,activation", [(1, 2), (2, 1)])
def test_gradients_with_mask_pad_match_jax_grad_of_scan(bidir, activation):
    """The Pallas backward has no ``mask_pad`` case: here the reference is
    ``jax.grad`` of the scan with ``mask_pad``."""
    import jax
    import jax.numpy as jnp

    from tpuseg.nn.sru import sru_recurrence as jax_recurrence

    d, k = 4, 3
    a = _inputs(7, 3, d, k, bidir, seed=40 + bidir, mask_c=True,
                mask_pad=True)
    gh, gcf = _cotangents(a, seed=41)
    kw = _kw(d, activation, bidir, True)
    j = _jax(a)

    def loss(u, x, wc, b, c0):
        h, c = jax_recurrence(u, x, wc, b, c0, mask_pad=j["mask_pad"],
                              mask_c=j["mask_c"], **kw)
        return jnp.sum(h * gh) + jnp.sum(c * gcf)

    names = ("u", "x", "weight_c", "bias", "c0")
    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(
        *(j[n] for n in names))
    auto, formula = _port_grads(a, kw, torch.from_numpy(gh),
                                torch.from_numpy(gcf))
    for n, w in zip(names, want):
        np.testing.assert_allclose(auto[n], np.asarray(w), err_msg=n,
                                   **BWD_TOL)
        np.testing.assert_allclose(formula[n], np.asarray(w), err_msg=n,
                                   **BWD_TOL)


def _flax_and_port(name):
    from tpuseg.nn import sru as jsru

    if name == "cell-k4":
        kw = dict(n_in=6, n_out=4, activation=1, highway_bias=-1.0)
        return jsru.SRUCell(**kw), SRUCell(**kw), 6
    if name == "cell-bi-k3":
        kw = dict(n_in=8, n_out=4, bidirectional=True, activation=2)
        return jsru.SRUCell(**kw), SRUCell(**kw), 8
    if name == "stack-proj-ln":
        kw = dict(input_size=6, hidden_size=5, num_layers=2, n_proj=3,
                  use_layer_norm=True, activation=1, highway_bias=-3.0)
        return jsru.SRU(**kw), SRU(**kw), 6
    kw = dict(input_size=6, hidden_size=4, num_layers=2, bidirectional=True,
              use_layer_norm=True, activation=0)
    return jsru.SRU(**kw), SRU(**kw), 6


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, np.asarray(tree)


@pytest.mark.parametrize("name", ["cell-k4", "cell-bi-k3", "stack-proj-ln",
                                  "stack-bi-ln"])
def test_module_matches_flax_apply(name):
    """From the JAX module's ``init`` variables: forward (h, c), the
    gradient of every parameter and of x, and ``to_flax`` giving the tree
    back leaf for leaf."""
    import jax
    import jax.numpy as jnp

    fmod, tmod, n_in = _flax_and_port(name)
    rng = np.random.default_rng(50)
    x = rng.normal(size=(5, 2, n_in)).astype(np.float32)
    variables = jax.tree.map(np.asarray, jax.jit(fmod.init)(
        jax.random.PRNGKey(3), jnp.asarray(x)))
    tmod = load_flax(tmod, variables).eval()
    h_t, c_t = tmod(torch.from_numpy(x))
    gh = rng.normal(size=h_t.shape).astype(np.float32)
    gc = rng.normal(size=c_t.shape).astype(np.float32)

    def loss(params, xx):
        h, c = fmod.apply({"params": params}, xx)
        return jnp.sum(h * gh) + jnp.sum(c * gc), (h, c)

    (_, (h_j, c_j)), (g_p, g_x) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(variables["params"],
                                             jnp.asarray(x))
    np.testing.assert_allclose(h_t.detach().numpy(), np.asarray(h_j),
                               **FWD_TOL)
    np.testing.assert_allclose(c_t.detach().numpy(), np.asarray(c_j),
                               **FWD_TOL)
    xt = torch.from_numpy(x).requires_grad_()
    h_t, c_t = tmod(xt)
    ((h_t * torch.from_numpy(gh)).sum()
     + (c_t * torch.from_numpy(gc)).sum()).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), **BWD_TOL)
    want, got = dict(_leaves(g_p)), dict(_leaves(grads_to_flax(tmod)))
    assert got.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, err_msg=str(path),
                                   **BWD_TOL)
    want, got = dict(_leaves(variables)), dict(_leaves(to_flax(tmod)))
    assert got.keys() == want.keys()
    for path, w in want.items():
        assert got[path].shape == w.shape and got[path].dtype == w.dtype
        assert got[path].tobytes() == np.ascontiguousarray(w).tobytes(), path


@pytest.mark.parametrize("kw", [
    dict(n_in=8, n_out=4, bidirectional=True, dropout=0.2),
    dict(n_in=6, n_out=5, rnn_dropout=0.1, highway_bias=-3.0),
], ids=["k3-bi-dropout", "k4-rnn-dropout-highway"])
def test_init_recipe(kw):
    """Per-k-group bounds of ``weight`` (uniform +-sqrt(3/rows) times
    1 / sqrt(0.5) / sqrt(0.5) / scale_x for slots 0..3, with the dropout
    rescales), ``weight_c`` in +-sqrt(1.5), ``bias`` 0 then highway_bias:
    the port's draws (from a ``torch.Generator``) and the JAX module's."""
    import jax
    import jax.numpy as jnp

    from tpuseg.nn.sru import SRUCell as JaxCell

    cell = SRUCell(**kw, generator=torch.Generator().manual_seed(0))
    k, bidir = cell._k(), 2 if cell.bidirectional else 1
    val = (3.0 / kw["n_in"]) ** 0.5
    bound = np.array([1.0, 0.5 ** 0.5, 0.5 ** 0.5, cell.scale_x][:k]) * val
    bound[0] *= (1 - kw.get("dropout", 0.0)) ** 0.5
    bound *= (1 - kw.get("rnn_dropout", 0.0)) ** 0.5
    x = jnp.zeros((2, 3, kw["n_in"]), jnp.float32)
    jparams = jax.jit(JaxCell(**kw).init)(jax.random.PRNGKey(0), x)["params"]
    n_out = kw["n_out"]
    half = bidir * n_out
    for w, wc, b in (
        (cell.weight.detach().numpy(), cell.weight_c.detach().numpy(),
         cell.bias.detach().numpy()),
        (np.asarray(jparams["weight"]), np.asarray(jparams["weight_c"]),
         np.asarray(jparams["bias"])),
    ):
        assert w.shape == (kw["n_in"], bidir * n_out * k)
        per_slot = np.abs(w.reshape(kw["n_in"], bidir, n_out, k)).max(
            axis=(0, 1, 2))
        assert np.all(per_slot <= bound * (1 + 1e-6))
        assert np.all(per_slot >= 0.7 * bound)  # the draws fill the range
        assert np.abs(wc).max() <= 1.5 ** 0.5 and np.abs(wc).max() > 0.7
        np.testing.assert_array_equal(b[:half], 0.0)
        np.testing.assert_array_equal(b[half:], kw.get("highway_bias", 0.0))
    # the generator decides the draws
    again = SRUCell(**kw, generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.weight, cell.weight)


def test_train_mode_masks_come_from_the_generator():
    """``rnn_dropout`` scales x's features and ``dropout`` the outputs, one
    mask per sequence each, drawn from the generator given to forward (the
    input mask first); eval mode draws nothing."""
    cell = SRUCell(n_in=6, n_out=4, rnn_dropout=0.3, dropout=0.25,
                   activation=1, generator=torch.Generator().manual_seed(1))
    x = torch.from_numpy(
        np.random.default_rng(2).normal(size=(5, 3, 6)).astype(np.float32))
    h, c = cell.train()(x, generator=torch.Generator().manual_seed(7))
    g = torch.Generator().manual_seed(7)
    m_in = torch.bernoulli(torch.full((3, 6), 0.7), generator=g) / 0.7
    m_c = torch.bernoulli(torch.full((3, 4), 0.75), generator=g) / 0.75
    u = ((x * m_in) @ cell.weight).detach()
    want_h, want_c = sru_recurrence(
        u, x, cell.weight_c.detach(), cell.bias.detach(), d=4, activation=1,
        scale_x=cell.scale_x, mask_c=m_c)
    torch.testing.assert_close(h.detach(), want_h, rtol=0, atol=1e-6)
    torch.testing.assert_close(c.detach(), want_c, rtol=0, atol=1e-6)
    h_eval, _ = cell.eval()(x, generator=torch.Generator().manual_seed(7))
    assert not torch.allclose(h_eval, h)


def test_wrapper_takes_plain_on_cpu_without_counting():
    """On CPU tensors ``sru_scan`` is the plain loop and launches nothing;
    the launch functions themselves take CUDA tensors only."""
    a = _torch(_inputs(4, 2, 3, 4, 2, seed=60, mask_pad=True))
    kw = _kw(3, 1, 2, True)
    before = (sru_scan.launches, sru_scan.forward_launches,
              sru_scan.backward_launches)
    got = sru_scan(a["u"], a["x"], a["weight_c"], a["bias"], a["c0"],
                   mask_pad=a["mask_pad"], **kw)
    want = sru_recurrence(a["u"], a["x"], a["weight_c"], a["bias"], a["c0"],
                          mask_pad=a["mask_pad"], **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (sru_scan.launches, sru_scan.forward_launches,
            sru_scan.backward_launches) == before
    args = (a["u"], a["x"], a["weight_c"], a["bias"], a["c0"], None, None)
    spec = (3, 1, True, True, SCALE_X)
    with pytest.raises(ValueError, match="CUDA"):
        sru_scan_forward(*args, *spec)
    with pytest.raises(ValueError, match="CUDA"):
        sru_scan_backward(*args, a["u"][..., :6], a["u"][..., :6],
                          a["c0"], *spec)


def _misaligned(t):
    flat = torch.zeros(t.numel() + 1)
    return flat[1:].view(t.shape)  # contiguous, 4 bytes past 16-aligned


@pytest.mark.parametrize("bad", ["float64-u", "strided-x", "bias-shape",
                                 "misaligned-k4-u", "mask_pad-shape",
                                 "activation"])
def test_input_checks_raise(bad):
    """What the kernels do not take is refused before any launch."""
    from tpuseg_torch.kernels.sru_scan import _check

    a = _torch(_inputs(4, 2, 3, 4, 1, seed=61, mask_pad=True))
    act = 1
    if bad == "float64-u":
        a["u"] = a["u"].double()
    elif bad == "strided-x":
        a["x"] = a["x"].transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "bias-shape":
        a["bias"] = a["bias"][:-1]
    elif bad == "misaligned-k4-u":
        a["u"] = _misaligned(a["u"])
    elif bad == "mask_pad-shape":
        a["mask_pad"] = a["mask_pad"].t()
    else:
        act = 3
    args = [a[n] for n in ("u", "x", "weight_c", "bias", "c0", "mask_c",
                           "mask_pad")]
    with pytest.raises(ValueError, match="sru_scan"):
        _check(*args, 3, act, False, True)
    a = _torch(_inputs(4, 2, 3, 4, 1, seed=61, mask_pad=True))
    _check(*[a[n] for n in ("u", "x", "weight_c", "bias", "c0", "mask_c",
                            "mask_pad")], 3, 1, False, True)


@pytest.mark.parametrize("bad", ["misaligned-k4-u", "float64-u",
                                 "strided-x"])
def test_checked_caches_and_still_raises(bad):
    """The wrappers run ``_check`` once per input signature: a second call
    of the same signature comes from the cache, and an input that
    ``_check`` refuses still raises after a good call of the same shapes
    (``u``'s alignment is checked on every call)."""
    from tpuseg_torch.kernels import sru_scan as mod

    names = ("u", "x", "weight_c", "bias", "c0", "mask_c", "mask_pad")
    a = _torch(_inputs(4, 2, 3, 4, 1, seed=63, mask_pad=True))
    args = [a[n] for n in names]
    mod._CHECKED.clear()
    want = mod._check(*args, 3, 1, False, True)
    for _ in range(2):
        assert mod._checked(*args, 3, 1, False, True) == want
        assert len(mod._CHECKED) == 1
    if bad == "misaligned-k4-u":
        a["u"] = _misaligned(a["u"])
    elif bad == "float64-u":
        a["u"] = a["u"].double()
    else:
        a["x"] = a["x"].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="sru_scan"):
        mod._checked(*[a[n] for n in names], 3, 1, False, True)


@pytest.mark.cuda
def test_folded_batch_sum_and_prefetch_on_card():
    """The backward's batch sum folded into the scan: one launch per call,
    weight gradients bit-equal over two runs and within tolerance of the
    plain backward, over several column slices and lengths that are and
    are not multiples of the prefetch depth (L = 1 included), uni k=3 and
    bi k=4, with ragged ``mask_pad``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    for length in (1, 3, 4, 7, 9):
        for bidir, k, pad in ((1, 3, True), (2, 4, True), (1, 4, False)):
            d = 70  # W = 70 or 140: two or three slices of the grid
            a = _inputs(length, 33, d, k, bidir, seed=length * 10 + k,
                        mask_c=True, mask_pad=pad and length > 1)
            kw = _kw(d, 1, bidir, True)
            spec = tuple(kw[n] for n in ("d", "activation", "bidirectional",
                                         "has_skip_term", "scale_x"))
            t = {n: None if v is None else v.to(dev)
                 for n, v in _torch(a).items()}
            args = [t[n] for n in ("u", "x", "weight_c", "bias", "c0",
                                   "mask_c", "mask_pad")]
            h, cf, c_all = sru_scan_forward(*args, *spec)
            hp, cfp, c_allp = sru_states(*args[:5], mask_pad=t["mask_pad"],
                                         mask_c=t["mask_c"], **kw)
            for got, want in ((h, hp), (cf, cfp), (c_all, c_allp)):
                torch.testing.assert_close(got, want, **FWD_TOL)
            gh = torch.randn(h.shape, device=dev)
            gcf = torch.randn(cf.shape, device=dev)
            before = sru_scan.backward_launches
            got = sru_scan_backward(*args, c_all, gh, gcf, *spec)
            again = sru_scan_backward(*args, c_all, gh, gcf, *spec)
            torch.cuda.synchronize()
            assert sru_scan.backward_launches - before == 2 * BACKWARD_LAUNCHES
            assert BACKWARD_LAUNCHES == 1
            assert torch.equal(got[2], again[2]) and torch.equal(got[3],
                                                                 again[3])
            want = sru_scan_backward_plain(*args, c_all, gh, gcf, *spec)
            for g, w in zip(got, want):
                assert (g is None) == (w is None)
                if g is not None:
                    torch.testing.assert_close(g, w, **BWD_TOL)


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """Forward (h, c_final, c_all) within 2e-5 of the plain loop; backward
    within rtol 3e-4 / atol 3e-5 of ``sru_scan_backward_plain`` and of
    autograd through the plain loop; weight_c and bias gradients bit-equal
    over two runs; launches counted per direction.  Uni/bi, k 3/4, the
    three activations, mask_c, mask_pad and no skip term."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    cases = [c + (False,) for c in FWD_CASES] + [
        (1, 3, 1, True, True, True), (2, 4, 2, True, True, True)]
    for bidir, k, act, mask_c, has_skip, pad in cases:
        d = 37
        a = _inputs(9, 5, d, k, bidir, seed=70 + k + act, mask_c=mask_c,
                    mask_pad=pad)
        kw = _kw(d, act, bidir, has_skip)
        spec = tuple(kw[n] for n in ("d", "activation", "bidirectional",
                                     "has_skip_term", "scale_x"))
        t = {n: None if v is None else v.to(dev) for n, v in _torch(a).items()}
        args = [t[n] for n in ("u", "x", "weight_c", "bias", "c0", "mask_c",
                               "mask_pad")]
        before = (sru_scan.forward_launches, sru_scan.backward_launches)
        h, cf, c_all = sru_scan_forward(*args, *spec)
        hp, cfp, c_allp = sru_states(*args[:5], mask_pad=t["mask_pad"],
                                     mask_c=t["mask_c"], **kw)
        for got, want in ((h, hp), (cf, cfp), (c_all, c_allp)):
            torch.testing.assert_close(got, want, **FWD_TOL)
        gh = torch.randn(h.shape, device=dev)
        gcf = torch.randn(cf.shape, device=dev)
        got = sru_scan_backward(*args, c_all, gh, gcf, *spec)
        again = sru_scan_backward(*args, c_all, gh, gcf, *spec)
        torch.cuda.synchronize()
        assert (sru_scan.forward_launches - before[0] == FORWARD_LAUNCHES
                and sru_scan.backward_launches - before[1]
                == 2 * BACKWARD_LAUNCHES)
        assert torch.equal(got[2], again[2]) and torch.equal(got[3], again[3])
        want = sru_scan_backward_plain(*args, c_all, gh, gcf, *spec)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                torch.testing.assert_close(g, w, **BWD_TOL)
        # the autograd binding against autograd through the plain loop
        names = ("u", "x", "weight_c", "bias", "c0")
        grads = []
        for fn in (sru_scan, sru_recurrence):
            leaves = {n: t[n].clone().requires_grad_() for n in names}
            hh, cc = fn(*(leaves[n] for n in names), mask_pad=t["mask_pad"],
                        mask_c=t["mask_c"], **kw)
            ((hh * gh).sum() + (cc * gcf).sum()).backward()
            grads.append([torch.zeros_like(leaves[n]) if leaves[n].grad is None
                          else leaves[n].grad for n in names])
        for g, w in zip(*grads):
            torch.testing.assert_close(g, w, **BWD_TOL)
