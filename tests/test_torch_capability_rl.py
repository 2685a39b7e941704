"""The port's DQN selector, legacy AtteNet, MMD losses, DCGAN decoder and
WAE match loss against the JAX package on the CPU.

Weights: the port module's initial weights, written as a flax tree by
``tpuseg_torch.weights.to_flax`` (checked against the JAX module's tree
from ``eval_shape``), so both packages run the same numbers.  Forward f32
within atol 1e-5 / rtol 1e-4; one optimizer step (``DQNSelecter.update``
on a fixed batch, ``MatchLoss.step``) within rtol 1e-4.  The random parts
run through the port's draw-injected cores fed the JAX package's exact
draws (``jax.random.uniform`` of the keys ``mmd.py`` folds and splits),
or in eval mode; epsilon-greedy is checked at epsilon 0 (the JAX greedy
actions) and 1 (inside the mask).  Ties are broken as JAX breaks them:
``_select_points`` keeps the lowest indices (``lax.top_k``), ``gl_loss``
ranks stably.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpuseg.configs import DecoderConfig as JaxDecoderConfig
from tpuseg.losses import mmd as jmmd
from tpuseg.models import attenet_legacy as jleg
from tpuseg.nn import dcgan_decoder as jdc
from tpuseg.nn import dqn as jdqn
from tpuseg.runtime import wae as jwae
from tpuseg.runtime.state import PlateauState as JaxPlateau
from tpuseg_torch.configs import DecoderConfig
from tpuseg_torch.losses import mmd as tmmd
from tpuseg_torch.models import attenet_legacy as tleg
from tpuseg_torch.nn import dcgan_decoder as tdc
from tpuseg_torch.nn import dqn as tdqn
from tpuseg_torch.runtime import wae as twae
from tpuseg_torch.weights import grads_to_flax, to_flax

KEY = jax.random.PRNGKey(0)
CLOSE = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    torch.manual_seed(0)  # the port modules' initial weights
    yield
    torch.set_num_threads(before)


def _tree(tree, leaf=np.asarray):
    if hasattr(tree, "items"):
        return {k: _tree(v, leaf) for k, v in tree.items()}
    return leaf(tree)


def _flax_of(jax_module, module, *args, **kw):
    """The port module's weights as a flax tree, of the JAX module's
    structure and shapes."""
    variables = to_flax(module)
    spec = lambda a: (tuple(a.shape), str(a.dtype))  # noqa: E731
    want = jax.eval_shape(functools.partial(jax_module.init, **kw), KEY, *args)
    assert _tree(variables, spec) == _tree(want, spec)
    return variables


def _np(a):
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return (a.permute(0, 2, 3, 1) if a.ndim == 4 else a).numpy()
    return np.asarray(a)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or CLOSE))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


# --------------------------------- DQN ---------------------------------

def _dqn_pair(c=6, h=6, w=6, **kw):
    """A port selecter and the JAX selecter of its weights, and a maker of
    the latter (for a reference traced inside ``jax.jit``)."""
    tsel = tdqn.DQNSelecter(tdqn.RLSelect(c), **kw)
    with torch.no_grad():  # BatchNorm statistics away from 0 / 1
        for m in tsel.net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    tsel.target_net.load_state_dict(tsel.net.state_dict())
    v = _flax_of(jdqn.RLSelect(), tsel.net, np.zeros((1, h, w, c),
                                                     np.float32),
                 np.ones((1, h * w), np.float32), train=True)

    def make(params):
        tx = optax.adam(1e-3)
        return jdqn.DQNSelecter(
            params=params, target_params=params,
            batch_stats=v["batch_stats"], opt_state=tx.init(params),
            net=jdqn.RLSelect(), tx=tx, **kw)

    return tsel, make(v["params"]), make


def _transitions(rng, b, c, h, w):
    state = rng.standard_normal((b, h, w, c)).astype(np.float32)
    mask = (rng.random((b, h * w)) > 0.3).astype(np.float32)
    next_mask = mask * (rng.random((b, h * w)) > 0.5)
    action = np.array([np.flatnonzero(m)[0] for m in mask])
    reward = rng.random(b).astype(np.float32)
    done = np.array([False, True, False, False][:b])
    return state, action, reward, mask, next_mask.astype(np.float32), done


def test_rl_select_q_values():
    rng = np.random.default_rng(0)
    tsel, jsel, _ = _dqn_pair()
    state, _, _, mask, _, _ = _transitions(rng, 2, 6, 6, 6)
    _close(tsel.q_values(_nchw(state), torch.from_numpy(mask)),
           jax.jit(jsel.q_values)(state, mask))


def test_dqn_update_one_adam_step():
    """A buffer of exactly one batch (the sampled order does not change the
    mean TD loss): the TD loss and the updated Q-net within rtol 1e-4; the
    target net synced at frame 0; BatchNorm statistics unchanged."""
    rng = np.random.default_rng(1)
    kw = dict(buffer_start=4, dqn_batch_size=4)
    tsel, jsel, make = _dqn_pair(**kw)
    fields = _transitions(rng, 4, 6, 6, 6)
    tfields = list(fields)
    tfields[0] = np.moveaxis(fields[0], -1, 1).copy()
    tbatch = [torch.as_tensor(a) for a in tfields]
    _close(tsel.td_loss(tbatch),
           jax.jit(jsel.td_loss)(jsel.params, [jnp.asarray(a)
                                               for a in fields]))

    def reference(params):  # the JAX selecter's update(), traced once
        sel = make(params)
        sel.buffer.push(fields)
        sel.update()
        return sel.params, sel.target_params

    params, target = jax.jit(reference)(jsel.params)
    tsel.buffer.push(tfields)
    stats = {k: v.clone() for k, v in tsel.net.state_dict().items()
             if "running" in k}
    tsel.update()
    for got, want in ((tsel.net, params), (tsel.target_net, target)):
        jax.tree.map(lambda g, w: _close(g, w, rtol=1e-4, atol=1e-7),
                     to_flax(got)["params"], _tree(want))
    for k, v in stats.items():
        assert torch.equal(tsel.net.state_dict()[k], v), k


def test_dqn_load_flax_takes_params_target_and_stats():
    """The JAX selecter's three trees load into the port's: ``params`` into
    ``net``, ``target_params`` into ``target_net``, the shared
    ``batch_stats`` into both."""
    rng = np.random.default_rng(4)
    tsel, jsel, make = _dqn_pair()
    params = jax.tree.map(lambda a: a + 0.01, jsel.params)
    other = make(params)
    other.target_params = jsel.params
    fresh = tdqn.DQNSelecter(tdqn.RLSelect(6))
    fresh.load_flax(_tree(other.params), _tree(other.target_params),
                    _tree(other.batch_stats))
    state, _, _, mask, _, _ = _transitions(rng, 2, 6, 6, 6)
    ts, tm = _nchw(state), torch.from_numpy(mask)
    q = jax.jit(other.q_values)
    _close(fresh.q_values(ts, tm), q(state, mask))
    _close(fresh.q_values(ts, tm, fresh.target_net),
           q(state, mask, other.target_params))


def test_dqn_act_epsilon_zero_and_one():
    rng = np.random.default_rng(2)
    state, _, _, mask, _, _ = _transitions(rng, 3, 6, 6, 6)
    mask[2] = 0.0  # a sample with no allowed pixel
    tsel, jsel, _ = _dqn_pair(epsilon_start=0.0, epsilon_end=0.0)
    g = torch.Generator().manual_seed(0)
    greedy = tsel.act(g, _nchw(state), torch.from_numpy(mask))
    want = jax.jit(jsel.act)(KEY, state, mask)
    np.testing.assert_array_equal(greedy.numpy()[:2], np.asarray(want)[:2])
    assert tsel.frame == 1
    tsel.epsilon_start = tsel.epsilon_end = 1.0
    for _ in range(5):
        act = tsel.act(g, _nchw(state), torch.from_numpy(mask)).numpy()
        assert mask[0, act[0]] == 1 and mask[1, act[1]] == 1
        assert 0 <= act[2] < 36


def test_replay_buffer_draws_from_its_own_generator():
    a, b = tdqn.ReplayBuffer(8, seed=3), tdqn.ReplayBuffer(8, seed=3)
    fields = [np.arange(6), np.arange(6) * 2]
    a.push(fields)
    b.push(fields)
    import random
    random.seed(1)
    first = a.sample(3)
    random.seed(2)
    np.testing.assert_array_equal(first[0], b.sample(3)[0])
    assert len(a) == 6 and np.array_equal(first[1], first[0] * 2)


# --------------------------- legacy AtteNet ----------------------------

@pytest.mark.parametrize("selector", ["norm", "dqn", "orphan"])
def test_attenet_legacy(selector):
    """Loss and transitions of 3 iterations: the encoder-norm heuristic,
    the DQN's q_fn, and a fixed Q map whose peak is a foreground pixel in
    no instance (gold_idx 0, the first index on the tie)."""
    rng = np.random.default_rng(3)
    b, h, w, n, d = 2, 8, 8, 3, 6
    feats = rng.standard_normal((b, h, w, d)).astype(np.float32)
    ins = np.zeros((b, h, w, n), np.float32)
    ins[:, :4, :5, 0] = 1
    ins[:, 4:, 2:, 1] = 1
    ins[1, :2, 6:, 2] = 1
    mask = (ins.sum(-1, keepdims=True) > 0).astype(np.float32)
    mask[:, 0, 7] = 1.0  # in no instance
    jcfg, tcfg = JaxDecoderConfig(d_model=d), DecoderConfig(d_model=d)
    tm = tleg.AtteNetLegacy(tcfg, d, aspp_rates=(1, 2), max_iter=3).eval()
    jm = jleg.AtteNetLegacy(cfg=jcfg, aspp_rates=(1, 2), max_iter=3)
    v = _flax_of(jm, tm, feats, mask, ins)
    if selector == "dqn":
        tsel, jsel, _ = _dqn_pair(c=d, h=h, w=w)
        tq, jq = tsel.q_values, jsel.q_values
    elif selector == "orphan":
        q = np.zeros((b, h * w), np.float32)
        q[:, 7] = 1.0
        tq = lambda e, r: torch.from_numpy(q)  # noqa: E731
        jq = lambda e, r: jnp.asarray(q)  # noqa: E731
    else:
        tq = jq = None
    jloss, jtrans = jax.jit(functools.partial(jm.apply, q_fn=jq))(
        v, feats, mask, ins)
    tloss, ttrans = tm(_nchw(feats), _nchw(mask), _nchw(ins), q_fn=tq)
    _close(tloss, jloss)
    assert len(ttrans) == len(jtrans) == 3
    for t, j in zip(ttrans, jtrans):
        for k in ("action", "done"):
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
        for k in ("reward", "mask", "next_mask"):
            _close(t[k], j[k])
    if selector == "orphan":
        assert (ttrans[0]["action"] == 7).all()


# ------------------------------ MMD losses ------------------------------

@pytest.mark.parametrize("pz", ["normal", "sphere", "uniform"])
def test_mmd_penalty(pz):
    rng = np.random.default_rng(4)
    q, p = rng.standard_normal((7, 5)), rng.standard_normal((6, 5))
    q, p = q.astype(np.float32), p.astype(np.float32)
    _close(tmmd.mmd_penalty(torch.from_numpy(q), torch.from_numpy(p), pz=pz,
                            zdim=5),
           jmmd.mmd_penalty(q, p, pz=pz, zdim=5))


@pytest.mark.parametrize("kernel", ["RBF", "IMQ"])
def test_mmd_penalty_with_p(kernel):
    rng = np.random.default_rng(5)
    q, p = rng.random((9, 2)) * 8, rng.random((7, 2)) * 8
    qw, pw = rng.random(9), rng.random(7)
    qw[3] = pw[0] = 0.0  # padded points
    args = [a.astype(np.float32) for a in (q, p, qw, pw)]
    _close(tmmd.mmd_penalty_with_p(*map(torch.from_numpy, args),
                                   kernel=kernel),
           jmmd.mmd_penalty_with_p(*args, kernel=kernel))


def _select_draws(key, shape):
    return np.stack([np.asarray(jax.random.uniform(key, shape)),
                     np.asarray(jax.random.uniform(jax.random.fold_in(key, 1),
                                                   shape))])


def test_select_points_ties():
    """Fewer accepted pixels than k (the -inf priorities tie): the JAX
    draws give the JAX points; equal finite priorities keep the lowest
    indices, as ``lax.top_k`` does."""
    prob = np.zeros((6, 5), np.float32)
    prob[1, 1:4] = 0.9
    prob[4, 2] = 0.7
    key = jax.random.PRNGKey(7)
    jc, jw = jmmd._select_points(jnp.asarray(prob), key, 1.0, 8)
    tc, tw = tmmd._select_points(torch.from_numpy(prob),
                                 torch.from_numpy(_select_draws(key, (6, 5))),
                                 1.0, 8)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert int((tw > 0).sum()) == 4
    draws = np.zeros((2, 6, 5), np.float32)
    draws[1] = np.array([0.5, 0.25])[np.arange(30) % 2].reshape(6, 5)
    prio = np.where(prob > 0, draws[1], -np.inf).reshape(-1)
    _, want = jax.lax.top_k(jnp.asarray(prio), 6)
    tc, _ = tmmd._select_points(torch.from_numpy(prob),
                                torch.from_numpy(draws), 1.0, 6)
    np.testing.assert_array_equal(
        (tc[:, 0] * 5 + tc[:, 1]).long().numpy(), np.asarray(want))


def _decoder_mmd_draws(key, b, h, w):
    keys = jax.random.split(key, b)
    return np.stack([np.stack([
        _select_draws(jax.random.fold_in(keys[i], j), (h, w))
        for j in (0, 1)]) for i in range(b)])


def test_decoder_mmd_loss_with_the_jax_draws():
    rng = np.random.default_rng(6)
    b, h, w = 3, 12, 10
    inputs = rng.random((b, h, w)).astype(np.float32)
    targets = (rng.random((b, h, w)) > 0.7).astype(np.float32)
    targets[2] = 0.0  # an empty cloud: that sample adds 0
    key = jax.random.PRNGKey(11)
    want = jax.jit(functools.partial(jmmd.decoder_mmd_loss, max_points=40))(
        inputs, targets, key)
    draws = torch.from_numpy(_decoder_mmd_draws(key, b, h, w))
    got = tmmd.decoder_mmd_loss(torch.from_numpy(inputs),
                                torch.from_numpy(targets), max_points=40,
                                draws=draws)
    _close(got, want)
    # without draws the port draws from the generator: a finite value
    g = torch.Generator().manual_seed(0)
    assert torch.isfinite(tmmd.decoder_mmd_loss(
        torch.from_numpy(inputs), torch.from_numpy(targets), g))


def test_mmd_loss_pooled_with_the_jax_draws():
    rng = np.random.default_rng(7)
    b, side = 2, 16
    inputs = rng.random((b, side * side)).astype(np.float32)
    targets = (rng.random((b, side, side)) > 0.6).astype(np.float32)
    key = jax.random.PRNGKey(5)
    kx, kt = jax.random.split(key)
    draws = np.stack([np.asarray(jax.random.uniform(k, (b, side, side)))
                      for k in (kx, kt)])
    want = jax.jit(jmmd.mmd_loss_pooled)(inputs, targets, key)
    got = tmmd.mmd_loss_pooled(torch.from_numpy(inputs),
                               torch.from_numpy(targets),
                               draws=torch.from_numpy(draws))
    _close(got, want)


def test_gl_loss_ranks_ties_stably():
    """Integer-valued codes: exact distances with many ties (the zero
    diagonal, equal pairs), ranked as ``jnp.argsort`` ranks them."""
    rng = np.random.default_rng(8)
    enc = rng.integers(0, 3, (6, 4)).astype(np.float32)
    enc[3] = enc[1]
    dec = rng.integers(0, 2, (6, 5, 5)).astype(np.float32)
    dec[4] = dec[0]
    _close(tmmd.gl_loss(torch.from_numpy(enc), torch.from_numpy(dec)),
           jmmd.gl_loss(enc, dec), rtol=1e-6, atol=0)


# ---------------------------- DCGAN decoder -----------------------------

@pytest.mark.parametrize("out_shape", [(16, 16, 1), (8, 12, 2)])
def test_dcgan_decoder(out_shape):
    """The Dense output in flax's NHWC order, the 5x5 SAME transposed
    convolutions, the affine eps-1e-6 instance norms."""
    rng = np.random.default_rng(9)
    z = rng.standard_normal((2, 4)).astype(np.float32)
    tm = tdc.DcganDecoder(coding=4, num_units=16, num_layers=3,
                          out_shape=out_shape).eval()
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, torch.nn.GroupNorm):
                m.weight.uniform_(0.5, 1.5)
                m.bias.uniform_(-0.2, 0.2)
    jm = jdc.DcganDecoder(coding=4, num_units=16, num_layers=3,
                          out_shape=out_shape)
    v = _flax_of(jm, tm, z)
    got = tm(torch.from_numpy(z))
    want = jax.jit(jm.apply)(v, z)
    if out_shape[2] == 1:
        assert got.shape == (2,) + out_shape[:2]
        _close(got, want)
    else:
        _close(got, want)  # (B, C, H, W) vs (B, H, W, C)


# --------------------------- WAE match loss -----------------------------

def test_match_loss_step():
    """One step with weight decay and the plateau's lr at 0.5 (it scales
    the whole update, decay included), the JAX draws injected: the loss
    parts, and the updated parameters within rtol 1e-4.  Adam's first step
    moves an element by lr * g / (|g| + 1e-8): where |g| is below 1e-6 of
    the largest gradient the direction is rounding noise (the two
    ConvTranspose biases that feed an instance norm have an exact gradient
    of 0), so there each package is held to a step of at most
    lr * plateau (1 + weight decay)."""
    rng = np.random.default_rng(10)
    b, coding, shape = 3, 8, (16, 16, 1)
    tl = twae.MatchLoss.create(coding=coding, out_shape=shape,
                               weight_decay=1e-2, device="cpu")
    tl.plateau = dataclasses.replace(tl.plateau, lr=0.5)
    jdec = jdc.DcganDecoder(coding=coding, out_shape=shape)
    z = rng.standard_normal((b, coding)).astype(np.float32)
    ins = (rng.random((b, 16, 16)) > 0.6).astype(np.float32)
    params = _flax_of(jdec, tl.decoder, z)["params"]
    key = jax.random.PRNGKey(3)

    def reference(params, z, ins, key):  # MatchLoss.step, traced once
        tx = optax.chain(optax.clip_by_global_norm(10.0),
                         optax.adamw(1e-3, b1=0.5, b2=0.999,
                                     weight_decay=1e-2))
        ml = jwae.MatchLoss(
            decoder=jdec, params=params, opt_state=tx.init(params),
            plateau=JaxPlateau.create(1.0, 0.5, 25).replace(
                lr=jnp.asarray(0.5)), tx=tx)
        total, parts = ml.step(z, ins, key)
        return total, parts, ml.params

    jtotal, jparts, jparams = jax.jit(reference)(params, z, ins, key)
    draws = torch.from_numpy(_decoder_mmd_draws(key, b, 16, 16))
    ttotal, tparts = tl.step(torch.from_numpy(z), torch.from_numpy(ins),
                             draws=draws)
    _close(ttotal, jtotal)
    for k in jparts:
        _close(tparts[k], jparts[k])
    grads = grads_to_flax(tl.decoder)
    noise = 1e-6 * max(float(np.abs(g).max())
                       for g in jax.tree.leaves(grads))
    for mod in ("ConvTranspose_0", "ConvTranspose_1"):
        assert np.abs(grads[mod]["bias"]).max() < noise
    got = to_flax(tl.decoder)["params"]
    for mod, leaves in _tree(jparams).items():
        for leaf, want in leaves.items():
            small = np.abs(grads[mod][leaf]) < noise
            for new in (got[mod][leaf], want):
                step = np.abs(new - params[mod][leaf])[small]
                assert (step <= 0.5e-3 * 1.01 + 1e-7).all()
            _close(got[mod][leaf][~small], want[~small], rtol=1e-4,
                   atol=1e-7)
    tl.scheduler_step(1.0)
    assert tl.plateau.best == 1.0 and tl.plateau.lr == 0.5
