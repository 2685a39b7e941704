"""The port's training slice against the JAX package: the loss-mode forward
in train mode, the running statistics it leaves behind, the step-0
gradients of every parameter and one optimizer step, at the JAX suite's
tiny size (32x32, n_filters 8, max_n_objects 4, B=2) with
``deterministic_glimpse`` and ``drop_rate`` 0, in float32 on the CPU (the
port takes the plain versions of its kernels).  Both sides load one
numpy-drawn parameter tree.

Sample 1 holds a single instance, so ``maxiter = 1 < K = max_iter = 2``:
the second glimpse slot is weighted by 0 but still decodes in train mode
and moves the BatchNorm statistics, on both sides.

The reference is the JAX package as it runs: its own jitted train step
(``remat`` and ``hoist_skips_train`` on, flax's default variance, XLA's
default optimisation), with one addition, the gradients handed out beside
the new state (``package_step``).  That is the one JAX compile of this
file, and where its time goes.

What float32 allows.  The forward agrees to 1e-4 and better.  The gradient
of this loss is ill-conditioned in the pyramid decoder and in the backbone
below it (some thirty train-mode BatchNorms in a row, each of which
projects the mean and the direction of its input out of the gradient, so
what is left is a small remainder of large terms): moving the decoder's
input features by 5e-6 relative, the agreement of the two float32
backbones, moves the port's own float64 decoder gradients by 1e-2 (median
leaf, relative L2), and the reference's gradients move by 1e-3 (largest
leaf 2e-2) when its parameters move by one ulp (``test_float32_floor_of_the_
reference`` shows it on the reference alone).  So the gradients of those
leaves are held per leaf to 1e-1 with a median of 5e-3 and as a whole to
5e-3 (measured: largest 2.6e-2, median 1.6e-3, whole 1.0e-3), and
everything outside pyramid, stem and backbone (attention, heads, semantic
output) to 2e-4 (measured 4.8e-5).  The pyramid on its own, fed equal features,
agrees to 3e-4 (``tests/test_torch_decoder_loss.py``).  The variable tree
and batch of this file come from the seed, of thirteen tried, at which the
gradients are best conditioned (at the others the median leaf differs up
to fifteen times more).

The optimizer step is compared twice: with the reference's own new
parameters (by the move of each leaf, since Adadelta's first step turns
with the sign of a gradient and a near-zero one may take either), and
exactly (1e-5) with the JAX package's ``apply_gradients`` fed the port's
gradients, carried across by ``grads_to_flax``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.cli.common import build_model
from tpuseg.configs import cvppp_config as jax_cvppp_config
from tpuseg.runtime.state import create_train_state as jax_create_train_state
from tpuseg.runtime.train import make_train_step as jax_make_train_step
from tpuseg_torch.configs import cvppp_config
from tpuseg_torch.models import ReSeg
from tpuseg_torch.runtime.state import create_train_state
from tpuseg_torch.runtime.train import make_train_step
from tpuseg_torch.weights import grads_to_flax, load_flax, to_flax

# tensors this small gain nothing from more threads, and the suite's other
# workers want the cores
torch.set_num_threads(2)


def tiny(cfg, **decoder_kw):
    """The JAX suite's tiny configuration (``tests/test_runtime.py``) at
    n_filters 8, deterministic unless overridden."""
    kw = dict(deterministic_glimpse=True, drop_rate=0.0)
    kw.update(decoder_kw)
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, image_height=32, image_width=32,
                                 max_n_objects=4),
        model=dataclasses.replace(cfg.model, n_filters=8),
        decoder=dataclasses.replace(cfg.decoder, **kw),
    )


def draw_variables(seed=0):
    """The tiny model's variable tree with every leaf drawn from a seeded
    numpy stream at init-like scales (BN statistics not the trivial 0/1).
    The shapes are read off the port's model through ``to_flax``; the
    strict ``load_flax`` and the JAX ``apply`` both hold them to the JAX
    package's tree."""
    shapes = to_flax(ReSeg(tiny(cvppp_config())))
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        name = path[-1].key
        if name == "kernel":
            a = rng.normal(size=v.shape) / np.sqrt(int(np.prod(v.shape[:-1])))
        elif name == "var":
            a = rng.uniform(0.5, 1.5, v.shape)
        elif name in ("scale", "out_gain"):
            a = 1.0 + 0.1 * rng.normal(size=v.shape)
        else:
            a = 0.1 * rng.normal(size=v.shape)
        return a.astype(v.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def make_batch(seed=0, b=2, h=32, w=32, n=4):
    """Random 21-channel images; sample 0 holds two instances, sample 1
    one (the lower half of its square is background)."""
    rng = np.random.RandomState(seed)
    labels = np.zeros((b, h, w), np.int32)
    labels[:, 8:24, 8:24] = 1
    labels[1, 16:24, 8:24] = 0
    ins = np.zeros((b, h, w, n), np.float32)
    ins[:, 8:16, 8:24, 0] = 1
    ins[0, 16:24, 8:24, 1] = 1
    return {
        "images": rng.randn(b, h, w, 21).astype(np.float32),
        "sem_onehot": np.eye(2, dtype=np.float32)[labels],
        "ins_masks": ins,
        "n_objects": np.array([2, 1], np.int32),
    }


def cheap_jit(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` without XLA's expensive
    optimisation passes: these functions run once, and compiling them is
    what the tests' time goes into."""
    return jax.jit(fn).lower(*args).compile(compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True,
    })


def tree_close(got, want, rtol, atol, what):
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    assert len(flat_g) == len(flat_w), what
    for path, w in flat_w:
        np.testing.assert_allclose(
            flat_g[path], np.asarray(w), rtol=rtol, atol=atol,
            err_msg=f"{what}{jax.tree_util.keystr(path)}")


SEED = 9  # see the module docstring


def package_step(jcfg, jmodel):
    """The JAX package's train step with its gradients handed out: the loss
    function of its own ``train_step`` (out of that function's closure),
    differentiated as ``train_step`` differentiates it, then its own
    ``apply_gradients`` and ``grad_norm``.  Returns the jitted
    ``step(state, batch, rng) -> (grads, metrics, new state)``."""
    inner = jax_make_train_step(jcfg, jmodel).__wrapped__
    loss_fn = dict(zip(inner.__code__.co_freevars,
                       (c.cell_contents for c in inner.__closure__)))["loss_fn"]

    def step(state, batch, rng):
        grads, (metrics, mut) = jax.grad(loss_fn, has_aux=True)(
            state.params, state, batch, rng)
        metrics["grad_norm"] = jnp.sqrt(
            sum(jnp.sum(g * g) for g in jax.tree_util.tree_leaves(grads)))
        return grads, metrics, state.apply_gradients(
            grads, batch_stats=mut["batch_stats"],
            decoder_state=mut["decoder_state"])

    return jax.jit(step)


@pytest.fixture(scope="module")
def both():
    return run_both()


def run_both():
    """On each side, from the same variables and batch: one train step
    (forward, backward, optimizer).  Returns everything the tests below
    compare."""
    jcfg, tcfg = tiny(jax_cvppp_config()), tiny(cvppp_config())
    for c in (jcfg, tcfg):
        assert c.decoder.remat and c.decoder.hoist_skips_train
    jmodel = build_model(jcfg)
    variables = draw_variables(SEED)
    batch = make_batch(SEED)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    j_state0 = jax_create_train_state(jcfg, variables)
    j_step = package_step(jcfg, jmodel)
    rng = jax.random.PRNGKey(0)  # nothing is drawn: deterministic, no dropout
    j_grads, j_metrics, j_state = j_step(j_state0, jb, rng)

    # the same compiled step at parameters one ulp away (1e-7 relative)
    noise = np.random.default_rng(1)
    nudged = jax.tree.map(
        lambda a: (a * (1 + 1e-7 * noise.standard_normal(a.shape))).astype(
            np.float32), variables["params"])
    j_grads_nudged = j_step(j_state0.replace(params=nudged), jb, rng)[0]

    # the port: the same step through its entry points; the gradients are
    # read just before the optimizer applies
    model = load_flax(ReSeg(tcfg), variables)
    state = create_train_state(tcfg, model, device="cpu")
    step = make_train_step(tcfg, model)
    seen = {}
    apply_gradients = state.apply_gradients

    def spy():
        seen.update(grads=grads_to_flax(model), forward=to_flax(model),
                    points=list(model.decoder.last_points))
        apply_gradients()

    state.apply_gradients = spy
    state, m1 = step(state, batch, None)

    # the JAX package's optimizer step on the port's gradients
    def jax_apply(state0, grads, stepped):
        return state0.apply_gradients(
            grads, batch_stats=stepped.batch_stats,
            decoder_state=stepped.decoder_state)

    j_applied = cheap_jit(jax_apply, j_state0, seen["grads"], j_state)(
        j_state0, seen["grads"], j_state)
    return dict(
        variables=variables, batch=batch, j_metrics=j_metrics,
        j_grads=jax.tree.map(np.asarray, j_grads),
        j_grads_nudged=jax.tree.map(np.asarray, j_grads_nudged),
        j_state=j_state, j_applied=j_applied, m1=m1, t_grads=seen["grads"],
        t_forward=seen["forward"], points=seen["points"],
        t_step1=to_flax(model), state=state)


ILL = ("['base']", "['ins_stem']", "['bone']")  # see the module docstring


def leaf_errors(want, got):
    """[(path string, relative L2 error)] over the leaves whose reference
    gradient is more than 1e-4 of the largest; the others must be as small
    on the other side (a bias in front of a train-mode BatchNorm has a
    zero gradient but for float noise)."""
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(flat_w) == len(flat_g)
    top = max(float(np.abs(w).max()) for _, w in flat_w)
    out = []
    for path, w in flat_w:
        name = jax.tree_util.keystr(path)
        w = np.asarray(w, np.float64)
        g = np.asarray(flat_g[path], np.float64)
        if np.abs(w).max() < 1e-4 * top:
            assert np.abs(g).max() < 2e-4 * top, name
            continue
        out.append((name, np.linalg.norm(g - w) / np.linalg.norm(w)))
    return out


def split_ill(errors):
    ill = [e for n, e in errors if any(k in n for k in ILL)]
    well = [(n, e) for n, e in errors if not any(k in n for k in ILL)]
    return ill, well


def test_loss_mode_train_forward_matches_jax(both):
    """Every key of ``total_cost``'s metrics (the decoder losses among
    them) as ``train_step`` returns them, rtol 1e-4; ``grad_norm``, the
    norm of the raw gradients, to 5e-3."""
    want, got = both["j_metrics"], both["m1"]
    assert set(got) == set(want) and len(want) == 12
    for k, v in want.items():
        np.testing.assert_allclose(
            float(got[k]), float(v), rtol=5e-3 if k == "grad_norm" else 1e-4,
            atol=1e-6, err_msg=k)


def test_glimpse_points_and_slot_count(both):
    """Training runs all K = 2 slots although maxiter = 1.  Every glimpse
    lies inside its instance (slot k takes instance k under
    ``deterministic_glimpse``), except the one of the empty slot, which
    falls to index 0."""
    ins = both["batch"]["ins_masks"].reshape(2, -1, 4)
    assert len(both["points"]) == 2
    for k, s in enumerate(both["points"]):
        for i in range(2):
            if k < both["batch"]["n_objects"][i]:
                assert ins[i, int(s[i]), k] == 1.0
            else:
                assert int(s[i]) == 0


def test_running_stats_after_train_step_match_jax(both):
    """``batch_stats`` (biased variances; the decoder's moved by both glimpse
    slots, the invalid one included; the hoisted skip transforms' by the
    0.9^K rule) and the REINFORCE baseline against the state the JAX step
    ends with, after the port's forward and after its whole step; rtol
    1e-4."""
    want = both["j_state"]
    for got in (both["t_forward"], both["t_step1"]):
        tree_close(got["batch_stats"], want.batch_stats,
                   rtol=1e-4, atol=1e-5, what="batch_stats")
        np.testing.assert_allclose(
            got["decoder_state"]["decoder"]["baseline"],
            np.asarray(want.decoder_state["decoder"]["baseline"]), rtol=1e-4)
    # and they did move
    moved = jax.tree.map(lambda a, b: float(np.abs(a - b).max()),
                         both["t_forward"]["batch_stats"],
                         both["variables"]["batch_stats"])
    assert min(jax.tree_util.tree_leaves(moved)) > 0


def test_step0_gradients_match_jax(both):
    """Leaf by leaf, every parameter, against the gradients of the JAX
    package's own train step (relative L2 per leaf).  Outside pyramid, stem
    and backbone: 2e-4.  Inside (see the module docstring): each leaf 1e-1,
    their median 5e-3, all gradients as one vector 5e-3.  The leaves
    left out (some forty) have a zero gradient but for float noise, on
    both sides."""
    errors = leaf_errors(both["j_grads"], both["t_grads"])
    ill, well = split_ill(errors)
    assert len(well) >= 20 and len(ill) >= 380
    for name, e in well:
        assert e <= 2e-4, (name, e)
    for name, e in errors:
        assert e <= 1e-1, (name, e)
    assert np.median(ill) <= 5e-3

    def flat(tree):
        return np.concatenate([
            np.asarray(a, np.float64).ravel()
            for a in jax.tree_util.tree_leaves(tree)])

    w, g = flat(both["j_grads"]), flat(both["t_grads"])
    assert np.linalg.norm(g - w) <= 5e-3 * np.linalg.norm(w)


def test_float32_floor_of_the_reference(both):
    """What the tolerances above rest on, shown on the reference alone: the
    same compiled JAX step, its parameters moved by 1e-7 relative (one
    ulp), changes its own pyramid, stem and backbone gradients by more than
    3e-4 in the median leaf, and its other gradients by less than 1e-4
    anywhere.  The port is within ten times that of the reference."""
    floor = leaf_errors(both["j_grads"], both["j_grads_nudged"])
    ill, well = split_ill(floor)
    assert 3e-4 <= np.median(ill) <= 1e-2
    assert max(e for _, e in well) <= 1e-4
    port_ill, _ = split_ill(leaf_errors(both["j_grads"], both["t_grads"]))
    assert np.median(port_ill) <= 10 * np.median(ill)


def test_one_optimizer_step_matches_jax(both):
    """Parameters after ``train_step``.  Against the JAX package's
    ``apply_gradients`` on the same gradients (density pre-clip, global
    clip, Adadelta with L2 weight decay, plateau scale): rtol 1e-5.
    Against the parameters the JAX step itself ends with: the move of each
    leaf to 5e-2 (relative L2), the median leaf's to 5e-3 (measured 1.5e-2
    and 1.3e-3), no element further apart than 6.4e-3.  Adadelta's first step moves an element by
    at most ``sqrt(eps / 0.1) = 3.2e-3`` and turns with the gradient's
    sign."""
    got = both["t_step1"]["params"]
    tree_close(got, both["j_applied"].params, rtol=1e-5, atol=1e-7,
               what="params")
    before = both["variables"]["params"]
    moved = np.concatenate([
        np.abs(np.asarray(a) - b).ravel() for a, b in zip(
            jax.tree_util.tree_leaves(before),
            jax.tree_util.tree_leaves(got))])
    assert 2e-3 < moved.max() <= 3.2e-3 and np.median(moved) > 1e-5
    assert both["state"].step == 1 and int(both["j_state"].step) == 1

    want = jax.tree.map(np.asarray, both["j_state"].params)
    rel = []
    for w, g, b in zip(*(jax.tree_util.tree_leaves(t)
                         for t in (want, got, before))):
        assert np.abs(g - w).max() <= 6.4e-3
        rel.append(np.linalg.norm(g - w) / np.linalg.norm(w - b))
    assert max(rel) <= 5e-2 and np.median(rel) <= 5e-3
