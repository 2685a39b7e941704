"""The port's training recipes (``tpuseg_torch/tools/``) on the CPU at
small widths (``test_torch_train.tiny``: 32x32, n_filters 8).

Against the JAX package's ``tools/train_density.py`` (loaded from its
file), float32:

* ``make_pool`` and ``host_density_target`` bitwise equal;
* the density-head loss equal to the JAX tool's expression over
  ``model.apply(mode="density")`` within 1e-5 relative, the head's
  gradients within 1e-4 of the largest, and no gradient reaches the
  backbone;
* five clip + Adam + cosine steps equal to the optax chain within 1e-5;
* the closed-form count calibration folded into ``out_gain`` /
  ``out_off`` equal to the JAX tool's own lines on the same estimates.

The port alone: two epochs of ``train_hard_r3``'s loop with
``--freeze_bn --freeze_subtrees count_head,density_head --warm_opt 1
--swa_frac 1`` keep the pinned subtrees and every batch statistic bitwise
at the resumed checkpoint's, the warm-up moves no weight while filling the
Adadelta accumulators, and the SWA candidate is the mean of its snapshots;
``overfit_check`` and ``train_synthetic_e2e`` run end to end; the tools'
outputs go only where they are told (an install needs an explicit target).

One JAX compile: the density head's value and gradient.
"""

import contextlib
import dataclasses
import importlib.util
import io
import os
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_predict import _draw
from test_torch_train import tiny

from tpuseg.cli.common import build_model, init_variables
from tpuseg.configs import cvppp_config as jax_cvppp_config
from tpuseg.data.colorspace import image_ex_standardize as jax_standardize
from tpuseg_torch.cli.common import init_model
from tpuseg_torch.configs import cvppp_config
from tpuseg_torch.data.dataset import AlignCollate
from tpuseg_torch.data.loader import PrefetchLoader
from tpuseg_torch.data.records import SegRecordDataset
from tpuseg_torch.data.synthetic import write_synthetic_records
from tpuseg_torch.models import ReSeg
from tpuseg_torch.models.reseg import DENSITY_SCALE
from tpuseg_torch.runtime.state import create_train_state
from tpuseg_torch.runtime.train import make_train_step
from tpuseg_torch.tools import (
    overfit_check, train_density, train_hard_r3, train_synthetic_e2e,
)
from tpuseg_torch.utils.checkpoint_io import read_msgpack, write_msgpack
from tpuseg_torch.weights import grads_to_flax, load_flax, to_flax

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOL = os.path.join(REPO, "tools", "train_density.py")


def _jax_train_density():
    spec = importlib.util.spec_from_file_location("jax_train_density",
                                                  JAX_TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_pool_and_density_target_are_the_jax_tools():
    jtd = _jax_train_density()
    want = jtd.make_pool(np.random.default_rng(4), 6, 32, 16, hard_frac=0.5,
                         max_leaves=14)
    got = train_density.make_pool(np.random.default_rng(4), 6, 32, 16,
                                  hard_frac=0.5, max_leaves=14)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    imgs, labels, counts = got
    rng_a, rng_b = np.random.default_rng(9), np.random.default_rng(9)
    lab_a, lab_b = labels.copy(), labels.copy()
    img_a, img_b = imgs.copy(), imgs.copy()
    train_density.d4_augment(rng_a, img_a, lab_a)
    for j in range(len(img_b)):  # the JAX tool's loop, inline there
        k = int(rng_b.integers(0, 4))
        if k:
            img_b[j] = np.rot90(img_b[j], k)
            lab_b[j] = np.rot90(lab_b[j], k)
        if rng_b.random() < 0.5:
            img_b[j] = img_b[j][:, ::-1]
            lab_b[j] = lab_b[j][:, ::-1]
    assert np.array_equal(img_a, img_b) and np.array_equal(lab_a, lab_b)
    g = train_density.host_density_target(lab_a, counts, 16, DENSITY_SCALE)
    w = jtd.host_density_target(lab_a, counts, 16, DENSITY_SCALE)
    assert g.shape == (6, 8, 8, 1) and g.tobytes() == w.tobytes()


def test_density_loss_and_head_gradient_match_the_jax_tool():
    res = 32
    jcfg = train_density.recipe_config(res, cfg=tiny(jax_cvppp_config()))
    tcfg = train_density.recipe_config(res, cfg=tiny(cvppp_config()))
    jmodel = build_model(jcfg)
    variables = _draw(jax.eval_shape(
        lambda: init_variables(jcfg, jmodel, 0)), seed=6)
    imgs, labels, counts = train_density.make_pool(
        np.random.default_rng(2), 4, res, 16)
    gt = train_density.host_density_target(labels, counts, 16, DENSITY_SCALE)

    base = {k: v for k, v in variables["params"].items()
            if k != "density_head"}
    aux = {k: v for k, v in variables.items() if k != "params"}

    def loss_fn(head_params, imgs_u8, gt, counts):  # the JAX tool's
        params = {**base, "density_head": head_params}
        dens = jmodel.apply({"params": params, **aux},
                            jax_standardize(imgs_u8), train=False,
                            mode="density")
        mse = jnp.mean(jnp.square(dens - gt)) * float(
            (res // 4) * (res // 4) / 16.0)
        est = jnp.sum(dens, axis=(1, 2, 3)) / DENSITY_SCALE
        cl = jnp.mean(jnp.square(est - counts.astype(jnp.float32)))
        return mse + 0.1 * cl, est

    (want, want_est), want_g = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"]["density_head"],
                                jnp.asarray(imgs), jnp.asarray(gt),
                                jnp.asarray(counts))

    model = load_flax(ReSeg(tcfg), variables).eval()
    loss, est = train_density.density_loss(model, model.density_head, imgs,
                                           gt, counts, res)
    loss.backward()
    assert abs(loss.item() - float(want)) <= 1e-5 * abs(float(want))
    np.testing.assert_allclose(est.detach().numpy(), np.asarray(want_est),
                               rtol=1e-5, atol=1e-5)
    got_g = grads_to_flax(model)["density_head"]
    scale = max(float(np.abs(np.asarray(v)).max())
                for v in jax.tree_util.tree_leaves(want_g))
    for k, sub in want_g.items():
        for leaf, v in (sub.items() if isinstance(sub, dict)
                        else [(None, sub)]):
            g = got_g[k] if leaf is None else got_g[k][leaf]
            np.testing.assert_allclose(g, np.asarray(v), rtol=0,
                                       atol=1e-4 * scale, err_msg=k)
    assert all(p.grad is None for n, p in model.named_parameters()
               if not n.startswith("density_head."))


def test_clipped_adam_is_the_optax_chain():
    rng = np.random.default_rng(0)
    params0 = {"w": rng.normal(size=(3, 4)).astype(np.float32),
               "b": rng.normal(size=(4,)).astype(np.float32)}
    steps, lr = 5, 5e-2
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adam(optax.cosine_decay_schedule(lr, steps,
                                                            alpha=0.05)))
    jp = {k: jnp.asarray(v) for k, v in params0.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params0.items()}
    opt = train_density.ClippedAdam(tp.values(), lr, steps)
    for i in range(steps):
        # norms above and below the clip
        scale = 3.0 if i % 2 == 0 else 0.05
        grads = {k: (scale * rng.normal(size=v.shape)).astype(np.float32)
                 for k, v in params0.items()}
        updates, state = tx.update({k: jnp.asarray(v)
                                    for k, v in grads.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k].copy())
        opt.step()
        for k in params0:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{k} step {i}")
    assert opt.count == steps


def test_count_calibration_fold_is_the_jax_tools():
    src = open(JAX_TOOL).read()
    start = src.index("    A = np.stack([ests, np.ones_like(ests)]")
    end = src.index("\n", src.index('    best["out_off"] ='))
    rng = np.random.default_rng(1)
    vc = rng.integers(3, 15, size=40)
    ests = (vc * 0.8 + 1.3 + rng.normal(scale=0.6, size=40)).astype(
        np.float32)
    ns = {"np": np, "ests": ests, "vc": vc,
          "best": {"out_gain": np.full((1,), 1.1, np.float32),
                   "out_off": np.full((1,), 0.2, np.float32)}}
    exec(textwrap.dedent(src[start:end]), ns)

    a, b = train_density.calibrate_counts(ests, vc)
    assert (a, b) == (ns["a_fit"], ns["best_b"])
    head = ReSeg(train_density.recipe_config(
        32, cfg=tiny(cvppp_config()))).density_head
    with torch.no_grad():
        head.out_gain.fill_(1.1)
        head.out_off.fill_(0.2)
    train_density.fold_calibration(head, a, b)
    for name in ("out_gain", "out_off"):
        got = getattr(head, name).detach().numpy()
        want = np.asarray(ns["best"][name])
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.fixture(scope="module")
def tiny_asset(tmp_path_factory):
    """A checkpoint of the small model written by the port's writer, with
    BatchNorm statistics that are not the trivial 0 / 1."""
    model = init_model(tiny(cvppp_config()), seed=4)
    tree = to_flax(model)
    rng = np.random.default_rng(8)
    for path, _ in list(_leaf_paths(tree["batch_stats"])):
        node = tree["batch_stats"]
        for p in path[:-1]:
            node = node[p]
        node[path[-1]] = rng.uniform(0.2, 1.5, node[path[-1]].shape).astype(
            np.float32)
    path = str(tmp_path_factory.mktemp("asset") / "tiny.msgpack")
    write_msgpack(path, tree)
    return path


def _leaf_paths(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_paths(v, path + (k,))
        else:
            yield path + (k,), v


def test_hard_r3_loop_pins_what_it_freezes(tiny_asset, tmp_path,
                                           monkeypatch):
    snaps = []
    add = train_hard_r3.TreeAverage.add

    def recording_add(self, tree):
        snaps.append({c: {k: np.array(v) for k, v in _leaf_paths(t)}
                      for c, t in tree.items()})
        add(self, tree)

    monkeypatch.setattr(train_hard_r3.TreeAverage, "add", recording_add)
    cfg = train_hard_r3.recipe_config(32, 4, 0.3, cfg=tiny(cvppp_config()))
    out = str(tmp_path / "hard.msgpack")
    with contextlib.redirect_stdout(io.StringIO()) as log:
        r = train_hard_r3.run(
            cfg, epochs=2, n_train=8, n_val=4, eval_every=1,
            root=str(tmp_path / "r3"), out=out, device="cpu",
            resume_from=tiny_asset, n_workers=2, eval_batch=4,
            freeze_bn=True, freeze_subtrees="count_head,density_head",
            warm_opt=1, swa_frac=1.0)
    text = log.getvalue()
    assert "pinned subtrees: ['count_head', 'density_head']" in text
    assert "opt-warmup epoch 0 done" in text and "SWA(2 snapshots)" in text

    asset = to_flax(load_flax(ReSeg(cfg), read_msgpack(tiny_asset)))
    final = to_flax(r["state"].model)
    moved = 0
    for col in ("params", "batch_stats"):
        for path, want in _leaf_paths(asset[col]):
            got = final[col]
            for p in path:
                got = got[p]
            same = got.tobytes() == want.tobytes()
            if col == "batch_stats" or path[0] in ("count_head",
                                                   "density_head"):
                assert same, (col, path)
            else:
                moved += not same
    assert moved > 0  # the rest trained
    # the SWA candidate: the mean of the two epochs' snapshots
    assert r["swa_n"] == len(snaps) == 2
    for col in ("params", "batch_stats"):
        for path, got in _leaf_paths(r["swa_payload"][col]):
            key = path
            want = ((snaps[0][col][key].astype(np.float64)
                     + snaps[1][col][key]) / 2).astype(np.float32)
            assert got.tobytes() == want.tobytes(), (col, path)
    # an unbeaten incumbent leaves the output unwritten; a win writes it
    assert r["saved"] == os.path.isfile(out)


def test_warm_opt_fills_the_optimizer_and_moves_no_weight(tiny_asset,
                                                          tmp_path):
    cfg = tiny(cvppp_config())
    model = load_flax(ReSeg(cfg), read_msgpack(tiny_asset))
    state = create_train_state(cfg, model, device="cpu")
    assert cfg.train.optimizer == "Adadelta" and cfg.train.weight_decay > 0
    write_synthetic_records(str(tmp_path / "train"), 4, seed=1, height=32,
                            width=32)
    loader = PrefetchLoader(SegRecordDataset(str(tmp_path / "train")),
                            AlignCollate("training", cfg.data, 2), 2,
                            shuffle=True, seed=0, n_workers=1)
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    stats = {k: v.clone() for k, v in
             train_hard_r3.batch_stat_buffers(model).items()}
    gen = torch.Generator().manual_seed(0)
    with contextlib.redirect_stdout(io.StringIO()):
        train_hard_r3.warm_optimizer(state, make_train_step(cfg, model),
                                     loader, gen, 1, time.time())
    for k, v in model.named_parameters():
        assert torch.equal(v, params[k]), k
    for k, v in train_hard_r3.batch_stat_buffers(model).items():
        assert torch.equal(v, stats[k]), k
    slots = [state.optimizer.state[p] for p in model.parameters()
             if p in state.optimizer.state]
    assert state.step == 2 and slots and all(s["step"] == 2 for s in slots)
    assert sum(int((s["square_avg"] > 0).sum()) for s in slots) > 0
    assert sum(int((s["acc_delta"] > 0).sum()) for s in slots) > 0


def test_overfit_and_e2e_recipes_run_and_write_only_where_told(
        tiny_asset, tmp_path, monkeypatch):
    with contextlib.redirect_stdout(io.StringIO()) as log:
        costs = overfit_check.run(tiny(cvppp_config()), steps=6,
                                  device="cpu", res=32)
    assert len(costs) == 6 and np.isfinite(costs).all()
    assert "OVERFIT CHECK PASSED" in log.getvalue()

    # resumed (TPUSEG_RESUME=1), so the FG-dice gate is off, as in JAX
    monkeypatch.setenv("TPUSEG_RESUME", "1")
    cfg = train_synthetic_e2e.recipe_config(32, 4, 1.0,
                                            cfg=tiny(cvppp_config()))
    target = tmp_path / "installed.msgpack"
    target.write_bytes(b"old")
    asset_bytes = open(tiny_asset, "rb").read()
    with contextlib.redirect_stdout(io.StringIO()) as log:
        r = train_synthetic_e2e.run(
            cfg, epochs=2, n_train=8, n_val=4, eval_every=1,
            install_bar=-1.0, root=str(tmp_path / "e2e"), device="cpu",
            resume_from=tiny_asset, n_workers=2)
    text = log.getvalue()
    assert f"resumed weights from {tiny_asset}" in text
    assert "NOT installed" in text and "no --install_to" in text
    assert r["steps"] == 4 and r["out"] == str(tmp_path / "e2e" /
                                               "trained_ckpt.msgpack")
    assert sorted(read_msgpack(r["out"])) == ["batch_stats", "decoder_state",
                                              "params"]
    assert target.read_bytes() == b"old"
    assert open(tiny_asset, "rb").read() == asset_bytes
    # a bar every SBD clears, and a target: the best weights land there
    with contextlib.redirect_stdout(io.StringIO()):
        r2 = train_synthetic_e2e.run(
            cfg, epochs=1, n_train=8, n_val=4, eval_every=1,
            install_bar=-1.0, install_to=str(target),
            root=str(tmp_path / "e2e2"), device="cpu",
            resume_from=tiny_asset, n_workers=2)
    assert target.read_bytes() == open(r2["out"], "rb").read()


class _Stop(Exception):
    pass


@pytest.mark.parametrize("tool", ["overfit_check", "train_synthetic_e2e",
                                  "train_density", "train_hard_r3"])
def test_recipes_train_with_tf32_off(tool, monkeypatch):
    """Each training recipe runs in float32 with TF32 off, as the JAX
    recipe computes it, and puts PyTorch's settings back after."""
    mod = {"overfit_check": overfit_check,
           "train_synthetic_e2e": train_synthetic_e2e,
           "train_density": train_density,
           "train_hard_r3": train_hard_r3}[tool]
    seen = []

    def spy(device):  # the first call of every recipe's run
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        raise _Stop

    monkeypatch.setattr(mod, "resolve_device", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(_Stop):
        mod.run(tiny(cvppp_config()))
    assert seen == [(False, False)]
    assert torch.backends.cudnn.allow_tf32
    assert torch.backends.cuda.matmul.allow_tf32


def test_outputs_default_to_the_temp_dir_and_the_pool_cache_key():
    import tempfile

    from tpuseg_torch.tools import calibrate_stopping

    tmp = tempfile.gettempdir()
    for d in (train_synthetic_e2e.ROOT, train_hard_r3.ROOT,
              calibrate_stopping.OUT_DIR):
        assert os.path.dirname(d) == tmp
    base = dict(cache_dir="c", pool=8, res=32, seed=5, hard_frac=0.5,
                max_leaves=14)
    path = train_density.pool_cache_path(**base)
    assert path == train_density.pool_cache_path(**base)
    assert os.path.dirname(path) == "c"
    for k, v in (("pool", 9), ("res", 64), ("seed", 6), ("hard_frac", 1.0),
                 ("max_leaves", 12)):
        assert train_density.pool_cache_path(**{**base, k: v}) != path, k


def test_density_install_needs_an_explicit_checkpoint():
    with pytest.raises(SystemExit):
        with contextlib.redirect_stderr(io.StringIO()):
            train_density.main(["--install", "--steps", "1"])
