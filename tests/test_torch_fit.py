"""The port's train state, optimizer chain, plateau schedule, checkpoint and
``fit`` loop, at the tiny configuration on the CPU.  The plateau schedule
and the optimizer chain are held against the JAX package's (optax, run
eagerly on a toy tree: nothing to compile); the rest checks the port's own
behaviour: determinism under a seed, sampled glimpses, frozen backbone,
logs and checkpoints.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from test_torch_train import draw_variables, make_batch, tiny
from tpuseg_torch.configs import cvppp_config
from tpuseg_torch.data.synthetic import make_batch as synthetic_batch
from tpuseg_torch.models import ReSeg
from tpuseg_torch.runtime.checkpoint import restore_checkpoint, save_checkpoint
from tpuseg_torch.runtime.loop import fit
from tpuseg_torch.runtime.state import (
    PlateauState,
    TrainState,
    create_train_state,
    make_optimizer,
)
from tpuseg_torch.runtime.train import make_eval_step, make_train_step
from tpuseg_torch.weights import load_flax


@pytest.fixture(scope="module")
def variables():
    return draw_variables()


def _state(cfg, variables, seed=None):
    model = load_flax(ReSeg(cfg), variables)
    return model, create_train_state(cfg, model, device="cpu")


def test_plateau_state_matches_jax():
    from tpuseg.runtime.state import PlateauState as JaxPlateau

    seq = [1.0, 0.9, 0.8, 0.79999, 0.9, 0.9, 0.9, 0.7, 0.7, 0.7, 0.7, 0.7,
           0.69, 5.0, 5.0, 5.0, 5.0]
    want = JaxPlateau.create(1.0, 0.5, patience=2)
    got = PlateauState.create(1.0, 0.5, patience=2)
    drops = 0
    for v in seq:
        want, prev = want.step(v), got.lr
        got = got.step(v)
        drops += got.lr < prev
        assert got.lr == float(want.lr)
        assert got.num_bad == int(want.num_bad)
        np.testing.assert_allclose(got.best, float(want.best), rtol=1e-7)
    assert drops == 3 and got.lr == 0.125


class _Toy(torch.nn.Module):
    """Three top-level subtrees, named as the chain's masks expect."""

    def __init__(self, tree):
        super().__init__()
        for name, leaves in tree.items():
            sub = torch.nn.Module()
            for leaf, a in leaves.items():
                sub.register_parameter(
                    leaf, torch.nn.Parameter(torch.from_numpy(a.copy())))
            self.add_module(name, sub)


@pytest.mark.parametrize("optimizer,train_cnn", [
    ("Adadelta", True), ("Adadelta", False), ("Adam", True), ("SGD", True),
    ("RMSprop", True),
])
def test_optimizer_chain_matches_optax(optimizer, train_cnn):
    """Three steps of density pre-clip -> global clip -> optimizer with L2
    weight decay -> plateau scale, against ``tpuseg.runtime.state``'s optax
    chain on the same gradients (rtol 1e-5 + 2e-5 absolute on steps of
    size 0.5; RMSprop 5e-3: torch adds its
    ``eps`` outside the square root, optax inside).  The density gradients
    are large enough for both clips to act; with ``train_cnn`` off ``base``
    does not move at all."""
    import jax
    import jax.numpy as jnp

    from tpuseg.configs import cvppp_config as jax_cvppp_config
    from tpuseg.runtime.state import create_train_state as jax_create

    def with_train(cfg):
        return dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, optimizer=optimizer, train_cnn=train_cnn))

    rng = np.random.default_rng(0)
    shapes = {"base": {"w": (4, 3), "b": (3,)}, "density_head": {"w": (5, 2)},
              "decoder": {"w": (2, 2, 3)}}
    params = {k: {n: rng.normal(size=s).astype(np.float32)
                  for n, s in sub.items()} for k, sub in shapes.items()}
    grads = [{k: {n: (rng.normal(size=s) * (40.0 if k == "density_head"
                                            else 3.0)).astype(np.float32)
                  for n, s in sub.items()} for k, sub in shapes.items()}
             for _ in range(3)]

    jstate = jax_create(with_train(jax_cvppp_config()), {"params": params})
    jstate = jstate.replace(plateau=jstate.plateau.replace(
        lr=jnp.asarray(0.5, jnp.float32)))
    for g in grads:
        jstate = jstate.apply_gradients(jax.tree.map(jnp.asarray, g))

    cfg = with_train(cvppp_config())
    toy = _Toy(params)
    state = TrainState(cfg, toy, make_optimizer(cfg, toy),
                       PlateauState.create(0.5, 0.5, 25))
    for g in grads:
        for k, sub in g.items():
            for n, a in sub.items():
                getattr(getattr(toy, k), n).grad = torch.from_numpy(a.copy())
        state.apply_gradients()
    assert state.step == 3
    rtol = 5e-3 if optimizer == "RMSprop" else 1e-5
    for k, sub in params.items():
        for n, a in sub.items():
            got = getattr(getattr(toy, k), n).detach().numpy()
            np.testing.assert_allclose(
                got, np.asarray(jstate.params[k][n]), rtol=rtol, atol=2e-5,
                err_msg=f"{k}.{n}")
            assert (got != a).any() == (train_cnn or k != "base")


def test_train_cnn_false_leaves_base_bit_equal(variables):
    cfg = tiny(cvppp_config())
    cfg = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, train_cnn=False))
    model, state = _state(cfg, variables)
    before = {k: v.clone() for k, v in model.base.state_dict().items()}
    other = model.ins_stem.Conv_1.weight.detach().clone()
    step = make_train_step(cfg, model, train_cnn=False)
    state, metrics = step(state, make_batch(), None)
    for k, v in model.base.state_dict().items():
        if "running_" in k or "num_batches" in k:
            continue  # BatchNorm statistics still follow the batches
        assert torch.equal(v, before[k]), k
    assert not torch.equal(model.ins_stem.Conv_1.weight, other)
    assert np.isfinite(float(metrics["grad_norm"]))


def test_sampling_and_dropout_are_seeded_and_glimpses_stay_inside(variables):
    """With sampling and dropout on: two runs of two steps from the same
    generator seed end with equal parameters (the next test shows that it
    does sample); every sampled glimpse of a valid slot lies inside its
    instance; the costs are finite."""
    cfg = tiny(cvppp_config(), deterministic_glimpse=False, drop_rate=0.5)
    batch = make_batch()
    ins = batch["ins_masks"].reshape(2, -1, 4)
    finals = []
    for seed, n_steps in ((3, 2), (3, 2), (4, 1)):
        model, state = _state(cfg, variables)
        step = make_train_step(cfg, model)
        gen = torch.Generator().manual_seed(seed)
        for _ in range(n_steps):
            state, metrics = step(state, batch, gen)
            assert np.isfinite(float(metrics["cost"]))
            for s in model.decoder.last_points:
                for i in range(2):
                    owners = ins[i, int(s[i])]
                    # a slot past the sample's instances draws anywhere
                    assert owners.sum() == 1.0 or batch["n_objects"][i] < 2
        finals.append(torch.cat([p.detach().flatten()
                                 for p in model.parameters()]))
    assert torch.equal(finals[0], finals[1])
    assert finals[2].isfinite().all()


def test_sampled_glimpse_never_leaves_its_instance(variables):
    """Many draws of the first slot: ``multinomial`` of the instance's
    distribution never picks a pixel outside it."""
    cfg = tiny(cvppp_config(), deterministic_glimpse=False, max_iter=1)
    model = load_flax(ReSeg(cfg), variables).train()
    from tpuseg_torch.runtime.train import model_inputs

    batch = make_batch()
    images, sem, ins, n_obj = model_inputs(batch, "cpu")
    flat = batch["ins_masks"].reshape(2, -1, 4)
    gen = torch.Generator().manual_seed(0)
    seen = set()
    with torch.no_grad():
        for _ in range(12):
            model.loss(images, sem, ins, n_obj, generator=gen)
            (s,) = model.decoder.last_points
            for i in range(2):
                inst = int(np.argmax(flat[i, int(s[i])]))
                assert flat[i, int(s[i]), inst] == 1.0
                assert inst < batch["n_objects"][i]
            seen.add(tuple(s.tolist()))
    assert len(seen) > 6  # it does sample


def test_fit_writes_logs_and_a_checkpoint_that_restores(tmp_path, variables,
                                                        capsys):
    """One epoch of two synthetic batches: ``training.log`` /
    ``validation.log`` / ``metrics.jsonl``, the best-val checkpoint under
    the JAX package's name pattern, and a restore into a fresh state that
    equals the trained one (model, optimizer slots, plateau, step)."""
    cfg = tiny(cvppp_config(), deterministic_glimpse=False, drop_rate=0.5)
    rng = np.random.default_rng(0)
    batches = [synthetic_batch(rng, 2, 32, 32, max_n_objects=4)
               for _ in range(2)]
    assert batches[0]["images"].dtype == np.uint8
    assert batches[0]["ins_masks"].shape == (2, 32, 32, 4)
    model, state = _state(cfg, variables)
    run_dir = str(tmp_path / "run")
    state = fit(cfg, model, state, lambda epoch: batches,
                lambda epoch: batches[:1], run_dir, n_epochs=1, log_every=1)
    assert state.step == 2 and state.plateau.best < float("inf")
    files = os.listdir(run_dir)
    assert {"training.log", "validation.log", "metrics.jsonl"} <= set(files)
    with open(os.path.join(run_dir, "training.log")) as f:
        lines = f.read().strip().splitlines()
    assert lines[0] == "Epoch,Cost" and len(lines) == 2
    assert "Epoch [0/1]" in capsys.readouterr().out
    ckpts = [f for f in files if f.startswith("model_0_")]
    assert len(ckpts) == 1 and ckpts[0].endswith("_1")  # lr 1 -> "%.4g"

    model2, state2 = _state(cfg, variables)
    restore_checkpoint(os.path.join(run_dir, ckpts[0]), state2)
    assert state2.step == 2 and state2.plateau == state.plateau
    for (k, a), (_, b) in zip(model.state_dict().items(),
                              model2.state_dict().items()):
        assert torch.equal(a, b), k
    slots = state.optimizer.state_dict()["state"]
    slots2 = state2.optimizer.state_dict()["state"]
    assert slots.keys() == slots2.keys() and len(slots) > 400
    for i in slots:
        for name in ("square_avg", "acc_delta"):
            assert torch.equal(slots[i][name], slots2[i][name])
    # a restored state trains on: same next step from the same seed
    metrics = []
    for m, s in ((model, state), (model2, state2)):
        gen = torch.Generator().manual_seed(9)
        metrics.append(make_train_step(cfg, m)(s, batches[0], gen)[1])
    assert float(metrics[0]["cost"]) == float(metrics[1]["cost"])
    # a second save / restore cycle through save_checkpoint directly
    path = str(tmp_path / "again.pt")
    save_checkpoint(path, state, metadata={"epoch": 7})
    assert restore_checkpoint(path, state2).step == 3


def test_fit_over_a_one_rank_mesh_with_the_live_view(tmp_path, variables,
                                                    capsys):
    """``fit(mesh=make_mesh(1, "cpu"), live=True, tensorboard=True)`` ends
    where ``fit`` without them ends, bit for bit, and writes the live rows
    and the TensorBoard events (the data-parallel runs over several ranks:
    ``tests/test_torch_parallel.py``)."""
    from tpuseg_torch.parallel import make_mesh

    cfg = tiny(cvppp_config())
    # the on-device augmentation is ported now (tests/test_torch_device_aug.py)
    assert callable(make_train_step(cfg, model=None, device_aug=True))
    batches = [make_batch(0), make_batch(1)]
    finals = []
    for name, kw in (("plain", {}), ("mesh", dict(
            mesh=make_mesh(1, "cpu"), live=True, tensorboard=True))):
        model, state = _state(cfg, variables)
        fit(cfg, model, state, lambda e: batches, lambda e: batches[:1],
            str(tmp_path / name), n_epochs=1,
            generator=torch.Generator().manual_seed(0), **kw)
        finals.append(model.state_dict())
    for k, v in finals[0].items():
        assert torch.equal(v, finals[1][k]), k
    out = capsys.readouterr().out
    assert out.count("live metrics:") == 2 and "val/ins_dice_loss" in out
    assert os.listdir(tmp_path / "mesh" / "tb")
    assert not (tmp_path / "plain" / "tb").exists()


def test_bfloat16_autocast_step_keeps_float32_state(variables):
    """``dtype=torch.bfloat16``: the model runs under autocast, parameters,
    optimizer slots and metrics stay float32, the costs are finite and
    close to the float32 step's."""
    cfg = tiny(cvppp_config())
    batch = make_batch()
    costs = {}
    for dtype in (None, torch.bfloat16):
        model, state = _state(cfg, variables)
        state, m = make_train_step(cfg, model, dtype=dtype)(state, batch, None)
        assert all(p.dtype == torch.float32 for p in model.parameters())
        assert all(v.dtype == torch.float32 for v in m.values())
        e = make_eval_step(cfg, model, dtype=dtype)(state, batch)
        assert np.isfinite(float(e["cost"]))
        costs[dtype] = float(m["cost"])
    assert np.isfinite(costs[torch.bfloat16])
    assert abs(costs[torch.bfloat16] / costs[None] - 1.0) < 0.1
