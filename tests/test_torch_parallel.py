"""The port's data-parallel path (``tpuseg_torch/parallel``) on the CPU: two
gloo ranks against one process and against the JAX package's mesh.

* ``pad_to_multiple`` and the rank slicing equal ``tpuseg.parallel``'s
  padding and ``P('data')`` shards on numpy inputs (B = 3 and 8, 2 ranks).
* A train-mode BatchNorm over 2 ranks equals one process over the whole
  batch: output, input and weight gradients, running statistics (atol
  2e-6, rtol 1e-5; the ranks' statistics bit-identical).
* One train step over 2 ranks equals one process on the same global batch
  (the tiny configuration of ``tests/test_fit_mesh.py``: SGD, deterministic
  glimpse, ``drop_rate`` 0): every parameter, BN statistic and the
  REINFORCE baseline within rtol 1e-3 / atol 1e-3 (the worst here is
  1.1e-4 on a weight; the same step with the backward's all-reduce of the
  batch statistics removed misses by 1e-2), the metrics within 1e-5 of
  their value (``grad_norm`` 5e-3: the ill-conditioned gradient of
  ``tests/test_torch_train.py``), the ranks bit-identical.  An odd global
  batch (3) is padded with sample 0 on both sides.
* ``fit`` over 2 ranks against the JAX ``fit(mesh=make_mesh(2))`` on the
  faked CPU devices: parameters and BN statistics under
  ``test_fit_mesh.py``'s tolerances (rtol 5e-3, atol 1.6e-2), the logged
  cost within 2e-2.
* A rank that raises fails the run at once, with its traceback; the join
  waits as long as the ranks run unless it is given a deadline.

Every spawned run joins with its own time limit; a rank that imports JAX,
flax or the JAX package fails (``parallel/mesh.py::_rank_entry``).
"""

import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

from test_torch_train import draw_variables, tiny, tree_close
from tpuseg.cli.common import build_model
from tpuseg.configs import cvppp_config as jax_cvppp_config
from tpuseg.parallel import make_mesh as jax_make_mesh
from tpuseg.parallel import pad_to_multiple as jax_pad_to_multiple
from tpuseg.parallel import shard_batch as jax_shard_batch
from tpuseg.runtime.loop import fit as jax_fit
from tpuseg.runtime.state import create_train_state as jax_create_train_state
from tpuseg_torch.configs import cvppp_config
from tpuseg_torch.models import ReSeg
from tpuseg_torch.parallel import (
    Mesh, make_mesh, pad_to_multiple, run_ranks, shard_batch, tasks,
)
from tpuseg_torch.parallel import mesh as mesh_module
from tpuseg_torch.weights import load_flax, to_flax

LIMIT = 300  # seconds a spawned run may take


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _cfg(make):
    """``tests/test_fit_mesh.py``'s tiny configuration (n_filters 8, 32x32,
    SGD at 0.01, deterministic glimpse) without dropout."""
    cfg = tiny(make())
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=4, optimizer="SGD", learning_rate=0.01))


def _batch(seed, b):
    """uint8 images; every sample two instances, as in test_fit_mesh."""
    rng = np.random.RandomState(seed)
    labels = np.zeros((b, 32, 32), np.int32)
    labels[:, 8:24, 8:24] = 1
    ins = np.zeros((b, 32, 32, 4), np.float32)
    ins[:, 8:16, 8:24, 0] = 1
    ins[:, 16:24, 8:24, 1] = 1
    return {
        "images": rng.randint(0, 255, (b, 32, 32, 3)).astype(np.uint8),
        "sem_onehot": np.eye(2, dtype=np.float32)[labels],
        "ins_masks": ins,
        "n_objects": np.full((b,), 2, np.int32),
    }


@pytest.fixture(scope="module")
def variables():
    return draw_variables(0)


def _model_state(cfg, variables):
    return load_flax(ReSeg(cfg), variables).state_dict()


@pytest.mark.parametrize("b", [3, 8])
def test_padding_and_rank_slices_match_jax(b):
    arr = np.random.default_rng(b).integers(0, 255, (b, 5, 3)).astype(np.int32)
    padded, n = pad_to_multiple(arr, 2)
    want, want_n = jax_pad_to_multiple(arr, 2)
    assert n == want_n == b
    np.testing.assert_array_equal(padded, want)
    sharded = jax_shard_batch(want, jax_make_mesh(2))
    shards = sorted(sharded.addressable_shards, key=lambda s: s.device.id)
    for r, shard in enumerate(shards):
        got = shard_batch(padded, Mesh(2, r, torch.device("cpu")))
        np.testing.assert_array_equal(got.numpy(), np.asarray(shard.data))
        both = shard_batch({"x": padded, "y": torch.from_numpy(padded)},
                           Mesh(2, r, torch.device("cpu")))
        assert torch.equal(both["x"], both["y"]) and torch.equal(both["x"], got)


def test_batch_norm_over_two_ranks_matches_one_process():
    rng = np.random.default_rng(0)
    x = (2.0 * rng.normal(size=(4, 3, 5, 6)) + 1.0).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    w = rng.normal(size=3).astype(np.float32)
    bias = rng.normal(size=3).astype(np.float32)
    one = tasks.batch_norm_grads(make_mesh(1, "cpu"), x, g, w, bias)
    two = run_ranks(tasks.batch_norm_grads, 2, (x, g, w, bias), device="cpu",
                    timeout=LIMIT)
    close = dict(rtol=1e-5, atol=2e-6)
    for key in ("y", "dx"):
        np.testing.assert_allclose(torch.cat([r[key] for r in two]),
                                   one[key], **close, err_msg=key)
    for key in ("dweight", "dbias"):  # each rank holds its share
        np.testing.assert_allclose(two[0][key] + two[1][key], one[key],
                                   **close, err_msg=key)
    for key in ("running_mean", "running_var"):
        assert torch.equal(two[0][key], two[1][key]), key
        np.testing.assert_allclose(two[0][key], one[key], **close, err_msg=key)


@pytest.mark.parametrize("b", [4, 3])
def test_train_step_over_two_ranks_matches_one_process(tmp_path, variables, b):
    """The step runs inside ``trace_context``: its all-reduces are read
    from the trace (one per rank and collective, none in one process)."""
    cfg = _cfg(cvppp_config)
    state = _model_state(cfg, variables)
    batch = _batch(1, b)
    two = run_ranks(tasks.train_steps, 2, (cfg, state, [batch], None, 0,
                                           str(tmp_path / "two")),
                    device="cpu", timeout=LIMIT)
    # one process on the batch the ranks see: sample 0 repeated to a
    # multiple of 2
    padded = {k: pad_to_multiple(v, 2)[0] for k, v in batch.items()}
    one = tasks.train_steps(make_mesh(1, "cpu"), cfg, state, [padded],
                            trace_dir=str(tmp_path / "one"))
    assert two[0]["step"] == two[1]["step"] == one["step"] == 1
    assert two[0]["collectives_per_step"] == two[1]["collectives_per_step"] > 0
    assert two[0]["collective_ms_per_step"] > 0
    assert one["collectives_per_step"] == 0
    for k, want in one["model"].items():
        a, c = two[0]["model"][k], two[1]["model"][k]
        assert torch.equal(a, c), k
        if want.is_floating_point():
            np.testing.assert_allclose(a, want, rtol=1e-3, atol=1e-3,
                                       err_msg=k)
        else:
            assert torch.equal(a, want), k
    assert "decoder.baseline" in one["model"]
    m2, m1 = two[0]["metrics"][0], one["metrics"][0]
    assert m2 == two[1]["metrics"][0]
    assert m2.keys() == m1.keys()
    for k in m1:
        rtol = 5e-3 if k == "grad_norm" else 1e-5
        assert m2[k] == pytest.approx(m1[k], rel=rtol, abs=1e-6), k


def test_fit_over_two_ranks_matches_the_jax_mesh_fit(tmp_path, variables):
    batches = [_batch(2, 4), _batch(3, 4)]
    jcfg, tcfg = _cfg(jax_cvppp_config), _cfg(cvppp_config)
    jax_state = jax_fit(
        jcfg, build_model(jcfg), jax_create_train_state(jcfg, variables),
        train_batches=lambda epoch: batches,
        val_batches=lambda epoch: batches[:1], run_dir=str(tmp_path / "jax"),
        n_epochs=1, rng=jax.random.PRNGKey(0), mesh=jax_make_mesh(2))
    ranks = run_ranks(
        tasks.fit_run, 2, (tcfg, _model_state(tcfg, variables), batches,
                           batches[:1], str(tmp_path / "torch"), 1),
        device="cpu", timeout=LIMIT)
    assert int(jax_state.step) == ranks[0]["step"] == ranks[1]["step"] == 2
    for k, v in ranks[0]["model"].items():
        assert torch.equal(v, ranks[1]["model"][k]), k
    got = to_flax(_load(tcfg, ranks[0]["model"]))
    for col in ("params", "batch_stats", "decoder_state"):
        tree_close(got[col], getattr(jax_state, col), rtol=5e-3, atol=1.6e-2,
                   what=col)
    costs = [float((tmp_path / side / "training.log").read_text()
                   .strip().splitlines()[-1].split(",")[1])
             for side in ("jax", "torch")]
    assert abs(costs[0] - costs[1]) < 2e-2 * max(1.0, abs(costs[0]))
    assert not (tmp_path / "torch" / "tb").exists()


def _load(cfg, state):
    model = ReSeg(cfg)
    model.load_state_dict(state)
    return model


@pytest.mark.parametrize("deadline", [None, 0.5])
def test_the_join_waits_for_every_rank_or_its_deadline(deadline):
    """Without a deadline the join waits as long as the ranks run; with
    one, it raises when the deadline passes."""
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=time.sleep, args=(s,)) for s in (0.1, 2.0)]
    for p in procs:
        p.start()
    try:
        if deadline is None:
            mesh_module._join(procs, ["", ""], deadline)
            assert [p.exitcode for p in procs] == [0, 0]
        else:
            with pytest.raises(TimeoutError, match=r"ranks \[1\] still running"):
                mesh_module._join(procs, ["", ""], deadline)
    finally:
        for p in procs:
            p.kill()
            p.join()


def test_a_failing_rank_fails_the_run():
    """A batch of 3 does not divide over 2 ranks: the ranks raise, and the
    run fails at once with a rank's traceback."""
    x = np.zeros((3, 2, 2, 2), np.float32)
    w, bias = np.ones(2, np.float32), np.zeros(2, np.float32)
    with pytest.raises(RuntimeError, match=r"(?s)rank \d.*does not divide"):
        run_ranks(tasks.batch_norm_grads, 2, (x, x, w, bias), device="cpu",
                  timeout=LIMIT)
