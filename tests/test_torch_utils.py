"""The port's validation helpers and tracing utilities against the JAX
package's ``tpuseg/utils``: the same bad inputs raise with the same
messages, ``nan_guard`` and ``assert_finite`` give what the JAX functions
give, ``trace_context`` writes a Chrome trace on the CPU, ``StepTimer``
records one time a call."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.utils import validation as jval
from tpuseg_torch.utils import validation as tval
from tpuseg_torch.utils.tracing import TRACE_FILE, StepTimer, annotate, trace_context


def _batch(b=2, h=8, w=8, c=2, n=3):
    return {
        "images": np.zeros((b, h, w, 3), np.uint8),
        "sem_onehot": np.zeros((b, h, w, c), np.float32),
        "ins_masks": np.zeros((b, h, w, n), np.float32),
        "n_objects": np.array([1, 3], np.int32),
    }


def _bad_batches():
    yield "missing", {k: v for k, v in _batch().items() if k != "ins_masks"}
    for key, value in (
        ("images", np.zeros((2, 8, 8), np.uint8)),
        ("images", np.zeros((2, 8, 8, 4), np.uint8)),
        ("images", np.zeros((2, 8, 8, 3), np.float32)),
        ("sem_onehot", np.zeros((2, 8, 8, 3), np.float32)),
        ("ins_masks", np.zeros((2, 8, 7, 3), np.float32)),
        ("n_objects", np.array([1, 2, 3], np.int32)),
        ("n_objects", np.array([1, 4], np.int32)),
    ):
        batch = _batch()
        batch[key] = value
        yield key, batch


def _message(fn, *args):
    with pytest.raises(ValueError) as err:
        fn(*args)
    return str(err.value), type(err.value).__name__


@pytest.mark.parametrize("case", range(8))
def test_check_batch_raises_as_the_jax_one(case):
    _, batch = list(_bad_batches())[case]
    want = _message(jval.check_batch, batch, 2, 3)
    assert _message(tval.check_batch, batch, 2, 3) == want
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    assert _message(tval.check_batch, tensors, 2, 3) == want
    assert issubclass(tval.ValidationError, ValueError)


def test_good_inputs_pass():
    tval.check_batch(_batch(), 2, 3)
    tval.check_batch({k: torch.from_numpy(v) for k, v in _batch().items()},
                     2, 3)
    tval.check_image_batch(np.zeros((1, 4, 4, 21), np.float32))


def test_nan_guard_and_assert_finite_match_jax():
    x = np.array([[1.0, np.nan], [-np.inf, 3.0]], np.float32)
    for value in (0.0, -2.5):
        np.testing.assert_array_equal(
            tval.nan_guard(torch.from_numpy(x), value).numpy(),
            np.asarray(jval.nan_guard(jnp.asarray(x), value)))
    ok = torch.ones(3)
    assert tval.assert_finite(ok, "ok") is ok
    for bad in (x, np.array([np.inf], np.float32)):
        with pytest.raises(FloatingPointError, match="non-finite values in w"):
            tval.assert_finite(torch.from_numpy(bad), "w")


def test_trace_context_writes_a_trace_and_the_timer_records(tmp_path):
    timer = StepTimer()
    a = torch.randn(64, 64)
    with trace_context(str(tmp_path / "trace")):
        with annotate("matmul_step"):
            out = timer.time("mm", torch.matmul, a, a)
    assert out.shape == (64, 64)
    with trace_context(None):  # a no-op
        timer.time("mm", lambda: {"y": [a + 1]})
    trace = json.loads((tmp_path / "trace" / TRACE_FILE).read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "matmul_step" in names and "aten::matmul" in names
    summary = timer.summary()
    assert summary["mm"]["count"] == 2 and summary["mm"]["min_s"] > 0
    assert os.listdir(tmp_path) == ["trace"]
