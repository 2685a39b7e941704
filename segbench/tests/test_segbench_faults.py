"""A run whose timed path is broken underneath comes out not correct: the
harness is driven whole (past its look for a card), on the CPU at a
small size, with the cells' own limits.  Also the control: the reference
with float8 products in the program's place fails the limits."""

import pytest
import torch

from segbench import run
from segbench.entries import infer, train
from segbench.faults import (AlteredAnswer, HalfBatch, InferControl,
                             TrainControl, TrainHalfBatch, Unchanged)
from segbench.tests._small import small_cell

DEV = torch.device("cpu")
SEED = 2 ** 31 + 77


def _run(name, cls, batch=2, hw=64):
    cell = small_cell(name, dtype="float32", batch=batch, hw=hw)
    return run.run_cell(name, SEED, 0.5, False, DEV, cell=cell,
                        run_class=cls)


INFER_CELLS = ("cvppp256_infer_hard", "a1native_infer_hard",
               "cvppp256_infer_sparse")


@pytest.mark.parametrize("cell", INFER_CELLS)
def test_inference_faults_and_control_are_not_correct(cell):
    assert _run(cell, infer.Run)["correct"]
    for cls in (HalfBatch, AlteredAnswer):
        r = _run(cell, cls)
        assert r["correct"] is False, (cls.__name__, r["checks"])
        assert r["failed"] > 0
    # the control, at a size at which a plant has leaves the rounds find
    r = _run(cell, InferControl, batch=4, hw=128)
    assert r["correct"] is False, r["checks"]


def test_training_faults_and_control_are_not_correct():
    assert _run("cvppp256_train_b32", train.Run, batch=4)["correct"]
    for cls in (Unchanged, TrainHalfBatch, TrainControl):
        r = _run("cvppp256_train_b32", cls, batch=4)
        assert r["correct"] is False, (cls.__name__, r["checks"])
