"""The plain reference: independent of the program and of JAX, and equal
to the program's float32 outputs on the CPU at a small size."""

import ast
import os

import pytest
import torch

from segbench import cells
from segbench.tests._small import small_cell

NOT_IN_REFERENCE = {"jax", "jaxlib", "flax", "tpuseg", "tpuseg_torch",
                    "bench"}
NOT_IN_HARNESS = {"jax", "jaxlib", "flax", "tpuseg", "bench"}


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module.split(".")[0]


def _sources(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_reference_imports_nothing_of_the_program_or_jax():
    found = {(p, m) for p in _sources(os.path.join(cells.HERE, "reference"))
             for m in _imports(p) if m in NOT_IN_REFERENCE}
    assert not found


def test_harness_imports_nothing_of_jax():
    found = {(p, m) for p in _sources(cells.HERE) for m in _imports(p)
             if m in NOT_IN_HARNESS}
    assert not found


@pytest.mark.parametrize("hw,batch,distinct", [
    (64, 2, 3),   # unwindowed decode
    (256, 1, 1),  # the windowed decode of the 256² configuration
])
def test_reference_gives_the_programs_inference_outputs(hw, batch, distinct):
    cell = small_cell("cvppp256_infer_hard", dtype="float32", hw=hw,
                      batch=batch, distinct=distinct)
    cell["params"]["check_batches"] = distinct
    run = cells.entry("infer").Run(cell, 2 ** 32 + 7, torch.device("cpu"))
    run.warm()
    run.window(1.5)
    run.release()
    numbers = run.check()
    assert set(numbers.values()) == {0.0}


def test_reference_gives_the_programs_training_steps():
    cell = small_cell("cvppp256_train_b32", dtype="float32")
    run = cells.entry("train").Run(cell, 2 ** 32 + 9, torch.device("cpu"))
    run.warm()
    run.release()
    numbers = run.check()
    assert numbers["loss_gap"] < 1e-5 and numbers["term_gap"] < 1e-5
    assert numbers["grad_gap"] < 1e-4
    assert numbers["update_gap"] < 1e-4
