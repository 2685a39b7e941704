"""The frozen count of operations equals the program's own count
(``tpuseg_torch/utils/roofline.py::count``) at 64x64, B=2, and grows
with the batch as the harness scales it."""

import torch

from segbench import cells, program
from segbench.count import flops
from segbench.tests._small import small_cell

DEV = torch.device("cpu")


def test_inference_count_equals_the_programs():
    from tpuseg_torch.utils.roofline import count

    cell = small_cell("cvppp256_infer_hard", dtype="float32")
    run = cells.entry("infer").Run(cell, 2 ** 32 + 3, DEV)
    images = run.batches[0]["images"]
    before = run.predictor.rounds_run
    with count() as c:
        run.predictor.predict_batch_packed(images)
    rounds = run.predictor.rounds_run - before
    w = flops.infer_work(run._reference(), images[0])
    assert c.flops == 2 * (w["prep_flops"] + rounds * w["round_flops"])
    assert c.kernels["ir_chain"]["calls"] == rounds * len(w["round_chains"])
    ours = run.work({"batches": 1, "rounds": rounds, "dtype": "float32"})
    assert ours["flops"] == c.flops
    assert ours["chain_calls"] == c.kernels["ir_chain"]["calls"]


def test_training_count_equals_the_programs_and_scales_with_the_batch():
    from tpuseg_torch.utils.roofline import count

    cell = small_cell("cvppp256_train_b32", dtype="float32")
    run = cells.entry("train").Run(cell, 2 ** 32 + 4, DEV)
    batch = run.batches[0]
    with count() as c:
        run.step(run.state, batch, torch.Generator().manual_seed(1))
    conf = cell["configuration"]
    ckpt = program.path(conf["checkpoint"])
    two = flops.train_work(conf["config"], ckpt, batch, 1, DEV)
    one = flops.train_work(conf["config"], ckpt,
                           {k: v[:1] for k, v in batch.items()}, 1, DEV)
    assert two == c.flops
    assert two == 2 * one
    assert run.work({"steps": 1})["flops"] == c.flops
