"""Read what ``chip_smoke.py``'s dp-fit gates see when the data-parallel
reductions are sound and when one is broken, on the card.

    python tpuseg_torch/tools/dp_gate.py [n_ranks] [backend]

Runs dp-fit's f32 comparison (``chip_smoke.dp_fit_inputs``: ``fit`` at the
full CVPPP width from the committed checkpoint, deterministic glimpses, no
dropout, SGD, global B=4, 2 steps + 1 validation batch) in one process,
then over ``n_ranks`` ranks (2 by default; rank r on card r % cards) with
``backend`` (gloo by default, as dp-fit runs; nccl with a card a rank)
three times, in one spawn of the ranks:

* ``sound``: the port as it is;
* ``no_stat_backward``: the all-reduce under the global batch statistics
  (BatchNorm, the REINFORCE baseline) passes its cotangent back
  unreduced, so the gradient through the statistics stays per-rank;
* ``summed_grads``: the gradients are summed over the ranks, not averaged.

The faults are made inside the ranks, for the one run, and undone after
it.  Prints ``chip_smoke.dp_readings`` of each run against the one process
as a JSON line, and the gates: ``UPDATE_TOL`` and ``METRIC_TOL`` must pass
the sound run and fail each broken one.  Exits non-zero without CUDA.
"""

import json
import os
import sys
import tempfile

FAULTS = ("sound", "no_stat_backward", "summed_grads")


def faulty_fit_run(mesh, fault, *args):
    """``tasks.fit_run(mesh, *args)`` with ``fault`` made for the run."""
    import torch.distributed as dist

    from tpuseg_torch.parallel import mesh as mesh_lib
    from tpuseg_torch.parallel import tasks
    from tpuseg_torch.runtime import train as train_lib

    backward = mesh_lib._AllReduceSum.backward
    mean = train_lib.mean_over_ranks_

    def summed(tensors):
        if tensors and tensors[0].dim() > 0:  # the gradients; metrics are 0-d
            mesh_lib._flat(tensors, dist.all_reduce)
        else:
            mean(tensors)

    if fault == "no_stat_backward":
        mesh_lib._AllReduceSum.backward = staticmethod(lambda ctx, g: g)
    elif fault == "summed_grads":
        train_lib.mean_over_ranks_ = summed
    try:
        return tasks.fit_run(mesh, *args)
    finally:
        mesh_lib._AllReduceSum.backward = backward
        train_lib.mean_over_ranks_ = mean


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("dp_gate: CUDA is not available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import chip_smoke as cs
    from tpuseg_torch.cli.common import load_model
    from tpuseg_torch.kernels import build
    from tpuseg_torch.parallel import make_mesh, run_ranks, tasks
    from tpuseg_torch.settings import get_config

    build.build()
    cfg, model = load_model(
        get_config("CVPPP"),
        os.path.join(root, "assets", "synthetic_ckpt.msgpack"))
    sd, det, train_b, val_b = cs.dp_fit_inputs(cfg, model)
    names = [n for n, _ in model.named_parameters()]
    work = tempfile.mkdtemp(prefix="dp_gate_")

    def args(name):
        return cs.dp_fit_args(det, sd, train_b, val_b, os.path.join(work, name))

    one = tasks.fit_run(make_mesh(1, "cuda"), *args("one"))
    n_ranks = int(argv[1]) if len(argv) > 1 else 2
    backend = argv[2] if len(argv) > 2 else "gloo"
    runs = run_ranks(tasks.in_turn, n_ranks, ([
        (faulty_fit_run, (fault, *args(fault))) for fault in FAULTS],),
        device="cuda", backend=backend, timeout=900)
    print(cs.smi_line(), flush=True)
    for fault, two in zip(FAULTS, runs[0]):
        read = cs.dp_readings(two["model"], one["model"], sd, names,
                              os.path.join(work, fault),
                              os.path.join(work, "one"))
        caught = (bool(read["outside_tol"])
                  or read["update_err"] > cs.UPDATE_TOL
                  or read["metric_err"] > cs.METRIC_TOL)
        print(json.dumps({"fault": fault, "ranks": n_ranks,
                          "backend": backend, "gates_fail": caught,
                          "update_tol": cs.UPDATE_TOL,
                          "metric_tol": cs.METRIC_TOL, **read}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
