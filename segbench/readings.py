"""The readings that the limits of ``correct`` are set from, on the card.

    python3 segbench/readings.py --workload <cell> --seeds 1,2,3 \
        [--seconds 2] [--control 1] [--fault half] [--witness 1] \
        [--out file.jsonl]

For each seed, in one process: the cell's program set up from the seed
(with ``--fault``: with that fault planted, ``faults.py``), a short
window at the cell's own load, then the numbers ``compare.py`` gives for
what the timed path produced (the lower reading, or the fault's); with
``--control 1`` also the control's, the reference with float8 products in
the program's place (the upper reading).  With ``--witness 1`` also the
numbers between the program and the reference computed in bfloat16 as
the configuration runs it, and between that reference and the float32
one, and for training which glimpse samples of the checked steps the
program and the two references share.  One JSON line a seed and kind, on
standard output and in ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))


class Samples:
    """Records the glimpse samples that ``module.sample_flat`` draws while
    it is on."""

    def __init__(self, module):
        self.module, self.draw = module, module.sample_flat
        self.calls: list = []
        self.on = False

    def __enter__(self):
        self.on = True
        return self

    def __exit__(self, *exc):
        self.on = False

    def __call__(self, weights, generator, width):
        s = self.draw(weights, generator, width)
        if self.on:
            self.calls.append(s.detach().cpu())
        return s

    def install(self):
        self.module.sample_flat = self
        return self


def shared_samples(a: list, b: list) -> list:
    """Per glimpse of the checked steps, how many rows drew the same
    sample on both sides."""
    return [int((x == y).sum()) for x, y in zip(a, b)]


def _train_witness(run, line):
    from segbench import compare
    from segbench.reference.parallel import spatial as ref_spatial

    refs, samples = {}, {}
    rec = Samples(ref_spatial).install()
    for dtype in ("float32", "bfloat16"):
        rec.calls = []
        with rec:
            refs[dtype] = run.reference(dtype)
        samples[dtype] = rec.calls
    ref_spatial.sample_flat = rec.draw
    line["vs_bf16"] = compare.train_numbers(run.first, refs["bfloat16"])
    line["bf16_vs_f32"] = compare.train_numbers(refs["bfloat16"],
                                                refs["float32"])
    prog = run.samples
    line["rows"] = int(run.batch)
    line["samples_prog_f32"] = shared_samples(prog, samples["float32"])
    line["samples_prog_bf16"] = shared_samples(prog, samples["bfloat16"])
    line["samples_bf16_f32"] = shared_samples(samples["bfloat16"],
                                              samples["float32"])
    if line["with_control"]:
        low = run.reference("bfloat16", control=True)
        line["control_vs_bf16"] = compare.train_numbers(low,
                                                        refs["bfloat16"])


def _infer_witness(run, line):
    from segbench import compare

    sample = run.check_sample()
    f32 = run.reference_outputs(sample, "float32")
    bf16 = run.reference_outputs(sample, "bfloat16")
    prog = run.program_outputs(sample)
    line["vs_bf16"] = compare.infer_numbers(prog, bf16)
    line["bf16_vs_f32"] = compare.infer_numbers(bf16, f32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--fault", default="")
    ap.add_argument("--witness", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch

    from segbench import cells, faults

    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = cells.load_cell(args.workload)
    kind = cell["entry"]
    cls = (faults.run_class(args.fault, kind) if args.fault
           else cells.entry(kind).Run)
    rec = None
    if kind == "train" and args.witness:
        from tpuseg_torch.parallel import spatial

        rec = Samples(spatial).install()
    out = open(args.out, "a") if args.out else None
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        run = cls(cell, seed, device)
        if rec is not None:
            rec.calls = []
            with rec:
                run.warm()
            run.samples = rec.calls
        else:
            run.warm()
        run.window(args.seconds)
        run.release()
        line = {"workload": args.workload, "seed": seed,
                "kind": "fault_" + args.fault if args.fault else "program",
                "numbers": run.check()}
        if args.witness:
            line["with_control"] = bool(args.control)
            (_train_witness if kind == "train" else _infer_witness)(run,
                                                                   line)
        lines = [line]
        if args.control:
            lines.append({"workload": args.workload, "seed": seed,
                          "kind": "control",
                          "numbers": run.check(control=True)})
        for ln in lines:
            ln["seconds"] = time.perf_counter() - t0
            print(json.dumps(ln), flush=True)
            if out:
                out.write(json.dumps(ln) + "\n")
                out.flush()
        del run
        torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
