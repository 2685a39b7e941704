"""Time builds of the ``masked_softmax`` kernels side by side on one card.

    python tpuseg_torch/tools/bench_masked_softmax.py [--out FILE]
        [--rounds R] LABEL=SOURCE[@NAME=VALUE,...] ...

Each argument names one build of a ``.cu`` file that exports the C entry
points of ``csrc/masked_softmax.cu`` (``tpuseg_masked_softmax_fwd`` /
``_bwd``), such as this checkout's and a parent's written out with
``git show <commit>:tpuseg_torch/kernels/csrc/masked_softmax.cu`` into
``_tree_check/`` (gitignored); ``@NAME=VALUE`` pairs are compiled in as
``#define`` lines (``MS_UNROLL``).  All builds compile at once; then, at
the
training path's shape (8, 32, 65536) with the instance masks of synthetic
scenes, and at an odd HW (8, 32, 65025), every build runs the forward and
the backward in turns, forward and reversed order, for ``R`` rounds.  The
backward runs with two kinds of cotangent: "main", as training gives it
(``chip_smoke.SOFTMAX_K`` rows per sample nonzero, the rest exact zeros),
and "dense".  Per build and case it prints the time per call from CUDA
events (median over rounds), the device time per call from
``torch.profiler``, the bytes bound and the share of it, max|err| against
the plain version, whether de is bit-equal to the first build's, and the
``ptxas`` report; beside them the plain version and the PyTorch calls
(``torch.softmax`` on masked logits, ``torch._softmax_backward_data``).
``--out`` also writes the numbers as JSON.  Compare builds only within one
run: the card's power limit and host differ between machines.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CASES = (  # (label, B, side, cotangent)
    ("main-path g", 8, 256, "main"),
    ("dense g", 8, 256, "dense"),
    ("odd HW, main-path g", 8, 255, "main"),
    ("odd HW, dense g", 8, 255, "dense"),
)


def per_kernel_ms(torch, fn, calls=10):
    """{kernel name: mean device ms per launch} over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and "masked_softmax" in e.name):
            name = re.search(r"masked_softmax_\w+", e.name).group(0)
            us, n = per.get(name, (0.0, 0))
            per[name] = (us + e.device_time, n + 1)
    return {k: us / n / 1e3 for k, (us, n) in per.items()}


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("builds", nargs="+")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv[1:])
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("bench_masked_softmax: CUDA is not available", file=sys.stderr)
        return 2
    from chip_smoke import (
        cuda_ms, kernel_device_ms, smi_line, softmax_cotangent,
        softmax_inputs,
    )
    from tpuseg_torch.utils.roofline import softmax_bound_ms
    from tpuseg_torch.kernels import build
    from tpuseg_torch.kernels.masked_softmax import (
        masked_softmax_backward_plain, masked_softmax_plain,
    )
    from tpuseg_torch.tools.bench_sru_scan import build_jobs

    smi = smi_line()
    print("card:", smi, flush=True)
    bdir = build.BUILD_DIR / "bench"
    bdir.mkdir(parents=True, exist_ok=True)
    jobs, _ = build_jobs(args.builds, "ms", bdir)
    specs = list(jobs)
    build.compile_all(jobs)
    ptxas, fns = {}, {}
    for label in specs:
        ptxas[label] = [ln.strip() for ln in build.build_logs[label]
                        .splitlines() if "Compiling entry" in ln
                        or "registers" in ln or "spill" in ln]
        print(f"built {label}:", *ptxas[label], sep="\n  ", flush=True)
        lib = ctypes.CDLL(str(jobs[label][1]))
        fwd, bwd = lib.tpuseg_masked_softmax_fwd, lib.tpuseg_masked_softmax_bwd
        p, i = ctypes.c_void_p, ctypes.c_int
        fwd.argtypes = [p, p, p, i, i, i, p]
        bwd.argtypes = [p, p, p, p, i, i, i, p]
        fwd.restype = bwd.restype = ctypes.c_int
        fns[label] = (fwd, bwd)

    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    gen = torch.Generator().manual_seed(1)
    inputs = {}
    results = {label: {} for label in specs}
    for case, b, side, kind in CASES:
        if side not in inputs:
            inputs[side] = softmax_inputs(rng, gen, b, side, dev)
        e, mask, _ = inputs[side]
        n, hw = mask.shape[1], side * side
        g, active = softmax_cotangent(mask, kind, seed=side)
        p_want = masked_softmax_plain(e, mask)
        de_want = masked_softmax_backward_plain(p_want, g)
        de_scale = de_want.abs().max().item()
        p_out = torch.empty_like(p_want)
        scratch = torch.empty(2 * b * n, dtype=torch.float32, device=dev)
        de_out = torch.empty((b, hw), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream

        def forward(label):
            err = fns[label][0](e.data_ptr(), mask.data_ptr(),
                                p_out.data_ptr(), b, n, hw, stream)
            if err:
                raise RuntimeError(f"{label} forward: cudaError {err}")

        def backward(label):
            err = fns[label][1](p_want.data_ptr(), g.data_ptr(),
                                scratch.data_ptr(), de_out.data_ptr(), b, n,
                                hw, stream)
            if err:
                raise RuntimeError(f"{label} backward: cudaError {err}")

        bf, bb = softmax_bound_ms(b, n, hw, active)
        ev = {label: ([], []) for label in specs}
        for r in range(args.rounds):
            for label in (specs if r % 2 == 0 else specs[::-1]):
                ev[label][0].append(cuda_ms(lambda: forward(label), 30))
                ev[label][1].append(cuda_ms(lambda: backward(label), 30))
        first_de = None
        logits = torch.where(mask > 0, e[:, None, :],
                             torch.full_like(e[:, None, :], -1e30))
        lib_f = cuda_ms(lambda: torch.softmax(logits, dim=-1), 30)
        lib_b = cuda_ms(lambda: torch._softmax_backward_data(
            g, p_want, -1, torch.float32), 30)
        plain_f = cuda_ms(lambda: masked_softmax_plain(e, mask), 10)
        plain_b = cuda_ms(lambda: masked_softmax_backward_plain(p_want, g),
                          10)
        del logits
        print(f"{case} ({b},{n},{hw}), {active} of {b * n} g rows nonzero: "
              f"bound forward {bf:.4f} ms, backward {bb:.4f} ms; plain "
              f"{plain_f:.4f} / {plain_b:.4f} ms; torch.softmax {lib_f:.4f}"
              f" ms, torch._softmax_backward_data {lib_b:.4f} ms",
              flush=True)
        for label in specs:
            forward(label)
            backward(label)
            torch.cuda.synchronize()
            p_err = (p_out - p_want).abs().max().item()
            de_err = (de_out - de_want).abs().max().item() / de_scale
            if first_de is None:
                first_de, same = de_out.clone(), True
            else:
                same = torch.equal(de_out, first_de)
            dev_f = kernel_device_ms(lambda: forward(label), 10,
                                     "masked_softmax_fwd")
            dev_b = kernel_device_ms(lambda: backward(label), 10,
                                     "masked_softmax_", launches=2)
            split = per_kernel_ms(torch, lambda: backward(label))
            row = {"backward_kernels_ms": split,
                   "forward_ms": statistics.median(ev[label][0]),
                   "backward_ms": statistics.median(ev[label][1]),
                   "forward_rounds": ev[label][0],
                   "backward_rounds": ev[label][1],
                   "forward_device_ms": dev_f, "backward_device_ms": dev_b,
                   "bound_forward_ms": bf, "bound_backward_ms": bb,
                   "active_rows": active, "max_p_err": p_err,
                   "max_de_err_over_max": de_err,
                   "de_bit_equal_to_first": same,
                   "plain_forward_ms": plain_f, "plain_backward_ms": plain_b,
                   "torch_softmax_ms": lib_f,
                   "torch_softmax_backward_data_ms": lib_b}
            results[label][case] = row
            print(f"  {label}: forward {row['forward_ms']:.4f} ms (device "
                  f"{dev_f}, {bf / row['forward_ms']:.1%} of its bound), "
                  f"backward {row['backward_ms']:.4f} ms (device {dev_b}, "
                  f"{bb / row['backward_ms']:.1%}); max|p err| {p_err:.2e}, "
                  f"max|de err|/max|de| {de_err:.2e}, de bit-equal to "
                  f"{specs[0]}: {same}; backward kernels "
                  f"{ {k: round(v, 4) for k, v in split.items()} }",
                  flush=True)
        del g, p_want, de_want, p_out, de_out, scratch
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "builds": args.builds, "ptxas": ptxas,
                       "cases": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
