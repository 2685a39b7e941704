"""Time builds of the ``sru_scan`` kernels, and their Python wrappers, side
by side on one card.

    python tpuseg_torch/tools/bench_sru_scan.py [--out FILE] [--rounds R]
        [--old-wrapper PY] LABEL=SOURCE[@NAME=VALUE,...] ...

Each argument names one build of a ``.cu`` file that exports the C entry
points of ``csrc/sru_scan.cu``, such as this checkout's and a parent's
written out with ``git show <commit>:tpuseg_torch/kernels/csrc/sru_scan.cu``
into ``_tree_check/`` (gitignored); ``@NAME=VALUE`` pairs are compiled in as
``#define`` lines (``SRU_THREADS``, ``SRU_PREFETCH``).  A build is called
through a wrapper module of its own C interface: this checkout's
``tpuseg_torch/kernels/sru_scan.py`` for a source whose backward takes the
arrival counters, else the file ``--old-wrapper`` names (the parent's
``sru_scan.py``, written out the same way).  All builds compile at once;
then, at the SRU language-model width (``chip_smoke.SRU_LM``: d = 910,
B = 32), every build runs the forward and the backward of each case in
turns, forward and reversed order, for ``R`` rounds.  Per build and case it
prints the device time per call from ``torch.profiler`` and the host time
per wrapper call (back-to-back calls on the host clock), medians over the
rounds, the time per call from CUDA events, the bytes bound and the share of
it, max|err| against the plain versions (held to ``tests/test_sru.py``'s
tolerances), whether the weight gradients are bit-equal over two runs and
to the first build's, and the ``ptxas`` report.  ``--out`` also writes the
numbers as JSON.  Compare builds only within one run.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CASES = (  # (label, length, bidirectional, activation, mask_c, mask_pad)
    ("uni k=3 L=35 (training path)", 35, False, 0, True, False),
    ("bi k=4 L=35", 35, True, 1, True, False),
    ("uni k=3 L=35 ragged mask_pad", 35, False, 1, True, True),
    ("uni k=3 L=1024", 1024, False, 0, True, False),
)


def build_jobs(specs, prefix: str, bdir: Path):
    """``{label: (source, library)}`` for ``LABEL=SOURCE[@NAME=VALUE,...]``
    arguments, the defines written as ``#define`` lines into a copy of the
    source under ``bdir``; also each source's text."""
    jobs, texts = {}, {}
    for spec in specs:
        label, rest = spec.split("=", 1)
        src, _, defs = rest.partition("@")
        src = Path(src).resolve()
        texts[label] = text = src.read_text()
        lines = [f"#define {d.replace('=', ' ', 1)}"
                 for d in defs.split(",") if d]
        if lines:
            src = bdir / f"{prefix}_{label}.cu"
            src.write_text("\n".join(lines) + "\n" + text)
        jobs[label] = (src, bdir / f"lib{prefix}_{label}.so")
    return jobs, texts


def load_wrapper(path: Path, label: str, lib_path: Path, counters: bool):
    """The wrapper module at ``path``, bound to the library ``lib_path``."""
    spec = importlib.util.spec_from_file_location(f"sru_scan_{label}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lib = ctypes.CDLL(str(lib_path))
    fwd, bwd = lib.tpuseg_sru_fwd, lib.tpuseg_sru_bwd
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fwd.argtypes = [p] * 10 + [i] * 7 + [f, p]
    bwd.argtypes = [p] * (16 if counters else 15) + [i] * 7 + [f, p]
    fwd.restype = bwd.restype = ctypes.c_int
    mod._kernel_fns = lambda: (fwd, bwd)
    return mod


def host_parts(torch, dev, args, spec, h, mod, calls=2000):
    """Host time of the pieces of a forward wrapper call (``mod``'s), each
    over ``calls`` calls on the host clock."""
    import time

    parts = {
        "_check": lambda: mod._check(*args, *spec[:4]),
        "_checked (cached)": lambda: mod._checked(*args, *spec[:4]),
        "torch.empty (L, B, W)": lambda: torch.empty(
            h.shape, dtype=torch.float32, device=dev),
        "current_stream().cuda_stream": lambda: torch.cuda.current_stream(
            dev).cuda_stream,
        "three data_ptr()": lambda: (args[0].data_ptr(), args[1].data_ptr(),
                                     args[2].data_ptr()),
        "sru_scan_forward": lambda: mod.sru_scan_forward(*args, *spec),
    }
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        parts["_cuda_getCurrentRawStream"] = lambda: raw(dev.index or 0)
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        dt = time.perf_counter() - t
        torch.cuda.synchronize()
        print(f"  host {name}: {1e6 * dt / calls:.2f} us per call", flush=True)


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("builds", nargs="+")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--old-wrapper", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv[1:])
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("bench_sru_scan: CUDA is not available", file=sys.stderr)
        return 2
    from chip_smoke import (
        SRU_BWD_TOL, SRU_FWD_TOL, cuda_ms, host_ms, kernel_device_ms,
        smi_line, sru_case, within,
    )
    from tpuseg_torch.utils.roofline import bytes_ms
    from tpuseg_torch.kernels import build
    from tpuseg_torch.kernels.sru_scan import sru_scan_backward_plain
    from tpuseg_torch.nn.sru import sru_states

    smi = smi_line()
    print("card:", smi, flush=True)
    bdir = build.BUILD_DIR / "bench"
    bdir.mkdir(parents=True, exist_ok=True)
    jobs, texts = build_jobs(args.builds, "sru", bdir)
    specs = list(jobs)
    abi = {label: "void* counters" in texts[label] for label in specs}
    build.compile_all(jobs)
    mods, ptxas = {}, {}
    for label in specs:
        ptxas[label] = [ln.strip() for ln in build.build_logs[label]
                        .splitlines() if "Compiling entry" in ln
                        or "registers" in ln or "spill" in ln]
        print(f"built {label}:", *ptxas[label], sep="\n  ", flush=True)
        wrapper = (ROOT / "tpuseg_torch" / "kernels" / "sru_scan.py"
                   if abi[label] else Path(args.old_wrapper))
        mods[label] = load_wrapper(wrapper, label, jobs[label][1], abi[label])

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    names = ("u", "x", "weight_c", "bias", "c0", "mask_c", "mask_pad")
    results = {label: {} for label in specs}
    for ci, (case, length, bidir, act, mc, pad) in enumerate(CASES):
        a, spec, k = sru_case(dev, length, bidir, act, mc, pad, seed=500 + ci)
        args_ = [a[n] for n in names]
        kw = dict(d=spec[0], activation=act, bidirectional=bidir,
                  has_skip_term=True, scale_x=spec[4], mask_pad=a["mask_pad"],
                  mask_c=a["mask_c"])
        hp, cfp, c_allp = sru_states(*args_[:5], **kw)
        gen = torch.Generator().manual_seed(600 + ci)
        gh = torch.randn(hp.shape, generator=gen).to(dev)
        gcf = torch.randn(cfp.shape, generator=gen).to(dev)
        want = sru_scan_backward_plain(*args_, c_allp, gh, gcf, *spec)
        x_in = a["x"] if k == 3 else None
        small = (a["weight_c"], a["bias"], a["c0"], a["mask_c"],
                 a["mask_pad"])
        bf = bytes_ms(a["u"], x_in, *small, hp, c_allp, cfp)
        bb = bytes_ms(a["u"], x_in, *small, c_allp, gh, gcf, *want)
        print(f"{case}: bound forward {bf:.4f} ms, backward {bb:.4f} ms",
              flush=True)

        def fwd(label):
            return mods[label].sru_scan_forward(*args_, *spec)

        def bwd(label):
            return mods[label].sru_scan_backward(*args_, c_allp, gh, gcf,
                                                 *spec)

        dev_f = {label: [] for label in specs}
        dev_b = {label: [] for label in specs}
        host_f = {label: [] for label in specs}
        host_b = {label: [] for label in specs}
        with torch.no_grad():
            for r in range(args.rounds):
                for label in (specs if r % 2 == 0 else specs[::-1]):
                    dev_f[label].append(kernel_device_ms(
                        lambda: fwd(label), 10, "sru_"))
                    dev_b[label].append(kernel_device_ms(
                        lambda: bwd(label), 10, "sru_",
                        launches=mods[label].BACKWARD_LAUNCHES))
                    host_f[label].append(host_ms(lambda: fwd(label), 100))
                    host_b[label].append(host_ms(lambda: bwd(label), 100))
        first = None
        for label in specs:
            h, cf, c_all = fwd(label)
            err_f = max(within(h, hp, **SRU_FWD_TOL, what=f"{label} h"),
                        within(cf, cfp, **SRU_FWD_TOL, what=f"{label} cf"),
                        within(c_all, c_allp, **SRU_FWD_TOL,
                               what=f"{label} c"))
            got, again = bwd(label), bwd(label)
            torch.cuda.synchronize()
            err_b = max(within(g, w, **SRU_BWD_TOL, what=f"{label} {n}")
                        for n, g, w in zip(("du", "dx", "dwc", "db", "dc0"),
                                           got, want))
            stable = torch.equal(got[2], again[2]) and torch.equal(
                got[3], again[3])
            if first is None:
                first, same = (got[2].clone(), got[3].clone()), True
            else:
                same = (torch.equal(got[2], first[0])
                        and torch.equal(got[3], first[1]))
            with torch.no_grad():
                fc = cuda_ms(lambda: fwd(label), 30)
                bc = cuda_ms(lambda: bwd(label), 30)
            fh = statistics.median(host_f[label])
            bh = statistics.median(host_b[label])
            fh_min, bh_min = min(host_f[label]), min(host_b[label])
            f_ms = statistics.median(v for v in dev_f[label] if v)
            b_ms = statistics.median(v for v in dev_b[label] if v)
            row = {"forward_device_ms": f_ms, "backward_device_ms": b_ms,
                   "forward_device_rounds": dev_f[label],
                   "backward_device_rounds": dev_b[label],
                   "forward_call_ms": fc, "backward_call_ms": bc,
                   "forward_host_ms": fh, "backward_host_ms": bh,
                   "forward_host_min_ms": fh_min,
                   "backward_host_min_ms": bh_min,
                   "forward_host_rounds": host_f[label],
                   "backward_host_rounds": host_b[label],
                   "bound_forward_ms": bf, "bound_backward_ms": bb,
                   "max_abs_err_forward": err_f,
                   "max_abs_err_backward": err_b,
                   "weight_grads_bit_equal_over_two_runs": stable,
                   "weight_grads_bit_equal_to_first": same}
            results[label][case] = row
            print(f"  {label}: forward {f_ms:.4f} ms ({bf / f_ms:.1%} of its "
                  f"bound; call {fc:.4f}, host {fh:.4f}, min {fh_min:.4f}), "
                  f"backward {b_ms:.4f} ms ({bb / b_ms:.1%}; call {bc:.4f}, "
                  f"host {bh:.4f}, min {bh_min:.4f}); max|err| {err_f:.2e} / "
                  f"{err_b:.2e}; weight "
                  f"grads bit-equal over two runs {stable}, to {specs[0]} "
                  f"{same}", flush=True)
            del h, cf, c_all, got, again
        if ci == 0:
            host_parts(torch, dev, args_, spec, hp, mods[specs[-1]])
        del a, args_, hp, c_allp, want
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "builds": args.builds, "ptxas": ptxas,
                       "cases": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
