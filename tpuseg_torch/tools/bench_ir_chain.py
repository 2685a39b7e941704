"""Time builds of the ``ir_chain`` kernel side by side on one card.

    python tpuseg_torch/tools/bench_ir_chain.py [--dtype D] [--out FILE]
        [--rounds R] [--old-wrapper PY] LABEL=SOURCE[@PATCH|@NAME=VALUE,...]
        ...

Each argument names one build of a ``.cu`` file that exports
``tpuseg_ir_block`` (the C entry point of ``csrc/ir_chain.cu``), such as
this checkout's and a parent's written out with ``git show
<commit>:tpuseg_torch/kernels/csrc/ir_chain.cu`` into ``_tree_check/``
(gitignored).  ``@PATCH`` edits the source text first (``PATCHES``: timed
variants of a kernel whose results are allowed to be wrong); ``@NAME=VALUE``
pairs are compiled in as ``#define`` lines, a value may hold commas (the
float32 tile sets ``IR_F32_<C>``, e.g. ``"@IR_F32_32=Tile<32, 8, 16, 32,
1, 2, 256, 4>"``).
All builds compile at once, then every build runs the main path's five
chain calls in ``--dtype`` (bfloat16, the default, or float32;
``chip_smoke.MAIN_SHAPES``, N = 128, the mid-chain skip on every level but
the first, the committed checkpoint's folded weights) in turns, forward and
reversed order, for ``R`` rounds.  Per build and level it prints the time
per chain from CUDA events (median over rounds), the device time per
launch from ``torch.profiler``, max|err| / max|y| against the float32 plain
version, max|diff| against the first build's output, and the ``ptxas``
report; ``--out`` also writes them as JSON.  ``--old-wrapper`` names
another ``kernels/ir_chain.py`` (a parent's): the host time per call of it
and of this checkout's wrapper, both on the last build, is timed in turns
at the first level.  Compare builds only within one run: the card's power
limit and host differ between machines.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import re
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# timed variants of the WMMA bf16 kernel of commit e37eaf2 (``git archive
# e37eaf2``), to split its time by cause: (a) ``noweights``, each chunk's
# weights loaded only for the first chunk; (b) ``nobias``, the separate
# bias + relu6 + mask pass over ``hs`` gone.  Of this checkout's float32
# (3xTF32) kernel: (c) ``nosplit``, the operands passed whole (lo = 0: the
# splits cost nothing, the three products stay); (d) ``onemma``, only the
# hi . hi product (the cross terms and their splits gone: single-pass
# TF32's cost); (e) ``nodw``, the depthwise gone
_CROSS_TERMS = re.compile(
    r"#pragma unroll\n\s*for \(int j = 0; j < NG; \+\+j\) mma1688\(h\[j\], al,"
    r".*?\n.*?\n\s*for \(int j = 0; j < NG; \+\+j\) mma1688\(h\[j\], ah, bl.*?\n")
_CROSS_TERMS_3 = re.compile(
    r"(#pragma unroll\n\s*for \(int i = 0; i < kFM; \+\+i\)\n#pragma unroll\n"
    r"\s*for \(int j = 0; j < kFN; \+\+j\)\n\s*mma1688\(acc\.v\[i\]\[j\], "
    r"a[lh]\[i\], b[hl]\[j\]\[0\], b[hl]\[j\]\[1\]\);\n){2}")
PATCHES = {
    "nosplit": [(
        "  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;\n"
        "  lo = __float_as_uint(v - __uint_as_float(hi));",
        "  hi = __float_as_uint(v);\n  lo = 0u;"),
    ],
    "onemma": [(_CROSS_TERMS, ""), (_CROSS_TERMS_3, "")],
    "nodw": [("      depthwise<L>(hs, ds, b2c, wdc);\n", "")],
    "noweights": [(
        re.compile(r"(    for \(int i = tid; i < C \* KC; i \+= kThreads\) \{\n"
                   r"      const int k = i / KC, j = i - k \* KC;\n"
                   r"      w1s\[k \* L::kLW1 \+ j\].*?)"
                   r"(    __syncthreads\(\);\n\n    // 1\. expansion on the "
                   r"tensor cores)", re.S),
        r"    if (c0 == 0) {\n\1    }\n\2"),
    ],
    "nobias": [(
        re.compile(r"    // \+ b1, relu6; zero outside the image\n.*?"
                   r"    __syncthreads\(\);\n", re.S), ""),
    ],
}


def patched(src: Path, patch: str, out: Path) -> Path:
    text = src.read_text()
    for old, new in PATCHES[patch]:
        if isinstance(old, re.Pattern):
            text, n = old.subn(new, text, count=1)
        else:
            n = text.count(old)
            text = text.replace(old, new, 1)
        if n < 1:
            raise ValueError(f"patch {patch}: text not found in {src}")
    out.write_text(text)
    return out


def parse(spec: str):
    """(label, source, patch name or None, ``#define`` lines)."""
    label, rest = spec.split("=", 1)
    src, _, opt = rest.partition("@")
    if "=" not in opt:
        return label, Path(src).resolve(), opt or None, []
    # NAME=VALUE pairs; a value runs up to the next ``,NAME=``
    defs = re.split(r",(?=[A-Za-z_]\w*=)", opt)
    return label, Path(src).resolve(), None, [
        f"#define {d.replace('=', ' ', 1)}" for d in defs]


def load_wrapper(path: Path, label: str, fn):
    """The wrapper module at ``path``, launching through ``fn``."""
    spec = importlib.util.spec_from_file_location(f"ir_chain_{label}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._kernel_fn = lambda: fn
    return mod


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("builds", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=None)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--old-wrapper", default=None)
    args = ap.parse_args(argv[1:])
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("bench_ir_chain: CUDA is not available", file=sys.stderr)
        return 2
    from chip_smoke import (
        MAIN_SHAPES, N_DECODE, cuda_ms, host_ms, kernel_device_ms, smi_line,
    )
    from tpuseg_torch.utils.roofline import chain_bound
    from tpuseg_torch.cli.common import load_model
    from tpuseg_torch.kernels import build
    from tpuseg_torch.kernels import ir_chain as wrapper
    from tpuseg_torch.kernels.ir_chain import ir_chain_plain, stack_chain_params
    from tpuseg_torch.settings import get_config

    smi = smi_line()
    print("card:", smi, flush=True)
    jobs, specs = {}, []
    bdir = build.BUILD_DIR / "bench"
    bdir.mkdir(parents=True, exist_ok=True)
    for spec in args.builds:
        label, src, patch, defines = parse(spec)
        if patch:
            src = patched(src, patch, bdir / f"{label}.cu")
        elif defines:
            text = "\n".join(defines) + "\n" + src.read_text()
            src = bdir / f"{label}.cu"
            src.write_text(text)
        jobs[label] = (src, bdir / f"lib{label}.so")
        specs.append(label)
    build.compile_all(jobs)
    ptxas = {}
    for label in specs:
        ptxas[label] = [ln.strip() for ln in build.build_logs[label]
                        .splitlines() if "ir_block" in ln
                        or "registers" in ln or "spill" in ln]
        print(f"built {label}:", *ptxas[label], sep="\n  ", flush=True)
    fns = {}
    for label in specs:
        fn = ctypes.CDLL(str(jobs[label][1])).tpuseg_ir_block
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[label] = fn

    torch.backends.cudnn.allow_tf32 = False
    dtype = getattr(torch, args.dtype)
    code = wrapper._DTYPE_CODE[dtype]
    dev = torch.device("cuda")
    _, model = load_model(get_config("CVPPP"),
                          str(ROOT / "assets" / "synthetic_ckpt.msgpack"))
    levels = model.to(dev).eval().decoder.bone.levels
    g = torch.Generator().manual_seed(0)
    results = {label: {} for label in specs}
    host = {}
    for lvl, h, w, c in MAIN_SHAPES:
        blk = levels[lvl]
        params = [t.to(dev) for t in stack_chain_params(
            [blk.dil1a, blk.dil1b, blk.dil2a, blk.dil2b], dtype)]
        x = torch.randn(N_DECODE, h, w, c, generator=g).to(dev, dtype)
        skip = (torch.randn(N_DECODE, h, w, c, generator=g)
                .to(dev, dtype) if lvl else None)
        want = ir_chain_plain(x.float(), None if skip is None else
                              skip.float(), *[t.float() for t in params])
        scale = want.abs().max().item()
        outs = [torch.empty_like(x) for _ in range(4)]
        stream = torch.cuda.current_stream().cuda_stream

        def chain(fn):
            v = x
            for s in range(4):
                err = fn(code, v.data_ptr(),
                         skip.data_ptr() if (s == 2 and skip is not None)
                         else None, outs[s].data_ptr(),
                         *[t[s].data_ptr() for t in params], N_DECODE, h, w, c,
                         stream)
                if err:
                    raise RuntimeError(f"launch failed: cudaError {err}")
                v = outs[s]
            return v

        if args.old_wrapper and not host:
            # host time of a wrapper call, the parent's and this one, both
            # launching the last build, in turns
            mods = {"old_wrapper": load_wrapper(
                        Path(args.old_wrapper).resolve(), "old",
                        fns[specs[-1]]),
                    "wrapper": load_wrapper(Path(wrapper.__file__), "new",
                                            fns[specs[-1]])}
            host = {k: [] for k in mods}
            for r in range(2 * args.rounds + 1):
                for k in (mods if r % 2 == 0 else list(mods)[::-1]):
                    host[k].append(host_ms(
                        lambda: mods[k].ir_chain(x, skip, *params), 100))
            host = {k: {"median_ms": statistics.median(v), "min_ms": min(v),
                        "ms_rounds": v} for k, v in host.items()}
            print(f"host time per wrapper call at L{lvl}: " + ", ".join(
                f"{k} {v['median_ms']:.4f} ms (min {v['min_ms']:.4f})"
                for k, v in host.items()), flush=True)

        iters = max(3, min(50, int(2e8 // (N_DECODE * h * w * c))))
        b_ms, o_ms = chain_bound(N_DECODE, h, w, c, args.dtype, lvl > 0)
        # float32: the bound with every product on the CUDA cores beside
        core_ms = (max(chain_bound(N_DECODE, h, w, c, args.dtype, lvl > 0,
                                   cuda_cores=True))
                   if args.dtype == "float32" else None)
        ev = {label: [] for label in specs}
        for r in range(args.rounds):
            for label in (specs if r % 2 == 0 else specs[::-1]):
                ev[label].append(cuda_ms(lambda: chain(fns[label]), iters))
        first = None
        for label in specs:
            got = chain(fns[label]).float()
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            if first is None:
                first = got.clone()
            diff = (got - first).abs().max().item()
            dev_ms = kernel_device_ms(lambda: chain(fns[label]), 3, "ir_block",
                                      launches=4)
            dev_ms = None if dev_ms is None else dev_ms / 4
            row = {"ms": statistics.median(ev[label]), "ms_rounds": ev[label],
                   "device_ms_per_launch": dev_ms,
                   "bound_ms": max(b_ms, o_ms),
                   "bound_cuda_cores_ms": core_ms,
                   "rel_err": err / scale, "max_diff_first": diff}
            results[label][f"L{lvl}"] = row
            print(f"L{lvl} {[N_DECODE, h, w, c]} {args.dtype} {label}: "
                  f"{row['ms']:.3f} ms per chain (rounds "
                  f"{[round(v, 3) for v in ev[label]]}), device "
                  f"{dev_ms if dev_ms is None else round(dev_ms, 4)}"
                  f" ms per launch, bound {row['bound_ms']:.4f} ms"
                  + ("" if core_ms is None else f" (CUDA cores {core_ms:.4f})")
                  + ", "
                  f"max|err|/max|y| {row['rel_err']:.3e}, max|diff| vs "
                  f"{specs[0]} {diff:.3e}", flush=True)
            del got
        del x, skip, want, outs, first
        torch.cuda.empty_cache()
    for label in specs:
        tot = sum(r["ms"] for r in results[label].values())
        print(f"{label}: {tot:.3f} ms per round of the five levels",
              flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "dtype": args.dtype,
                       "builds": args.builds, "ptxas": ptxas,
                       "host_ms_per_call": host, "levels": results}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
