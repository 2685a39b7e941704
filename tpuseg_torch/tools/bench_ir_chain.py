"""Time builds of the bf16 ``ir_chain`` kernel side by side on one card.

    python tpuseg_torch/tools/bench_ir_chain.py [--out FILE] [--rounds R]
        LABEL=SOURCE[@PATCH] ...

Each argument names one build of a ``.cu`` file that exports
``tpuseg_ir_block`` (the C entry point of ``csrc/ir_chain.cu``), such as
this checkout's and a parent's unpacked with ``git archive``: ``PATCH``
edits the source text first (``PATCHES``: timed variants of a kernel whose
results are allowed to be wrong).  All builds compile at once, then every build
runs the main path's five bf16 chain calls (``chip_smoke.MAIN_SHAPES``,
N = 128, the mid-chain skip on every level but the first, the committed
checkpoint's folded weights) in turns, forward and reversed order, for
``R`` rounds.  Per build and level it prints the time per chain from CUDA
events (median over rounds), the device time per launch from
``torch.profiler``, max|err| / max|y| against the float32 plain version,
and the ``ptxas`` report; ``--out`` also writes them as JSON.  Compare
builds only within one run: the card's power limit and host differ
between machines.
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

# timed variants of the WMMA bf16 kernel of commit e37eaf2 (``git archive
# e37eaf2``), to split its time by cause: (a) ``noweights``, each chunk's
# weights loaded only for the first chunk; (b) ``nobias``, the separate
# bias + relu6 + mask pass over ``hs`` gone
PATCHES = {
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
    label, rest = spec.split("=", 1)
    src, _, patch = rest.partition("@")
    return label, Path(src).resolve(), patch or None


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("builds", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv[1:])
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("bench_ir_chain: CUDA is not available", file=sys.stderr)
        return 2
    from chip_smoke import (
        MAIN_SHAPES, N_DECODE, chain_bound, cuda_ms, kernel_device_ms,
        smi_line,
    )
    from tpuseg_torch.cli.common import load_model
    from tpuseg_torch.kernels import build
    from tpuseg_torch.kernels.ir_chain import ir_chain_plain, stack_chain_params
    from tpuseg_torch.settings import get_config

    smi = smi_line()
    print("card:", smi, flush=True)
    jobs, specs = {}, []
    bdir = build.BUILD_DIR / "bench"
    bdir.mkdir(parents=True, exist_ok=True)
    for spec in args.builds:
        label, src, patch = parse(spec)
        if patch:
            src = patched(src, patch, bdir / f"{label}.cu")
        jobs[label] = (src, bdir / f"lib{label}.so")
        specs.append(label)
    build.compile_all(jobs)
    ptxas = {}
    for label in specs:
        ptxas[label] = [ln.strip() for ln in build.build_logs[label]
                        .splitlines() if "ir_block_tc" in ln
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
    dev = torch.device("cuda")
    _, model = load_model(get_config("CVPPP"),
                          str(ROOT / "assets" / "synthetic_ckpt.msgpack"))
    levels = model.to(dev).eval().decoder.bone.levels
    g = torch.Generator().manual_seed(0)
    results = {label: {} for label in specs}
    for lvl, h, w, c in MAIN_SHAPES:
        blk = levels[lvl]
        params = [t.to(dev) for t in stack_chain_params(
            [blk.dil1a, blk.dil1b, blk.dil2a, blk.dil2b], torch.bfloat16)]
        x = torch.randn(N_DECODE, h, w, c, generator=g).to(dev, torch.bfloat16)
        skip = (torch.randn(N_DECODE, h, w, c, generator=g)
                .to(dev, torch.bfloat16) if lvl else None)
        want = ir_chain_plain(x.float(), None if skip is None else
                              skip.float(), *[t.float() for t in params])
        scale = want.abs().max().item()
        outs = [torch.empty_like(x) for _ in range(4)]
        stream = torch.cuda.current_stream().cuda_stream

        def chain(fn):
            v = x
            for s in range(4):
                err = fn(1, v.data_ptr(),
                         skip.data_ptr() if (s == 2 and skip is not None)
                         else None, outs[s].data_ptr(),
                         *[t[s].data_ptr() for t in params], N_DECODE, h, w, c,
                         stream)
                if err:
                    raise RuntimeError(f"launch failed: cudaError {err}")
                v = outs[s]
            return v

        iters = max(3, min(50, int(2e8 // (N_DECODE * h * w * c))))
        b_ms, o_ms = chain_bound(N_DECODE, h, w, c, "bfloat16", lvl > 0)
        ev = {label: [] for label in specs}
        for r in range(args.rounds):
            for label in (specs if r % 2 == 0 else specs[::-1]):
                ev[label].append(cuda_ms(lambda: chain(fns[label]), iters))
        for label in specs:
            got = chain(fns[label])
            torch.cuda.synchronize()
            err = (got.float() - want).abs().max().item()
            dev_ms = kernel_device_ms(lambda: chain(fns[label]), 3, "ir_block",
                                      launches=4)
            dev_ms = None if dev_ms is None else dev_ms / 4
            row = {"ms": statistics.median(ev[label]), "ms_rounds": ev[label],
                   "device_ms_per_launch": dev_ms,
                   "bound_ms": max(b_ms, o_ms),
                   "rel_err": err / scale}
            results[label][f"L{lvl}"] = row
            print(f"L{lvl} {[N_DECODE, h, w, c]} {label}: {row['ms']:.3f} ms "
                  f"per chain (rounds {[round(v, 3) for v in ev[label]]}), "
                  f"device {dev_ms if dev_ms is None else round(dev_ms, 4)}"
                  f" ms per launch, bound {row['bound_ms']:.4f} ms, "
                  f"max|err|/max|y| {row['rel_err']:.3e}", flush=True)
        del x, skip, want, outs
        torch.cuda.empty_cache()
    for label in specs:
        tot = sum(r["ms"] for r in results[label].values())
        print(f"{label}: {tot:.3f} ms per round of the five levels",
              flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": smi, "builds": args.builds, "ptxas": ptxas,
                       "levels": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
