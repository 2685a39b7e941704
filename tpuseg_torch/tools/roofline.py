"""Roofline accounting of the inference stages and the train step (port of
``tools/roofline.py``).

    python -m tpuseg_torch.tools.roofline [--batch 32] [--f32] [--train]
        [--iters 8] [--out PATH] [--device cpu]

For each stage (``tools/stages.py``: preprocess, semantic, full infer at
the k=32 cap; with ``--train`` also the 256x256 B=8 bf16 train step of
``tools/profile_train.py``) this tool:

1. counts the operations and bytes of one run (``utils/roofline.py``:
   2 x the multiply-adds of the products, each dispatched operation's
   inputs read once and outputs written once, the hand kernels by their
   formulas), where the JAX tool read XLA's cost analysis;
2. times the stage with CUDA events after a warm-up (``--iters`` runs;
   bf16, or float32 with TF32 off under ``--f32``);
3. reports GFLOP, GB, FLOP/byte, ms, TFLOP/s, the share of the card's peak
   FLOP rate (``pct_mxu_peak``, the JAX tool's key: the operations' least
   time at the peaks over the time, the ``ir_chain`` kernel's at its
   route's matrix rate and the rest at the stage's compute type's,
   ``utils/roofline.py::ops_seconds``), HBM GB/s and the share of the HBM
   peak, the least time the card could take (``bound_ms``: the larger of
   that operations time and bytes over the HBM rate), which of the two bounds it (``bound_by``) and
   ``bound_ms`` over the time (``pct_roofline``), with the kernel calls
   and launches of the counted run.

The peaks are the H100 SXM data sheet's (``utils/roofline.py::
card_peaks``), chosen by the card's name; any other card raises.  The
card's name and power limit are printed beside them.  With ``--device
cpu`` (a small batch: ``--batch``, ``--res``) it gives the counts, the CPU's
ms and no share.  Writes the rows as JSON to ``--out`` (by default
``tpuseg_torch_roofline.json`` under the temporary directory); the repo's
``ROOFLINE.json`` and PERF.md are the JAX package's records and are not
written.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Dict, List, Optional

import numpy as np
import torch

from tpuseg_torch import resolve_device
from tpuseg_torch.tools import stages
from tpuseg_torch.utils import roofline as rl

OUT = os.path.join(tempfile.gettempdir(), "tpuseg_torch_roofline.json")
TRAIN_BATCH = 8  # tools/profile_train.py's


def row(name: str, c: rl.Count, ms: float, peaks: Optional[Dict],
        dtype: str, note: str = "", **extra) -> Dict:
    """One stage's numbers; the rates and shares only with ``peaks`` (a
    card)."""
    r = {"stage": name, "gflop": c.flops / 1e9, "gb": c.bytes / 1e9,
         "ai_flop_per_byte": c.flops / c.bytes if c.bytes else None,
         "ms": ms, "tflops": None, "pct_mxu_peak": None, "hbm_gbs": None,
         "pct_hbm_peak": None, "bound_ms": None, "bound_by": None,
         "pct_roofline": None, "note": note, "dtype": dtype,
         "ops": c.ops, "kernels": c.kernels, **extra}
    if peaks:
        s = ms / 1e3
        flops_s = rl.ops_seconds(c, dtype, peaks)
        bytes_s = c.bytes / peaks["bytes"]
        r.update(
            tflops=c.flops / s / 1e12,
            pct_mxu_peak=100 * flops_s / s,
            hbm_gbs=c.bytes / s / 1e9,
            pct_hbm_peak=100 * c.bytes / s / peaks["bytes"],
            bound_ms=1e3 * max(flops_s, bytes_s),
            bound_by="operations" if flops_s > bytes_s else "bytes",
            pct_roofline=100 * max(flops_s, bytes_s) / s)
    return r


def launch_counts() -> Dict[str, int]:
    from tpuseg_torch.kernels.ir_chain import ir_chain
    from tpuseg_torch.kernels.masked_softmax import masked_softmax
    from tpuseg_torch.kernels.sru_scan import sru_scan

    return {"ir_chain": ir_chain.launches,
            "masked_softmax": masked_softmax.launches,
            "sru_scan": sru_scan.launches}


def counted(fn):
    """(one run's count, its output, the kernel launches it made)."""
    before = launch_counts()
    with rl.count() as c:
        out = fn()
    launches = {k: v - before[k] for k, v in launch_counts().items()}
    return c, out, launches


def train_stage(args, dev, peaks, iters: int) -> Dict:
    """The B=8 bf16 train step of ``tools/profile_train.py`` at ``--res``,
    counted over one step and timed over ``iters`` steps that carry the
    state as training does."""
    from tpuseg_torch.data.synthetic import make_batch
    from tpuseg_torch.runtime.state import create_train_state
    from tpuseg_torch.runtime.train import make_train_step

    _, cfg, model = stages.load(args)
    state = create_train_state(cfg, model, device=dev)
    step = make_train_step(cfg, model, dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(cfg.train.seed)
    batch = make_batch(np.random.default_rng(13), TRAIN_BATCH, args.res,
                       args.res, cfg.data.max_n_objects, hard=True)
    step(state, batch, gen)  # warm-up
    c, _, launches = counted(lambda: step(state, batch, gen))
    ms = stages.time_ms(lambda: step(state, batch, gen), dev, iters,
                        warmup=0)
    return row(f"train step {args.res}^2 B={TRAIN_BATCH} bf16", c, ms,
               peaks, "bfloat16", "fwd+bwd+Adadelta, remat on",
               launches=launches)


def run(args) -> List[Dict]:
    s = stages.setup(args)
    dtype = "float32" if s.dtype == torch.float32 else "bfloat16"
    peaks = None
    if s.dev.type == "cuda":
        name = torch.cuda.get_device_name(s.dev)
        peaks = rl.card_peaks(name)
        print(f"card: {rl.card_line()}; peaks (data sheet, H100 SXM at 700 W): "
              f"{peaks['bfloat16'] / 1e12:.0f} TFLOP/s bf16, "
              f"{peaks['tf32'] / 1e12:.1f} TF32, {peaks['float32'] / 1e12:.0f}"
              f" float32, {peaks['bytes'] / 1e12:.2f} TB/s", flush=True)
    k = s.cfg.data.max_n_objects
    rows = []
    for name, fn, note in (
        ("preprocess (21-ch)", lambda: stages.preprocess(s),
         "elementwise: bandwidth-bound"),
        ("semantic (pre+UNet+head)", lambda: stages.semantic(s), ""),
        (f"full infer, k={k} cap", lambda: stages.batch(s.pred, s.x),
         "production pred_list program"),
    ):
        fn()  # warm-up (cuDNN plans, allocator)
        c, out, launches = counted(fn)
        ms = stages.time_ms(fn, s.dev, args.iters, warmup=0)
        extra = {"rounds": out} if isinstance(out, int) else {}
        rows.append(row(name, c, ms, peaks, dtype, note, launches=launches,
                        **extra))
        print(json.dumps(rows[-1]), flush=True)
    if args.train:
        del s
        rows.append(train_stage(args, resolve_device(args.device), peaks,
                                args.iters))
        print(json.dumps(rows[-1]), flush=True)
    return rows


def render(rows: List[Dict], batch: int, res: int) -> str:
    def f(v, fmt):
        return "n/a" if v is None else format(v, fmt)

    lines = [f"B={batch} at {res}^2; operations and bytes computed "
             "(utils/roofline.py), ms from CUDA events",
             "", "| stage | GFLOP | GB | FLOP/byte | ms | TFLOP/s | % FLOP "
             "peak | HBM GB/s | % HBM peak | bound ms | bound by | % of "
             "bound |", "|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        lines.append(
            f"| {r['stage']} | {r['gflop']:.3f} | {r['gb']:.4f} | "
            f"{f(r['ai_flop_per_byte'], '.2f')} | {r['ms']:.3f} | "
            f"{f(r['tflops'], '.2f')} | {f(r['pct_mxu_peak'], '.2f')} | "
            f"{f(r['hbm_gbs'], '.1f')} | {f(r['pct_hbm_peak'], '.2f')} | "
            f"{f(r['bound_ms'], '.4f')} | {r['bound_by'] or 'n/a'} | "
            f"{f(r['pct_roofline'], '.2f')} |")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    stages.add_model_args(ap)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--train", action="store_true",
                    help="also the B=8 bf16 train step at --res")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    resolve_device(args.device)
    rows = run(args)
    print(render(rows, args.batch, args.res))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=2)
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
