"""Per-stage timing of the batched inference path on the card (port of
``tools/profile_stages.py``).

    python -m tpuseg_torch.tools.profile_stages [--batch 32] [--f32]
        [--ks 1,8,16,32] [--iters 8] [--trace DIR] [--device cpu]

Times, with CUDA events after a warm-up (``tools/stages.py``):
  preprocess : uint8 -> the 21 standardised channels
  semantic   : preprocess + UNet backbone + SE + semantic head
  infer_k{k} : the full path at the instance cap k, for each k of ``--ks``
               (a ``Predictor(max_instances=k)`` batch, as ``pred_list``
               runs it) — the slope over k is the cost of a glimpse slot,
               the k -> 0 intercept minus ``semantic`` the attend + skip
               transforms + conv1 partials.
Derived, under the JAX tool's keys: ``per_slot_extract``,
``attend_plus_skips``, ``unet_only``.

``--trace DIR`` also runs one full batch (k at the config's cap) inside
``utils/tracing.py::trace_context`` under the annotation
``predict_batch`` and prints ``trace_summary`` of it (buckets for the
``ir_chain`` kernel, the convolutions, copies and the rest; the idle share
and the longest gaps with their host events).  Prints the report as JSON.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from tpuseg_torch import resolve_device
from tpuseg_torch.tools import stages

# trace_summary's buckets of an inference batch (REGEX=NAME, first match
# wins): the hand kernel, cuDNN's convolutions and the products, the
# BatchNorms, copies (dtype and layout copies, cat, memcpy), indexing
# (gathers, scatters, the window selection), reductions; the rest is
# elementwise
INFER_BUCKETS = (
    "ir_block=ir_chain",
    "conv|cudnn|xmma|implicit_gemm|gemm|cutlass=convolutions",
    "batch_norm=batchnorm",
    "(?i)copy|memcpy|memset=copies",
    "index|gather|scatter=indexing",
    "reduce=reductions",
)


def trace_batch(s: stages.Setup, trace_dir: str) -> dict:
    """One full batch traced under ``predict_batch``; its summary."""
    from tpuseg_torch.tools import trace_summary
    from tpuseg_torch.utils.tracing import annotate, trace_context

    stages.batch(s.pred, s.x)  # warm-up
    with trace_context(trace_dir):
        with annotate("predict_batch"):
            stages.batch(s.pred, s.x)
    path = trace_summary.trace_path(trace_dir)
    buckets = [trace_summary.bucket(spec) for spec in INFER_BUCKETS]
    r = trace_summary.summarize(trace_summary.load_events(path), buckets,
                                window="predict_batch")
    print("\n".join(trace_summary.render(path, r)),
          file=sys.stderr)
    return r


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    stages.add_model_args(ap)
    ap.add_argument("--ks", default="1,8,16,32")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--trace", default="", help="trace one batch into DIR")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    s = stages.setup(args)

    ms = {"preprocess": stages.time_ms(lambda: stages.preprocess(s), s.dev,
                                       args.iters),
          "semantic": stages.time_ms(lambda: stages.semantic(s), s.dev,
                                     args.iters)}
    ks = [int(k) for k in args.ks.split(",")]
    rounds = {}
    for k in ks:
        pred = s.predictor(k)
        ms[f"infer_k{k}"] = stages.time_ms(lambda: stages.batch(pred, s.x),
                                           s.dev, args.iters)
        rounds[f"infer_k{k}"] = stages.batch(pred, s.x)
    if len(ks) >= 2:
        k_lo, k_hi = ks[0], ks[-1]
        slope = (ms[f"infer_k{k_hi}"] - ms[f"infer_k{k_lo}"]) / (k_hi - k_lo)
        ms["per_slot_extract"] = slope
        ms["attend_plus_skips"] = (ms[f"infer_k{k_lo}"] - slope * k_lo
                                   - ms["semantic"])
    ms["unet_only"] = ms["semantic"] - ms["preprocess"]
    b = s.batch
    report = {
        "batch": b,
        "dtype": s.dtype_name,
        "device": stages.device_name(s.dev),
        "stages_ms_per_batch": ms,
        "stages_ms_per_image": {k: v / b for k, v in ms.items()},
        "imgs_per_sec_full": 1e3 * b / ms[f"infer_k{ks[-1]}"],
        "rounds": rounds,
    }
    if args.trace:
        report["trace"] = trace_batch(s, args.trace)
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
