"""The device trace of a traced run: ``torch.profiler`` over the traced
window, and the arithmetic that reduces its Chrome trace to busy time,
idle gaps and device time by bucket (a frozen copy of the program's
``tools/trace_summary.py`` arithmetic).

The device lane is the events of category ``kernel``, ``gpu_memcpy`` and
``gpu_memset``; busy time is the union of their intervals inside the
window (streams that overlap count once); each idle gap is named by the
innermost host event (``cpu_op`` or ``cuda_runtime``) running when it
began, ``(none)`` where the host was between operations.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import itertools
import json
import os
import re
import tempfile
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime")
WINDOW = "segbench_window"

# device time by kind of operation (regex, name; the first match wins,
# the rest is elementwise work)
BUCKETS = tuple((re.compile(p), n) for p, n in (
    ("ir_block", "ir_chain"),
    ("masked_softmax|softmax_tiles|softmax_row", "masked_softmax"),
    ("conv|cudnn|xmma|implicit_gemm|gemm|cutlass", "convolutions"),
    ("batch_norm", "batchnorm"),
    ("(?i)copy|memcpy|memset", "copies"),
    ("index|gather|scatter", "indexing"),
    ("reduce", "reductions"),
))


def _span(e) -> Tuple[float, float]:
    return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))


def union(intervals: Sequence[Tuple[float, float]]) -> List[List[float]]:
    """The union of [start, end) intervals, sorted and merged."""
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


class HostEvents:
    def __init__(self, events: Sequence[dict]):
        host = sorted((_span(e) + (e.get("name", "?"),) for e in events
                       if e.get("ph") == "X" and e.get("cat") in HOST_CATS))
        self.spans = host
        self.starts = [a for a, _, _ in host]
        # the latest end among the spans up to each one: the search stops
        # where no earlier span reaches ``t``
        self.reach = list(itertools.accumulate((b for _, b, _ in host), max))

    def at(self, t: float) -> Optional[str]:
        """The innermost host event running at ``t``: of those whose span
        holds it, the latest to start."""
        for i in range(bisect.bisect_right(self.starts, t) - 1, -1, -1):
            if self.reach[i] <= t:
                return None
            a, b, name = self.spans[i]
            if t < b:
                return name
        return None


def summarize(events: Sequence[dict], window: str = WINDOW,
              top: int = 10) -> Dict:
    """Seconds of device work in the window named ``window`` (the span of
    the host events of that name): ``busy_s``, ``window_s``, ``ops``
    (device events), ``by_name`` (seconds) and ``launches`` (events) by
    kernel name, ``buckets`` (seconds), ``idle_gaps`` (the ``top``
    longest, [host event, seconds]) and ``idle_by_host`` (seconds by host
    event).  Raises ``ValueError`` when the window holds no device
    event."""
    named = [_span(e) for e in events
             if e.get("ph") == "X" and e.get("name") == window]
    if not named:
        raise ValueError(f"no event named {window!r} in the trace")
    w0, w1 = min(a for a, _ in named), max(b for _, b in named)
    device = [(e, _span(e)) for e in events
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    inside = [(e, s) for e, s in device if s[1] > w0 and s[0] < w1]
    if not inside:
        raise ValueError("the trace holds no device event in its window")
    by_name: collections.Counter = collections.Counter()
    n_by_name: collections.Counter = collections.Counter()
    buckets: collections.Counter = collections.Counter()
    for e, (a, b) in inside:
        dur = (min(b, w1) - max(a, w0)) / 1e6
        name = e.get("name", "?")
        by_name[name] += dur
        n_by_name[name] += 1
        for pat, bname in BUCKETS:
            if pat.search(name):
                buckets[bname] += dur
                break
        else:
            buckets["elementwise"] += dur
    busy = union([(max(a, w0), min(b, w1)) for _, (a, b) in inside])
    busy_s = sum(b - a for a, b in busy) / 1e6
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    host = HostEvents(events)
    by_host: collections.Counter = collections.Counter()
    for a, b in idle:
        by_host[host.at(a) or "(none)"] += (b - a) / 1e6
    longest = sorted(idle, key=lambda g: g[0] - g[1])[:top]
    return {
        "busy_s": busy_s,
        "window_s": (w1 - w0) / 1e6,
        "ops": len(inside),
        "by_name": dict(by_name),
        "launches": dict(n_by_name),
        "buckets": dict(buckets),
        "idle_gaps": [[host.at(a) or "(none)", (b - a) / 1e6]
                      for a, b in longest],
        "idle_by_host": dict(by_host),
    }


def breakdown(summary: Dict, top: int = 10) -> Dict:
    """The result line's ``breakdown``: device seconds by bucket, and idle
    seconds by the host event at each gap's start, the largest first."""
    def largest(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                ][:top]
    return {"device_ops": largest(summary["buckets"]),
            "idle_gaps": largest(summary["idle_by_host"])}


@contextlib.contextmanager
def traced() -> Iterator[Dict]:
    """Profile the block (host and device); the yielded dict gets the
    trace's events once the block has ended.  The caller marks the window
    with ``torch.profiler.record_function(WINDOW)``.  The trace file lives
    in a temporary directory under ``TMPDIR`` and is deleted once read."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out: Dict = {}
    with tempfile.TemporaryDirectory(prefix="segbench-trace-") as tmp:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            yield out
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            out["events"] = json.load(f)["traceEvents"]
