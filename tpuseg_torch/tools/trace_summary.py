"""Summarise a ``torch.profiler`` Chrome trace into a device cost map
(port of ``tools/trace_summary.py``).

    python -m tpuseg_torch.tools.trace_summary TRACE [--top 30]
        [--bucket REGEX=NAME ...] [--steps 1] [--window NAME] [--gaps 5]
        [--json]

TRACE is the Chrome trace that ``utils/tracing.py::trace_context`` writes
(a directory holding its ``trace.json``) or any ``export_chrome_trace``
file (``.json`` or ``.json.gz``).  The device lane is the events of
category ``kernel``, ``gpu_memcpy`` and ``gpu_memset``.  As the JAX tool
does, it sums their time by name (the top ops, with their counts) and by
``--bucket`` patterns, tried in order against the name: the first match
wins, the rest land in ``other``; ``--steps`` divides the totals.

Beyond the JAX tool:
- device busy time: the union of the device intervals (streams that
  overlap count once), where the sum counts them twice;
- the window: the span of the events named ``--window`` (a
  ``record_function`` annotation such as ``predict_batch``), else first to
  last device event; only device time inside it counts;
- the idle share, 1 - busy / window;
- launches per kernel name;
- the ``--gaps`` longest idle gaps of the window, each with the host
  event (``cpu_op`` or ``cuda_runtime``, the innermost) that was running
  when the gap began, and the number of gaps;
- the idle time by that host event, over every gap (``(none)``: the gap
  began between operations, in Python).

``--json`` prints the same numbers as one JSON object.  Exits non-zero
when the trace holds no device event: there is no fallback to host time.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import gzip
import json
import os
import re
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from tpuseg_torch.utils.tracing import TRACE_FILE

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime")


def bucket(spec: str):
    """``REGEX=NAME`` -> (compiled regex, name); NAME defaults to REGEX."""
    pat, _, name = spec.partition("=")
    return re.compile(pat), name or pat


def trace_path(path: str) -> str:
    return os.path.join(path, TRACE_FILE) if os.path.isdir(path) else path


def load_events(path: str) -> List[dict]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)["traceEvents"]


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
    """The host events of a trace, for :meth:`at`."""

    def __init__(self, events: Sequence[dict]):
        host = sorted((_span(e) + (e.get("name", "?"),) for e in events
                       if e.get("ph") == "X" and e.get("cat") in HOST_CATS))
        self.spans = host
        self.starts = [a for a, _, _ in host]

    def at(self, t: float) -> Optional[str]:
        """The innermost host event running at ``t``: of those whose span
        holds it, the latest to start."""
        for i in range(bisect.bisect_right(self.starts, t) - 1, -1, -1):
            a, b, name = self.spans[i]
            if t < b:
                return name
        return None


def summarize(events: Sequence[dict], buckets=(), steps: int = 1,
              top: int = 30, window: str = "", gaps: int = 5) -> Dict:
    """The device cost map of a trace's events (module docstring); raises
    ``ValueError`` when there is no device event."""
    device = [e for e in events
              if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    if not device:
        raise ValueError("the trace holds no device event (kernel, "
                         "gpu_memcpy, gpu_memset)")
    spans = [_span(e) for e in device]
    if window:
        named = [_span(e) for e in events
                 if e.get("ph") == "X" and e.get("name") == window]
        if not named:
            raise ValueError(f"no event named {window!r} in the trace")
        w0, w1 = min(a for a, _ in named), max(b for _, b in named)
    else:
        w0, w1 = min(a for a, _ in spans), max(b for _, b in spans)
    inside = [(e, s) for e, s in zip(device, spans) if s[1] > w0 and s[0] < w1]

    by_name: collections.Counter = collections.Counter()
    n_by_name: collections.Counter = collections.Counter()
    by_bucket: collections.Counter = collections.Counter()
    total = 0.0
    for e, _ in inside:
        dur = float(e.get("dur", 0)) / 1e3  # us -> ms
        name = e.get("name", "?")
        total += dur
        by_name[name] += dur
        n_by_name[name] += 1
        for pat, bname in buckets:
            if pat.search(name):
                by_bucket[bname] += dur
                break
        else:
            by_bucket["other"] += dur

    busy = union([(max(a, w0), min(b, w1)) for _, (a, b) in inside])
    busy_ms = sum(b - a for a, b in busy) / 1e3
    window_ms = (w1 - w0) / 1e3
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    host = HostEvents(events)
    by_host: collections.Counter = collections.Counter()
    for a, b in idle:
        by_host[host.at(a) or "(none)"] += (b - a) / 1e3
    longest = sorted(idle, key=lambda g: g[0] - g[1])[:gaps]
    s = steps
    return {
        "device_ms": total / s,
        "ops": len(inside),
        "buckets": {k: v / s for k, v in by_bucket.most_common()}
        if buckets else {},
        "top": [{"name": n, "count": n_by_name[n], "ms": ms / s,
                 "pct": 100 * ms / total}
                for n, ms in by_name.most_common(top)],
        "busy_ms": busy_ms / s,
        "window_ms": window_ms / s,
        "window": window or "first to last device event",
        "idle_share": 1.0 - busy_ms / window_ms if window_ms > 0 else 0.0,
        "launches": {k: n_by_name[k] for k, _ in by_name.most_common()},
        "gaps": [{"start_us": a - w0, "ms": (b - a) / 1e3,
                  "host": host.at(a)} for a, b in longest],
        "n_gaps": len(idle),
        "idle_by_host": {k: v / s for k, v in by_host.most_common(top)},
    }


def render(path: str, r: Dict) -> List[str]:
    """The JAX tool's tables (bucket, top op) and the lines it lacks."""
    lines = [f"# {path}",
             f"device total: {r['device_ms']:.1f} ms/step ({r['ops']} ops)",
             ""]
    if r["buckets"]:
        lines += ["| bucket | ms/step | % |", "|---|---|---|"]
        lines += [f"| {b} | {ms:.1f} | {100 * ms / r['device_ms']:.1f} |"
                  for b, ms in r["buckets"].items()]
        lines.append("")
    lines += ["| top op (x count) | ms/step | % |", "|---|---|---|"]
    for t in r["top"]:
        name = t["name"]
        short = name if len(name) <= 90 else name[:87] + "..."
        lines.append(f"| {short} (x{t['count']}) | {t['ms']:.2f} "
                     f"| {t['pct']:.1f} |")
    lines += [
        "",
        f"window ({r['window']}): {r['window_ms']:.3f} ms/step; device busy "
        f"(union of streams) {r['busy_ms']:.3f} ms/step; idle share "
        f"{r['idle_share']:.4f}",
        f"launches: {sum(r['launches'].values())} device events, "
        f"{len(r['launches'])} names",
    ]
    lines.append(f"idle gaps: {r['n_gaps']}; the longest:")
    for g in r["gaps"]:
        lines.append(f"  gap {g['ms']:.3f} ms at +{g['start_us'] / 1e3:.3f} "
                     f"ms, host: {g['host'] or '(none)'}")
    lines.append("idle ms/step by the host event at each gap's start: "
                 + ", ".join(f"{k} {v:.3f}"
                             for k, v in r["idle_by_host"].items()))
    return lines


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trace")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--bucket", action="append", default=[],
                    help="REGEX=NAME, first match wins")
    ap.add_argument("--steps", type=int, default=1,
                    help="divide totals by this many traced steps")
    ap.add_argument("--window", default="",
                    help="name of the annotation whose span is the window")
    ap.add_argument("--gaps", type=int, default=5)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    path = trace_path(args.trace)
    buckets = [bucket(spec) for spec in args.bucket]
    try:
        r = summarize(load_events(path), buckets, args.steps, args.top,
                      args.window, args.gaps)
    except ValueError as e:
        print(f"trace_summary: {path}: {e}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(dict(r, trace=path)))
    else:
        print("\n".join(render(path, r)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
