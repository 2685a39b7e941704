"""The benchmark of the port (``tpuseg_torch``) on NVIDIA H100 cards.

    python3 segbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of ``BENCHMARK.json``: builds the program and the cell's
traffic from the seed, warms up every shape the window uses (set-up,
``setup_s``), then measures for ``--seconds`` (``--trace 0``: the cell's
end-to-end metrics) or traces a fixed window under the profiler
(``--trace 1``: its per-layer metrics).  After the window it frees the
program's state and holds what the timed path produced against the plain
reference (``compare.py``).  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(and ``breakdown`` with ``--trace 1``), and last ``checks``: each number
compared with its limit, which are also the last lines of standard
error.

Exits non-zero without a result when no CUDA card (or fewer than the cell
asks for) is present, and when JAX, flax or the JAX package is loaded once
the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(HERE))

FORBIDDEN = ("jax", "jaxlib", "flax", "tpuseg", "bench")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def _device_record(device, peak: int, traced_summary=None):
    import torch

    rec = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    if traced_summary is not None:
        rec["busy_s"] = traced_summary["busy_s"]
        rec["window_s"] = traced_summary["window_s"]
    return rec


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             bench=None, cell=None, run_class=None) -> dict:
    """One run of cell ``name`` on ``device``; returns the result line
    (a dict).  ``bench``: the benchmark file's contents (read from the
    checkout when None); ``cell``: the cell as ``cells.load_cell`` gives
    it (read by name when None); ``run_class``: the ``Run`` to use in the
    place of the cell's entry."""
    import torch

    from segbench import cells, compare

    bench = bench or cells.benchmark()
    cell = cell or cells.load_cell(name)
    t_built = time.perf_counter()
    run = (run_class or cells.entry(cell["entry"]).Run)(cell, seed, device)
    t_warm = time.perf_counter()
    run.warm()
    setup_s = time.perf_counter() - T_START
    print(f"setup_s {setup_s:.3f}: imports {t_built - T_START:.3f}, "
          f"program and traffic {t_warm - t_built:.3f}, "
          f"warm-up {T_START + setup_s - t_warm:.3f}", file=sys.stderr)
    cuda = device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
    summary = None
    if not trace:
        e2e = run.window(seconds)
        wanted = cells.metrics_of(bench, name, "end_to_end")
        values = dict(e2e, setup_s=setup_s)
        for m in wanted:
            if m["name"] in values:
                result["metrics"][m["name"]] = {"value": values[m["name"]],
                                                "unit": m["unit"]}
        result["attempted"] = int(e2e.get("batches", e2e.get("steps", 0)))
    else:
        tr = run.traced_window()
        summary = tr["summary"]
    peak = max(setup_peak,
               torch.cuda.max_memory_allocated(device) if cuda else 0)
    result["device"] = _device_record(device, peak, summary)
    if trace:
        from segbench.trace import breakdown

        ctx = dict(tr, **run.work(tr), device_kind=result["device"]["kind"])
        result["attempted"] = int(tr.get("batches", tr.get("steps", 0)))
        for m in cells.metrics_of(bench, name, "per_layer"):
            v = cells.metric_reader(m["name"]).read(ctx)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        result["breakdown"] = breakdown(summary)
    run.release()
    numbers = run.check()
    checks = compare.verdict(numbers, cell["limits"])
    result["correct"] = all(ok for *_, ok in checks)
    result["failed"] = 0 if result["correct"] else result["attempted"]
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim, _ in checks}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from segbench import cells

    bench = cells.benchmark()
    chips = int(cells.workload(bench, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"segbench: cell {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0), bench)
    bad = forbidden_modules()
    if bad:
        print(f"segbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for n, c in result["checks"].items():
        print(f"check {n}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
