"""Tracing and step timing (port of ``tpuseg/utils/tracing.py``).

``trace_context`` captures a ``torch.profiler`` trace of the block (the
card's kernels and copies where the tensors are on the card) and writes it
as a Chrome trace, viewable in Perfetto or ``chrome://tracing``;
``annotate`` names a region on that timeline; ``StepTimer`` times calls on
the host clock after synchronising the device, so a time covers the work
and not only its enqueue.  ``tools/profile_train.py`` reads a trace the
same way for the train step.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace_context(log_dir: Optional[str]) -> Iterator[None]:
    """Profile the block and write ``<log_dir>/trace.json`` (no-op when
    ``log_dir`` is None).  CUDA activity is traced when a card is there."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """A named region on the profiler's timeline (a context manager)."""
    return torch.profiler.record_function(name)


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class StepTimer:
    """``timer.time(name, fn, *args)`` runs ``fn`` between two
    synchronisations of the card (where there is one) and records the
    wall time under ``name``."""

    def __init__(self):
        self.records: Dict[str, list] = {}

    def time(self, name: str, fn, *args, **kw):
        _sync()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        _sync()
        self.records.setdefault(name, []).append(time.perf_counter() - t0)
        return out

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"mean_s": float(np.mean(v)), "min_s": float(np.min(v)),
                "count": len(v)}
            for k, v in self.records.items()
        }
