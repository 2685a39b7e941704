"""Structured metric logging (own copy of ``tpuseg/runtime/metrics_log.py``):

* the ``training.log`` / ``validation.log`` CSVs (Epoch,Cost),
* a ``metrics.jsonl`` stream with every metric per epoch,
* an optional live view: terminal unicode sparklines per metric
  (``live=True``) and/or TensorBoard scalars (``tensorboard=True``,
  written under ``<run_dir>/tb`` through ``torch.utils.tensorboard``; where
  that is unavailable the logger prints one line and carries on: logging
  never stops training).
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

_SPARK = "▁▂▃▄▅▆▇█"


def sparkline(values: List[float], width: int = 40) -> str:
    """A metric history as a unicode sparkline (the last ``width`` points,
    min-max scaled, NaNs dropped)."""
    vals = [v for v in values[-width:] if v == v]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    return "".join(
        _SPARK[int((v - lo) / span * (len(_SPARK) - 1))] for v in vals
    )


class LiveView:
    """Terminal live plot: one sparkline row per (split, metric), printed
    after every update."""

    def __init__(self, metrics: Optional[List[str]] = None):
        self._hist: Dict[str, List[float]] = defaultdict(list)
        self._filter = set(metrics) if metrics else None

    def update(self, split: str, metrics: Dict[str, float]) -> None:
        for k, v in metrics.items():
            if self._filter and k not in self._filter:
                continue
            self._hist[f"{split}/{k}"].append(float(v))
        self.render()

    def render(self) -> None:
        lines = []
        for name in sorted(self._hist):
            h = self._hist[name]
            lines.append(
                f"  {name:<28s} {sparkline(h):<40s} "
                f"last={h[-1]:+.4f} min={min(h):+.4f} max={max(h):+.4f}"
            )
        if lines:
            print("live metrics:\n" + "\n".join(lines), flush=True)


class Averager:
    """Streaming mean over the elements of array values."""

    def __init__(self):
        self.reset()

    def add(self, v) -> None:
        arr = np.asarray(v)
        self.n_count += arr.size
        self.total += float(arr.sum())

    def reset(self) -> None:
        self.n_count = 0
        self.total = 0.0

    def val(self) -> float:
        return self.total / self.n_count if self.n_count else 0.0


class MetricLogger:
    def __init__(self, run_dir: str, live: bool = False,
                 tensorboard: bool = False):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self._train_csv = open(os.path.join(run_dir, "training.log"), "w")
        self._val_csv = open(os.path.join(run_dir, "validation.log"), "w")
        self._train_csv.write("Epoch,Cost\n")
        self._val_csv.write("Epoch,Cost\n")
        self._jsonl = open(os.path.join(run_dir, "metrics.jsonl"), "a")
        self._live = LiveView() if live else None
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(run_dir, "tb"))
            except ImportError as e:
                print(f"tensorboard writer unavailable ({e}); skipping")

    def log(self, split: str, epoch: int, metrics: Dict[str, float],
            cost_key: str = "ins_dice_loss") -> None:
        rec = {"ts": time.time(), "split": split, "epoch": epoch,
               **{k: float(v) for k, v in metrics.items()}}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        cost = float(metrics.get(cost_key, metrics.get("cost", 0.0)))
        f = self._train_csv if split == "train" else self._val_csv
        f.write(f"{epoch},{cost}\n")
        f.flush()
        if self._live is not None:
            self._live.update(split, metrics)
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(f"{split}/{k}", float(v), epoch)
            self._tb.flush()

    def close(self) -> None:
        self._train_csv.close()
        self._val_csv.close()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
