"""Structured metric logging (own copy of ``tpuseg/runtime/metrics_log.py``):
the ``training.log`` / ``validation.log`` CSVs (Epoch,Cost) and a
``metrics.jsonl`` stream with every metric per epoch.  The live sparkline
view and the TensorBoard writer of the JAX package are not ported yet;
asking for either raises.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricLogger:
    def __init__(self, run_dir: str, live: bool = False,
                 tensorboard: bool = False):
        if live or tensorboard:
            raise NotImplementedError(
                "the live view and the TensorBoard writer are not ported yet")
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self._train_csv = open(os.path.join(run_dir, "training.log"), "w")
        self._val_csv = open(os.path.join(run_dir, "validation.log"), "w")
        self._train_csv.write("Epoch,Cost\n")
        self._val_csv.write("Epoch,Cost\n")
        self._jsonl = open(os.path.join(run_dir, "metrics.jsonl"), "a")

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

    def close(self) -> None:
        self._train_csv.close()
        self._val_csv.close()
        self._jsonl.close()
