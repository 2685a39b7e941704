"""Timed paths broken on purpose, each a ``Run`` of an entry with one
fault planted where the program produces its output; the control, the
reference with float8 products in the program's place.  The kept test
(``tests/test_segbench_faults.py``) drives whole runs with them and sees
``correct`` come out false; ``readings.py`` reads the numbers they give
on the card, from which the limits are set."""

from __future__ import annotations

import numpy as np

from segbench.entries import infer, train


class HalfBatch(infer.Run):
    """Half of each batch left out: the second half's outputs empty."""

    def _call(self, i):
        super()._call(i)
        packed, counts = self.outputs[i]
        half = len(counts) // 2
        packed, counts = packed.copy(), counts.copy()
        packed[half:] = 0
        counts[half:] = 0
        self.outputs[i] = (packed, counts)


class AlteredAnswer(infer.Run):
    """Each answer altered where it is produced: the instances merged
    into one and the count off by four."""

    def _call(self, i):
        super()._call(i)
        packed, counts = self.outputs[i]
        ids = packed & 0x7F
        packed = np.where(ids > 0, (packed & 0x80) | 1, packed).astype(
            np.uint8)
        self.outputs[i] = (packed, counts + 4)


class InferControl(infer.Run):
    def check(self, control=False):
        return super().check(control=True)


class Unchanged(train.Run):
    """A step that returns its state unchanged: no optimizer update."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.state.optimizer.step = lambda *args, **kwargs: None


class TrainHalfBatch(train.Run):
    """Half of each batch left out, the mean taken over the rest: the
    step sees the first half of the rows."""

    def _step_batch(self, batch):
        half = batch["images"].shape[0] // 2
        return {k: v[:half] for k, v in batch.items()}


class TrainControl(train.Run):
    def check(self, control=False):
        return super().check(control=True)


FAULTS = {"half": {"infer": HalfBatch, "train": TrainHalfBatch},
          "altered": {"infer": AlteredAnswer},
          "unchanged": {"train": Unchanged}}


def run_class(fault: str, entry: str):
    """The ``Run`` with ``fault`` planted for a cell of ``entry``."""
    try:
        return FAULTS[fault][entry]
    except KeyError:
        raise ValueError(f"no fault {fault!r} for entry {entry!r}") from None
