"""The port's metric logging (``tpuseg_torch/runtime/metrics_log.py``)
against the JAX package's: ``sparkline``, ``LiveView``'s printed rows,
``Averager``, and ``MetricLogger``'s files with the live view and the
TensorBoard writer on (after ``tests/test_runtime.py``'s checks)."""

import json
import os

import numpy as np
import pytest

from tpuseg.runtime import metrics_log as jlog
from tpuseg_torch.runtime import metrics_log as tlog


@pytest.mark.parametrize("values", [
    [], [1.0], [0.0, 0.5, 1.0], [2.0, 2.0, 2.0], [3.0, float("nan"), -1.0],
    list(np.linspace(-2.0, 5.0, 57) ** 2),
])
def test_sparkline_matches_jax(values):
    assert tlog.sparkline(values) == jlog.sparkline(values)
    assert tlog.sparkline(values, width=7) == jlog.sparkline(values, width=7)


def test_live_view_prints_what_the_jax_view_prints(capsys):
    views = (jlog.LiveView(), tlog.LiveView(), jlog.LiveView(["cost"]),
             tlog.LiveView(["cost"]))
    outs = []
    for view in views:
        for epoch in range(4):
            view.update("train", {"cost": 1.0 / (epoch + 1), "dice": 0.1 * epoch})
            view.update("val", {"cost": 2.0 - epoch})
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and outs[2] == outs[3]
    assert "train/dice" in outs[1] and "train/dice" not in outs[3]


def test_averager_matches_jax():
    a, b = jlog.Averager(), tlog.Averager()
    assert a.val() == b.val() == 0.0
    for v in (np.array([1.0, 2.0, 3.0]), 4.0, np.ones((2, 2))):
        a.add(v)
        b.add(v)
    assert b.val() == a.val() == pytest.approx(14.0 / 8.0)
    b.reset()
    assert b.val() == 0.0 and b.n_count == 0


def test_metric_logger_files_live_view_and_tensorboard(tmp_path, capsys):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    outs = {}
    for name, mod in (("jax", jlog), ("torch", tlog)):
        logger = mod.MetricLogger(str(tmp_path / name), live=True,
                                  tensorboard=True)
        for epoch in range(3):
            logger.log("train", epoch, {"cost": 1.0 - 0.1 * epoch,
                                        "ins_dice_loss": 0.5})
            logger.log("val", epoch, {"cost": 1.2 - 0.1 * epoch})
        logger.close()
        outs[name] = capsys.readouterr().out
    assert outs["torch"] == outs["jax"] and "live metrics:" in outs["torch"]
    for f in ("training.log", "validation.log"):
        assert ((tmp_path / "torch" / f).read_text()
                == (tmp_path / "jax" / f).read_text())
    recs = [json.loads(line) for line in
            (tmp_path / "torch" / "metrics.jsonl").read_text().splitlines()]
    assert [(r["split"], r["epoch"]) for r in recs] == [
        (s, e) for e in range(3) for s in ("train", "val")]
    acc = EventAccumulator(os.path.join(tmp_path, "torch", "tb"))
    acc.Reload()
    assert set(acc.Tags()["scalars"]) == {"train/cost", "train/ins_dice_loss",
                                          "val/cost"}
    vals = [e.value for e in acc.Scalars("val/cost")]
    np.testing.assert_allclose(vals, [1.2, 1.1, 1.0], rtol=1e-6)
