"""The result line and the harness's refusals."""

import json
import os
import subprocess
import sys

import torch

from segbench import cells, run
from segbench.tests._small import small_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_result_holds_the_contract_keys_and_checks_last():
    name = "cvppp256_infer_hard"
    r = run.run_cell(name, 2 ** 31 + 5, 0.5, False, torch.device("cpu"),
                     cell=small_cell(name, dtype="float32"))
    assert list(r) == KEYS + ["checks"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"setup_s", "infer_img_per_s",
                                 "infer_batch_p95_ms"}
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(r)


def test_no_card_exits_nonzero_without_a_result():
    if torch.cuda.is_available():
        return  # only where there is no card
    p = subprocess.run(
        [sys.executable, os.path.join(cells.HERE, "run.py"), "--workload",
         "cvppp256_infer_hard", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, cwd=cells.ROOT, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpuseg_torch_like", sys)
    assert "tpuseg" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in run.forbidden_modules()
