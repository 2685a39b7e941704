"""The harness finds each part of a cell by name, from files alone."""

import json
import os
import shutil

import pytest

from segbench import cells


def test_every_cell_and_metric_of_the_benchmark_is_found():
    bench = cells.benchmark()
    for w in bench["workloads"]:
        cell = cells.load_cell(w["name"])
        assert cell["config"] == w["config"]
        assert cell["traffic"] == w["traffic"]
        assert cells.entry(cell["entry"]).Run
        assert set(cell["limits"])
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(cells.ROOT, c["file"]))
    for m in bench["per_layer"]:
        assert callable(cells.metric_reader(m["name"]).read)


def test_a_metric_lists_its_cells():
    bench = cells.benchmark()
    names = {w["name"] for w in bench["workloads"]}
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            assert set(m.get("workloads", names)) <= names
    for w in names:
        e2e = [m["name"] for m in cells.metrics_of(bench, w, "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cells.metrics_of(bench, w, "per_layer")


def test_a_new_cell_is_added_as_files(tmp_path, monkeypatch):
    """A copy of the benchmark's data with one cell, configuration and mix
    more, written as files: found by name, with no edit to any code."""
    root = tmp_path / "segbench"
    for d in ("configs", "traffic", "workloads"):
        shutil.copytree(os.path.join(cells.HERE, d), root / d)
    conf = json.loads((root / "configs" / "reseg_cvppp256.json").read_text())
    conf["canvas"] = [320, 320]
    (root / "configs" / "reseg_cvppp320.json").write_text(json.dumps(conf))
    mix = json.loads((root / "traffic" / "hard256.json").read_text())
    mix["scene"].update(height=320, width=320)
    (root / "traffic" / "hard320.json").write_text(json.dumps(mix))
    cell = json.loads((root / "workloads" /
                       "cvppp256_infer_hard.json").read_text())
    cell.update(config="reseg_cvppp320", traffic="hard320")
    (root / "workloads" / "cvppp320_infer_hard.json").write_text(
        json.dumps(cell))
    monkeypatch.setattr(cells, "HERE", str(root))
    got = cells.load_cell("cvppp320_infer_hard")
    assert got["configuration"]["canvas"] == [320, 320]
    assert got["mix"]["scene"]["height"] == 320
    with pytest.raises(FileNotFoundError):
        cells.load_cell("no_such_cell")
