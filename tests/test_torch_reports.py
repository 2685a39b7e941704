"""The port's report tools (``tpuseg_torch/tools/{freeze_eval,
native_res_report,quality_report}.py``) against the JAX package's.

* ``parse_metrics`` gives the JAX tool's values on the same ``evaluate``
  outputs and raises where it raises;
* the NATIVE_RES section is replaced in place or appended, and
  ``quality_report``'s rewrite keeps NATIVE_RES and SEED_VARIANCE;
* ``freeze_eval`` refuses on the committed asset and leaves it as it is;
  with ``--prefix`` elsewhere it writes the committed asset's hashes;
* ``native_res_report --device cpu --n 2`` at 512x512: the generated
  scenes, counts and id maps of both paths equal the first two scenes of
  ``assets/native_res512_jax_f32.json`` (the JAX package's ``pred_list
  --f32 --batchsize 8`` -> ``evaluate`` on the report's default scenes, on
  the CPU);
* neither report tool writes the root ``REPORT.md`` or under ``assets/``.

The ``slow`` test makes the pinned file again from the JAX package and
compares; ``python tests/test_torch_reports.py --write`` writes it through
the same function (24 scenes at 512x512, two paths: tens of minutes of
JAX on a CPU).
"""

import hashlib
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_cli import A1, CKPT, _per_image

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
NATIVE_REF = REPO / "assets" / "native_res512_jax_f32.json"
# the native-res report's defaults (tools/native_res_report.py)
NATIVE = {"n": 24, "res": 512, "seed": 7, "batch": 8, "max_leaves": 14}
PATHS = {"resize256": [], "native_bucketed": ["--bucketed"]}


def tree_hashes(root: str) -> dict:
    """sha256 of each file of a generated eval tree that does not name the
    tree's own location: the A1 PNGs and the instance counts."""
    out = {}
    a1 = os.path.join(root, *A1)
    files = [(name, os.path.join(a1, name)) for name in sorted(os.listdir(a1))]
    files.append(("number_of_instances.txt",
                  os.path.join(root, "data", "metadata", "CVPPP",
                               "number_of_instances.txt")))
    for name, path in files:
        with open(path, "rb") as f:
            out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


def jax_native_reference(root: str, n_images: int = NATIVE["n"]) -> dict:
    """The JAX package's ``pred_list --f32 --batchsize 8`` (with and
    without ``--bucketed``) -> ``evaluate`` on the native-res report's
    default scenes, on the CPU."""
    from tpuseg.cli import evaluate as jeval
    from tpuseg.cli import pred_list as jpred
    from tpuseg.data.synthetic import write_synthetic_eval_tree

    tree = os.path.join(root, "tree")
    lst = write_synthetic_eval_tree(
        tree, n_images, seed=NATIVE["seed"], height=NATIVE["res"],
        width=NATIVE["res"], hard=True, max_leaves=NATIVE["max_leaves"])
    meta = os.path.dirname(lst)
    paths = {}
    for tag, extra in PATHS.items():
        pred_dir = os.path.join(root, "out_" + tag)
        jpred.main(["--lst", lst, "--model", CKPT, "--dataset", "CVPPP",
                    "--batchsize", str(NATIVE["batch"]), "--output",
                    pred_dir, "--f32"] + extra)
        sbd, dic, fg = jeval.main(["--pred_dir", pred_dir, "--dataset",
                                   "CVPPP", "--metadata", meta,
                                   "--img_dir", os.path.join(tree, *A1)])
        paths[tag] = {"mean_sbd": sbd, "mean_abs_dic": dic,
                      "mean_fg_dice": fg, "images": _per_image(pred_dir, lst)}
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO,
                            capture_output=True, text=True).stdout.strip()
    return {
        "made_by": "tests/test_torch_reports.py::jax_native_reference",
        "command": f"pred_list.py --f32 --batchsize {NATIVE['batch']} "
                   "[--bucketed] --model assets/synthetic_ckpt.msgpack -> "
                   "evaluate.py, JAX on the CPU",
        "scenes": "tpuseg.data.synthetic.write_synthetic_eval_tree("
                  f"n, seed={NATIVE['seed']}, height={NATIVE['res']}, "
                  f"width={NATIVE['res']}, hard=True, "
                  f"max_leaves={NATIVE['max_leaves']})",
        "commit": commit or None,
        "n_images": n_images,
        "tree_sha256": tree_hashes(tree),
        "paths": paths,
    }


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _protected() -> dict:
    """sha256 of the root ``REPORT.md`` and of every file under
    ``assets/``."""
    files = [REPO / "REPORT.md"] + sorted((REPO / "assets").rglob("*"))
    return {str(p): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in files if p.is_file()}


def _port_eval_output(sbd, dic, fg):
    """What ``cli/evaluate.py`` prints for these means."""
    return (f"MEAN SBD     :  {sbd}\nMEAN |DIC|   :  {dic}\n"
            f"MEAN FG DICE :  {fg}\n")


EVAL_OUTPUTS = {
    "plain": _port_eval_output(0.8143574595451355, 0.5, 0.9997205436229706),
    "nan": _port_eval_output(float("nan"), float("nan"), float("nan")),
    "exponent": _port_eval_output(1e-05, 2.5e-3, 1.0),
    "noise_around": "step 3 MEAN SBD 0.1\n" + _port_eval_output(0.7, 1.25,
                                                                  0.99)
    + "MEAN SBD     :  0.2\n",
    "missing_label": "MEAN SBD     :  0.8\nMEAN FG DICE :  0.99\n",
    "label_with_text": "MEAN SBD     :  0.8 (64 images)\nMEAN |DIC|   :  "
                       "0.5\nMEAN FG DICE :  0.99\n",
}


@pytest.mark.parametrize("case", sorted(EVAL_OUTPUTS))
def test_parse_metrics_is_the_jax_tools(case):
    """The same ``evaluate`` outputs give the JAX tool's values, or raise
    where it raises."""
    from tpuseg_torch.tools.native_res_report import parse_metrics

    text = EVAL_OUTPUTS[case]
    jax_parse = _jax_tool("native_res_report").parse_metrics
    try:
        want = jax_parse(text)
    except RuntimeError:
        with pytest.raises(RuntimeError, match="did not match"):
            parse_metrics(text)
        assert case in ("missing_label", "label_with_text")
        return
    got = parse_metrics(text)
    np.testing.assert_array_equal(got, want)
    assert case != "nan" or np.isnan(got).all()


def test_native_res_section_is_replaced_in_place_or_appended():
    from tpuseg_torch.tools.native_res_report import (
        MARK_BEGIN, MARK_END, merge_section,
    )

    new = f"{MARK_BEGIN}\nnew table\n{MARK_END}"
    assert merge_section("", new) == "\n\n" + new + "\n"
    assert merge_section("# report\ntext\n\n", new) == (
        "# report\ntext\n\n" + new + "\n")
    old = (f"# report\nbefore\n{MARK_BEGIN}\nold table\n{MARK_END}\n"
           "<!-- SEED_VARIANCE:BEGIN -->\nseeds\n<!-- SEED_VARIANCE:END -->\n")
    assert merge_section(old, new) == (
        f"# report\nbefore\n{new}\n<!-- SEED_VARIANCE:BEGIN -->\nseeds\n"
        "<!-- SEED_VARIANCE:END -->\n")


def test_quality_report_rewrite_keeps_the_marked_sections():
    from tpuseg_torch.tools.quality_report import keep_sections

    native = "<!-- NATIVE_RES:BEGIN -->\nnative\n<!-- NATIVE_RES:END -->"
    seeds = ("<!-- SEED_VARIANCE:BEGIN -->\nseeds\n"
             "<!-- SEED_VARIANCE:END -->")
    old = f"# old\nstale numbers\n{seeds}\nmore\n{native}\ntail\n"
    assert keep_sections("# new\n\n", old) == (
        f"# new\n\n{native}\n\n{seeds}\n")
    assert keep_sections("# new\n", "# old, no sections\n") == "# new\n"
    # a section whose end marker is missing is not kept
    assert keep_sections("# new\n", "<!-- NATIVE_RES:BEGIN -->\nx\n") == (
        "# new\n")


def test_freeze_eval_refuses_on_the_committed_asset_and_pins_its_bytes(
        tmp_path):
    """As the JAX tool: on the committed asset, exit status 1 and its
    message, the three files untouched; with ``--prefix`` elsewhere at the
    defaults, the committed asset's hashes."""
    from tpuseg_torch.tools import freeze_eval

    before = _protected()
    runs = [subprocess.run([sys.executable, *cmd], cwd=REPO,
                           capture_output=True, text=True, timeout=120)
            for cmd in (["tools/freeze_eval.py"],
                        ["-m", "tpuseg_torch.tools.freeze_eval"])]
    assert [r.returncode for r in runs] == [1, 1]
    assert runs[1].stderr == runs[0].stderr
    assert "already exists" in runs[1].stderr
    assert _protected() == before
    prefix = str(tmp_path / "eval_hard64")
    hashes = freeze_eval.main(["--prefix", prefix])
    pinned = (REPO / "assets" / "eval_hard64.sha256").read_text()
    assert Path(prefix + ".sha256").read_text() == pinned
    assert sorted(hashes) == ["eval_hard64.tsbin", "eval_hard64.tsidx"]
    with pytest.raises(SystemExit, match="already exists"):
        freeze_eval.main(["--prefix", prefix])
    freeze_eval.main(["--prefix", prefix, "--force"])
    assert Path(prefix + ".sha256").read_text() == pinned


def _report_rows(path):
    """{row label: (SBD, |DiC|, FG)} of the NATIVE_RES table."""
    rows = {}
    for line in Path(path).read_text().splitlines():
        cells = [c.strip() for c in line.strip("|").split(" | ")]
        if len(cells) == 4 and cells[0].startswith(("resize256", "native")):
            rows[cells[0].split()[0]] = tuple(float(c) for c in cells[1:])
    return rows


def test_native_res_report_cpu_equals_the_jax_package(tmp_path, monkeypatch):
    """``native_res_report --device cpu --n 2`` (batch 2) at 512x512: the
    scenes are the pinned file's first two, byte for byte; counts and id
    maps of both paths equal the JAX package's; the report holds both
    rows; the root ``REPORT.md`` and ``assets/`` are untouched."""
    from tpuseg_torch.tools import native_res_report

    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    ref = json.loads(NATIVE_REF.read_text())
    before = _protected()
    report = tmp_path / "report" / "REPORT.md"
    out = native_res_report.main(["--device", "cpu", "--n", "2", "--batch",
                                  "2", "--report", str(report),
                                  "--work", str(tmp_path / "work")])
    assert _protected() == before
    tree = tree_hashes(str(tmp_path / "work"))
    assert {k: v for k, v in tree.items() if k.endswith(".png")} == {
        k: v for k, v in ref["tree_sha256"].items()
        if k.startswith(("plant0000_", "plant0001_"))}
    rows = _report_rows(report)
    for tag in PATHS:
        assert out[tag]["ir_chain_launches"] == 0  # the plain version
        got = _per_image(out[tag]["pred_dir"], out["lst"])
        assert got == ref["paths"][tag]["images"][:2], tag
        m = out[tag]
        assert rows[tag.split("_")[0]] == (m["sbd"], m["dic"], m["fg"])
        assert np.isfinite([m["sbd"], m["dic"], m["fg"]]).all()


def test_quality_report_cpu_keeps_sections_and_writes_nothing_else(
        tmp_path, monkeypatch):
    """``quality_report --device cpu`` on 2 fresh scenes (batch 2, no
    ab_infer, which times the card): the report holds the evaluate output
    and both wall times, keeps the file's NATIVE_RES and SEED_VARIANCE
    sections, and the root ``REPORT.md`` and ``assets/`` are untouched."""
    from tpuseg_torch.tools import quality_report

    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    report = tmp_path / "REPORT.md"
    sections = [(REPO / "REPORT.md").read_text()[
        (REPO / "REPORT.md").read_text().index(b):
        (REPO / "REPORT.md").read_text().index(e) + len(e)]
        for b, e in quality_report.KEPT_SECTIONS]
    report.write_text("# an older report\n\n" + "\n".join(sections[::-1]))
    before = _protected()
    out = quality_report.main(["--device", "cpu", "--n_images", "2",
                               "--fresh_seed", "3", "--report", str(report)])
    assert _protected() == before
    text = report.read_text()
    assert text.startswith("# tpuseg_torch report")
    assert "an older report" not in text
    assert text.rstrip().endswith(sections[1]) and sections[0] in text
    assert "MEAN SBD" in text and f"{out['cold_s']:.1f}s" in text
    assert np.isfinite([out["sbd"], out["dic"], out["fg"]]).all()
    assert out["ab_infer"] is None and "not run: ab_infer" in text
    assert out["ir_chain_launches"] == [0, 0]  # the plain version on the CPU


@pytest.mark.slow
def test_native_jax_reference_file_is_what_the_jax_package_gives(tmp_path):
    want = json.loads(NATIVE_REF.read_text())
    got = jax_native_reference(str(tmp_path), want["n_images"])
    for key in ("n_images", "tree_sha256"):
        assert got[key] == want[key], key
    for tag in PATHS:
        assert got["paths"][tag]["images"] == want["paths"][tag]["images"]
        for key in ("mean_sbd", "mean_abs_dic", "mean_fg_dice"):
            assert got["paths"][tag][key] == pytest.approx(
                want["paths"][tag][key], abs=1e-9), (tag, key)


if __name__ == "__main__":
    if sys.argv[1:] not in (["--write"], ["--write", "--n", "8"]):
        sys.exit("usage: python tests/test_torch_reports.py --write [--n 8]")
    import tempfile

    sys.path.insert(0, str(REPO))
    import jax

    jax.config.update("jax_platforms", "cpu")
    n = int(sys.argv[3]) if len(sys.argv) > 3 else NATIVE["n"]
    with tempfile.TemporaryDirectory() as tmp:
        ref = jax_native_reference(tmp, n)
    NATIVE_REF.write_text(json.dumps(ref, indent=1) + "\n")
    print(f"wrote {NATIVE_REF}: " + ", ".join(
        f"{k} SBD {v['mean_sbd']} |DiC| {v['mean_abs_dic']} FG "
        f"{v['mean_fg_dice']}" for k, v in ref["paths"].items()))
