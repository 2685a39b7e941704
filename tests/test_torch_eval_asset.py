"""The port's frozen eval asset (``tpuseg_torch/data/eval_asset.py``) and
synthetic ground-truth tree against the JAX package's: the committed asset
verifies, the tree materialized from it is byte for byte the JAX one, a
tampered copy raises, and ``freeze_eval_records`` /
``write_synthetic_eval_tree`` write the JAX functions' bytes."""

import os
import shutil

import pytest

from tpuseg.data import eval_asset as jasset
from tpuseg.data import synthetic as jsyn
from tpuseg_torch.data import eval_asset as tasset
from tpuseg_torch.data import synthetic as tsyn

ASSET = tasset.default_asset_prefix()


def _tree(root):
    """{relative path: bytes} of every file under ``root``, with the root
    itself written as ``<root>`` inside the list files."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read().replace(
                    str(root).encode(), b"<root>")
    return out


def test_default_prefix_is_the_jax_packages():
    assert ASSET == jasset.default_asset_prefix()


def test_committed_asset_verifies():
    tasset.verify_eval_records(ASSET)


def test_materialized_tree_equals_the_jax_tree(tmp_path):
    t_lst = tasset.materialize_eval_tree(ASSET, str(tmp_path / "t"))
    j_lst = jasset.materialize_eval_tree(ASSET, str(tmp_path / "j"))
    assert os.path.relpath(t_lst, tmp_path / "t") == os.path.relpath(
        j_lst, tmp_path / "j")
    t, j = _tree(tmp_path / "t"), _tree(tmp_path / "j")
    assert len(t) == 3 * 64 + 2
    assert t == j


def test_a_tampered_copy_raises(tmp_path):
    for suffix in (".tsbin", ".tsidx", ".sha256"):
        shutil.copy(ASSET + suffix, tmp_path / ("copy" + suffix))
    prefix = str(tmp_path / "copy")
    with open(ASSET + ".sha256") as f:
        pinned = f.read().replace("eval_hard64", "copy")
    with open(prefix + ".sha256", "w") as f:
        f.write(pinned)
    tasset.verify_eval_records(prefix)
    with open(prefix + ".tsbin", "r+b") as f:
        f.seek(100)
        byte = f.read(1)
        f.seek(100)
        f.write(bytes([byte[0] ^ 1]))
    with pytest.raises(ValueError, match="hash mismatch"):
        tasset.verify_eval_records(prefix)
    with pytest.raises(ValueError, match="hash mismatch"):
        tasset.materialize_eval_tree(prefix, str(tmp_path / "out"))


@pytest.mark.parametrize("kw", [
    {"n_samples": 3, "seed": 5},
    {"n_samples": 2, "seed": 8, "height": 41, "width": 33, "hard": False,
     "max_leaves": 6},
])
def test_freeze_writes_the_jax_functions_bytes(tmp_path, kw):
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    t_hash = tasset.freeze_eval_records(str(tmp_path / "t" / "mini"), **kw)
    j_hash = jasset.freeze_eval_records(str(tmp_path / "j" / "mini"), **kw)
    assert t_hash == j_hash
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")


def test_synthetic_eval_tree_equals_the_jax_tree(tmp_path):
    tsyn.write_synthetic_eval_tree(str(tmp_path / "t"), 3, seed=7, height=40,
                                   width=48, hard=True)
    jsyn.write_synthetic_eval_tree(str(tmp_path / "j"), 3, seed=7, height=40,
                                   width=48, hard=True)
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")
