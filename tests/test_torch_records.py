"""The port's packed records (``tpuseg_torch/data/records.py``) and synthetic
record writer against the JAX package's: the writers give the same bytes,
each reader reads the other's files, ``open_dataset`` picks the reader by
what lies on disk, and the LMDB pair round-trips the reference layout
through an in-memory ``lmdb`` stub (the test's own copy of
``tests/test_e2e_pipeline.py``'s)."""

import os
import sys
import types

import numpy as np
import pytest

from tpuseg.data import records as jrec
from tpuseg.data import synthetic as jsyn
from tpuseg_torch.data import records as trec
from tpuseg_torch.data import synthetic as tsyn


def _bytes(prefix):
    with open(prefix + ".tsbin", "rb") as a, open(prefix + ".tsidx", "rb") as b:
        return a.read(), b.read()


def _same_samples(a, b):
    assert len(a) == len(b)
    for i in range(len(a)):
        ia, sa, na, ka = a[i]
        ib, sb, nb, kb = b[i]
        assert ia.mode == ib.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(ia), np.asarray(ib))
        np.testing.assert_array_equal(sa, sb)
        np.testing.assert_array_equal(na, nb)
        assert ka == kb and na.shape[-1] == ka


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Both packages' synthetic record writers on one seed, at an odd
    size, hard and easy scenes."""
    root = tmp_path_factory.mktemp("records")
    out = {}
    for name, syn in (("jax", jsyn), ("torch", tsyn)):
        for kind, kw in (("easy", {}), ("hard", {"hard": True})):
            prefix = str(root / f"{name}_{kind}")
            syn.write_synthetic_records(prefix, 3, seed=5, height=37,
                                        width=45, **kw)
            out[name, kind] = prefix
    return out


@pytest.mark.parametrize("kind", ["easy", "hard"])
def test_writer_bytes_equal_the_jax_writers(written, kind):
    assert _bytes(written["torch", kind]) == _bytes(written["jax", kind])


def test_record_writer_alone_gives_the_same_bytes(tmp_path):
    """The writer on hand-made samples, an empty instance stack included."""
    for pkg in ("jax", "torch"):
        rng = np.random.default_rng(3)
        w = (jrec if pkg == "jax" else trec).RecordWriter(str(tmp_path / pkg))
        for n in (2, 0, 5):
            sem = rng.integers(0, 2, (9, 11), dtype=np.uint8)
            ins = rng.integers(0, 2, (9, 11, n), dtype=np.uint8)
            w.add(rng.bytes(17), sem, ins, n)
        w.close()
    assert _bytes(str(tmp_path / "torch")) == _bytes(str(tmp_path / "jax"))


def test_writer_rejects_masks_of_another_shape(tmp_path):
    w = trec.RecordWriter(str(tmp_path / "bad"))
    with pytest.raises(ValueError, match="do not match"):
        w.add(b"", np.zeros((4, 4), np.uint8), np.zeros((4, 5, 1), np.uint8), 1)
    w.close()


@pytest.mark.parametrize("kind", ["easy", "hard"])
def test_each_reader_reads_the_others_files(written, kind):
    _same_samples(trec.SegRecordDataset(written["jax", kind]),
                  jrec.SegRecordDataset(written["jax", kind]))
    _same_samples(jrec.SegRecordDataset(written["torch", kind]),
                  trec.SegRecordDataset(written["torch", kind]))


def test_reader_refuses_a_file_without_the_magic(tmp_path):
    prefix = str(tmp_path / "x")
    trec.RecordWriter(prefix).close()
    with open(prefix + ".tsbin", "r+b") as f:
        f.write(b"NOTMAGIC")
    with pytest.raises(ValueError, match="not a record file"):
        trec.SegRecordDataset(prefix)


def test_open_dataset_dispatch(written, tmp_path, monkeypatch):
    prefix = written["torch", "easy"]
    for path in (prefix, prefix + ".tsidx", prefix + ".tsbin"):
        ds = trec.open_dataset(path)
        assert isinstance(ds, trec.SegRecordDataset) and len(ds) == 3
    monkeypatch.setitem(sys.modules, "lmdb", _fake_lmdb_module())
    lmdb_dir = tmp_path / "db"
    lmdb_dir.mkdir()
    (lmdb_dir / "data.mdb").write_bytes(b"")
    jrec.convert_to_lmdb(prefix, str(lmdb_dir))
    assert isinstance(trec.open_dataset(str(lmdb_dir)), trec.LmdbSegDataset)
    assert isinstance(jrec.open_dataset(str(lmdb_dir)), jrec.LmdbSegDataset)


class _FakeTxn:
    def __init__(self, store):
        self._s = store

    def put(self, k, v):
        self._s[bytes(k)] = bytes(v)

    def get(self, k):
        return self._s.get(bytes(k))

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class _FakeEnv:
    _stores = {}

    def __init__(self, path):
        self._s = _FakeEnv._stores.setdefault(os.path.abspath(path), {})

    def begin(self, write=False, **kw):
        return _FakeTxn(self._s)

    def close(self):
        pass


def _fake_lmdb_module():
    mod = types.ModuleType("lmdb")
    mod.open = lambda path, **kw: _FakeEnv(path)
    return mod


def test_lmdb_pair_matches_the_jax_pair(written, tmp_path, monkeypatch):
    """Both packages' ``convert_to_lmdb`` store the same keys and values;
    each ``LmdbSegDataset`` reads the other's; ``convert_lmdb`` back to
    packed records gives the JAX package's bytes."""
    monkeypatch.setitem(sys.modules, "lmdb", _fake_lmdb_module())
    src = written["torch", "hard"]
    j_db, t_db = str(tmp_path / "j_lmdb"), str(tmp_path / "t_lmdb")
    assert jrec.convert_to_lmdb(src, j_db) == 3
    assert trec.convert_to_lmdb(src, t_db) == 3
    stores = _FakeEnv._stores
    assert stores[os.path.abspath(t_db)] == stores[os.path.abspath(j_db)]
    assert b"num-samples" in stores[os.path.abspath(t_db)]
    _same_samples(trec.LmdbSegDataset(j_db), jrec.LmdbSegDataset(t_db))
    _same_samples(trec.LmdbSegDataset(t_db), trec.SegRecordDataset(src))
    trec.convert_lmdb(t_db, str(tmp_path / "t_back"))
    jrec.convert_lmdb(j_db, str(tmp_path / "j_back"))
    assert _bytes(str(tmp_path / "t_back")) == _bytes(str(tmp_path / "j_back"))


def test_lmdb_writer_flushes_in_batches(tmp_path, monkeypatch):
    """More samples than one write transaction holds: every key lands."""
    monkeypatch.setitem(sys.modules, "lmdb", _fake_lmdb_module())
    monkeypatch.setattr(trec.LmdbWriter, "FLUSH_EVERY", 2)
    w = trec.LmdbWriter(str(tmp_path / "db"))
    for k in range(5):
        w.add(bytes([k]), np.full((2, 3), k, np.uint8),
              np.zeros((2, 3, 1), np.uint8), 1)
    w.close()
    store = _FakeEnv._stores[os.path.abspath(str(tmp_path / "db"))]
    assert store[b"num-samples"] == b"5"
    assert [store[f"image-{i}".encode()] for i in range(1, 6)] == [
        bytes([k]) for k in range(5)]


def test_lmdb_absent_raises_import_error(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "lmdb", None)
    with pytest.raises(ImportError, match="'lmdb' package"):
        trec.LmdbSegDataset(str(tmp_path))
    with pytest.raises(ImportError, match="'lmdb' package"):
        trec.LmdbWriter(str(tmp_path / "db"))
