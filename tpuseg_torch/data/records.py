"""Packed record datasets (own copy of ``tpuseg/data/records.py``).

A dataset is two files: ``<prefix>.tsbin``, the blobs after an 8-byte
magic, and ``<prefix>.tsidx``, a JSON index of each sample's blob offsets
and sizes.  Per sample: the image as encoded PNG bytes, the semantic mask
``(H, W)`` and the instance masks ``(H, W, n_objects)`` as raw uint8.  The
writer appends and renames the index into place when it closes; the reader
maps the blob file and slices it.  The files are byte for byte those of
the JAX package, so either package reads the other's.

The reference's LMDB layout (keys ``image-{i}``, ``semantic-annotation-
{i}``, ``instance-annotation-{i}``, ``height/width/n_objects-{i}``,
``num-samples``; 1-based) is read by ``LmdbSegDataset`` and written by
``LmdbWriter`` when the ``lmdb`` package is installed.

Pillow is imported where an image is decoded, not with the module.
"""

from __future__ import annotations

import io
import json
import mmap
import os
from typing import Dict, List, Tuple

import numpy as np

MAGIC = b"TSEG0001"


def _decode_rgb(png: bytes):
    from PIL import Image

    return Image.open(io.BytesIO(png)).convert("RGB")


def _png(img) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


def _import_lmdb():
    try:
        import lmdb
    except ImportError as e:
        raise ImportError(
            "the LMDB dataset layout needs the 'lmdb' package, which is not "
            "installed; packed records (RecordWriter / SegRecordDataset) need "
            "no extra package") from e
    return lmdb


class RecordWriter:
    """Append samples; ``close`` writes the JSON index atomically."""

    def __init__(self, path_prefix: str):
        self.prefix = path_prefix
        os.makedirs(os.path.dirname(os.path.abspath(path_prefix)) or ".",
                    exist_ok=True)
        self._bin = open(path_prefix + ".tsbin", "wb")
        self._bin.write(MAGIC)
        self._offset = len(MAGIC)
        self._index: List[Dict] = []

    def _write_blob(self, data: bytes) -> Tuple[int, int]:
        off = self._offset
        self._bin.write(data)
        self._offset += len(data)
        return off, len(data)

    def add(self, image_png: bytes, semantic: np.ndarray,
            instance: np.ndarray, n_objects: int) -> None:
        """semantic: (H, W) uint8; instance: (H, W, n_objects) uint8."""
        h, w = semantic.shape
        if instance.shape != (h, w, n_objects):
            raise ValueError(f"instance masks {instance.shape} do not match "
                             f"{(h, w, n_objects)}")
        img_off, img_len = self._write_blob(image_png)
        sem_off, sem_len = self._write_blob(
            np.ascontiguousarray(semantic, np.uint8).tobytes())
        ins_off, ins_len = self._write_blob(
            np.ascontiguousarray(instance, np.uint8).tobytes())
        self._index.append({
            "image": [img_off, img_len],
            "semantic": [sem_off, sem_len],
            "instance": [ins_off, ins_len],
            "height": h,
            "width": w,
            "n_objects": int(n_objects),
        })

    def close(self) -> None:
        self._bin.close()
        tmp = self.prefix + ".tsidx.tmp"
        with open(tmp, "w") as f:
            json.dump({"num_samples": len(self._index),
                       "samples": self._index}, f)
        os.replace(tmp, self.prefix + ".tsidx")


class SegRecordDataset:
    """``dataset[i]`` -> (PIL RGB image, semantic (H, W) uint8, instance
    (H, W, N) uint8, n_objects), the reference ``SegDataset`` contract."""

    def __init__(self, path_prefix: str):
        if path_prefix.endswith((".tsidx", ".tsbin")):
            path_prefix = path_prefix.rsplit(".", 1)[0]
        self.prefix = path_prefix
        with open(path_prefix + ".tsidx") as f:
            idx = json.load(f)
        self.samples = idx["samples"]
        self.n_samples = idx["num_samples"]
        self._file = open(path_prefix + ".tsbin", "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        if self._mm[:len(MAGIC)] != MAGIC:
            self.close()
            raise ValueError(f"{path_prefix}.tsbin is not a record file")

    def __len__(self) -> int:
        return self.n_samples

    def _blob(self, ref) -> bytes:
        off, ln = ref
        return self._mm[off:off + ln]

    def __getitem__(self, i: int):
        rec = self.samples[i]
        img = _decode_rgb(self._blob(rec["image"]))
        h, w, n = rec["height"], rec["width"], rec["n_objects"]
        sem = np.frombuffer(self._blob(rec["semantic"]), np.uint8).reshape(h, w)
        ins = np.frombuffer(self._blob(rec["instance"]), np.uint8).reshape(
            h, w, n)
        return img, sem.copy(), ins.copy(), n

    def close(self) -> None:
        self._mm.close()
        self._file.close()


class LmdbSegDataset:
    """Reads the reference's LMDB layout (needs the ``lmdb`` package)."""

    def __init__(self, lmdb_path: str):
        self.env = _import_lmdb().open(
            lmdb_path, max_readers=1, readonly=True, lock=False,
            readahead=False, meminit=False)
        with self.env.begin(write=False) as txn:
            self.n_samples = int(txn.get(b"num-samples"))

    def __len__(self):
        return self.n_samples

    def __getitem__(self, i: int):
        with self.env.begin(write=False) as txn:
            def get(name):
                return txn.get(f"{name}-{i + 1}".encode())

            img = _decode_rgb(get("image"))
            h, w, n = (int(get(k)) for k in ("height", "width", "n_objects"))
            sem = np.frombuffer(get("semantic-annotation"), np.uint8).reshape(h, w)
            ins = np.frombuffer(get("instance-annotation"), np.uint8).reshape(
                h, w, n)
        return img, sem.copy(), ins.copy(), n


class LmdbWriter:
    """Writes the reference's LMDB layout, so the reference's own reader
    opens a dataset prepared here; puts are batched ``FLUSH_EVERY`` samples
    to a write transaction (needs the ``lmdb`` package)."""

    FLUSH_EVERY = 50

    def __init__(self, lmdb_path: str, map_size: int = 1 << 36):
        self.env = _import_lmdb().open(lmdb_path, map_size=map_size)
        self.n = 0
        self._cache: Dict[bytes, bytes] = {}

    def _flush(self) -> None:
        with self.env.begin(write=True) as txn:
            for k, v in self._cache.items():
                txn.put(k, v)
        self._cache = {}

    def add(self, image_png: bytes, semantic: np.ndarray,
            instance: np.ndarray, n_objects: int) -> None:
        """Same arguments as ``RecordWriter.add``."""
        h, w = semantic.shape
        if instance.shape != (h, w, n_objects):
            raise ValueError(f"instance masks {instance.shape} do not match "
                             f"{(h, w, n_objects)}")
        i = self.n + 1
        put = self._cache
        put[f"image-{i}".encode()] = bytes(image_png)
        put[f"semantic-annotation-{i}".encode()] = np.ascontiguousarray(
            semantic, np.uint8).tobytes()
        put[f"instance-annotation-{i}".encode()] = np.ascontiguousarray(
            instance, np.uint8).tobytes()
        put[f"height-{i}".encode()] = str(h).encode()
        put[f"width-{i}".encode()] = str(w).encode()
        put[f"n_objects-{i}".encode()] = str(int(n_objects)).encode()
        self.n += 1
        if self.n % self.FLUSH_EVERY == 0:
            self._flush()

    def close(self) -> None:
        self._cache[b"num-samples"] = str(self.n).encode()
        self._flush()
        self.env.close()


def open_dataset(path: str):
    """A packed-record prefix (with or without its extension) or an LMDB
    directory."""
    if os.path.isfile(path + ".tsidx") or path.endswith((".tsidx", ".tsbin")):
        return SegRecordDataset(path)
    if os.path.isdir(path) and (
        os.path.isfile(os.path.join(path, "data.mdb"))
        or os.path.isfile(os.path.join(path, "data.lmdb"))
    ):
        return LmdbSegDataset(path)
    return SegRecordDataset(path)


def _copy(src, writer) -> int:
    for i in range(len(src)):
        img, sem, ins, n = src[i]
        writer.add(_png(img), sem, ins, n)
    writer.close()
    return len(src)


def convert_lmdb(lmdb_path: str, out_prefix: str) -> int:
    """A reference LMDB into packed records; returns the sample count."""
    return _copy(LmdbSegDataset(lmdb_path), RecordWriter(out_prefix))


def convert_to_lmdb(src_path: str, lmdb_path: str) -> int:
    """Packed records (or an LMDB) into the reference's LMDB layout."""
    return _copy(open_dataset(src_path), LmdbWriter(lmdb_path))
