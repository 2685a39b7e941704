"""Checkpoint reading without flax or msgpack.

``read_msgpack`` decodes the msgpack files ``flax.serialization`` writes
(``assets/synthetic_ckpt.msgpack``): nested string-keyed maps whose leaves
are ext type 1 (``_MsgpackExtType.ndarray``), each payload itself a
msgpack ``(shape, dtype_name, raw_bytes)`` triple; ext type 3 (a numpy
scalar, the same triple of its 0-d array) is read too.  Returns the same tree
of numpy arrays that ``flax.serialization.msgpack_restore`` does.
Also the CLI helpers the inference path needs from
``tpuseg/cli/common.py``: ``adapt_cfg_to_checkpoint`` (over
``adapt_cfg_to_heads``, which the port's own checkpoints use too) and
``load_stop_params``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Any, Optional, Tuple

import numpy as np

from segbench.reference.configs import Config

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3

# fixed-width integers and floats: code -> struct format (big-endian)
_FIXED = {
    0xCA: ">f", 0xCB: ">d",
    0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}
# length-prefixed str/bin/array/map: code -> (kind, length format)
_SIZED = {
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        code = self.take(1)[0]
        if code <= 0x7F:
            return code
        if code >= 0xE0:
            return code - 0x100
        if 0x80 <= code <= 0x8F:
            return self._map(code & 0x0F)
        if 0x90 <= code <= 0x9F:
            return [self.value() for _ in range(code & 0x0F)]
        if 0xA0 <= code <= 0xBF:
            return bytes(self.take(code & 0x1F)).decode("utf-8")
        if code == 0xC0:
            return None
        if code in (0xC2, 0xC3):
            return code == 0xC3
        if code in _FIXED:
            return self.unpack(_FIXED[code])
        if code in _FIXEXT:
            return self._ext(_FIXEXT[code])
        if code in _SIZED:
            kind, fmt = _SIZED[code]
            n = self.unpack(fmt)
            if kind == "str":
                return bytes(self.take(n)).decode("utf-8")
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "array":
                return [self.value() for _ in range(n)]
            if kind == "map":
                return self._map(n)
            return self._ext(n)
        raise ValueError(f"unsupported msgpack code 0x{code:02x}")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def _ext(self, n: int):
        typ = self.unpack(">b")
        payload = bytes(self.take(n))
        if typ in (_EXT_NDARRAY, _EXT_NPSCALAR):
            shape, dtype, raw = _Reader(payload).value()
            arr = np.frombuffer(raw, dtype=np.dtype(dtype))
            arr = arr.reshape(tuple(shape)).copy()
            return arr[()] if typ == _EXT_NPSCALAR else arr
        raise ValueError(f"unsupported msgpack ext type {typ}")


def read_msgpack(path_or_bytes) -> Any:
    """Decode a flax msgpack checkpoint into a tree of numpy arrays."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    r = _Reader(data)
    out = r.value()
    if r.pos != len(data):
        raise ValueError("trailing bytes after the msgpack object")
    return out


def adapt_cfg_to_heads(cfg: Config, modules) -> Config:
    """Disable the count/density heads that are not among ``modules``, the
    top-level module names a checkpoint holds weights for (a fresh head
    would cap extraction with an arbitrary budget)."""
    updates = {}
    if cfg.model.use_count_head and "count_head" not in modules:
        print("  [load] checkpoint has no count_head — head disabled")
        updates["use_count_head"] = False
    if cfg.model.use_density_head and "density_head" not in modules:
        print("  [load] checkpoint has no density_head — head disabled")
        updates["use_density_head"] = False
    if updates:
        return dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, **updates)
        )
    return cfg


def adapt_cfg_to_checkpoint(cfg: Config, model_path: str) -> Config:
    """``adapt_cfg_to_heads`` for a flax msgpack checkpoint."""
    if not (
        (cfg.model.use_count_head or cfg.model.use_density_head)
        and model_path
        and os.path.isfile(model_path)
    ):
        return cfg
    stored = read_msgpack(model_path)
    params = stored.get("params", {}) if isinstance(stored, dict) else {}
    return adapt_cfg_to_heads(cfg, params)


def load_stop_params(path: str) -> Optional[Tuple]:
    """Calibrated extraction stopping rule from ``path``:
    (min_remaining_frac, max_extract_misses[, peak_suppress_factor[,
    stop_remaining_frac]]), or None when the file is absent or malformed."""
    if not os.path.isfile(path):
        return None
    try:
        with open(path) as f:
            d = json.load(f)
        out = (float(d["min_remaining_frac"]), int(d["max_extract_misses"]))
        if "peak_suppress_factor" in d:
            out = out + (float(d["peak_suppress_factor"]),)
            if "stop_remaining_frac" in d:
                out = out + (float(d["stop_remaining_frac"]),)
        return out
    except (ValueError, KeyError, OSError):
        return None
