"""Checkpoint reading and writing without flax or msgpack.

``read_msgpack`` decodes the msgpack files ``flax.serialization`` writes
(``assets/synthetic_ckpt.msgpack``): nested string-keyed maps whose leaves
are ext type 1 (``_MsgpackExtType.ndarray``), each payload itself a
msgpack ``(shape, dtype_name, raw_bytes)`` triple; ext type 3 (a numpy
scalar, the same triple of its 0-d array) is read too.  Returns the same tree
of numpy arrays that ``flax.serialization.msgpack_restore`` does.
``write_msgpack`` is the inverse, byte for byte what
``flax.serialization.to_bytes`` writes for such a tree, and
``merge_restore`` is the JAX CLIs' merge-style load
(``tpuseg/cli/common.py::_merge_restore``).

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
from typing import Any, Dict, Optional, Tuple

import numpy as np

from tpuseg_torch.configs import Config

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
_FIXEXT_CODE = {n: code for code, n in _FIXEXT.items()}


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


def _pack(obj, out: list) -> None:
    """msgpack encoding of ``obj`` appended to ``out``, with the smallest
    header for each length and integer as msgpack-python writes it (the
    encoder flax uses); numpy arrays and scalars as flax's ext types."""
    if isinstance(obj, dict):
        _header(out, len(obj), 0x80, 0xDE, 0xDF)
        for k, v in obj.items():  # in the dict's order, as flax writes
            _pack(str(k), out)
            _pack(v, out)
    elif isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        if arr.dtype.hasobject or arr.dtype.isalignedstruct:
            raise TypeError(f"write_msgpack: unsupported dtype {arr.dtype}")
        inner: list = []
        _pack((arr.shape, arr.dtype.name, arr.tobytes("C")), inner)
        payload = b"".join(inner)
        n = len(payload)
        typ = _EXT_NDARRAY if isinstance(obj, np.ndarray) else _EXT_NPSCALAR
        if n in _FIXEXT_CODE:
            out.append(bytes([_FIXEXT_CODE[n]]))
        elif n <= 0xFF:
            out.append(struct.pack(">BB", 0xC7, n))
        elif n <= 0xFFFF:
            out.append(struct.pack(">BH", 0xC8, n))
        else:
            out.append(struct.pack(">BI", 0xC9, n))
        out.append(struct.pack(">b", typ) + payload)
    elif isinstance(obj, (list, tuple)):
        _header(out, len(obj), 0x90, 0xDC, 0xDD)
        for v in obj:
            _pack(v, out)
    elif obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_pack_int(obj))
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        n = len(raw)
        if n < 32:
            out.append(bytes([0xA0 | n]))
        else:
            out.append(_sized_header(n, 0xD9, 0xDA, 0xDB))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray)):
        out.append(_sized_header(len(obj), 0xC4, 0xC5, 0xC6))
        out.append(bytes(obj))
    else:
        raise TypeError(f"write_msgpack: cannot encode {type(obj).__name__}")


def _header(out: list, n: int, fix: int, code16: int, code32: int) -> None:
    if n <= 15:
        out.append(bytes([fix | n]))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", code16, n))
    else:
        out.append(struct.pack(">BI", code32, n))


def _sized_header(n: int, code8: int, code16: int, code32: int) -> bytes:
    if n <= 0xFF:
        return struct.pack(">BB", code8, n)
    if n <= 0xFFFF:
        return struct.pack(">BH", code16, n)
    return struct.pack(">BI", code32, n)


def _pack_int(v: int) -> bytes:
    if 0 <= v <= 0x7F or -32 <= v < 0:
        return struct.pack(">b" if v < 0 else ">B", v)
    for lo, hi, code, fmt in (
            (0, 0xFF, 0xCC, "B"), (0, 0xFFFF, 0xCD, "H"),
            (0, 0xFFFFFFFF, 0xCE, "I"), (0, 2 ** 64 - 1, 0xCF, "Q"),
            (-0x80, -1, 0xD0, "b"), (-0x8000, -1, 0xD1, "h"),
            (-0x80000000, -1, 0xD2, "i"), (-2 ** 63, -1, 0xD3, "q")):
        if lo <= v <= hi:
            return struct.pack(">B" + fmt, code, v)
    raise OverflowError(f"write_msgpack: integer {v} out of range")


def to_msgpack_bytes(tree: Any) -> bytes:
    """``flax.serialization.to_bytes`` of a nested dict whose leaves are
    numpy arrays or scalars (the payloads the training recipes save:
    ``weights.to_flax``'s ``{"params", "batch_stats", "decoder_state"}``).
    ``read_msgpack`` and ``flax.serialization.msgpack_restore`` return the
    tree."""
    out: list = []
    _pack(tree, out)
    return b"".join(out)


def write_msgpack(path: str, tree: Any) -> None:
    """Write ``to_msgpack_bytes(tree)`` to ``path`` atomically (a temporary
    file beside it, then a rename); makes the parent directory."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(to_msgpack_bytes(tree))
    os.replace(tmp, path)


def merge_restore(init_tree: Any, stored_tree: Any, path: str = "") -> Any:
    """The JAX CLIs' non-strict merge (``_merge_restore``): every stored
    leaf whose path and shape match the init tree overlays it (cast to the
    init leaf's dtype); any other init leaf is kept, with the JAX package's
    warning printed.  Stored leaves the init tree lacks are dropped.
    Leaves are numpy arrays (or anything ``np.asarray`` takes)."""
    if not isinstance(init_tree, dict):
        stored = np.asarray(stored_tree)
        init = np.asarray(init_tree)
        if stored.shape != init.shape:
            print(f"  [load] shape mismatch at {path}: "
                  f"ckpt {stored.shape} vs model {init.shape} — keeping init")
            return init
        return stored.astype(init.dtype)
    out = {}
    for k, v in init_tree.items():
        if isinstance(stored_tree, dict) and k in stored_tree:
            out[k] = merge_restore(v, stored_tree[k], f"{path}/{k}")
        else:
            print(f"  [load] missing in ckpt: {path}/{k} — keeping init")
            out[k] = v
    return out


def nest(flat: Dict[str, Any], sep: str = ".") -> Dict[str, Any]:
    """A flat ``state_dict`` as a nested dict keyed by the parts of its
    keys (``merge_restore`` works on the port's own checkpoints this
    way)."""
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split(sep)
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def flatten(tree: Dict[str, Any], sep: str = ".", prefix: str = ""
            ) -> Dict[str, Any]:
    """The inverse of :func:`nest`."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}{sep}{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, sep, key))
        else:
            out[key] = v
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


def default_stop_params_path() -> str:
    return os.path.join(
        os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir,
        "assets", "stop_params.json",
    )


def load_stop_params(path: str = "") -> Optional[Tuple]:
    """Calibrated extraction stopping rule from ``assets/stop_params.json``:
    (min_remaining_frac, max_extract_misses[, peak_suppress_factor[,
    stop_remaining_frac]]), or None when the file is absent or malformed."""
    path = path or default_stop_params_path()
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
