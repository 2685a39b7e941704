"""ctypes binding of the repo's C++ host library (port of
``tpuseg/nn/native.py``).

``native/sru_cpu.cpp`` (the SRU inference forward on the CPU) and
``native/records_io.cpp`` (the record blob gather) are compiled with the
host compiler at first use into ``tpuseg_torch/kernels/_build/``
(``kernels/build.py::build_host``).  Unlike the JAX loader, which returns
None when the build or the load fails, a failure here raises with the
compiler's message: there is no silent fallback.

The functions are called directly; ``nn/sru.py`` does not route through
them (its CPU path is the plain loop, its CUDA path the ``sru_scan``
kernels).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np

from tpuseg_torch.kernels import build

_i64 = ctypes.c_int64
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The library, built on first use; raises if it cannot be built or
    loaded."""
    lib = ctypes.CDLL(str(build.build_host()))
    lib.tpuseg_sru_forward.argtypes = [
        _f32p, _f32p, _f32p, _f32p, ctypes.c_void_p, ctypes.c_void_p,
        _i64, _i64, _i64, _i64, _i64, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, _f32p, _f32p,
    ]
    lib.tpuseg_sru_forward.restype = None
    lib.tpuseg_sru_bi_forward.argtypes = lib.tpuseg_sru_forward.argtypes
    lib.tpuseg_sru_bi_forward.restype = None
    lib.tpuseg_gather_blobs.argtypes = [
        ctypes.c_void_p, _i64p, _i64p, _i64p, _i64, _u8p, ctypes.c_int,
    ]
    lib.tpuseg_gather_blobs.restype = None
    return lib


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32)


def _shape_error(what, got, want):
    raise ValueError(f"sru_forward_cpu: {what} has shape {got}, expected "
                     f"{want}")


def sru_forward_cpu(
    u, x, weight_c, bias, c0, d: int, activation: int = 0,
    has_skip_term: bool = True, scale_x: float = 1.0,
    bidirectional: bool = False, mask_pad=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """C++ SRU inference forward on the host: u (L, B, bidir*d*k), x (L, B,
    n_in), weight_c / bias (2*bidir*d,), c0 (B, bidir*d) or None, mask_pad
    (L, B) or None.  Returns (h (L, B, bidir*d), c_final (B, bidir*d)) as
    float32 arrays."""
    bidir = 2 if bidirectional else 1
    u, x = _f32(u), _f32(x)
    weight_c, bias = _f32(weight_c), _f32(bias)
    if u.ndim != 3 or d <= 0 or u.shape[-1] % (bidir * d):
        _shape_error("u", u.shape, f"(L, B, {bidir}*{d}*k)")
    length, batch = u.shape[0], u.shape[1]
    k = u.shape[-1] // d // bidir
    if k not in (3, 4):
        raise ValueError(f"sru_forward_cpu: k = {k}, expected 3 or 4")
    if x.ndim != 3 or x.shape[:2] != (length, batch):
        _shape_error("x", x.shape, f"({length}, {batch}, n_in)")
    n_in = x.shape[-1]
    if k == 3 and has_skip_term and n_in != bidir * d:
        _shape_error("x", x.shape, f"({length}, {batch}, {bidir * d})")
    for name, a in (("weight_c", weight_c), ("bias", bias)):
        if a.shape != (2 * bidir * d,):
            _shape_error(name, a.shape, (2 * bidir * d,))
    keep = []  # the optional inputs, alive through the call

    def optional(a, shape, name):
        if a is None:
            return None
        a = _f32(a)
        if a.shape != shape:
            _shape_error(name, a.shape, shape)
        keep.append(a)
        return a.ctypes.data_as(ctypes.c_void_p)

    c0p = optional(c0, (batch, bidir * d), "c0")
    mpp = optional(mask_pad, (length, batch), "mask_pad")
    h = np.empty((length, batch, bidir * d), np.float32)
    cf = np.empty((batch, bidir * d), np.float32)
    lib = load()
    fn = lib.tpuseg_sru_bi_forward if bidirectional else lib.tpuseg_sru_forward
    fn(u, x, weight_c, bias, c0p, mpp, length, batch, d, k, n_in,
       int(activation), int(has_skip_term), float(scale_x), h, cf)
    return h, cf


def gather_blobs(base, offsets, lengths, n_threads: int = 4) -> np.ndarray:
    """Blob ``i`` = ``base[offsets[i] : offsets[i] + lengths[i]]``, all
    concatenated in order into one uint8 array (copied by ``n_threads``
    host threads)."""
    src = np.frombuffer(base, np.uint8)
    offsets = np.ascontiguousarray(offsets, np.int64)
    lengths = np.ascontiguousarray(lengths, np.int64)
    if offsets.ndim != 1 or offsets.shape != lengths.shape:
        raise ValueError("gather_blobs: offsets and lengths must be 1-D and "
                         "of equal length")
    if len(offsets) and (offsets.min() < 0 or lengths.min() < 0
                         or (offsets + lengths).max() > src.size):
        raise ValueError("gather_blobs: a blob lies outside the buffer")
    out_offsets = np.zeros_like(offsets)
    np.cumsum(lengths[:-1], out=out_offsets[1:])
    out = np.empty(int(lengths.sum()), np.uint8)
    load().tpuseg_gather_blobs(
        ctypes.c_void_p(src.ctypes.data), offsets, lengths, out_offsets,
        len(offsets), out, int(n_threads),
    )
    return out
