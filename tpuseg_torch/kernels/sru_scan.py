"""The SRU elementwise recurrence over time: the Hopper kernels (forward
and backward) and the backward's plain PyTorch version.

Replaces the TPU kernels of ``tpuseg/kernels/sru_scan.py``: the forward
(``_fwd_kernel``, under ``sru_scan_pallas`` and ``sru_scan_fused``) and
the backward (``_bwd_kernel``, under ``_fused_bwd``).

    u (L, B, bidir*d*k), x (L, B, n_in), weight_c, bias (2*bidir*d,),
    c0, mask_c (B, bidir*d), mask_pad (L, B)
        -> h (L, B, bidir*d), c_final (B, bidir*d)

k is 3 (skip term from ``x * scale_x``, so ``n_in == bidir*d``) or 4 (skip
term from ``u[..., 3]``).  The kernels read these tensors as they are, one
thread per (batch, direction, hidden) column; ``csrc/sru_scan.cu`` says
what bounds them (bytes) and how.  The forward also writes every step's
cell state ``c_all (L, B, bidir*d)``, from which the backward recomputes
the gates.  The backward sums its per-column weight_c and bias partials
over the batch in a fixed order (in the same launch, by the last block of
each column slice; no atomics on the values), so they are bit-equal from
run to run; ``mask_c`` and ``mask_pad`` get no gradient.

``sru_scan`` takes the plain version (``tpuseg_torch.nn.sru.
sru_recurrence``) only for tensors on the CPU; on a CUDA tensor it
launches the kernels or raises.  ``sru_scan.launches`` counts kernel
launches, ``forward_launches`` and ``backward_launches`` the two
directions (a backward call is ``BACKWARD_LAUNCHES`` launches).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from tpuseg_torch.kernels import build

FORWARD_LAUNCHES = 1   # kernel launches per forward call
BACKWARD_LAUNCHES = 1  # per backward call: the reverse scan and batch sum
_ACTIVATIONS = (0, 1, 2)  # id, tanh, relu


def _k(u, d, ndir):
    return u.shape[-1] // (d * ndir) if d > 0 else 0


def sru_scan_backward_plain(u, x, weight_c, bias, c0, mask_c, mask_pad,
                            c_all, gh, gc_final, d: int, activation: int,
                            bidirectional: bool, has_skip_term: bool,
                            scale_x: float):
    """The backward kernel's formula written out, from the forward's cell
    states ``c_all`` and the cotangents ``gh (L, B, bidir*d)``,
    ``gc_final (B, bidir*d)``.  Returns (du, dx or None, d weight_c,
    d bias, dc0); ``dx`` is None unless k = 3 with the skip term."""
    length, batch = u.shape[0], u.shape[1]
    ndir = 2 if bidirectional else 1
    k = _k(u, d, ndir)
    u5 = u.reshape(length, batch, ndir, d, k)
    cs = c_all.reshape(length, batch, ndir, d)
    gh4 = gh.reshape(length, batch, ndir, d)
    wc = weight_c.reshape(2, ndir, d)
    bb = bias.reshape(2, ndir, d)
    c0r = (torch.zeros_like(cs[0]) if c0 is None
           else c0.reshape(batch, ndir, d))
    mc = (torch.ones_like(cs[0]) if mask_c is None
          else mask_c.reshape(batch, ndir, d))
    pad = (None if mask_pad is None
           else mask_pad.reshape(length, batch, 1).to(u.dtype))
    if has_skip_term:
        xp_all = (u5[..., 3] if k == 4
                  else x.reshape(length, batch, ndir, d) * scale_x)
    gu = torch.zeros_like(u5)
    gxp = torch.zeros_like(cs)
    gwb = torch.zeros((4, ndir, d), dtype=u.dtype, device=u.device)
    gc0 = torch.empty_like(c0r)
    for di in range(ndir):
        fw, rw, fb, rb = wc[0, di], wc[1, di], bb[0, di], bb[1, di]
        m = mc[:, di]
        gc = gc_final.reshape(batch, ndir, d)[:, di]
        acc = [0.0, 0.0, 0.0, 0.0]
        steps = range(length) if di == 1 else range(length - 1, -1, -1)
        for t in steps:
            first = t == (length - 1 if di == 1 else 0)
            prev = t + 1 if di == 1 else t - 1
            cp = c0r[:, di] if first else cs[prev, :, di]
            c = cs[t, :, di]
            u_t = u5[t, :, di]
            f = torch.sigmoid(u_t[..., 1] + fb + cp * fw)
            r = torch.sigmoid(u_t[..., 2] + rb + cp * rw)
            p = 0.0 if pad is None else pad[t]
            ght = gh4[t, :, di] * (1 - p)
            if activation == 1:
                gv = torch.tanh(c)
                ga = 1 - gv * gv
            elif activation == 2:
                gv = torch.relu(c)
                ga = (c > 0).to(c.dtype)
            else:
                gv, ga = c, 1.0
            g = gv * m
            if has_skip_term:
                xp = xp_all[t, :, di]
                dr = ght * (g - xp)
                gxp[t, :, di] = ght * (1 - r)
            else:
                dr = ght * g
            gct = ght * r * m * ga + gc
            gcc = gct * (1 - p)
            du1 = gcc * (cp - u_t[..., 0]) * f * (1 - f)
            du2 = dr * r * (1 - r)
            gu[t, :, di, :, 0] = gcc * (1 - f)
            gu[t, :, di, :, 1] = du1
            gu[t, :, di, :, 2] = du2
            gc = gcc * f + du1 * fw + du2 * rw + gct * p
            for slot, v in enumerate((du1 * cp, du2 * cp, du1, du2)):
                acc[slot] = acc[slot] + v
        gc0[:, di] = gc
        for slot in range(4):
            gwb[slot, di] = acc[slot].sum(dim=0)
    gx = None
    if has_skip_term and k == 4:
        gu[..., 3] = gxp
    elif has_skip_term:
        gx = (gxp * scale_x).reshape(x.shape)
    return (gu.reshape(u.shape), gx, gwb[:2].reshape(-1), gwb[2:].reshape(-1),
            gc0.reshape(batch, ndir * d))


def _check(u, x, weight_c, bias, c0, mask_c, mask_pad, d, activation,
           bidirectional, has_skip_term):
    """Raise on what the kernels do not take."""
    if u.dim() != 3 or x.dim() != 3 or u.shape[:2] != x.shape[:2]:
        raise ValueError("sru_scan: u must be (L, B, bidir*d*k), x (L, B, "
                         "n_in)")
    length, batch = u.shape[0], u.shape[1]
    ndir = 2 if bidirectional else 1
    k = _k(u, d, ndir)
    if d <= 0 or k not in (3, 4) or u.shape[-1] != ndir * d * k:
        raise ValueError(f"sru_scan: u width {u.shape[-1]} is not "
                         f"{ndir} x d={d} x k (3 or 4)")
    if k == 3 and has_skip_term and x.shape[-1] != ndir * d:
        raise ValueError(f"sru_scan: k = 3 takes the skip term from x, whose "
                         f"width {x.shape[-1]} must be {ndir * d}")
    if activation not in _ACTIVATIONS:
        raise ValueError(f"sru_scan: unknown activation {activation}")
    if length == 0 or batch == 0:
        raise ValueError("sru_scan: empty input")
    width = ndir * d
    for name, t, shape in (
            ("u", u, u.shape), ("x", x, x.shape),
            ("weight_c", weight_c, (2 * width,)), ("bias", bias, (2 * width,)),
            ("c0", c0, (batch, width)), ("mask_c", mask_c, (batch, width)),
            ("mask_pad", mask_pad, (length, batch))):
        if t is None:
            continue
        if t.shape != shape:
            raise ValueError(f"sru_scan: {name} is {tuple(t.shape)}, want "
                             f"{shape}")
        if t.dtype != torch.float32:
            raise ValueError(f"sru_scan: {name} must be float32, got "
                             f"{t.dtype}")
        if t.device != u.device:
            raise ValueError(f"sru_scan: {name} lies on {t.device}, u on "
                             f"{u.device}")
        if not t.is_contiguous():
            raise ValueError(f"sru_scan: {name} must be contiguous")
    if k == 4 and u.data_ptr() % 16:
        raise ValueError("sru_scan: u must be 16-byte aligned for k = 4")
    return length, batch, ndir, k


_CHECKED: Dict[tuple, tuple] = {}  # input signature -> _check's result
_CHECKED_MAX = 256


def _checked(u, x, weight_c, bias, c0, mask_c, mask_pad, d, activation,
             bidirectional, has_skip_term):
    """``_check``'s result, computed once per input signature: the spec and
    every tensor's shape, strides (hence contiguity), dtype and device.
    The 16-byte alignment of ``u``, which changes from call to call, is
    checked every time."""
    key = (d, activation, bidirectional, has_skip_term) + tuple(
        None if t is None else (t.shape, t.stride(), t.dtype, t.device)
        for t in (u, x, weight_c, bias, c0, mask_c, mask_pad))
    got = _CHECKED.get(key)
    if got is None:
        got = _check(u, x, weight_c, bias, c0, mask_c, mask_pad, d,
                     activation, bidirectional, has_skip_term)
        if len(_CHECKED) >= _CHECKED_MAX:
            _CHECKED.clear()
        _CHECKED[key] = got
    elif got[3] == 4 and u.data_ptr() % 16:
        raise ValueError("sru_scan: u must be 16-byte aligned for k = 4")
    return got


_COUNTERS: Dict[tuple, torch.Tensor] = {}


def _counters(device, stream: int, n: int) -> torch.Tensor:
    """The backward's arrival counters, one per column slice: zeroed once
    per (device, stream) and left zeroed by every launch, so the calls that
    share them run in stream order."""
    buf = _COUNTERS.get((device, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _COUNTERS[(device, stream)] = buf
    return buf


def _kernel_fns():
    lib = build.load("sru_scan")
    fwd, bwd = lib.tpuseg_sru_fwd, lib.tpuseg_sru_bwd
    if fwd.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fwd.argtypes = [p] * 10 + [i] * 7 + [f, p]
        bwd.argtypes = [p] * 16 + [i] * 7 + [f, p]
        fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def _f32(t: torch.Tensor) -> torch.Tensor:
    if t.dtype != torch.float32 or not t.is_contiguous():
        t = t.to(torch.float32).contiguous()
    return t


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _on_card(u: torch.Tensor, name: str):
    if u.device.type != "cuda":
        raise ValueError(f"{name}: the kernels take CUDA tensors, got "
                         f"{u.device}")


def sru_scan_forward(u, x, weight_c, bias, c0, mask_c, mask_pad, d: int,
                     activation: int, bidirectional: bool,
                     has_skip_term: bool, scale_x: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward launch on CUDA tensors: (h, c_final, c_all)."""
    _on_card(u, "sru_scan_forward")
    length, batch, ndir, k = _checked(u, x, weight_c, bias, c0, mask_c,
                                      mask_pad, d, activation, bidirectional,
                                      has_skip_term)
    fwd, _ = _kernel_fns()
    h = torch.empty((length, batch, ndir * d), dtype=torch.float32,
                    device=u.device)
    c_all = torch.empty_like(h)
    c_final = torch.empty((batch, ndir * d), dtype=torch.float32,
                          device=u.device)
    stream = build.stream_handle(u.device)
    err = fwd(u.data_ptr(), _ptr(x), weight_c.data_ptr(), bias.data_ptr(),
              _ptr(c0), _ptr(mask_c), _ptr(mask_pad), h.data_ptr(),
              c_all.data_ptr(), c_final.data_ptr(), length, batch, d, k, ndir,
              activation, int(has_skip_term), float(scale_x), stream)
    if err != 0:
        raise RuntimeError(f"sru_scan forward launch failed: cudaError {err}")
    sru_scan.launches += FORWARD_LAUNCHES
    sru_scan.forward_launches += FORWARD_LAUNCHES
    return h, c_final, c_all


def sru_scan_backward(u, x, weight_c, bias, c0, mask_c, mask_pad, c_all, gh,
                      gc_final, d: int, activation: int, bidirectional: bool,
                      has_skip_term: bool, scale_x: float):
    """The backward launch on CUDA tensors: (du, dx or None, d weight_c,
    d bias, dc0), as ``sru_scan_backward_plain``."""
    _on_card(u, "sru_scan_backward")
    length, batch, ndir, k = _checked(u, x, weight_c, bias, c0, mask_c,
                                      mask_pad, d, activation, bidirectional,
                                      has_skip_term)
    width = ndir * d
    want = (length, batch, width)
    if (c_all.shape != want or gh.shape != want
            or gc_final.shape != want[1:]):
        raise ValueError("sru_scan_backward: c_all / gh / gc_final do not "
                         "match u")
    c_all, gh, gc_final = _f32(c_all), _f32(gh), _f32(gc_final)
    _, bwd = _kernel_fns()
    dev = u.device
    gu = torch.empty_like(u)
    gx = torch.empty_like(x) if has_skip_term and k == 3 else None
    # one buffer: d weight_c and d bias (4, W), dc0 (B, W), then the
    # per-column partials (4, B, W) as scratch
    n_cols = batch * width
    small = torch.empty(4 * width + 5 * n_cols, dtype=torch.float32,
                        device=dev)
    base = small.data_ptr()  # bytes
    stream = build.stream_handle(dev)
    err = bwd(u.data_ptr(), _ptr(x), weight_c.data_ptr(), bias.data_ptr(),
              _ptr(c0), _ptr(mask_c), _ptr(mask_pad), c_all.data_ptr(),
              gh.data_ptr(), gc_final.data_ptr(), gu.data_ptr(), _ptr(gx),
              base + 4 * (4 * width + n_cols), base + 16 * width, base,
              _counters(dev, stream, width).data_ptr(), length, batch, d, k,
              ndir, activation, int(has_skip_term), float(scale_x), stream)
    if err != 0:
        raise RuntimeError(f"sru_scan backward launch failed: cudaError {err}")
    sru_scan.launches += BACKWARD_LAUNCHES
    sru_scan.backward_launches += BACKWARD_LAUNCHES
    return (gu, gx, small[:2 * width], small[2 * width:4 * width],
            small[4 * width:4 * width + n_cols].view(batch, width))


class SRUScan(torch.autograd.Function):
    """The kernels bound to autograd (CUDA tensors only)."""

    @staticmethod
    def forward(ctx, u, x, weight_c, bias, c0, mask_c, mask_pad, spec):
        h, c_final, c_all = sru_scan_forward(u, x, weight_c, bias, c0, mask_c,
                                             mask_pad, *spec)
        ctx.save_for_backward(u, x, weight_c, bias, c0, mask_c, mask_pad,
                              c_all)
        ctx.spec = spec
        return h, c_final

    @staticmethod
    def backward(ctx, gh, gc_final):
        u, x, weight_c, bias, c0, mask_c, mask_pad, c_all = ctx.saved_tensors
        gu, gx, gwc, gb, gc0 = sru_scan_backward(
            u, x, weight_c, bias, c0, mask_c, mask_pad, c_all, gh, gc_final,
            *ctx.spec)
        return (gu, gx, gwc, gb, None if c0 is None else gc0, None, None,
                None)


def sru_scan(u, x, weight_c, bias, c0=None, d: int = 0, activation: int = 0,
             bidirectional: bool = False, has_skip_term: bool = True,
             scale_x: float = 1.0, mask_pad=None, mask_c=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h, c_final), the arguments as in ``sru_recurrence``.  CPU tensors
    take the plain loop, CUDA tensors the kernels.  ``u`` and ``x`` (a
    bfloat16 product under autocast) and the masks are cast to float32;
    the results are float32."""
    u, x = u.to(torch.float32), x.to(torch.float32)
    if mask_pad is not None:
        mask_pad = mask_pad.to(torch.float32)
    if mask_c is not None:
        mask_c = mask_c.to(torch.float32)
    if u.device.type == "cpu":
        from tpuseg_torch.nn.sru import sru_recurrence

        return sru_recurrence(
            u, x, weight_c, bias, c0, d=d, activation=activation,
            bidirectional=bidirectional, has_skip_term=has_skip_term,
            scale_x=scale_x, mask_pad=mask_pad, mask_c=mask_c)
    if u.device.type != "cuda":
        raise ValueError(f"sru_scan: unsupported device {u.device}")
    spec = (d, activation, bidirectional, has_skip_term, scale_x)
    return SRUScan.apply(u, x, weight_c, bias, c0, mask_c, mask_pad, spec)


sru_scan.launches = 0
sru_scan.forward_launches = 0
sru_scan.backward_launches = 0
