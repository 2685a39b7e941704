"""Per-instance masked spatial softmax: the Hopper kernels (forward and
backward) and their plain PyTorch version.

Replaces the TPU kernel ``tpuseg/kernels/masked_softmax.py::
masked_softmax_pallas`` (Pallas body ``_kernel``): one score map per sample
is broadcast over the sample's ``N`` instances, each instance takes a
softmax over its own pixels, an instance with no pixel gives zeros.

    e (B, HW) float32, mask (B, N, HW) {0, 1} -> p (B, N, HW) float32

The port is NCHW, so every (batch, instance) row of ``HW`` values is
contiguous and no transpose stands on the path (the JAX wrapper turns its
``(B, HW, N)`` mask round first).  The mask is float32, as the training
path holds the batch's instance masks.

The gradient reaches ``e`` only: ``de[b, hw] = sum_n p * (g - sum_hw p * g)``,
summed over the instances in a fixed order (no atomics), so it is the same
from run to run.  The backward reads ``p`` only where ``g`` is nonzero and
sums only the instances whose ``g`` row is: training gives a cotangent to
the few instances its glimpse loop picked.  ``csrc/masked_softmax.cu`` says
what bounds the kernels (bytes) and how a 256 KB row is streamed.

``masked_softmax`` takes the plain version only for tensors on the CPU; on
a CUDA tensor it launches the kernels or raises.  ``masked_softmax.launches``
counts kernel launches, ``forward_launches`` and ``backward_launches`` the
two directions (a backward call is ``BACKWARD_LAUNCHES`` launches).

Split rows (spatial sharding, ``parallel/spatial.py::masked_softmax``): a
row of pixels lies on several ranks.  Four entry points, each a launch on
CUDA tensors and a plain version on the CPU, leave the collectives between
them to the caller: ``masked_softmax_stats`` (each row's partial (max, sum
of exp)), ``masked_softmax_apply`` (p from the combined pairs),
``masked_softmax_row_dots`` (each row's share of the backward's dot and
its active flag) and ``masked_softmax_tiles`` (de from the global dots and
flags).  They count in ``split_forward_launches`` /
``split_backward_launches`` (and ``launches``).
"""

from __future__ import annotations

import ctypes

import torch

from tpuseg_torch.kernels import build

_NEG_INF = -1e30
FORWARD_LAUNCHES = 1   # kernel launches per forward call
BACKWARD_LAUNCHES = 2  # per backward call: the row dots and flags, then de


def masked_softmax_plain(e: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Unfused reference, differentiable by autograd: fill ``-1e30`` outside
    each instance, softmax over ``HW``, zero the empty instances."""
    inside = mask > 0
    logits = torch.where(inside, e[:, None, :], e.new_full((), _NEG_INF))
    p = torch.softmax(logits, dim=-1)
    return torch.where(inside.any(dim=-1, keepdim=True), p,
                       torch.zeros_like(p))


def masked_softmax_backward_plain(p: torch.Tensor,
                                  g: torch.Tensor) -> torch.Tensor:
    """The backward kernels' formula written out: ``de (B, HW)`` from the
    saved ``p`` and the cotangent ``g`` (both ``(B, N, HW)``)."""
    dot = (p * g).sum(dim=-1, keepdim=True)
    return (p * (g - dot)).sum(dim=1)


def _check(e, mask):
    if e.dim() != 2 or mask.dim() != 3:
        raise ValueError("masked_softmax: e must be (B, HW), mask (B, N, HW)")
    b, hw = e.shape
    if mask.shape[0] != b or mask.shape[2] != hw:
        raise ValueError(
            f"masked_softmax: mask {tuple(mask.shape)} does not match e "
            f"{tuple(e.shape)}")
    if e.dtype != torch.float32:
        raise ValueError(f"masked_softmax: e must be float32, got {e.dtype}")
    if mask.dtype != torch.float32:
        raise ValueError(
            f"masked_softmax: mask must be float32, got {mask.dtype}")
    if mask.device != e.device:
        raise ValueError("masked_softmax: e and mask lie on different devices")
    if not (e.is_contiguous() and mask.is_contiguous()):
        raise ValueError("masked_softmax: e and mask must be contiguous")
    if e.data_ptr() % 16 or mask.data_ptr() % 16:
        raise ValueError("masked_softmax: e and mask must be 16-byte aligned")
    if b == 0 or hw == 0 or mask.shape[1] == 0:
        raise ValueError("masked_softmax: empty input")


def _kernel_fns():
    lib = build.load("masked_softmax")
    fwd, bwd = lib.tpuseg_masked_softmax_fwd, lib.tpuseg_masked_softmax_bwd
    if fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fwd.argtypes = [p, p, p, i, i, i, p]
        bwd.argtypes = [p, p, p, p, i, i, i, p]
        fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


class MaskedSoftmax(torch.autograd.Function):
    """The kernels bound to autograd (CUDA tensors only)."""

    @staticmethod
    def forward(ctx, e, mask):
        _check(e, mask)
        fwd, _ = _kernel_fns()
        b, n, hw = mask.shape
        p = torch.empty((b, n, hw), dtype=torch.float32, device=e.device)
        stream = build.stream_handle(e.device)
        err = fwd(e.data_ptr(), mask.data_ptr(), p.data_ptr(), b, n, hw,
                  stream)
        if err != 0:
            raise RuntimeError(
                f"masked_softmax forward launch failed: cudaError {err}")
        masked_softmax.launches += FORWARD_LAUNCHES
        masked_softmax.forward_launches += FORWARD_LAUNCHES
        ctx.save_for_backward(p)
        ctx.mark_non_differentiable(mask)
        return p

    @staticmethod
    def backward(ctx, g):
        (p,) = ctx.saved_tensors
        return masked_softmax_backward(p, g), None


def masked_softmax_backward(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``de (B, HW)`` from the forward's output ``p`` and the cotangent ``g``
    (both ``(B, N, HW)`` on the card): the two backward launches.  ``p``
    must be finite, as the forward makes it: a zero of ``g`` skips it."""
    if p.device.type != "cuda" or p.dtype != torch.float32 or p.dim() != 3:
        raise ValueError("masked_softmax_backward: p must be a float32 "
                         "(B, N, HW) CUDA tensor")
    if g.shape != p.shape or g.device != p.device:
        raise ValueError("masked_softmax_backward: g must match p")
    p = p.contiguous()
    g = g.to(torch.float32).contiguous()
    if g.data_ptr() % 16:
        g = g.clone()
    _, bwd = _kernel_fns()
    b, n, hw = p.shape
    # scratch: the row dots, then the rows' active flags
    scratch = torch.empty((2, b, n), dtype=torch.float32, device=p.device)
    de = torch.empty((b, hw), dtype=torch.float32, device=p.device)
    stream = build.stream_handle(p.device)
    err = bwd(p.data_ptr(), g.data_ptr(), scratch.data_ptr(), de.data_ptr(),
              b, n, hw, stream)
    if err != 0:
        raise RuntimeError(
            f"masked_softmax backward launch failed: cudaError {err}")
    masked_softmax.launches += BACKWARD_LAUNCHES
    masked_softmax.backward_launches += BACKWARD_LAUNCHES
    return de


# ---------------------------- split rows --------------------------------

def masked_softmax_stats_plain(e: torch.Tensor,
                               mask: torch.Tensor) -> torch.Tensor:
    """(B, N, 2): each row's (max, sum of exp(e - max)) over its pixels
    whose mask is set; (-1e30, 0) for a row with none."""
    inside = mask > 0
    logits = torch.where(inside, e[:, None, :], e.new_full((), _NEG_INF))
    m = logits.amax(dim=-1)
    z = torch.where(inside, torch.exp(logits - m[..., None]),
                    torch.zeros_like(logits))
    return torch.stack([m, z.sum(dim=-1)], dim=-1)


def masked_softmax_apply_plain(e: torch.Tensor, mask: torch.Tensor,
                               stats: torch.Tensor) -> torch.Tensor:
    """p (B, N, HW) = exp(e - M) / S where the mask is set and the row's
    combined sum S > 0, else 0; ``stats`` (B, N, 2) holds (M, S)."""
    m, s = stats[..., 0:1], stats[..., 1:2]
    keep = (mask > 0) & (s > 0)
    z = torch.exp(e[:, None, :] - m) * (1.0 / s)
    return torch.where(keep, z, torch.zeros_like(z))


def masked_softmax_row_dots_plain(p: torch.Tensor,
                                  g: torch.Tensor) -> torch.Tensor:
    """(2, B, N): each row's ``sum p * g`` and whether its ``g`` is nonzero
    anywhere (1.0 / 0.0; NaN counts as nonzero)."""
    return torch.stack([(p * g).sum(dim=-1),
                        (g != 0).any(dim=-1).to(torch.float32)])


def masked_softmax_tiles_plain(p: torch.Tensor, g: torch.Tensor,
                               dots: torch.Tensor) -> torch.Tensor:
    """de (B, HW) = sum over the active rows of p * (g - dot), from the
    (2, B, N) global dots and flags (summed flags: > 0 is active)."""
    active = (dots[1] > 0)[..., None]
    t = p * (g - dots[0][..., None])
    return torch.where(active, t, torch.zeros_like(t)).sum(dim=1)


def _split_fns():
    lib = build.load("masked_softmax")
    fns = (lib.tpuseg_masked_softmax_stats, lib.tpuseg_masked_softmax_apply,
           lib.tpuseg_masked_softmax_bwd_rows,
           lib.tpuseg_masked_softmax_bwd_tiles)
    if fns[0].argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fns[0].argtypes = [p, p, p, i, i, i, p]
        fns[1].argtypes = [p, p, p, p, i, i, i, p]
        fns[2].argtypes = [p, p, p, i, i, i, p]
        fns[3].argtypes = [p, p, p, p, i, i, i, p]
        for f in fns:
            f.restype = ctypes.c_int
    return fns


def _launched(err: int, what: str, direction: str) -> None:
    if err != 0:
        raise RuntimeError(f"masked_softmax {what} launch failed: "
                           f"cudaError {err}")
    masked_softmax.launches += 1
    if direction == "forward":
        masked_softmax.split_forward_launches += 1
    else:
        masked_softmax.split_backward_launches += 1


def masked_softmax_stats(e: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Split rows, forward 1: (B, N, 2) partial (max, sum of exp) per row of
    this rank's pixels.  CPU: the plain version; CUDA: one launch."""
    if e.device.type == "cpu":
        return masked_softmax_stats_plain(e, mask)
    _check(e, mask)
    b, n, hw = mask.shape
    stats = torch.empty((b, n, 2), dtype=torch.float32, device=e.device)
    err = _split_fns()[0](e.data_ptr(), mask.data_ptr(), stats.data_ptr(),
                          b, n, hw, build.stream_handle(e.device))
    _launched(err, "stats", "forward")
    return stats


def masked_softmax_apply(e: torch.Tensor, mask: torch.Tensor,
                         stats: torch.Tensor) -> torch.Tensor:
    """Split rows, forward 2: p (B, N, HW) from the rows' combined (max,
    sum) ``stats`` (B, N, 2).  CPU: the plain version; CUDA: one launch."""
    if e.device.type == "cpu":
        return masked_softmax_apply_plain(e, mask, stats)
    _check(e, mask)
    b, n, hw = mask.shape
    stats = stats.to(torch.float32).contiguous()
    if stats.shape != (b, n, 2) or stats.device != e.device:
        raise ValueError("masked_softmax_apply: stats must be (B, N, 2) on "
                         "e's device")
    p = torch.empty((b, n, hw), dtype=torch.float32, device=e.device)
    err = _split_fns()[1](e.data_ptr(), mask.data_ptr(), stats.data_ptr(),
                          p.data_ptr(), b, n, hw,
                          build.stream_handle(e.device))
    _launched(err, "apply", "forward")
    return p


def _check_pg(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    if p.dtype != torch.float32 or p.dim() != 3 or not p.is_contiguous():
        raise ValueError("masked_softmax split backward: p must be a "
                         "contiguous float32 (B, N, HW) tensor")
    if g.shape != p.shape or g.device != p.device:
        raise ValueError("masked_softmax split backward: g must match p")
    g = g.to(torch.float32).contiguous()
    return g.clone() if g.data_ptr() % 16 else g


def masked_softmax_row_dots(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Split rows, backward 1: (2, B, N) float32, each row's share of
    ``sum p * g`` and its active flag (1.0 / 0.0).  CPU: the plain version;
    CUDA: one launch."""
    if p.device.type == "cpu":
        return masked_softmax_row_dots_plain(p, g)
    g = _check_pg(p, g)
    b, n, hw = p.shape
    scratch = torch.empty((2, b, n), dtype=torch.float32, device=p.device)
    err = _split_fns()[2](p.data_ptr(), g.data_ptr(), scratch.data_ptr(),
                          b, n, hw, build.stream_handle(p.device))
    _launched(err, "row dots", "backward")
    return torch.stack([scratch[0],
                        scratch[1].view(torch.int32).to(torch.float32)])


def masked_softmax_tiles(p: torch.Tensor, g: torch.Tensor,
                         dots: torch.Tensor) -> torch.Tensor:
    """Split rows, backward 2: de (B, HW) from the global (2, B, N) dots and
    flags.  CPU: the plain version; CUDA: one launch."""
    if p.device.type == "cpu":
        return masked_softmax_tiles_plain(p, g, dots)
    g = _check_pg(p, g)
    b, n, hw = p.shape
    scratch = torch.empty((2, b, n), dtype=torch.float32, device=p.device)
    scratch[0] = dots[0]
    scratch[1].view(torch.int32).copy_((dots[1] > 0).to(torch.int32))
    de = torch.empty((b, hw), dtype=torch.float32, device=p.device)
    err = _split_fns()[3](p.data_ptr(), g.data_ptr(), scratch.data_ptr(),
                          de.data_ptr(), b, n, hw,
                          build.stream_handle(p.device))
    _launched(err, "tiles", "backward")
    return de


def masked_softmax(e: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``p (B, N, HW)`` from ``e (B, HW)`` and ``mask (B, N, HW)``.  CPU
    tensors take the plain version; CUDA tensors the kernels."""
    if e.device.type == "cpu":
        return masked_softmax_plain(e, mask)
    if e.device.type != "cuda":
        raise ValueError(f"masked_softmax: unsupported device {e.device}")
    return MaskedSoftmax.apply(e, mask)


masked_softmax.launches = 0
masked_softmax.forward_launches = 0
masked_softmax.backward_launches = 0
masked_softmax.split_forward_launches = 0
masked_softmax.split_backward_launches = 0
