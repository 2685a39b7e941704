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
