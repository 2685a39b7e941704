"""Fused inverted-residual decode chain: the Hopper kernel and its plain
PyTorch version.

Replaces the TPU kernel ``tpuseg/kernels/ir_chain.py::ir_chain`` (Pallas
body ``_kernel``), which the JAX package kept off its inference path; here
it is the path: every pyramid level of every extraction round runs its
``dil1a -> dil1b (+x1u) -> dil2a -> dil2b`` blocks through it.

    y = IR4(IR3(IR2(IR1(x)) + x1u))
    IR(v) = v + pw2(relu6(dw3x3(relu6(pw1 v + b1)) + b2)) + b3

BatchNorms folded into the weights (``fold_ir_params``); weights stacked
over the 4 blocks (``stack_chain_params``): W1 (4, C, 2C), B1 (4, 2C),
WD (4, 3, 3, 2C), B2 (4, 2C), W2 (4, 2C, C), B3 (4, C).  x, x1u and y are
NHWC ``(N, H, W, C)``.

The kernel (``csrc/ir_chain.cu``) is one fused launch per block, four per
chain; the 2C hidden never reaches device memory.  Both pointwise products
run on the tensor cores: in bfloat16 as bf16 products, in float32 as
3xTF32 (three TF32 products per float32 one, within ~1e-5 of max|y| of the
float32 plain chain).  What bounds it and the design choice are in the
source's header.  ``ir_chain`` takes the plain version only for tensors on
the CPU; on a CUDA tensor it launches the kernel or raises.
``ir_chain.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from tpuseg_torch.kernels import build
from tpuseg_torch.nn.blocks import relu6

# the kernel is built for the decoder's level widths at n_filters 32
SUPPORTED_CHANNELS = (32, 64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def ir_chain_plain(x, x1u, w1, b1, wd, b2, w2, b3) -> torch.Tensor:
    """Unfused reference: per block a 1x1 conv, a depthwise 3x3 conv and a
    1x1 conv with the folded BN as conv bias, in the input's dtype."""
    dt = x.dtype
    v = x.permute(0, 3, 1, 2)
    for s in range(4):
        if s == 2 and x1u is not None:
            v = v + x1u.permute(0, 3, 1, 2)
        h = relu6(F.conv2d(v, w1[s].t().to(dt)[:, :, None, None],
                           b1[s].to(dt)))
        h = relu6(F.conv2d(h, wd[s].permute(2, 0, 1)[:, None].to(dt),
                           b2[s].to(dt), padding=1, groups=h.shape[1]))
        v = v + F.conv2d(h, w2[s].t().to(dt)[:, :, None, None], b3[s].to(dt))
    return v.permute(0, 2, 3, 1)


def _check(x, x1u, w1, b1, wd, b2, w2, b3):
    if x.dim() != 4 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(
            "ir_chain: x must be a contiguous, 16-byte aligned NHWC tensor")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"ir_chain: unsupported dtype {x.dtype}")
    c = x.shape[3]
    if c not in SUPPORTED_CHANNELS:
        raise ValueError(f"ir_chain: no kernel for C={c}")
    if x1u is not None and (
        x1u.shape != x.shape or x1u.dtype != x.dtype
        or x1u.device != x.device or not x1u.is_contiguous()
        or x1u.data_ptr() % 16
    ):
        raise ValueError("ir_chain: x1u must match x (shape, dtype, device)")
    want = (
        (w1, (4, c, 2 * c), x.dtype), (b1, (4, 2 * c), torch.float32),
        (wd, (4, 3, 3, 2 * c), torch.float32), (b2, (4, 2 * c), torch.float32),
        (w2, (4, 2 * c, c), x.dtype), (b3, (4, c), torch.float32),
    )
    for i, (t, shape, dtype) in enumerate(want):
        if (tuple(t.shape) != shape or t.dtype != dtype
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(
                f"ir_chain: weight {i} must be contiguous {dtype} {shape} on "
                f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )


def _kernel_fn():
    fn = build.load("ir_chain").tpuseg_ir_block
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
            + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return fn


def ir_chain(x: torch.Tensor, x1u: Optional[torch.Tensor], w1, b1, wd, b2,
             w2, b3) -> torch.Tensor:
    """The fused 4-block chain on NHWC tensors; ``x1u`` (or None) is added
    before block 3.  CPU tensors take the plain version; CUDA tensors the
    kernel."""
    if x.device.type == "cpu":
        return ir_chain_plain(x, x1u, w1, b1, wd, b2, w2, b3)
    if x.device.type != "cuda":
        raise ValueError(f"ir_chain: unsupported device {x.device}")
    _check(x, x1u, w1, b1, wd, b2, w2, b3)
    fn = _kernel_fn()
    n, h, w, c = x.shape
    stream = build.stream_handle(x.device)
    # two buffers in turn: a block never writes the tensor it reads
    bufs = (torch.empty_like(x), torch.empty_like(x))
    v = x
    for s in range(4):
        out = bufs[s % 2]
        skip = x1u.data_ptr() if (s == 2 and x1u is not None) else None
        err = fn(
            _DTYPE_CODE[x.dtype], v.data_ptr(), skip, out.data_ptr(),
            w1[s].data_ptr(), b1[s].data_ptr(), wd[s].data_ptr(),
            b2[s].data_ptr(), w2[s].data_ptr(), b3[s].data_ptr(),
            n, h, w, c, stream,
        )
        if err != 0:
            raise RuntimeError(f"ir_chain kernel launch failed: cudaError {err}")
        ir_chain.launches += 1
        v = out
    return v


ir_chain.launches = 0


@torch.no_grad()
def fold_ir_params(block) -> Tuple[torch.Tensor, ...]:
    """(w1, b1, wd, b2, w2, b3) in float32 from one ``InvertedResidual``
    (``tpuseg_torch.nn.blocks``), BNs folded to their inference affine:
    w1 (C, 2C), wd (3, 3, 2C), w2 (2C, C) in the JAX kernel's layout."""
    s1, t1 = block._BN_0.folded()
    s2, t2 = block._BN_1.folded()
    s3, t3 = block._BN_2.folded()
    w1 = block.Conv_0.weight.float()[:, :, 0, 0].t() * s1[None, :]
    wd = block.Conv_1.weight.float()[:, 0].permute(1, 2, 0) * s2
    w2 = block.Conv_2.weight.float()[:, :, 0, 0].t() * s3[None, :]
    return w1, t1, wd, t2, w2, t3


@torch.no_grad()
def stack_chain_params(blocks: Sequence, dtype=torch.bfloat16):
    """Stack 4 blocks' folded params into the kernel's inputs: the two
    pointwise weights in ``dtype``, biases and depthwise taps in float32."""
    folded = [fold_ir_params(b) for b in blocks]
    w1, b1, wd, b2, w2, b3 = (
        torch.stack([f[i] for f in folded]).contiguous() for i in range(6)
    )
    return (w1.to(dtype), b1, wd, b2, w2.to(dtype), b3)
