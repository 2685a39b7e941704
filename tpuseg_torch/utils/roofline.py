"""Operations and bytes of the port's work, and the peaks of the card they
are held to (counterpart of the count half of ``tools/roofline.py``, which
read XLA's cost analysis).

**The count** (:func:`count`): every PyTorch operation dispatched inside
the block is seen by a ``TorchDispatchMode``.

- Operations: 2 x the multiply-adds of every convolution and matrix product
  (``aten.convolution`` and its backward, ``mm``, ``addmm``, ``bmm``,
  ``baddbmm``); elementwise work, reductions and resampling count none, as
  ``torch.utils.flop_counter.FlopCounterMode`` counts.  A transposed
  convolution counts the products on its real input pixels (each input
  pixel times the taps that land inside the output).
- Bytes ("computed"): each dispatched operation's input tensors read once
  and its outputs written once.  Views and ``empty`` move nothing, and a
  0-dim tensor is a wrapped scalar.
- The hand kernels are counted at their dispatch functions (``KERNELS``:
  ``ir_chain``, ``masked_softmax`` forward and backward, ``sru_scan``
  forward and backward) by a formula from the shapes: the operations of
  their products and the bytes of their inputs read once and outputs
  written once.  The operations inside, the plain version's on the CPU or
  the wrapper's around a launch on the card, are hidden from the count, so
  a stage counts the same work whichever implementation runs.  The count
  wraps the call site named in ``KERNELS`` for the block and restores it
  after it (the spatial path's split ``masked_softmax`` entry points are
  not wrapped: their operations count as they run).
- Where the work depends on the data (the extraction rounds that run, the
  rows of a ``masked_softmax`` cotangent that are not zero), the count is
  what this run executed.

**The bounds** of one kernel call used by ``chip_smoke.py`` and the bench
tools: :func:`chain_bound`, :func:`softmax_bound_ms`, :func:`bytes_ms`;
:func:`card_line` reads the card's name and power limit.

**The peaks**: NVIDIA's data sheet for the H100 SXM (dense): 989 TFLOP/s
bf16, 494.7 TF32, 67 float32 outside the tensor cores, 3.35 TB/s of HBM,
at the full 700 W; :func:`card_peaks` gives them for that card by its name
and raises for any other.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import math
import subprocess
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# H100 SXM, dense (NVIDIA's data sheet): everything but matrix products at
# the float32 rate of the CUDA cores; the products at the rate of the route
# the ir_chain kernel takes: bf16 on the tensor cores, float32 as 3xTF32 on
# the tensor cores (three TF32 products for each float32-accurate one, at
# the TF32 dense rate of 494.7 TFLOP/s)
PEAK_F32 = 67e12
PEAK_TF32 = 494.7e12
PEAK_3XTF32 = PEAK_TF32 / 3
PEAK_BF16 = 989e12
PEAK_MATMUL = {"float32": PEAK_3XTF32, "bfloat16": PEAK_BF16}
PEAK_BYTES = 3.35e12

# card names whose data-sheet peaks are the ones above (the SXM part)
_H100_SXM = ("H100 80GB HBM3", "H100 SXM")


def card_peaks(name: str) -> Dict[str, float]:
    """The data-sheet peaks of the card named ``name``
    (``torch.cuda.get_device_name``): FLOP/s by compute type and bytes/s.
    Raises for a card whose figures this module does not hold."""
    if not any(part in name for part in _H100_SXM):
        raise RuntimeError(f"no peak figures for {name!r}: only the H100 SXM "
                           f"({', '.join(_H100_SXM)}) is known")
    return {"bfloat16": PEAK_BF16, "tf32": PEAK_TF32, "float32": PEAK_F32,
            "bytes": PEAK_BYTES}


def ops_seconds(c: "Count", dtype_name: str, peaks: Dict[str, float]) -> float:
    """The least time for ``c``'s operations at ``peaks`` (:func:`card_peaks`):
    the ``ir_chain`` kernel's at the matrix rate of its route (bf16 on the
    tensor cores; float32 as 3xTF32, a third of the TF32 rate), every other
    operation at the rate of ``dtype_name`` (bfloat16 or float32)."""
    chain = c.kernels.get("ir_chain", {}).get("flops", 0)
    matmul = (peaks["tf32"] / 3 if dtype_name == "float32"
              else peaks[dtype_name])
    return chain / matmul + (c.flops - chain) / peaks[dtype_name]


def card_line() -> str:
    """The first card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (a
    card below 700 W runs slower than the peaks say)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ------------------------- one kernel call ------------------------------

def chain_ops(n: int, h: int, w: int, c: int) -> int:
    """2 x the multiply-adds of one ``ir_chain`` call: per pixel and block
    the two pointwise products (2 x 2 C^2 MACs) and the depthwise 3x3 taps
    (18 C MACs), as ``FlopCounterMode`` counts ``ir_chain_plain``."""
    return 4 * n * h * w * (8 * c * c + 36 * c)


def chain_bytes(n: int, h: int, w: int, c: int, act_bytes: int,
                with_skip: bool) -> int:
    """Inputs read once and the output written once: x (and x1u), the
    four blocks' weights (pointwise in the activations' dtype, biases and
    depthwise taps in float32), y."""
    act = n * h * w * c * act_bytes
    weights = 4 * (2 * c * 2 * c * act_bytes + (2 * c * 2 + 2 * c * 9 + c) * 4)
    return act * (3 if with_skip else 2) + weights


def chain_bound(n, h, w, c, dtype_name, with_skip, cuda_cores=False):
    """(bytes ms, operations ms): the least time for one chain call is the
    larger — inputs read once and the output written once at the memory
    rate, operations at the card's peak for their type.  Per pixel and
    block: the two pointwise products (8 C^2 FLOPs) at the matrix rate of
    the kernel's route (``PEAK_MATMUL``); the depthwise taps (36 C), the two
    bias + relu6 passes (12 C) and the residual + b3 (2 C), accumulated in
    float32, at the CUDA cores' float32 rate.  The two kinds run on
    different units, so the larger time bounds.  ``cuda_cores``: the
    float32 products on the CUDA cores too, where both kinds add (the
    yardstick of a kernel that keeps its products off the tensor cores)."""
    es = 4 if dtype_name == "float32" else 2
    nbytes = chain_bytes(n, h, w, c, es, with_skip)
    px = n * h * w * 4
    other_s = px * 50 * c / PEAK_F32
    if cuda_cores:
        ops_s = px * 8 * c * c / PEAK_F32 + other_s
    else:
        ops_s = max(px * 8 * c * c / PEAK_MATMUL[dtype_name], other_s)
    return 1e3 * nbytes / PEAK_BYTES, 1e3 * ops_s


def softmax_bytes(b: int, n: int, hw: int,
                  active: Optional[int] = None) -> Tuple[int, int]:
    """(forward, backward) bytes of ``masked_softmax``: each input read
    once, each output written once.  Forward reads e and the float32 mask
    and writes p; backward reads g, p where g is nonzero (``active`` rows
    of the B*N, all of them when None) and writes de."""
    active = b * n if active is None else active
    fwd = b * hw * 4 + b * n * hw * 8
    bwd = b * n * hw * 4 + active * hw * 4 + b * hw * 4
    return fwd, bwd


def softmax_bound_ms(b, n, hw, active=None):
    """Bytes bounds (forward, backward) in ms: :func:`softmax_bytes` at the
    card's memory rate."""
    fwd, bwd = softmax_bytes(b, n, hw, active)
    return 1e3 * fwd / PEAK_BYTES, 1e3 * bwd / PEAK_BYTES


def bytes_ms(*tensors):
    """The bytes bound in ms of float32 tensors: each moved once at the
    memory rate (the ``sru_scan`` calls' inputs and outputs)."""
    moved = sum(4 * t.numel() for t in tensors if t is not None)
    return 1e3 * moved / PEAK_BYTES


def sru_bytes(length: int, batch: int, width: int, k: int, n_in: int,
              has_c0: bool, has_mask_c: bool, has_mask_pad: bool,
              backward: bool) -> int:
    """Bytes of one ``sru_scan`` call, float32: ``width`` = bidir * d.
    Forward reads u (L, B, width*k), x (L, B, n_in) where the skip term
    reads it (k = 3), weight_c and bias (2 width each), c0 and mask_c
    (B, width), mask_pad (L, B) and writes h and the cell states c_all
    (L, B, width) and c_final (B, width).  Backward reads those inputs,
    c_all, gh (L, B, width) and gc_final and writes du, dx, the weight_c
    and bias gradients and dc0."""
    seq, col = length * batch, batch * width
    x = seq * n_in if k == 3 else 0
    ins = (seq * width * k + x + 4 * width + col * (int(has_c0) + int(has_mask_c))
           + seq * int(has_mask_pad))
    if not backward:
        return 4 * (ins + 2 * seq * width + col)
    return 4 * (ins + 2 * seq * width + col       # c_all, gh, gc_final
                + seq * width * k + x + 4 * width + col)  # du, dx, dwc/db, dc0


# --------------------------- the counter ---------------------------------

_MATMULS = {"mm", "addmm", "bmm", "baddbmm"}
_NO_BYTES = {"empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "detach", "alias", "lift_fresh",
             "_unsafe_view", "_local_scalar_dense"}


def _shape(t) -> Tuple[int, ...]:
    return tuple(int(s) for s in t.shape)


def _taps_inside(n_in: int, n_out: int, k: int, stride: int, pad: int,
                 dil: int) -> int:
    """Pairs (input pixel i, tap j) of a transposed convolution along one
    axis whose output ``i * stride - pad + j * dil`` lies in [0, n_out)."""
    return sum(1 for i in range(n_in) for j in range(k)
               if 0 <= i * stride - pad + j * dil < n_out)


def conv_flops(x_shape, w_shape, out_shape, transposed: bool, stride,
               padding, dilation, groups: int) -> int:
    """2 x the multiply-adds of ``aten.convolution``.  Plain: every output
    element times its taps (padding included) and the input channels of its
    group.  Transposed (weight (C_in, C_out / groups, k...)): every real
    input pixel times its taps that land inside the output."""
    batch = x_shape[0]
    if not transposed:
        c_out, c_in_g = w_shape[0], w_shape[1]
        return 2 * batch * c_out * c_in_g * math.prod(w_shape[2:]) * \
            math.prod(out_shape[2:])
    c_in, c_out_g = w_shape[0], w_shape[1]
    taps = math.prod(
        _taps_inside(x_shape[2 + i], out_shape[2 + i], w_shape[2 + i],
                     stride[i], padding[i], dilation[i])
        for i in range(len(w_shape) - 2))
    return 2 * batch * c_in * c_out_g * taps


def _matmul_flops(name: str, args) -> int:
    if name in ("mm", "bmm"):
        a, b = args[0], args[1]
    else:  # addmm / baddbmm: (bias, a, b)
        a, b = args[1], args[2]
    return 2 * math.prod(_shape(a)) * _shape(b)[-1]


def op_flops(func, args, out) -> int:
    """Operations of one dispatched ``aten`` call (0 unless a product)."""
    name = func._overloadpacket.__name__
    if name in _MATMULS:
        return _matmul_flops(name, args)
    if name == "convolution":
        x, w = args[0], args[1]
        stride, padding, dilation, transposed = args[3:7]
        groups = args[8]
        return conv_flops(_shape(x), _shape(w), _shape(out), transposed,
                          stride, padding, dilation, groups)
    if name == "convolution_backward":
        grad_out, x, w = args[0], args[1], args[2]
        stride, padding, dilation, transposed = args[4:8]
        groups, mask = args[9], args[10]
        fwd = conv_flops(_shape(x), _shape(w), _shape(grad_out), transposed,
                         stride, padding, dilation, groups)
        # the input's and the weight's gradients: each the forward's
        # products again
        return fwd * (int(mask[0]) + int(mask[1]))
    return 0


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0]
            if isinstance(t, torch.Tensor) and t.dim() > 0]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def op_bytes(func, args, kwargs, out) -> int:
    """Bytes of one dispatched call: its input tensors read once and its
    outputs written once; a view or an ``empty`` moves nothing."""
    if func._overloadpacket.__name__ in _NO_BYTES or func.is_view:
        return 0
    ins = {id(t): t for t in _tensors((args, kwargs))}
    return (sum(_nbytes(t) for t in ins.values())
            + sum(_nbytes(t) for t in _tensors(out)))


@dataclasses.dataclass
class Count:
    """What :func:`count` saw: ``flops`` (2 x multiply-adds), ``bytes``,
    ``ops`` (dispatched calls counted), and per hand kernel its ``calls``,
    ``flops`` and ``bytes`` (already in the totals)."""
    flops: int = 0
    bytes: int = 0
    ops: int = 0
    kernels: Dict[str, Dict[str, int]] = dataclasses.field(
        default_factory=dict)

    def add_kernel(self, name: str, flops: int, nbytes: int) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                           "bytes": 0})
        k["calls"] += 1
        k["flops"] += int(flops)
        k["bytes"] += int(nbytes)
        self.flops += int(flops)
        self.bytes += int(nbytes)


class _Counter(TorchDispatchMode):
    def __init__(self, result: Count):
        super().__init__()
        self.result = result
        self.hidden = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.hidden:
            self.result.ops += 1
            self.result.flops += op_flops(func, args, out)
            self.result.bytes += op_bytes(func, args, kwargs, out)
        return out

    @contextlib.contextmanager
    def hide(self) -> Iterator[None]:
        self.hidden += 1
        try:
            yield
        finally:
            self.hidden -= 1


# -------------------- the hand kernels' formulas -------------------------

def _chain_count(x, x1u, w1, *_):
    n, h, w, c = _shape(x)
    return (chain_ops(n, h, w, c),
            chain_bytes(n, h, w, c, x.element_size(), x1u is not None))


def _softmax_count(e, mask):
    b, n, hw = _shape(mask)
    return 0, softmax_bytes(b, n, hw)[0]


def _softmax_backward_count(args, kwargs, outs, grads):
    p, g = outs[0], grads[0]
    b, n, hw = _shape(p)
    active = int((g != 0).any(dim=-1).sum())
    return 0, softmax_bytes(b, n, hw, active)[1]


def _sru_shapes(u, x, weight_c, bias, c0=None, d=0, activation=0,
                bidirectional=False, has_skip_term=True, scale_x=1.0,
                mask_pad=None, mask_c=None):
    length, batch = u.shape[0], u.shape[1]
    width = weight_c.shape[0] // 2
    k = u.shape[-1] // width
    return dict(length=length, batch=batch, width=width, k=k,
                n_in=x.shape[-1] if has_skip_term else 0,
                has_c0=c0 is not None, has_mask_c=mask_c is not None,
                has_mask_pad=mask_pad is not None)


def _sru_count(*args, **kwargs):
    return 0, sru_bytes(**_sru_shapes(*args, **kwargs), backward=False)


def _sru_backward_count(args, kwargs, outs, grads):
    return 0, sru_bytes(**_sru_shapes(*args, **kwargs), backward=True)


@dataclasses.dataclass(frozen=True)
class Kernel:
    """A hand kernel as the count sees it: the call site (module, name)
    that the main paths reach it through, the formula of a forward call
    (the call's arguments -> (flops, bytes)) and, where it has one, of its
    backward (the forward's arguments, outputs and cotangents)."""
    site: Tuple[str, str]
    forward: Callable
    backward: Optional[Callable] = None


KERNELS: Dict[str, Kernel] = {
    "ir_chain": Kernel(("tpuseg_torch.decoder.pyramid", "ir_chain"),
                       _chain_count),
    "masked_softmax": Kernel(("tpuseg_torch.nn.attention", "masked_softmax"),
                             _softmax_count, _softmax_backward_count),
    "sru_scan": Kernel(("tpuseg_torch.nn.sru", "sru_scan"), _sru_count,
                       _sru_backward_count),
}


class _Hidden(torch.autograd.Function):
    """A kernel call under autograd: the forward and, in the backward pass,
    its gradient run hidden from the count, each counted by its formula."""

    @staticmethod
    def forward(ctx, counter, name, fn, spec, args, kwargs, *tensors):
        leaves, treedef = tree_flatten((args, kwargs))
        inputs = [t.detach().requires_grad_(t.requires_grad)
                  for t in tensors]
        it = iter(inputs)
        call_args, call_kwargs = treedef.unflatten(
            [next(it) if isinstance(v, torch.Tensor) else v for v in leaves])
        with torch.enable_grad(), counter.hide():
            out = fn(*call_args, **call_kwargs)
        outs = out if isinstance(out, tuple) else (out,)
        ctx.counter, ctx.name, ctx.spec = counter, name, spec
        ctx.call = (call_args, call_kwargs)
        ctx.inputs, ctx.outs = inputs, outs
        return tuple(o.detach() for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        counter = ctx.counter
        wanted = [i for i, t in enumerate(ctx.inputs) if t.requires_grad]
        with counter.hide():
            flops, nbytes = ctx.spec.backward(*ctx.call, ctx.outs, grads)
            counter.result.add_kernel(f"{ctx.name}_backward", flops, nbytes)
            got = torch.autograd.grad(
                [o for o in ctx.outs if o.requires_grad],
                [ctx.inputs[i] for i in wanted],
                [g for o, g in zip(ctx.outs, grads) if o.requires_grad],
                allow_unused=True)
        result = [None] * len(ctx.inputs)
        for i, g in zip(wanted, got):
            result[i] = g
        return (None,) * 6 + tuple(result)


def _counted(counter: _Counter, name: str, spec: Kernel, fn):
    def call(*args, **kwargs):
        with counter.hide():
            counter.result.add_kernel(name, *spec.forward(*args, **kwargs))
        tensors = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
        if (spec.backward is None or not torch.is_grad_enabled()
                or not any(t.requires_grad for t in tensors)):
            with counter.hide():
                return fn(*args, **kwargs)
        outs = _Hidden.apply(counter, name, fn, spec, args, kwargs, *tensors)
        return outs if len(outs) > 1 else outs[0]
    return call


@contextlib.contextmanager
def count(kernels: bool = True) -> Iterator[Count]:
    """Count the block's operations and bytes (module docstring) into the
    yielded :class:`Count`.  ``kernels=False`` leaves the hand kernels'
    call sites alone: the plain versions' operations are then counted as
    they run (on the CPU), the way ``FlopCounterMode`` would."""
    result = Count()
    counter = _Counter(result)
    patched = []
    try:
        if kernels:
            for name, spec in KERNELS.items():
                mod = importlib.import_module(spec.site[0])
                fn = getattr(mod, spec.site[1])
                patched.append((mod, spec.site[1], fn))
                setattr(mod, spec.site[1], _counted(counter, name, spec, fn))
        with counter:
            yield result
    finally:
        for mod, attr, fn in reversed(patched):
            setattr(mod, attr, fn)
