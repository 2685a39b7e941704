"""The operations a batch or a training step needs, counted on the plain
reference at one image: 2 x the multiply-adds of every convolution and
matrix product that the reference dispatches, at the configuration's
shapes, and the ``ir_chain`` formula (``peaks.chain_ops``) for each chain
call, whose plain operations are hidden from the count.  The count is of
the work, so it is the same whatever implements it; elementwise work,
reductions and resampling count none.  Frozen from the program's
``utils/roofline.py`` rules."""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from segbench.count.peaks import chain_ops

_MATMULS = {"mm", "addmm", "bmm", "baddbmm"}


def _shape(t) -> Tuple[int, ...]:
    return tuple(int(s) for s in t.shape)


def _taps_inside(n_in: int, n_out: int, k: int, stride: int, pad: int,
                 dil: int) -> int:
    return sum(1 for i in range(n_in) for j in range(k)
               if 0 <= i * stride - pad + j * dil < n_out)


def conv_flops(x_shape, w_shape, out_shape, transposed: bool, stride,
               padding, dilation, groups: int) -> int:
    """Plain: every output element times its taps and the input channels
    of its group.  Transposed: every real input pixel times its taps that
    land inside the output."""
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


def op_flops(func, args, out) -> int:
    name = func._overloadpacket.__name__
    if name in _MATMULS:
        a, b = (args[0], args[1]) if name in ("mm", "bmm") else (args[1],
                                                                 args[2])
        return 2 * math.prod(_shape(a)) * _shape(b)[-1]
    if name == "convolution":
        stride, padding, dilation, transposed = args[3:7]
        return conv_flops(_shape(args[0]), _shape(args[1]), _shape(out),
                          transposed, stride, padding, dilation, args[8])
    if name == "convolution_backward":
        grad_out, x, w = args[0], args[1], args[2]
        stride, padding, dilation, transposed = args[4:8]
        fwd = conv_flops(_shape(x), _shape(w), _shape(grad_out), transposed,
                         stride, padding, dilation, args[9])
        mask = args[10]
        return fwd * (int(mask[0]) + int(mask[1]))
    return 0


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.flops = 0
        self.hidden = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.hidden:
            self.flops += op_flops(func, args, out)
        return out


@contextlib.contextmanager
def counting() -> Iterator[Dict]:
    """Count the block: the yielded dict gets ``flops`` and ``chains``
    (each ``ir_chain`` call's (n, h, w, c, with_skip)) when it ends."""
    from segbench.reference.decoder import pyramid

    counter = _Counter()
    chains: List[Tuple[int, int, int, int, bool]] = []
    plain = pyramid.ir_chain

    def chain(x, x1u, *rest):
        n, h, w, c = _shape(x)
        chains.append((n, h, w, c, x1u is not None))
        counter.flops += chain_ops(n, h, w, c)
        counter.hidden += 1
        try:
            return plain(x, x1u, *rest)
        finally:
            counter.hidden -= 1

    out: Dict = {}
    pyramid.ir_chain = chain
    try:
        with counter:
            yield out
    finally:
        pyramid.ir_chain = plain
        out["flops"] = counter.flops
        out["chains"] = chains


def infer_work(ref, image_u8: np.ndarray) -> Dict:
    """The work of one image through ``ref`` (``reference.plain.Inference``):
    ``prep_flops`` (expansion, backbone, heads, decoder prep),
    ``round_flops`` and ``round_chains`` (the ``ir_chain`` calls of one
    extraction round, n per image)."""
    from segbench.reference.data.colorspace import image_ex_standardize
    from segbench.reference.plain import full_float32

    x = torch.from_numpy(np.ascontiguousarray(image_u8[None])).to(ref.device)
    with torch.no_grad(), full_float32():
        with counting() as prep:
            xs = image_ex_standardize(x).permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last)
            _, sem_mask, budget, score, partials = ref.model.infer_prep(xs)
        with counting() as rnd:
            ref.model.decoder.extract_rounds(
                sem_mask, score, partials, count_budget=budget, n_rounds=1,
                stop_params=ref.stop, sync_rounds=False)
    return {"prep_flops": prep["flops"], "round_flops": rnd["flops"],
            "round_chains": rnd["chains"]}


def train_work(groups: Dict, checkpoint: str, batch: Dict, seed: int,
               device) -> int:
    """The operations of one training step of the reference over
    ``batch`` (forward, backward and update)."""
    from segbench.reference import plain

    with counting() as c:
        plain.train_steps(groups, checkpoint, [batch], seed, device)
    return c["flops"]
