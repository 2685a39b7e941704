"""The numbers that decide ``correct``, each held to its limit from the
cell file, and the control: the reference computed with the products of
the next precision below the configuration's.

Inference, over the sampled images:

- ``fg_mismatch``: the share of pixels whose foreground differs from the
  reference's (colour expansion, UNet, semantic head);
- ``count_gap``: the mean absolute difference of the instance counts
  (density budget and extraction rounds);
- ``sbd_gap``: 1 - the mean symmetric best Dice between the program's and
  the reference's id maps (extraction rounds and pyramid decode; blind
  to the order of the ids).

Training, over the first steps of the run:

- ``loss_gap``: the largest relative gap of a step's loss;
- ``term_gap`` (``term_gap_step1``): the largest relative gap of a term
  of a step's loss (of the first step's), since the loss is a sum of
  terms of both signs that nearly cancel;
- ``grad_gap``: the worst parameter's gap between the norms of step 1's
  gradient as each optimizer got it, over the reference's norm of that
  parameter or the median parameter's, whichever is larger;
- ``update_gap``: the same of the change of each parameter over the
  steps, leaving out the parameters whose reference gradient is under a
  thousandth of the median parameter's;
- ``grad_median_gap``, ``update_median_gap``: the median parameter's
  gap of each.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

# ----------------------------- inference ---------------------------------


def sbd(a: np.ndarray, b: np.ndarray) -> float:
    """Symmetric best Dice of two id maps (uint8, 0 = background): the
    smaller of the two directions' mean over one map's instances of the
    best Dice with an instance of the other.  A direction from a map with
    no instance reads 1 when the other has none either, else 0."""
    joint = np.bincount(a.astype(np.int64).ravel() * 256 + b.ravel(),
                        minlength=256 * 256).reshape(256, 256)
    size_a, size_b = joint.sum(1), joint.sum(0)
    ids_a, ids_b = np.nonzero(size_a[1:])[0] + 1, np.nonzero(size_b[1:])[0] + 1
    if not len(ids_a) or not len(ids_b):
        return 1.0 if len(ids_a) == len(ids_b) else 0.0
    inter = joint[np.ix_(ids_a, ids_b)]
    dice = 2.0 * inter / (size_a[ids_a][:, None] + size_b[ids_b][None, :])
    return float(min(dice.max(1).mean(), dice.max(0).mean()))


def infer_numbers(program: Sequence, reference: Sequence) -> Dict[str, float]:
    """``program`` and ``reference``: per sampled batch (fg, idmap, counts)
    numpy arrays."""
    fg_bad, count_bad, sbds = [], [], []
    for (pf, pi, pc), (rf, ri, rc) in zip(program, reference):
        for j in range(len(rc)):
            fg_bad.append(float((pf[j] != rf[j]).mean()))
            count_bad.append(abs(int(pc[j]) - int(rc[j])))
            sbds.append(sbd(pi[j], ri[j]))
    return {"fg_mismatch": float(np.mean(fg_bad)),
            "count_gap": float(np.mean(count_bad)),
            "sbd_gap": 1.0 - float(np.mean(sbds))}


# ------------------------------ training ---------------------------------


# the terms that add up to the training cost (``runtime/train.py``)
TERMS = ("ins_cost", "count_loss", "density_loss", "ce_cost", "dice_cost")


def _leaf_gaps(prog: Sequence[float], ref: Sequence[float],
               keep: Sequence[bool]) -> np.ndarray:
    """Per kept parameter: the gap between the two norms over the
    reference's norm of that parameter or of the median parameter,
    whichever is larger."""
    ref = np.asarray(ref, np.float64)
    prog = np.asarray(prog, np.float64)
    keep = np.asarray(keep, bool)
    floor = float(np.median(ref[keep]))
    return (np.abs(prog - ref) / np.maximum(ref, floor))[keep]


def _term_gap(prog: Sequence[Dict], ref: Sequence[Dict]) -> float:
    return max(abs(p[k] - r[k]) / abs(r[k])
               for p, r in zip(prog, ref) for k in TERMS if k in r)


def train_numbers(program: Dict, reference: Dict) -> Dict[str, float]:
    """Each side: ``loss`` (the cost of each step), ``terms`` (each step's
    metrics, the cost's terms among them), ``grad_norms`` and ``change``
    (per parameter, in the model's order)."""
    lp = np.asarray(program["loss"], np.float64)
    lr = np.asarray(reference["loss"], np.float64)
    g_ref = np.asarray(reference["grad_norms"], np.float64)
    moved = g_ref >= 1e-3 * float(np.median(g_ref))
    grads = _leaf_gaps(program["grad_norms"], g_ref, np.ones_like(moved))
    change = _leaf_gaps(program["change"], reference["change"], moved)
    return {
        "loss_gap": float((np.abs(lp - lr) / np.abs(lr)).max()),
        "term_gap": _term_gap(program["terms"], reference["terms"]),
        "term_gap_step1": _term_gap(program["terms"][:1],
                                    reference["terms"][:1]),
        "grad_gap": float(grads.max()),
        "grad_median_gap": float(np.median(grads)),
        "update_gap": float(change.max()),
        "update_median_gap": float(np.median(change)),
    }


# ------------------------------- verdict ---------------------------------


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> List:
    """[[name, value, limit, within]] for every limited number; a number
    that is missing or not finite is not within its limit."""
    out = []
    for name, limit in limits.items():
        v = numbers.get(name)
        ok = v is not None and bool(np.isfinite(v)) and v <= limit
        out.append([name, v, limit, ok])
    return out


# ------------------------------- control ---------------------------------

_PRODUCTS = {"convolution", "convolution_backward", "mm", "addmm", "bmm",
             "baddbmm"}
FP8_MAX = 448.0  # float8_e4m3fn


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through float8 e4m3 with one scale for the tensor
    (its largest magnitude to the format's largest), back in its dtype."""
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, FP8_MAX / amax, torch.ones_like(amax))
    q = (t.float() * scale).to(torch.float8_e4m3fn).float() / scale
    return q.to(t.dtype)


class _Fp8Products(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._overloadpacket.__name__ in _PRODUCTS:
            args = tuple(fp8(a) if isinstance(a, torch.Tensor)
                         and a.is_floating_point() and a.dim() > 1 else a
                         for a in args)
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def fp8_products() -> Iterator[None]:
    """Inside the block every convolution and matrix product (and, in a
    backward pass, each of their gradients) takes its operands rounded to
    float8 e4m3: the precision below bfloat16, in which the control runs
    the reference."""
    with _Fp8Products():
        yield
