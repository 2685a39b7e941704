"""Rank tasks of the data-parallel path, run through ``run_ranks``.

Each is a module-level function of the port (a spawned rank imports it by
name and nothing else), takes host arguments and returns host values: the
rank's final state on the CPU, its metrics, its kernel launch counts.
Called directly with ``make_mesh(1, device)`` a task runs the same work
in this process, which is the one-process reference the ranks are held
to (``tests/test_torch_parallel.py``, ``chip_smoke.py``).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from tpuseg_torch.configs import Config
from tpuseg_torch.kernels.ir_chain import ir_chain
from tpuseg_torch.kernels.masked_softmax import masked_softmax
from tpuseg_torch.parallel.mesh import (
    Mesh, pad_and_shard, replicate, shard_batch,
)
from tpuseg_torch.utils.tracing import TRACE_FILE, trace_context


def _cpu_state(model) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def kernel_launches() -> Dict[str, int]:
    """The launch counters of the kernels on the training and inference
    paths in this process."""
    return {"masked_softmax_forward": masked_softmax.forward_launches,
            "masked_softmax_backward": masked_softmax.backward_launches,
            "ir_chain": ir_chain.launches}


def _since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in kernel_launches().items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _numerics(dtype: Optional[torch.dtype]):
    """float32 runs in full float32 (TF32 off), as ``Predictor`` does."""
    from tpuseg_torch.runtime.predict import tf32_off

    return tf32_off() if dtype == torch.float32 else contextlib.nullcontext()


def _train_state(mesh: Mesh, cfg: Config, model_state):
    from tpuseg_torch.models import ReSeg
    from tpuseg_torch.runtime.state import create_train_state

    model = ReSeg(cfg)
    model.load_state_dict(model_state)
    return create_train_state(cfg, model, device=mesh.device)


def batch_norm_grads(mesh: Mesh, x: np.ndarray, grad_y: np.ndarray,
                     weight: np.ndarray, bias: np.ndarray) -> Dict:
    """One train-mode BatchNorm (``nn/blocks.py``) forward and backward
    on this rank's shard of ``x`` (N, C, H, W) with the cotangent
    ``grad_y``: this rank's rows of y and dx, its share of the weight and
    bias gradients, and the running statistics after the update."""
    from tpuseg_torch.nn.blocks import _BN

    bn = _BN(x.shape[1]).to(mesh.device).train()
    with torch.no_grad():
        bn.BatchNorm_0.weight.copy_(torch.from_numpy(weight))
        bn.BatchNorm_0.bias.copy_(torch.from_numpy(bias))
    xs = shard_batch(x, mesh).requires_grad_()
    y = bn(xs)
    y.backward(shard_batch(grad_y, mesh))
    b = bn.BatchNorm_0
    return {k: v.detach().cpu() for k, v in (
        ("y", y), ("dx", xs.grad), ("dweight", b.weight.grad),
        ("dbias", b.bias.grad), ("running_mean", b.running_mean),
        ("running_var", b.running_var))}


def _all_reduces(trace_dir: str) -> Tuple[int, float]:
    """(count, summed ms) of the all-reduce spans in a trace that
    ``trace_context`` wrote: the backend's ``gloo:all_reduce`` /
    ``nccl:all_reduce`` annotations on the host timeline (the trace
    mirrors each onto the card's too), each from its enqueue to its end,
    so the wait for the peers counts."""
    with open(os.path.join(trace_dir, TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    spans = [e["dur"] for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and e.get("name", "").endswith(":all_reduce")]
    return len(spans), 1e-3 * sum(spans)


def train_steps(mesh: Mesh, cfg: Config, model_state,
                batches: Sequence[dict], dtype: Optional[torch.dtype] = None,
                warmup: int = 0, trace_dir: Optional[str] = None) -> Dict:
    """``warmup`` untimed, then the rest of ``batches`` timed, through
    ``make_train_step`` from ``model_state``; each global batch padded
    and sharded over the mesh.  With ``trace_dir`` the last batch's step
    runs untimed inside ``trace_context`` (``<trace_dir>/rank<r>``), and
    its all-reduces are counted and timed from that trace.  Returns the
    final model state, the step, the metrics of each step after the
    warm-up, the timed steps and their seconds and kernel launches, and
    the traced step's all-reduces and their ms.  ``dtype=torch.float32``
    turns TF32 off."""
    from tpuseg_torch.runtime.train import make_train_step

    state = _train_state(mesh, cfg, model_state)
    replicate(state, mesh)
    step = make_train_step(cfg, state.model, train_cnn=cfg.train.train_cnn,
                           dtype=dtype)
    gen = torch.Generator(device=mesh.device)
    gen.manual_seed(cfg.train.seed)
    shards = [pad_and_shard(b, mesh) for b in batches]
    timed = shards[warmup:len(shards) - (trace_dir is not None)]
    with _numerics(dtype):
        for b in shards[:warmup]:
            step(state, b, gen)
        _sync(mesh.device)
        before = kernel_launches()
        metrics = []
        t0 = time.perf_counter()
        for b in timed:
            metrics.append(step(state, b, gen)[1])
        _sync(mesh.device)
        seconds = time.perf_counter() - t0
        launches = _since(before)
        collectives, collective_ms = 0, 0.0
        if trace_dir is not None:
            traced = os.path.join(trace_dir, f"rank{mesh.rank}")
            with trace_context(traced):
                metrics.append(step(state, shards[-1], gen)[1])
            collectives, collective_ms = _all_reduces(traced)
    return {
        "model": _cpu_state(state.model), "step": state.step,
        "metrics": [{k: float(v) for k, v in m.items()} for m in metrics],
        "seconds": seconds, "steps": len(timed), "launches": launches,
        "collectives_per_step": collectives,
        "collective_ms_per_step": collective_ms,
    }


def fit_run(mesh: Mesh, cfg: Config, model_state,
            train_batches: Sequence[dict], val_batches: Sequence[dict],
            run_dir: str, n_epochs: int = 1,
            dtype: Optional[torch.dtype] = None) -> Dict:
    """``fit`` from ``model_state`` over the same batches every epoch;
    returns the final model state, the step, the plateau and the kernel
    launches.  ``dtype=torch.float32`` turns TF32 off."""
    from tpuseg_torch.runtime.loop import fit

    state = _train_state(mesh, cfg, model_state)
    before = kernel_launches()
    with _numerics(dtype):
        state = fit(cfg, state.model, state, lambda epoch: train_batches,
                    lambda epoch: val_batches, run_dir, n_epochs=n_epochs,
                    mesh=mesh, dtype=dtype)
    _sync(mesh.device)
    return {"model": _cpu_state(state.model), "step": state.step,
            "lr": state.plateau.lr, "launches": _since(before)}


def in_turn(mesh: Mesh, calls: Sequence[tuple]) -> list:
    """Several tasks one after another in one set of ranks (one spawn):
    ``calls`` holds ``(task, args)`` pairs; returns their results."""
    return [task(mesh, *args) for task, args in calls]
