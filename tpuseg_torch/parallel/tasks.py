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
    paths in this process (the split entry points of ``masked_softmax``
    that spatial training runs counted apart)."""
    return {"masked_softmax_forward": masked_softmax.forward_launches,
            "masked_softmax_backward": masked_softmax.backward_launches,
            "masked_softmax_split_forward":
                masked_softmax.split_forward_launches,
            "masked_softmax_split_backward":
                masked_softmax.split_backward_launches,
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


def _rows_or_samples(mesh: Mesh, t: np.ndarray, rows: bool) -> torch.Tensor:
    """This rank's rows (dim 2) or samples (dim 0) of an NCHW array."""
    if not rows:
        return shard_batch(t, mesh)
    per = t.shape[2] // mesh.size
    return torch.from_numpy(np.ascontiguousarray(
        t[:, :, mesh.rank * per:(mesh.rank + 1) * per])).to(mesh.device)


def masked_batch_norm_grads(mesh: Mesh, x: np.ndarray, mask: np.ndarray,
                            grad_y: np.ndarray, rows: bool) -> Dict:
    """One train-mode ``MaskedBatchNorm`` forward and backward on this
    rank's share of ``x`` (N, C, H, W) and ``mask`` (N, 1, H, W) with the
    cotangent ``grad_y``: its rows of the same samples (``rows``, under a
    spatial context) or its samples (data parallel).  Returns this rank's
    share of y and dx, its share of the scale and bias gradients and the
    running statistics after the update."""
    from tpuseg_torch.nn.attention import MaskedBatchNorm
    from tpuseg_torch.parallel import spatial

    bn = MaskedBatchNorm(x.shape[1]).to(mesh.device).train()
    xs = _rows_or_samples(mesh, x, rows).requires_grad_()
    ctx = (spatial.spatial_context(mesh, x.shape[2]) if rows
           else contextlib.nullcontext())
    with ctx:
        y = bn(xs, _rows_or_samples(mesh, mask, rows))
        y.backward(_rows_or_samples(mesh, grad_y, rows))
    return {k: v.detach().cpu() for k, v in (
        ("y", y), ("dx", xs.grad), ("dscale", bn.scale.grad),
        ("dbias", bn.bias.grad), ("mean", bn.mean), ("var", bn.var))}


def split_masked_softmax(mesh: Mesh, e: np.ndarray, mask: np.ndarray,
                         grad_p: np.ndarray) -> Dict:
    """``spatial.masked_softmax`` on this rank's rows of the score ``e``
    (B, 1, H, W) and the instance masks (B, N, H, W), then its backward
    with the cotangent ``grad_p``: this rank's rows of p and de, and the
    split entry points' launches."""
    from tpuseg_torch.parallel import spatial

    es = _rows_or_samples(mesh, e, True).requires_grad_()
    ms = _rows_or_samples(mesh, mask, True)
    b, n, h, w = ms.shape
    before = kernel_launches()
    with spatial.spatial_context(mesh, e.shape[2]):
        p = spatial.masked_softmax(es.reshape(b, h * w),
                                   ms.reshape(b, n, h * w))
        p.backward(_rows_or_samples(mesh, grad_p, True).reshape(b, n, h * w))
    _sync(mesh.device)
    return {"p": p.detach().reshape(b, n, h, w).cpu(),
            "de": es.grad.cpu(), "launches": _since(before)}


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


def pred_list_rank(mesh: Mesh, cfg: Config, model_state, paths: Sequence[str],
                   batch_size: int, output_path: str, predictor_kw: Dict,
                   bucketed: bool = False) -> Dict:
    """``pred_list --ndevices N``'s rank: its shard of ``paths``
    (``cli/pred_list.py::list_shard``) through its own ``Predictor`` on its
    device, each image's files written.  Returns the images written, the
    extraction rounds run, the kernel launches and the seconds its images
    took (reading, inference, writing)."""
    from tpuseg_torch.cli.pred_list import list_shard, predict_and_write
    from tpuseg_torch.models import ReSeg
    from tpuseg_torch.runtime.predict import Predictor

    mine = list(paths)[list_shard(len(paths), batch_size, mesh)]
    if not mine:
        return {"images": 0, "rounds": 0, "seconds": 0.0,
                "launches": _since(kernel_launches())}
    model = ReSeg(cfg)
    model.load_state_dict(model_state)
    predictor = Predictor(cfg, model, batch_size=batch_size,
                          device=mesh.device, **predictor_kw)
    before = kernel_launches()
    t0 = time.perf_counter()
    n = predict_and_write(predictor, mine, output_path, bucketed)
    _sync(mesh.device)
    return {"images": n, "rounds": predictor.rounds_run,
            "launches": _since(before), "seconds": time.perf_counter() - t0}


def timed_inference(mesh: Mesh, cfg: Config, model_state, images: np.ndarray,
                    batch_size: int, repeats: int, stop_params=None) -> Dict:
    """This rank's run of the whole batches of ``images`` that
    ``cli/pred_list.py::list_shard`` gives it, through its own bf16
    ``Predictor``: one warm-up batch, then ``repeats`` passes, each started
    with every rank at a barrier and timed to its synchronised end.
    Returns the images and each pass's seconds."""
    from tpuseg_torch.cli.pred_list import list_shard
    from tpuseg_torch.parallel.mesh import barrier
    from tpuseg_torch.runtime.predict import Predictor

    mine = images[list_shard(len(images), batch_size, mesh)]
    pred = Predictor(cfg, _model(mesh, cfg, model_state),
                     batch_size=batch_size, device=mesh.device,
                     stop_params=stop_params)
    batches = [mine[i:i + batch_size] for i in range(0, len(mine), batch_size)]
    if batches:
        pred.predict_batch_packed(batches[0])
    seconds = []
    for _ in range(repeats):
        barrier(mesh)
        _sync(mesh.device)
        t0 = time.perf_counter()
        for b in batches:
            packed, counts = pred.predict_batch_packed(b)
            packed.cpu(), counts.cpu()
        _sync(mesh.device)
        seconds.append(time.perf_counter() - t0)
    return {"images": len(mine), "seconds": seconds}


def _model(mesh: Mesh, cfg: Config, model_state):
    from tpuseg_torch.models import ReSeg

    model = ReSeg(cfg)
    model.load_state_dict(model_state)
    return model.to(mesh.device)


def _comms(record: bool):
    from tpuseg_torch.parallel import spatial

    return spatial.recording() if record else contextlib.nullcontext([])


def spatial_semantic(mesh: Mesh, cfg: Config, model_state,
                     images: np.ndarray, dtype: Optional[torch.dtype] = None,
                     record: bool = False) -> Dict:
    """``make_semantic_spatial`` on this rank's rows of ``images`` (B, H, W,
    3) uint8: its rows of the probabilities and, with ``record``, the
    tensors the ranks moved.  One rank: the whole image in one process."""
    from tpuseg_torch.parallel import spatial

    fn = spatial.make_semantic_spatial(_model(mesh, cfg, model_state), mesh,
                                       dtype)
    x = spatial.shard_spatial(images, mesh)
    with _comms(record) as log:
        probs = fn(x)
    return {"probs": probs.cpu(), "comms": list(log)}


def spatial_infer(mesh: Mesh, cfg: Config, model_state, batches,
                  max_instances: Optional[int] = None, stop_params=None,
                  dtype: Optional[torch.dtype] = None, record: bool = False,
                  timed: int = 0) -> Dict:
    """``make_infer_spatial`` on this rank's rows of each batch of
    ``batches`` (each (B, H, W, 3) uint8): per batch its rows of sem_probs
    and of the id map and the counts; the kernel launches and the
    extraction rounds of that pass; with ``record`` the tensors moved;
    then ``timed`` more passes over the batches, their ms a batch.  One
    rank: the whole image in one process."""
    from tpuseg_torch.parallel import spatial

    fn = spatial.make_infer_spatial(_model(mesh, cfg, model_state), mesh,
                                    max_instances, stop_params, dtype)
    shards = [spatial.shard_spatial(b, mesh) for b in batches]
    before = kernel_launches()
    outs = []
    with _comms(record) as log:
        for x in shards:
            sem, idmap, counts = fn(x)
            outs.append({"sem": sem.cpu(), "idmap": idmap.cpu(),
                         "counts": counts.cpu()})
    _sync(mesh.device)
    res = {"outs": outs, "launches": _since(before),
           "rounds": fn.rounds_run, "comms": list(log)}
    if timed:
        t0 = time.perf_counter()
        for _ in range(timed):
            for x in shards:
                fn(x)[2].cpu()
        _sync(mesh.device)
        res["ms_per_batch"] = 1e3 * (time.perf_counter() - t0) / (
            timed * len(shards))
    return res


def spatial_train(mesh: Mesh, cfg: Config, model_state,
                  batches: Sequence[dict], dtype: Optional[torch.dtype] = None,
                  record: bool = False) -> Dict:
    """``make_train_spatial`` over ``batches`` (each a global batch, the JAX
    layout) from ``model_state``, every rank's generator seeded alike:
    the final model state, each step's metrics, the kernel launches and,
    with ``record``, the tensors moved.  ``dtype=torch.float32`` turns TF32
    off.  One rank: the whole image in one process."""
    from tpuseg_torch.parallel import spatial

    state = _train_state(mesh, cfg, model_state)
    spatial.replicate_state(state, mesh)
    step = spatial.make_train_spatial(cfg, state.model, mesh,
                                      train_cnn=cfg.train.train_cnn,
                                      dtype=dtype)
    gen = torch.Generator(device=mesh.device)
    gen.manual_seed(cfg.train.seed)
    before = kernel_launches()
    metrics = []
    with _numerics(dtype), _comms(record) as log:
        for b in batches:
            metrics.append(step(state, b, gen)[1])
    _sync(mesh.device)
    return {"model": _cpu_state(state.model), "step": state.step,
            "metrics": [{k: float(v) for k, v in m.items()} for m in metrics],
            "launches": _since(before), "comms": list(log)}


def spatial_window_origin_fg(mesh: Mesh, fg_mask: np.ndarray,
                             point_flat: np.ndarray, win: int, stride: int,
                             group: int) -> Dict:
    """``decode_split(fg_mask=)``'s window origins
    (``pyramid.window_origin_fg``) from this rank's rows of the remaining
    foreground ``fg_mask`` (B, 1, H, W) for the glimpses ``point_flat``
    (B*group,): (ir, ic) and the tensors the ranks moved.  One rank: the
    whole mask in one process."""
    from tpuseg_torch.decoder.pyramid import window_origin_fg
    from tpuseg_torch.parallel import spatial

    h, w = fg_mask.shape[2:]
    rows = _rows_or_samples(mesh, fg_mask, True)
    pts = torch.from_numpy(point_flat).to(mesh.device)
    with _comms(True) as log, spatial.spatial_context(mesh, h):
        ir, ic, _, _, _ = window_origin_fg(pts, (h, w), win, stride, rows,
                                           group)
    return {"ir": ir.cpu(), "ic": ic.cpu(), "comms": list(log)}


def in_turn(mesh: Mesh, calls: Sequence[tuple]) -> list:
    """Several tasks one after another in one set of ranks (one spawn):
    ``calls`` holds ``(task, args)`` pairs; returns their results."""
    return [task(mesh, *args) for task, args in calls]
