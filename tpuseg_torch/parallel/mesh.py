"""Data-parallel layer (port of ``tpuseg/parallel/mesh.py``).

The JAX package runs data-parallel as one program over a 1-D device mesh:
the state is replicated, each batch is sharded on its leading axis, and
XLA inserts the all-reduces wherever the program reduces over the batch
(gradient and metric means, BatchNorm statistics, the REINFORCE baseline).
Here each rank is a process with its own replica of the state:

* ``run_ranks`` spawns the ranks and joins them, failing the run at the
  first rank that fails (a collective that waits too long for a peer
  fails its rank), with an optional deadline for the whole run; each rank
  joins the default process group and runs ``task(mesh, *args)``;
* ``shard_batch`` gives rank r the rows ``[r*b/N, (r+1)*b/N)`` of the
  global batch, as ``P('data')`` does; ``pad_to_multiple`` first pads a
  batch that does not divide, by repeating sample 0;
* ``replicate`` broadcasts rank 0's state to the others;
* the collectives the model code calls (``batch_sum``, ``batch_mean``,
  ``batch_min``, ``all_reduce_sum``) reduce over the ranks when a process
  group of more than one rank is up, and are the plain local reduction
  otherwise, so one process runs exactly the single-device program.  The
  batch reductions sum over ranks that hold different samples
  (``data_ranks``): under a spatial context (``parallel/spatial.py``),
  whose ranks hold rows of the same samples, they are local.

Backend: NCCL when each rank has a card of its own; gloo when ranks share
a card or run on the CPU (rank r on ``cuda:(r % device_count)``).
"""

from __future__ import annotations

import builtins
import dataclasses
import datetime
import multiprocessing.connection
import os
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from tpuseg_torch import resolve_device

# a rank that dies fails its peers' collectives after this long
COLLECTIVE_TIMEOUT_S = 60.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The 1-D data mesh as one rank sees it."""

    size: int
    rank: int
    device: torch.device


def world_size() -> int:
    """Ranks of the default process group; 1 when none is up."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


_SPATIAL = [False]


def set_spatial(on: bool) -> bool:
    """Mark the ranks as holding rows of the same samples (``True``) or
    different samples; returns the previous mark."""
    old = _SPATIAL[0]
    _SPATIAL[0] = on
    return old


def data_ranks() -> int:
    """Ranks that hold different samples of the global batch: the world,
    or 1 under a spatial context."""
    return 1 if _SPATIAL[0] else world_size()


def rank_device(rank: int, device="cuda") -> torch.device:
    """Rank r's device: ``cuda:(r % device_count)`` or the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def default_backend(n_ranks: int, device="cuda") -> str:
    """NCCL when every rank has a card of its own, else gloo."""
    dev = resolve_device(device)
    if dev.type == "cuda" and n_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def make_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """This process's mesh: inside a rank of ``run_ranks`` its world size,
    rank and device; outside, one rank on ``device``."""
    n = world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"make_mesh({n_devices}) in a process group of {n} "
                         "ranks: start the ranks with run_ranks")
    if n == 1 and not dist.is_initialized():
        return Mesh(1, 0, resolve_device(device))
    rank = dist.get_rank()
    return Mesh(n, rank, rank_device(rank, device))


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0):
    """Pad the batch axis by repeating its first element, so the duplicates
    count in gradients and metrics.  Returns (padded, n_valid)."""
    n = arr.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    pad = np.repeat(np.take(arr, [0], axis=axis), rem, axis=axis)
    return np.concatenate([arr, pad], axis=axis), n


def shard_rows(n_rows: int, mesh: Mesh) -> slice:
    """Rank ``mesh.rank``'s contiguous rows of a global batch of
    ``n_rows`` (a multiple of the mesh size)."""
    if n_rows % mesh.size:
        raise ValueError(f"batch of {n_rows} does not divide over "
                         f"{mesh.size} ranks: pad it (pad_to_multiple)")
    per = n_rows // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's slice of every leaf (a dict of arrays or tensors, or one
    of them), as a tensor on the rank's device."""
    def leaf(x):
        t = x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x))
        return t[shard_rows(t.shape[0], mesh)].to(mesh.device)

    if isinstance(batch, dict):
        return {k: leaf(v) for k, v in batch.items()}
    return leaf(batch)


def pad_and_shard(batch: dict, mesh: Mesh) -> dict:
    """A global batch dict padded to a multiple of the mesh size
    (``pad_to_multiple``), then this rank's shard on its device."""
    host = {k: pad_to_multiple(
        v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v),
        mesh.size)[0] for k, v in batch.items()}
    return shard_batch(host, mesh)


def _flat(tensors: Sequence[torch.Tensor], collective) -> None:
    """``collective(buffer)`` on one flat buffer per dtype of ``tensors``,
    the result copied back into them."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        collective(flat)
        offset = 0
        with torch.no_grad():
            for t in group:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


def replicate(state, mesh: Mesh):
    """Rank 0's state on every rank: a module's parameters and buffers, or
    a ``TrainState``'s model, optimizer slots, schedule and step.  Returns
    the same object."""
    if mesh.size == 1:
        return state
    model = getattr(state, "model", state)
    _flat(list(model.state_dict().values()),
          lambda flat: dist.broadcast(flat, src=0))
    if model is not state:
        host = None
        if mesh.rank == 0:
            host = {"optimizer": _to_cpu(state.optimizer.state_dict()),
                    "plateau": state.plateau, "step": state.step}
        box = [host]
        dist.broadcast_object_list(box, src=0)
        if mesh.rank != 0:
            state.optimizer.load_state_dict(box[0]["optimizer"])
            state.plateau = box[0]["plateau"]
            state.step = box[0]["step"]
    return state


def _to_cpu(obj):
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


# ------------------------- collectives -------------------------------

class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose backward sums the cotangents over the
    ranks: each rank's input feeds every rank's loss."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks (``x`` with one rank)."""
    return _AllReduceSum.apply(x) if world_size() > 1 else x


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over dim 0 of the global batch."""
    if data_ranks() == 1:
        return x.sum(dim=0)
    return all_reduce_sum(x.sum(dim=0))


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over dim 0 of the global batch (equal shards on every rank)."""
    n = data_ranks()
    if n == 1:
        return x.mean(dim=0)
    return all_reduce_sum(x.sum(dim=0)) / (x.shape[0] * n)


def batch_min(x: torch.Tensor) -> torch.Tensor:
    """Minimum of the global batch (no gradient)."""
    m = x.min()
    if data_ranks() > 1:
        m = m.clone()
        dist.all_reduce(m, op=dist.ReduceOp.MIN)
    return m


def mean_over_ranks_(tensors: Sequence[torch.Tensor]) -> None:
    """Each tensor replaced by its mean over the ranks, in place, through
    one all-reduce per dtype of a flat buffer."""
    n = world_size()
    if n > 1 and tensors:
        _flat(tensors, lambda flat: (dist.all_reduce(flat), flat.div_(n)))


def barrier(mesh: Optional[Mesh]) -> None:
    if mesh is not None and mesh.size > 1:
        dist.barrier()


# --------------------------- launcher --------------------------------

_FOREIGN = ("jax", "jaxlib", "flax", "tpuseg")


def _foreign_modules() -> List[str]:
    """The modules of JAX, flax or the JAX package loaded in this process.
    TensorFlow (TensorBoard's backend where it is installed) loads JAX
    itself; that JAX is not the port's (``_watch_imports`` sees the port's
    own imports of JAX whoever loaded it first)."""
    roots = _FOREIGN[2:] if "tensorflow" in sys.modules else _FOREIGN
    return sorted(m for m in sys.modules if m.split(".")[0] in roots)


def _watch_imports(task: Callable) -> List[str]:
    """From here on, every ``import`` statement in the port or in the
    task's module that names JAX, flax or the JAX package is appended to
    the returned list, whether or not the module is loaded already."""
    ours = {"tpuseg_torch", "__main__", "__mp_main__",
            task.__module__.split(".")[0]}
    seen: List[str] = []
    real = builtins.__import__

    def watched(name, globals=None, locals=None, fromlist=(), level=0):
        importer = (globals or {}).get("__name__", "")
        if (level == 0 and name.split(".")[0] in _FOREIGN
                and importer.split(".")[0] in ours):
            seen.append(f"{name} (by {importer})")
        return real(name, globals, locals, fromlist, level)

    builtins.__import__ = watched
    return seen


def _rank_entry(rank, world, init_method, device_type, backend, threads,
                collective_timeout, task, args, out_path):
    # the task's module (imported to unpickle the task) loaded before this
    loaded = _foreign_modules()
    seen = _watch_imports(task)
    torch.set_num_threads(threads)
    device = rank_device(rank, device_type)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    try:
        dist.init_process_group(
            backend, init_method=init_method, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=collective_timeout),
            device_id=device if backend == "nccl" else None)
        dist.barrier()  # every rank is up (and the backend's collectives run)
        result = task(make_mesh(world, device_type), *args)
        foreign = sorted(set(loaded + _foreign_modules() + seen))
        if foreign:
            raise RuntimeError(f"rank {rank} imported {foreign[:5]}: the "
                               "port's ranks run the port alone")
        torch.save({"ok": True, "result": result}, out_path)
    except BaseException:
        torch.save({"ok": False, "error": traceback.format_exc()}, out_path)
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _load_result(path: str, rank: int):
    if not os.path.exists(path):
        return {"ok": False, "error": f"rank {rank} wrote no result"}
    # only this launcher's ranks write these files
    return torch.load(path, map_location="cpu", weights_only=False)


def run_ranks(task: Callable, n_ranks: int, args: Sequence = (),
              device="cuda", backend: Optional[str] = None,
              timeout: Optional[float] = None,
              collective_timeout: float = COLLECTIVE_TIMEOUT_S) -> List[Any]:
    """Run ``task(mesh, *args)`` on ``n_ranks`` spawned processes, each in
    the default process group (rendezvous through a file in a fresh
    temporary directory), and return the ranks' results in rank order.

    ``task`` and ``args`` are pickled (a task is a module-level function of
    an importable module).  A rank that raises or dies fails the run at
    once, the others are killed; so does a rank whose collective waits
    ``collective_timeout`` seconds for a peer, and a run that outlasts
    ``timeout`` seconds (None: no deadline for the whole run).  Each rank
    gets this process's torch threads divided among the ranks."""
    device_type = resolve_device(device).type
    backend = backend or default_backend(n_ranks, device_type)
    cards = torch.cuda.device_count() if device_type == "cuda" else 0
    print(f"data-parallel: {n_ranks} ranks on "
          f"{f'{cards} card(s)' if cards else 'the CPU'}, backend {backend}",
          flush=True)
    threads = max(1, torch.get_num_threads() // n_ranks)
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="tpuseg_ranks_") as tmp:
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(n_ranks)]
        procs = [ctx.Process(target=_rank_entry, args=(
            r, n_ranks, init, device_type, backend, threads,
            collective_timeout, task, tuple(args), outs[r]))
            for r in range(n_ranks)]
        for p in procs:
            p.start()
        try:
            _join(procs, outs, timeout)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(10)
        results = [_load_result(path, r) for r, path in enumerate(outs)]
    for r, res in enumerate(results):
        if not res["ok"]:
            raise RuntimeError(f"rank {r} failed:\n{res['error']}")
    return [res["result"] for res in results]


def _join(procs, outs, timeout: Optional[float]) -> None:
    """Wait for every rank; raise at the first that exits non-zero or when
    ``timeout`` (None: none) runs out."""
    deadline = None if timeout is None else time.monotonic() + timeout
    live = {p.sentinel: (r, p) for r, p in enumerate(procs)}
    while live:
        left = None if deadline is None else deadline - time.monotonic()
        if left is not None and left <= 0:
            raise TimeoutError(
                f"ranks {sorted(r for r, _ in live.values())} still running "
                f"after {timeout:.0f} s")
        for s in multiprocessing.connection.wait(list(live), timeout=left):
            r, p = live.pop(s)
            p.join()
            if p.exitcode != 0:
                err = _load_result(outs[r], r).get("error", "")
                raise RuntimeError(
                    f"rank {r} exited with code {p.exitcode}\n{err}")
