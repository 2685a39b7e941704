"""Epoch fit loop (port of ``tpuseg/runtime/loop.py::fit``).

Per epoch: train minibatches -> aggregate metrics -> validation pass ->
plateau LR step on the validation cost -> best-val checkpoint keyed on
``ins_dice_loss`` -> CSV/jsonl logging.  With ``debug_dir`` the loop
writes the debug images of one single-glimpse forward every
``debug_every`` train steps.

With ``mesh`` (``parallel.make_mesh`` inside a rank of
``parallel.run_ranks``) the loop runs data-parallel: rank 0's state is
replicated, each batch is padded to a multiple of the ranks (sample 0
repeated) and sharded, the steps average gradients and metrics over the
ranks, and rank 0 alone writes the logs, the live view, TensorBoard, the
checkpoints and the debug dumps while the others wait at a barrier.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from tpuseg_torch.configs import Config
from tpuseg_torch.parallel.mesh import barrier, pad_and_shard, replicate
from tpuseg_torch.runtime.checkpoint import save_checkpoint
from tpuseg_torch.runtime.metrics_log import MetricLogger
from tpuseg_torch.runtime.state import TrainState
from tpuseg_torch.runtime.train import (
    make_debug_step, make_eval_step, make_train_step,
)


def _aggregate(metric_list) -> Dict[str, float]:
    """Per-key mean over the steps; one device-to-host copy per key."""
    if not metric_list:
        return {}
    return {
        k: float(torch.stack([m[k].float() for m in metric_list]).mean())
        for k in metric_list[0]
    }


def _dump_debug(debug_step, state, batch, out_dir: str) -> None:
    """The single-glimpse debug forward on ``batch``, its images for
    sample 0 written to ``out_dir`` (``utils/debug_images.py``)."""
    from tpuseg_torch.utils.debug_images import dump_pyramid_debug

    dbg = debug_step(state, batch)
    host = lambda t: t.detach().float().cpu().numpy()  # noqa: E731
    dump_pyramid_debug(
        out_dir, [host(p) for p in dbg["preds"]],
        [host(t) for t in dbg["targets"]], host(dbg["pro"]),
        host(dbg["sem_mask"]), alpha=host(dbg["alpha"]),
        point=int(dbg["point"][0]),
    )


def fit(
    cfg: Config,
    model,
    state: TrainState,
    train_batches: Callable[[int], Iterable],
    val_batches: Callable[[int], Iterable],
    run_dir: str,
    n_epochs: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    log_every: int = 0,
    mesh=None,
    live: bool = False,
    tensorboard: bool = False,
    debug_dir: Optional[str] = None,
    debug_every: int = 40,
    device_aug: bool = False,
    dtype: Optional[torch.dtype] = None,
) -> TrainState:
    """train_batches / val_batches: callables epoch -> iterable of batch
    dicts (numpy arrays or tensors, ``runtime/train.py`` gives the layout).
    Runs on the device of ``state`` (``create_train_state`` put the model
    there).  ``generator``: the random stream of the run, on that device;
    when None, seeded from ``cfg.train.seed`` (and, on rank r > 0 of a
    mesh, from (seed, r)).  ``dtype=torch.bfloat16`` runs the model under
    autocast.  ``debug_dir``: after train steps 1, 1 + ``debug_every``, ...
    of each epoch, the debug images of that step's batch go to
    ``<debug_dir>/ep<epoch:03d>_it<step:05d>``.  ``mesh``: see the module
    docstring; every rank returns its (identical) state."""
    n_epochs = n_epochs or cfg.train.n_epochs
    lead = mesh is None or mesh.rank == 0
    if generator is None:
        generator = torch.Generator(device=state.device)
        seed = cfg.train.seed
        if not lead:
            seed = int(np.random.SeedSequence([seed, mesh.rank])
                       .generate_state(1)[0])
        generator.manual_seed(seed)
    if mesh is not None:
        replicate(state, mesh)
    train_step = make_train_step(cfg, model, train_cnn=cfg.train.train_cnn,
                                 device_aug=device_aug, dtype=dtype)
    eval_step = make_eval_step(cfg, model, dtype=dtype)
    debug_step = (make_debug_step(cfg, model, dtype=dtype)
                  if debug_dir and lead else None)
    logger = (MetricLogger(run_dir, live=live, tensorboard=tensorboard)
              if lead else None)

    def _prepare(batch):
        return batch if mesh is None else pad_and_shard(batch, mesh)

    best_val = np.inf
    val_key = "ins_dice_loss" if cfg.model.use_instance_segmentation else (
        "dice_cost" if cfg.train.criterion in ("Dice", "Multi") else "ce_cost"
    )

    for epoch in range(n_epochs):
        t0 = time.time()
        train_metrics = []
        for batch in train_batches(epoch):
            batch = _prepare(batch)
            state, m = train_step(state, batch, generator)
            train_metrics.append(m)
            it = len(train_metrics)
            if debug_step is not None and (it - 1) % debug_every == 0:
                _dump_debug(debug_step, state, batch, os.path.join(
                    debug_dir, f"ep{epoch:03d}_it{it:05d}"))
            if lead and log_every and it % log_every == 0:
                print(f"epoch {epoch} it {it}: cost={float(m['cost']):.4f}")
        agg_train = _aggregate(train_metrics)
        if lead:
            logger.log("train", epoch, agg_train, cost_key=val_key)

        val_metrics = [eval_step(state, _prepare(batch), generator)
                       for batch in val_batches(epoch)]
        agg_val = _aggregate(val_metrics)
        if lead:
            logger.log("val", epoch, agg_val, cost_key=val_key)

        val_cost = agg_val.get(val_key, agg_val.get("cost", 0.0))
        state.plateau = state.plateau.step(val_cost)

        if lead:
            dur = time.time() - t0
            print(
                f"Epoch [{epoch}/{n_epochs}] {dur:.1f}s "
                f"train={ {k: round(v, 4) for k, v in agg_train.items()} } "
                f"val={ {k: round(v, 4) for k, v in agg_val.items()} } "
                f"lr={state.plateau.lr:.4g}"
            )
        if val_cost <= best_val:
            best_val = val_cost
            if lead:
                save_checkpoint(
                    os.path.join(
                        os.path.abspath(run_dir),
                        f"model_{epoch}_{val_cost:.8f}_{state.plateau.lr:.4g}",
                    ),
                    state,
                    metadata={"epoch": epoch, "val_cost": float(val_cost)},
                )
        barrier(mesh)
    if lead:
        logger.close()
    return state
