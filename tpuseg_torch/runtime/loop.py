"""Epoch fit loop (port of ``tpuseg/runtime/loop.py::fit``).

Per epoch: train minibatches -> aggregate metrics -> validation pass ->
plateau LR step on the validation cost -> best-val checkpoint keyed on
``ins_dice_loss`` -> CSV/jsonl logging.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from tpuseg_torch.configs import Config
from tpuseg_torch.runtime.checkpoint import save_checkpoint
from tpuseg_torch.runtime.metrics_log import MetricLogger
from tpuseg_torch.runtime.state import TrainState
from tpuseg_torch.runtime.train import make_eval_step, make_train_step


def _aggregate(metric_list) -> Dict[str, float]:
    """Per-key mean over the steps; one device-to-host copy per key."""
    if not metric_list:
        return {}
    return {
        k: float(torch.stack([m[k].float() for m in metric_list]).mean())
        for k in metric_list[0]
    }


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
    device_aug: bool = False,
    dtype: Optional[torch.dtype] = None,
) -> TrainState:
    """train_batches / val_batches: callables epoch -> iterable of batch
    dicts (numpy arrays or tensors, ``runtime/train.py`` gives the layout).
    Runs on the device of ``state`` (``create_train_state`` put the model
    there).  ``generator``: the random stream of the run, on that device;
    seeded from ``cfg.train.seed`` when None.  ``dtype=torch.bfloat16``
    runs the model under autocast.  Data-parallel meshes and the debug
    image dumps are later slices of the port."""
    if mesh is not None:
        raise NotImplementedError(
            "data-parallel fit (mesh) is a later slice of the port")
    if debug_dir is not None:
        raise NotImplementedError(
            "the debug mode and its image dumps are a later slice of the port")
    n_epochs = n_epochs or cfg.train.n_epochs
    if generator is None:
        generator = torch.Generator(device=state.device)
        generator.manual_seed(cfg.train.seed)
    train_step = make_train_step(cfg, model, train_cnn=cfg.train.train_cnn,
                                 device_aug=device_aug, dtype=dtype)
    eval_step = make_eval_step(cfg, model, dtype=dtype)
    logger = MetricLogger(run_dir, live=live, tensorboard=tensorboard)
    best_val = np.inf
    val_key = "ins_dice_loss" if cfg.model.use_instance_segmentation else (
        "dice_cost" if cfg.train.criterion in ("Dice", "Multi") else "ce_cost"
    )

    for epoch in range(n_epochs):
        t0 = time.time()
        train_metrics = []
        for batch in train_batches(epoch):
            state, m = train_step(state, batch, generator)
            train_metrics.append(m)
            if log_every and len(train_metrics) % log_every == 0:
                print(f"epoch {epoch} it {len(train_metrics)}: "
                      f"cost={float(m['cost']):.4f}")
        agg_train = _aggregate(train_metrics)
        logger.log("train", epoch, agg_train, cost_key=val_key)

        val_metrics = [eval_step(state, batch, generator)
                       for batch in val_batches(epoch)]
        agg_val = _aggregate(val_metrics)
        logger.log("val", epoch, agg_val, cost_key=val_key)

        val_cost = agg_val.get(val_key, agg_val.get("cost", 0.0))
        state.plateau = state.plateau.step(val_cost)

        dur = time.time() - t0
        print(
            f"Epoch [{epoch}/{n_epochs}] {dur:.1f}s "
            f"train={ {k: round(v, 4) for k, v in agg_train.items()} } "
            f"val={ {k: round(v, 4) for k, v in agg_val.items()} } "
            f"lr={state.plateau.lr:.4g}"
        )

        if val_cost <= best_val:
            best_val = val_cost
            save_checkpoint(
                os.path.join(
                    os.path.abspath(run_dir),
                    f"model_{epoch}_{val_cost:.8f}_{state.plateau.lr:.4g}",
                ),
                state, metadata={"epoch": epoch, "val_cost": float(val_cost)},
            )
    logger.close()
    return state
