"""Train and eval steps (port of ``tpuseg/runtime/train.py``).

Total cost = instance decoder loss + count CE + density terms + semantic
CE + semantic Dice(time=1) under criterion ``Multi``; gradient clipping
inside the optimizer chain (``runtime/state.py``); BatchNorm statistics and
the REINFORCE baseline live in the model and move in place.

Batches keep the JAX package's layout: ``images (B, H, W, 3)`` uint8 (or
the 21 standardised channels), ``sem_onehot (B, H, W, C)``, ``ins_masks
(B, H, W, N)``, ``n_objects (B,)``, numpy arrays or tensors.  The model
side is NCHW.  Every random draw of a step (instance order, glimpse
sampling, dropout) comes from the ``torch.Generator`` handed to it, which
lies on the step's device.

Under data parallelism (a process group of several ranks, each with its
shard of the global batch: ``parallel/``) a step is the JAX mesh step:
the gradients are averaged over the ranks as one flat all-reduce before
the clips and the optimizer see them, and the metrics are averaged too, so
every rank logs and schedules on the global values.  Under spatial
sharding (``parallel/spatial.py::make_train_spatial``) the same step runs
on each rank's rows of the same samples: the losses are the whole image's
on every rank, and the average of the ranks' gradients is the gradient.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from segbench.reference.configs import Config
from segbench.reference.data.colorspace import image_ex_standardize
from segbench.reference.losses.dice import dice_loss
from segbench.reference.losses.focal import softmax_cross_entropy
from segbench.reference.parallel import spatial
from segbench.reference.parallel.mesh import mean_over_ranks_, world_size
from segbench.reference.runtime.state import TrainState, global_norm


def prepare_images(images: torch.Tensor) -> torch.Tensor:
    """Raw uint8 RGB batches are expanded to the 21 standardised channels
    on the device; already expanded inputs pass through.  (B, H, W, 3|21)."""
    if images.shape[-1] == 3:
        return image_ex_standardize(images)
    return images


def upload(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A batch dict's four arrays as tensors on ``device`` (NHWC kept)."""
    def dev(v):
        t = v if torch.is_tensor(v) else torch.from_numpy(np.ascontiguousarray(v))
        return t.to(device, non_blocking=True)

    return {k: dev(batch[k])
            for k in ("images", "sem_onehot", "ins_masks", "n_objects")}


def model_inputs(batch: Dict, device) -> Tuple[torch.Tensor, ...]:
    """A batch dict -> the model's NCHW tensors on ``device``: (images
    (B, 21, H, W) channels_last, sem_onehot (B, C, H, W), ins_masks
    (B, N, H, W) contiguous float32, n_objects (B,) int64)."""
    b = upload(batch, device)
    images = prepare_images(b["images"]).float().permute(0, 3, 1, 2)
    images = images.contiguous(memory_format=torch.channels_last)
    sem = b["sem_onehot"].float().permute(0, 3, 1, 2)
    ins = b["ins_masks"].float().permute(0, 3, 1, 2).contiguous()
    return images, sem, ins, b["n_objects"].long()


def total_cost(cfg: Config, sem_logits, sem_onehot, dec_losses, train: bool,
               n_objects=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Instance cost + count-head CE + density terms + semantic CE + Dice
    per the criterion.  sem_logits / sem_onehot are (B, C, H, W).  Returns
    (cost, metrics); the metrics are detached."""
    del train  # the JAX signature; nothing here depends on it
    metrics: Dict[str, torch.Tensor] = {}
    cost = 0.0
    if dec_losses is not None:
        cost = cost + dec_losses["loss"]
        metrics["ins_cost"] = dec_losses["loss"]
        metrics["criterion"] = dec_losses["criterion"]
        metrics["ins_ce_loss"] = dec_losses["ins_ce_loss"]
        metrics["ins_dice_loss"] = dec_losses["ins_dice_loss"]
        if "count_logits" in dec_losses and n_objects is not None:
            logits = dec_losses["count_logits"]
            labels = n_objects.long().clamp(0, logits.shape[-1] - 1)
            with spatial.local():  # one row per sample, not pixels
                count_ce = softmax_cross_entropy(logits, labels)
            cost = cost + cfg.train.lambda_count * count_ce
            metrics["count_loss"] = count_ce
            metrics["count_err"] = (
                (logits.argmax(dim=-1) - n_objects).abs().float().mean())
        if "density_loss" in dec_losses:
            dl = (dec_losses["density_loss"]
                  + 0.1 * dec_losses["density_count_loss"])
            cost = cost + cfg.train.lambda_density * dl
            metrics["density_loss"] = dl
            if n_objects is not None:
                metrics["density_err"] = (
                    torch.round(dec_losses["density_count"])
                    - n_objects.float()).abs().mean()
    crit = cfg.train.criterion
    n_classes = cfg.data.n_classes
    if crit in ("CE", "Multi"):
        labels = sem_onehot.argmax(dim=1).reshape(-1)
        ce = softmax_cross_entropy(
            sem_logits.permute(0, 2, 3, 1).reshape(-1, n_classes), labels,
            cfg.data.class_weights)
        cost = cost + ce
        metrics["ce_cost"] = ce
    if crit in ("Dice", "Multi"):
        d = dice_loss(sem_logits, sem_onehot,
                      optimize_bg=cfg.train.optimize_bg, smooth=1.0, time=1)
        cost = cost + d
        metrics["dice_cost"] = d
    metrics["cost"] = cost
    return cost, {k: v.detach() for k, v in metrics.items()}


def _autocast(device: torch.device, dtype: Optional[torch.dtype]):
    if dtype in (None, torch.float32):
        return contextlib.nullcontext()
    if dtype != torch.bfloat16:
        raise ValueError(f"unsupported compute dtype {dtype}")
    return torch.autocast(device.type, dtype=torch.bfloat16)


def _forward(cfg, model, batch, device, dtype, generator, train: bool):
    images, sem, ins, n_obj = model_inputs(batch, device)
    with _autocast(device, dtype):
        sem_logits, _, dec_losses = model.loss(images, sem, ins, n_obj,
                                               generator=generator)
    # the model may compute in bfloat16 (parameters and optimizer stay
    # float32); the losses are always accumulated in float32
    return total_cost(cfg, sem_logits.float(), sem, dec_losses, train=train,
                      n_objects=n_obj)


def _mean_over_ranks(metrics: Dict[str, torch.Tensor]) -> None:
    """Each metric replaced by its mean over the ranks (in one all-reduce),
    in place."""
    if world_size() > 1:
        for k, v in metrics.items():
            metrics[k] = v.float().clone()
        mean_over_ranks_(list(metrics.values()))


def make_train_step(cfg: Config, model, train_cnn: bool = True,
                    dtype: Optional[torch.dtype] = None):
    """Returns ``train_step(state, batch, generator) -> (state, metrics)``.

    ``state.model`` must be ``model``; the step updates it (and the
    optimizer) in place and returns the same state object.  The metrics
    are 0-dim tensors on the device, ``grad_norm`` (the norm of the raw
    gradients, before any clip) among them.  ``train_cnn=False`` zeroes
    the ``base`` gradients.  ``dtype=torch.bfloat16`` runs the model under
    ``torch.autocast``.

    With ``cfg.decoder.hoist_skips_train`` the decoder's skip transforms
    run once per step and feed every glimpse; their BatchNorm statistics
    take the one update as ``max_iter`` identical ones (exact at
    ``drop_rate`` 0), which is what the JAX package's two-apply step ends
    with."""

    def train_step(state: TrainState, batch, generator):
        if state.model is not model:
            raise ValueError("train_step: the state holds another model")
        model.train()
        model.zero_grad(set_to_none=True)
        cost, metrics = _forward(cfg, model, batch, state.device, dtype,
                                 generator, train=True)
        cost.backward()
        _mean_over_ranks(metrics)
        mean_over_ranks_([p.grad for p in model.parameters()
                          if p.grad is not None])
        if not train_cnn:
            for p in model.base.parameters():
                if p.grad is not None:
                    p.grad.zero_()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        metrics["grad_norm"] = global_norm(grads)
        state.apply_gradients()
        return state, metrics

    return train_step

