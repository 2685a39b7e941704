"""Training state: model + optimizer + LR plateau (port of
``tpuseg/runtime/state.py``).

The JAX package threads immutable pytrees (params, batch_stats,
decoder_state, opt_state) through a jitted step; here the ``ReSeg`` module
holds parameters, BatchNorm statistics and the REINFORCE baseline, the
``torch.optim`` optimizer holds its slots, and a step updates both in
place.  The optimizer chain is the JAX one:

    clip the ``density_head`` gradients alone to ``clip_grad_norm``
    -> clip all gradients by their global norm
    -> Adadelta(rho 0.9, eps 1e-6) | Adam | RMSprop | SGD(momentum 0.9), at
       learning rate 1 with L2 weight decay added to the gradient
    -> the plateau's ``lr`` scales the update.

With ``cfg.train.train_cnn`` off the ``base`` subtree gets no update at
all, weight decay included.  (RMSprop differs from optax's in one detail:
torch adds ``eps`` outside the square root, optax inside.)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from segbench.reference import resolve_device
from segbench.reference.configs import Config


@dataclasses.dataclass
class PlateauState:
    """``torch.optim.lr_scheduler.ReduceLROnPlateau(mode="min")`` semantics:
    relative threshold 1e-4, ``best`` moves only on improvement, the rate
    drops once ``num_bad`` exceeds ``patience``."""

    lr: float
    best: float = float("inf")
    num_bad: int = 0
    factor: float = 0.5
    patience: int = 25
    threshold: float = 1e-4

    @classmethod
    def create(cls, lr: float, factor: float, patience: int) -> "PlateauState":
        return cls(lr=float(lr), factor=factor, patience=patience)

    def step(self, metric) -> "PlateauState":
        metric = float(metric)
        improved = metric < self.best * (1.0 - self.threshold)
        num_bad = 0 if improved else self.num_bad + 1
        lr = self.lr
        if num_bad > self.patience:
            lr, num_bad = lr * self.factor, 0
        return dataclasses.replace(
            self, lr=lr, best=metric if improved else self.best,
            num_bad=num_bad)


def trainable_parameters(cfg: Config, model) -> List[torch.nn.Parameter]:
    """The parameters the optimizer updates: all, or all but ``base``."""
    if cfg.train.train_cnn:
        return list(model.parameters())
    frozen = {id(p) for p in model.base.parameters()}
    return [p for p in model.parameters() if id(p) not in frozen]


def make_optimizer(cfg: Config, model) -> torch.optim.Optimizer:
    """{adadelta|adam|rmsprop|sgd} at learning rate 1 with L2 weight decay;
    the clips and the plateau scale are applied by
    ``TrainState.apply_gradients``."""
    t = cfg.train
    params = trainable_parameters(cfg, model)
    name = t.optimizer.lower()
    if name == "adadelta":
        return torch.optim.Adadelta(params, lr=1.0, rho=0.9, eps=1e-6,
                                    weight_decay=t.weight_decay)
    if name == "adam":
        return torch.optim.Adam(params, lr=1.0, weight_decay=t.weight_decay)
    if name == "rmsprop":
        return torch.optim.RMSprop(params, lr=1.0, alpha=0.9, eps=1e-8,
                                   weight_decay=t.weight_decay)
    if name == "sgd":
        return torch.optim.SGD(params, lr=1.0, momentum=0.9,
                               weight_decay=t.weight_decay)
    raise ValueError(t.optimizer)


def global_norm(grads) -> torch.Tensor:
    """The 2-norm over a list of tensors, as a 0-dim float32 tensor (a
    handful of launches whatever the list's length)."""
    return torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm([g.float() for g in grads])))


def _clip_(grads, max_norm: float) -> None:
    """optax ``clip_by_global_norm`` in place: untouched below the bound,
    else scaled to it.  No host sync."""
    if not grads:
        return
    norm = global_norm(grads)
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale)


class TrainState:
    """Everything a checkpoint holds: ``model`` (parameters, BatchNorm
    statistics, the decoder's baseline), ``optimizer``, ``plateau``,
    ``step``."""

    def __init__(self, cfg: Config, model, optimizer, plateau: PlateauState,
                 step: int = 0):
        self.cfg = cfg
        self.model = model
        self.optimizer = optimizer
        self.plateau = plateau
        self.step = step

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def apply_gradients(self) -> None:
        """One optimizer step from the ``.grad`` fields (see the module
        docstring for the chain); clears them."""
        clip = self.cfg.train.clip_grad_norm
        model = self.model
        if clip:
            if hasattr(model, "density_head"):
                _clip_([p.grad for p in model.density_head.parameters()
                        if p.grad is not None], clip)
            _clip_([p.grad for p in model.parameters()
                    if p.grad is not None], clip)
        for group in self.optimizer.param_groups:
            group["lr"] = self.plateau.lr
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        model.zero_grad(set_to_none=True)
        self.step += 1

    def state_dict(self) -> Dict:
        return {
            "step": self.step,
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "plateau": dataclasses.asdict(self.plateau),
        }

    def load_state_dict(self, sd: Dict) -> None:
        self.step = int(sd["step"])
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.plateau = PlateauState(**sd["plateau"])


def create_train_state(cfg: Config, model, device="cuda") -> TrainState:
    """Move ``model`` (float32, weights loaded or freshly initialised) to
    ``device`` and give it an optimizer and a plateau schedule.  Raises
    when CUDA is asked for but absent."""
    model = model.to(resolve_device(device)).float()
    return TrainState(
        cfg, model, make_optimizer(cfg, model),
        PlateauState.create(cfg.train.learning_rate, cfg.train.lr_drop_factor,
                            cfg.train.lr_drop_patience),
    )
