"""The reference's entry points: its configuration from a configuration
file, its model from the checkpoint, one inference batch and the training
steps, in float32 with TF32 off (or, where asked, in bfloat16 as the
program's configuration runs it)."""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from segbench.reference.configs import config as C
from segbench.reference.data.colorspace import image_ex_standardize
from segbench.reference.models import ReSeg
from segbench.reference.runtime.state import create_train_state
from segbench.reference.runtime.train import make_train_step
from segbench.reference.utils.checkpoint_io import (
    adapt_cfg_to_checkpoint, load_stop_params, read_msgpack,
)
from segbench.reference.weights import load_flax

_GROUPS = {"data": C.DataConfig, "model": C.ModelConfig,
           "decoder": C.DecoderConfig, "train": C.TrainConfig,
           "eval": C.EvalConfig}


def _field(value):
    return tuple(value) if isinstance(value, list) else value


def make_config(groups: Dict) -> C.Config:
    """The configuration tree of a configuration file's ``config`` groups;
    every field of every group has to be given."""
    parts = {}
    for name, cls in _GROUPS.items():
        given = groups[name]
        names = {f.name for f in dataclasses.fields(cls)}
        if set(given) != names:
            raise ValueError(f"config group {name}: fields differ: "
                             f"{sorted(set(given) ^ names)}")
        parts[name] = cls(**{k: _field(v) for k, v in given.items()})
    return C.Config(**parts)


@contextlib.contextmanager
def full_float32():
    """cuDNN convolutions and CUDA matmuls in full float32 inside the
    block; the previous settings restored after it."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    before = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = before


def load_model(groups: Dict, checkpoint: str, device) -> tuple:
    """(config, float32 ``ReSeg`` on ``device``) with every leaf read from
    the flax ``.msgpack`` checkpoint."""
    cfg = adapt_cfg_to_checkpoint(make_config(groups), checkpoint)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = ReSeg(cfg)
    model = load_flax(model, read_msgpack(checkpoint))
    return cfg, model.to(device).float()


class Inference:
    """The monolithic inference batch: expansion to 21 channels, the
    backbone, semantic head and density budget, then the extraction rounds
    until every sample is done."""

    def __init__(self, groups: Dict, checkpoint: str, stop_path: str,
                 device, dtype: torch.dtype = torch.float32):
        self.cfg, model = load_model(groups, checkpoint, device)
        self.model = model.to_inference(dtype)
        self.device = torch.device(device)
        self.stop = load_stop_params(stop_path)
        group = max(int(self.cfg.decoder.extract_group), 1)
        self.max_rounds = -(-self.cfg.data.max_n_objects // group)

    @torch.no_grad()
    def __call__(self, images_u8: np.ndarray):
        """(B, H, W, 3) uint8 -> (fg (B, H, W) uint8, idmap (B, H, W)
        uint8, counts (B,) int32), numpy."""
        x = torch.from_numpy(np.ascontiguousarray(images_u8)).to(self.device)
        x = image_ex_standardize(x).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        with full_float32():
            sem_probs, sem_mask, budget, score, partials = (
                self.model.infer_prep(x))
            idmap, counts, _, _ = self.model.decoder.extract_rounds(
                sem_mask, score, partials, count_budget=budget,
                n_rounds=self.max_rounds, stop_params=self.stop,
                sync_rounds=True)
        fg = sem_probs.argmax(dim=1).to(torch.uint8)
        return (fg.cpu().numpy(), idmap.to(torch.uint8).cpu().numpy(),
                counts.to(torch.int32).cpu().numpy())


def train_steps(groups: Dict, checkpoint: str, batches: Sequence[Dict],
                seed: int, device, dtype: Optional[torch.dtype] = None
                ) -> Dict:
    """The training steps from the checkpoint's weights over ``batches``,
    their random draws from a generator on ``device`` seeded with
    ``seed``, the model under bfloat16 autocast where ``dtype`` asks for
    it: {"loss": [per step], "terms": [each step's metrics],
    "grad_norms": per parameter, the norm of step 1's gradient as the
    optimizer got it, from its state; "change": per parameter, the norm
    of the change over all the steps}."""
    cfg, model = load_model(groups, checkpoint, device)
    state = create_train_state(cfg, model, device=device)
    step = make_train_step(cfg, model, train_cnn=cfg.train.train_cnn,
                           dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    params = list(model.parameters())
    start = [p.detach().clone() for p in params]
    losses: List[float] = []
    terms: List[Dict[str, float]] = []
    grads: Optional[List[float]] = None
    with full_float32():
        for i, batch in enumerate(batches):
            model.train()
            model.zero_grad(set_to_none=True)
            _, metrics = step(state, batch, gen)
            terms.append({k: float(v) for k, v in metrics.items()})
            losses.append(terms[-1]["cost"])
            if i == 0:
                grads = optimizer_grad_norms(state.optimizer, params)
    change = [float((p.detach() - s).norm()) for p, s in zip(params, start)]
    return {"loss": losses, "terms": terms, "grad_norms": grads,
            "change": change}


def optimizer_grad_norms(optimizer, params) -> List[float]:
    """Per parameter, the norm of the gradient that one Adadelta step saw
    (weight decay included), from its state: the running square average
    after one step is ``(1 - rho) g^2``."""
    rho = optimizer.param_groups[0]["rho"]
    out = []
    for p in params:
        st = optimizer.state.get(p)
        if not st:
            out.append(0.0)
            continue
        out.append(float((st["square_avg"].sum() / (1 - rho)).sqrt()))
    return out
