"""The batched-inference stages that the measurement tools time and count.

Counterpart of what the JAX tools share (``bench._build``,
``bench._synthetic_images`` and their jitted stage functions): the CVPPP
model from the committed checkpoint (``cli/common.py::load_model``), a
``Predictor`` for it in bfloat16 (float32 with ``--f32``, TF32 off), a
batch of ``make_scene`` images (seed 0, not hard, as the JAX bench draws
them), and the stages:

- ``preprocess``: uint8 (B, H, W, 3) -> the 21 standardised channels,
  NCHW channels_last (``Predictor._standardize``);
- ``semantic``: preprocess + UNet + SE + semantic head, argmax to uint8;
- ``batch(pred)``: one batch through ``Predictor.predict_batch_packed``,
  the call ``pred_list`` makes, at the predictor's instance cap
  (:meth:`Setup.predictor`); its rounds are the change in
  ``Predictor.rounds_run``.

:func:`time_ms` times a call with CUDA events after a warm-up on the card
and with the host clock on the CPU.  Every tool runs on the card unless
given ``--device cpu`` and raises without CUDA otherwise.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import os
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from tpuseg_torch import resolve_device
from tpuseg_torch.cli.common import load_model
from tpuseg_torch.configs import Config
from tpuseg_torch.data.synthetic import make_scene
from tpuseg_torch.runtime.predict import Predictor
from tpuseg_torch.settings import get_config
from tpuseg_torch.utils.checkpoint_io import load_stop_params

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CKPT = os.path.join(REPO, "assets", "synthetic_ckpt.msgpack")


def add_model_args(p: argparse.ArgumentParser, batch: int = 32) -> None:
    p.add_argument("--batch", type=int, default=batch)
    p.add_argument("--f32", action="store_true")
    p.add_argument("--res", type=int, default=256,
                   help="square input size (the model's: 256)")
    p.add_argument("--device", default="cuda")


@dataclasses.dataclass
class Setup:
    cfg: Config
    base: torch.nn.Module   # ReSeg, float32, as loaded
    dev: torch.device
    dtype: torch.dtype
    x: torch.Tensor         # (B, H, W, 3) uint8 on ``dev``
    stop: Optional[tuple]
    preds: Dict[int, Predictor] = dataclasses.field(default_factory=dict)

    @property
    def batch(self) -> int:
        return self.x.shape[0]

    @property
    def dtype_name(self) -> str:
        return "f32" if self.dtype == torch.float32 else "bf16"

    def predictor(self, k: Optional[int] = None) -> Predictor:
        """The predictor at the instance cap ``k`` (the config's
        ``max_n_objects`` when None), on a copy of the weights, made once."""
        k = k or self.cfg.data.max_n_objects
        if k not in self.preds:
            self.preds[k] = Predictor(
                self.cfg, copy.deepcopy(self.base), batch_size=self.batch,
                max_instances=k, stop_params=self.stop, device=self.dev,
                dtype=self.dtype)
        return self.preds[k]

    @property
    def pred(self) -> Predictor:
        return self.predictor()

    @property
    def model(self) -> torch.nn.Module:
        """The model at the cap, cast for inference."""
        return self.pred.model


def synthetic_images(n: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([make_scene(rng, h, w)[0] for _ in range(n)])


def load(args):
    """(device, cfg, float32 model) from the parsed arguments: the device
    checked first, then the committed checkpoint at ``--res``."""
    dev = resolve_device(args.device)
    cfg = get_config("CVPPP")
    cfg = cfg.replace(data=dataclasses.replace(
        cfg.data, image_height=args.res, image_width=args.res))
    with contextlib.redirect_stdout(sys.stderr):  # stdout: the report only
        cfg, model = load_model(cfg, CKPT)
    return dev, cfg, model


def setup(args) -> Setup:
    """The float32 model, ``--batch`` synthetic images on the device, and
    the predictors made from them in bf16 (``--f32``: float32)."""
    dev, cfg, model = load(args)
    dtype = torch.float32 if args.f32 else torch.bfloat16
    images = synthetic_images(args.batch, args.res, args.res)
    return Setup(cfg, model, dev, dtype, torch.from_numpy(images).to(dev),
                 load_stop_params())


def preprocess(s: Setup) -> torch.Tensor:
    return Predictor._standardize(s.x)


@torch.no_grad()
def semantic(s: Setup) -> torch.Tensor:
    with s.pred._compute():
        probs = s.model.semantic(preprocess(s))
    return probs.argmax(dim=1).to(torch.uint8)


def batch(pred: Predictor, x: torch.Tensor) -> int:
    """One batch through ``pred`` as ``pred_list`` runs it (packed masks
    and counts left on the device); the extraction rounds it ran."""
    before = pred.rounds_run
    pred.predict_batch_packed(x)
    return pred.rounds_run - before


def time_ms(fn: Callable, dev: torch.device, iters: int,
            warmup: int = 1) -> float:
    """ms a call: CUDA events around ``iters`` calls after ``warmup`` on
    the card; the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if dev.type != "cuda":
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        return 1e3 * (time.perf_counter() - t) / iters
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / iters


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
