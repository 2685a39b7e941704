"""The system under test, as a deployment loads it: the port's
configuration built from a configuration file, its kernels built into
the port's own cache inside the checkout, its model read from the
checkpoint through the CLIs' loader."""

from __future__ import annotations

import dataclasses
import os
from typing import Dict

import torch

from segbench.cells import ROOT

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def make_config(groups: Dict):
    """The port's ``Config`` of a configuration file's ``config`` groups;
    every field of every group has to be given."""
    from tpuseg_torch import configs as C

    classes = {"data": C.DataConfig, "model": C.ModelConfig,
               "decoder": C.DecoderConfig, "train": C.TrainConfig,
               "eval": C.EvalConfig}
    parts = {}
    for name, cls in classes.items():
        given = groups[name]
        names = {f.name for f in dataclasses.fields(cls)}
        if set(given) != names:
            raise ValueError(f"config group {name}: fields differ: "
                             f"{sorted(set(given) ^ names)}")
        parts[name] = cls(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in given.items()})
    return C.Config(**parts)


def path(rel: str) -> str:
    return os.path.join(ROOT, rel)


def load(configuration: Dict, device: torch.device, kernels=("ir_chain",)):
    """(config, float32 model) of the configuration file; the named CUDA
    kernels built first on a card.  Raises if the checkpoint changes the
    configuration the file states."""
    from tpuseg_torch.cli.common import load_model
    from tpuseg_torch.kernels import build

    if device.type == "cuda" and kernels:
        build.build(list(kernels))
    cfg = make_config(configuration["config"])
    loaded, model = load_model(cfg, path(configuration["checkpoint"]))
    if loaded != cfg:
        raise ValueError("the checkpoint changes the configuration the "
                         "configuration file states")
    return cfg, model
