"""Dataset settings: ``get_config(dataset)`` over the typed Config tree."""

from __future__ import annotations

from tpuseg_torch.configs import Config, cvppp_config

_DATASETS = ("CVPPP",)


def get_config(dataset: str) -> Config:
    if dataset not in _DATASETS:
        raise ValueError(f"unknown dataset {dataset}")
    return cvppp_config()
