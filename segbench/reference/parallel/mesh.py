"""The program's reductions over ranks, in one process: each is the local
reduction."""

import torch


def world_size() -> int:
    return 1


def data_ranks() -> int:
    return 1


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    return x


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dim=0)


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=0)


def batch_min(x: torch.Tensor) -> torch.Tensor:
    return x.min()


def mean_over_ranks_(tensors) -> None:
    return None
