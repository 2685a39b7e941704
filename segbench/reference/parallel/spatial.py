"""The program's row-sharding helpers in one process, where no map is
sharded: each helper is the plain operation it stands for."""

import contextlib

import torch
import torch.nn.functional as F

from segbench.reference.kernels.masked_softmax import masked_softmax  # noqa: F401

UNET_ROWS = 1
DECODE_ROWS = 4


def active() -> bool:
    return False


def level_rows(factor: int, min_rows: int = UNET_ROWS):
    return None


def at_rows(r):
    return contextlib.nullcontext()


def local():
    return contextlib.nullcontext()


def level(factor: int, min_rows: int = UNET_ROWS):
    return contextlib.nullcontext()


def rows():
    return None


def sharded() -> bool:
    return False


def row_offset() -> int:
    return 0


def canvas_rows(h_local: int) -> int:
    return h_local


def reduce_rows(x: torch.Tensor) -> torch.Tensor:
    return x


def space_sum(x: torch.Tensor, dim=None, keepdim: bool = False):
    return x.sum() if dim is None else x.sum(dim=dim, keepdim=keepdim)


def space_mean(x: torch.Tensor, dim, keepdim: bool = False):
    return x.mean(dim=dim, keepdim=keepdim)


def global_mean(x: torch.Tensor) -> torch.Tensor:
    return x.mean()


def space_max(x: torch.Tensor, dim, keepdim: bool = False):
    return x.detach().amax(dim=dim, keepdim=keepdim)


def space_argmax(flat: torch.Tensor, width: int) -> torch.Tensor:
    return flat.argmax(dim=1)


def owner_value(flat: torch.Tensor, index: torch.Tensor, width: int):
    return flat.gather(1, index[:, None])[:, 0]


def conv2d(conv: torch.nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return conv(x)


def avg_pool_3x3(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


def relayout(x, src, dst):
    return x


def pool_rows(x, pool, factor: int, src, dst):
    return pool(x, factor)


def upsample_rows(x, up, factor: int, src, dst):
    return up(x)


def upsample_bilinear_rows(x, width: int, src, dst, crop=None):
    crop = crop or (lambda t: t)
    t = crop(x)
    return F.interpolate(t, size=(2 * t.shape[2], width), mode="bilinear",
                         align_corners=False)


def softmax_flat(logits: torch.Tensor) -> torch.Tensor:
    return torch.softmax(logits, dim=1)


def sample_flat(weights: torch.Tensor, generator, width: int):
    return torch.multinomial(weights, 1, generator=generator)[:, 0]
