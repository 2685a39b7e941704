"""The per-instance masked softmax in plain PyTorch (the program launches
fused kernels for it), differentiable by autograd."""

import torch

_NEG_INF = -1e30


def masked_softmax(e: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """e (B, HW), mask (B, N, HW) -> p (B, N, HW): ``-1e30`` outside each
    instance, softmax over HW, the empty instances zero."""
    inside = mask > 0
    logits = torch.where(inside, e[:, None, :], e.new_full((), _NEG_INF))
    p = torch.softmax(logits, dim=-1)
    return torch.where(inside.any(dim=-1, keepdim=True), p,
                       torch.zeros_like(p))
