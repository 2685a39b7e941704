"""The decoder's inverted-residual chain in plain PyTorch (the program
launches a fused kernel for it): four blocks of a 1x1 convolution, a
depthwise 3x3 and a 1x1 convolution, the folded BatchNorms as biases, the
skip added before block 3."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from segbench.reference.nn.blocks import relu6


def ir_chain(x, x1u, w1, b1, wd, b2, w2, b3) -> torch.Tensor:
    """x (N, H, W, C) -> (N, H, W, C), in the input's dtype."""
    dt = x.dtype
    v = x.permute(0, 3, 1, 2)
    for s in range(4):
        if s == 2 and x1u is not None:
            v = v + x1u.permute(0, 3, 1, 2)
        h = relu6(F.conv2d(v, w1[s].t().to(dt)[:, :, None, None],
                           b1[s].to(dt)))
        h = relu6(F.conv2d(h, wd[s].permute(2, 0, 1)[:, None].to(dt),
                           b2[s].to(dt), padding=1, groups=h.shape[1]))
        v = v + F.conv2d(h, w2[s].t().to(dt)[:, :, None, None], b3[s].to(dt))
    return v.permute(0, 2, 3, 1)


@torch.no_grad()
def fold_ir_params(block) -> Tuple[torch.Tensor, ...]:
    """(w1, b1, wd, b2, w2, b3) in float32 from one ``InvertedResidual``,
    BNs folded to their inference affine: w1 (C, 2C), wd (3, 3, 2C),
    w2 (2C, C)."""
    s1, t1 = block._BN_0.folded()
    s2, t2 = block._BN_1.folded()
    s3, t3 = block._BN_2.folded()
    w1 = block.Conv_0.weight.float()[:, :, 0, 0].t() * s1[None, :]
    wd = block.Conv_1.weight.float()[:, 0].permute(1, 2, 0) * s2
    w2 = block.Conv_2.weight.float()[:, :, 0, 0].t() * s3[None, :]
    return w1, t1, wd, t2, w2, t3


@torch.no_grad()
def stack_chain_params(blocks: Sequence, dtype=torch.bfloat16):
    """Four blocks' folded params stacked: the two pointwise weights in
    ``dtype``, biases and depthwise taps in float32."""
    folded = [fold_ir_params(b) for b in blocks]
    w1, b1, wd, b2, w2, b3 = (
        torch.stack([f[i] for f in folded]).contiguous() for i in range(6)
    )
    return (w1.to(dtype), b1, wd, b2, w2.to(dtype), b3)
