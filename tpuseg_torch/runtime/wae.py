"""WAE match loss, a trainable loss head (port of
``tpuseg/runtime/wae.py``): owns a ``DcganDecoder`` with its own optimizer
and plateau scheduler, and combines a focal reconstruction loss, the gl
rank-matching penalty and the sampled point-cloud MMD.

The optimizer is the JAX chain: clip by global norm 10, then AdamW (b1
0.5, b2 0.999), with the plateau's ``lr`` scaling the whole update, weight
decay included (``torch.optim.AdamW`` at ``learning_rate * plateau.lr``
applies both terms at that rate, as optax's scaled update does).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from tpuseg_torch import resolve_device
from tpuseg_torch.losses.mmd import decoder_mmd_loss, gl_loss
from tpuseg_torch.nn.dcgan_decoder import DcganDecoder
from tpuseg_torch.runtime.state import PlateauState, _clip_


@dataclasses.dataclass
class MatchLoss:
    decoder: DcganDecoder
    opt: torch.optim.AdamW
    plateau: PlateauState
    learning_rate: float = 1e-3
    lam: float = 1.0

    @classmethod
    def create(cls, coding: int = 24, out_shape=(64, 64, 1),
               learning_rate: float = 1e-3, weight_decay: float = 0.0,
               lr_drop_factor: float = 0.5, lr_drop_patience: int = 25,
               lam: float = 1.0, seed: int = 0, device="cuda") -> "MatchLoss":
        dev = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            decoder = DcganDecoder(coding=coding, out_shape=out_shape)
        decoder.to(dev)
        opt = torch.optim.AdamW(decoder.parameters(), lr=learning_rate,
                                betas=(0.5, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
        return cls(decoder=decoder, opt=opt,
                   plateau=PlateauState.create(1.0, lr_drop_factor,
                                               lr_drop_patience),
                   learning_rate=learning_rate, lam=lam)

    def loss_fn(self, sample_qz: torch.Tensor, ins_annotations: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                draws: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """sample_qz (B, coding) latents; ins_annotations (B, H, W) masks.
        recon (focal) * 100 + gl penalty + lam * point-cloud MMD; ``draws``
        as ``losses.mmd.decoder_mmd_loss`` takes them."""
        recon = self.decoder(sample_qz)
        t = ins_annotations.reshape(-1).to(recon.dtype)
        p = recon.reshape(-1).clamp(1e-7, 1 - 1e-7)
        rec_loss = (-((1 - p) ** 2) * torch.log(p) * t
                    - (p ** 2) * torch.log(1 - p) * (1 - t)).mean()
        penalty = gl_loss(sample_qz, recon)
        dmmd = decoder_mmd_loss(recon, ins_annotations.to(recon.dtype),
                                generator, draws=draws)
        total = 100.0 * rec_loss + penalty + self.lam * dmmd
        return total, {"reconstruction": rec_loss, "gl_penalty": penalty,
                       "decoder_mmd": dmmd}

    def step(self, sample_qz, ins_annotations, generator=None, draws=None):
        """One optimizer step on the loss; returns (total, parts)."""
        self.opt.zero_grad(set_to_none=True)
        total, parts = self.loss_fn(sample_qz, ins_annotations, generator,
                                    draws)
        total.backward()
        params = [p for p in self.decoder.parameters() if p.grad is not None]
        _clip_([p.grad for p in params], 10.0)
        for group in self.opt.param_groups:
            group["lr"] = self.learning_rate * self.plateau.lr
        self.opt.step()
        return total.detach(), {k: v.detach() for k, v in parts.items()}

    def scheduler_step(self, cost):
        self.plateau = self.plateau.step(cost)
