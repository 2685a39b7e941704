"""Legacy v1 attention decoder (port of ``tpuseg/models/attenet_legacy.py``):
a masked ASPP encoder, one selected glimpse per iteration (the DQN's
``q_fn`` or the argmax of the encoder's norm), a correlation decoder
``sigmoid(feature . encoding)``, a focal + dice loss with the IoU reward
for the DQN's replay buffer, and the selected instance removed from the
remaining foreground.  Fixed shapes: finished samples are masked, not
dropped."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from tpuseg_torch.configs import DecoderConfig
from tpuseg_torch.losses.dice import instance_dice_loss
from tpuseg_torch.losses.focal import focal_loss
from tpuseg_torch.nn.aspp import MaskedAsppEncoder


class CorrelationDecoder(nn.Module):
    """selected (B, C), encode (B, C, H, W) -> (B, H*W) in (0, 1)."""

    def forward(self, selected, encode):
        b = encode.shape[0]
        corr = torch.einsum("bc,bchw->bhw", selected, encode)
        return torch.sigmoid(corr.reshape(b, -1))


def _take(flat, idx):
    """flat (B, HW, K), idx (B,) -> (B, K)."""
    return flat.gather(1, idx[:, None, None].expand(-1, 1, flat.shape[2]))[:, 0]


class AtteNetLegacy(nn.Module):
    """Encoder + iterative select / decode loss."""

    def __init__(self, cfg: DecoderConfig, cin: int,
                 aspp_rates: Sequence[int] = (3, 6, 12),
                 focal_weight: float = 10.0, max_iter: int = 4):
        super().__init__()
        self.cfg = cfg
        self.focal_weight = focal_weight
        self.max_iter = max_iter
        self.encoder = MaskedAsppEncoder(cin, cfg.d_model, aspp_rates)
        self.decoder = CorrelationDecoder()

    def forward(self, features, mask, ins_seg, q_fn=None, train: bool = False,
                generator=None):
        """features (B, C, H, W) with C = d_model; mask (B, 1, H, W) the
        foreground; ins_seg (B, N, H, W) the instance stack; q_fn: callable
        (encode, flat remaining mask) -> (B, H*W) Q-values, or None for the
        norm of the encoding.  Returns (per-sample loss (B,), transitions
        for the replay buffer)."""
        cfg = self.cfg
        b, c, h, w = features.shape
        n = ins_seg.shape[1]
        hw = h * w
        encode = self.encoder(features, mask, train, generator)
        feat_flat = features.reshape(b, c, hw).transpose(1, 2)
        ins_flat = ins_seg.reshape(b, n, hw).transpose(1, 2).float()

        remaining = mask.reshape(b, hw).float()
        mask_sum = remaining.sum(1).clamp_min(1.0)
        done = remaining.sum(1) == 0
        loss = features.new_zeros((b,), dtype=torch.float32)
        transitions = []
        neg = torch.full_like(remaining, -1e30)
        for _ in range(self.max_iter):
            if q_fn is not None:
                q = q_fn(encode, remaining)
            else:
                q = torch.linalg.vector_norm(encode.reshape(b, -1, hw), dim=1)
            actions = torch.where(remaining > 0, q, neg).argmax(1)
            sel = _take(feat_flat, actions)
            pred = self.decoder(sel, encode)
            picked = _take(ins_flat, actions)  # (B, N)
            gold_idx = picked.argmax(1)
            gold = ins_flat.gather(
                2, gold_idx[:, None, None].expand(-1, hw, 1))[..., 0]

            pred_m = pred * remaining
            gold_m = gold * remaining
            f = focal_loss(
                torch.stack([1 - pred_m, pred_m], -1).reshape(-1, 2) * 20 - 10,
                gold_m.reshape(-1), gamma=cfg.focal_gamma,
            ).reshape(b, hw).mean(1)
            d = instance_dice_loss(pred_m, gold_m)
            step_loss = self.focal_weight * f + d

            pred_bin = (pred_m > 0.5).float()
            inter = (pred_bin * gold_m).sum(1)
            iou = 2 * inter / (gold_m.sum(1) + pred_bin.sum(1)).clamp_min(1.0)
            covered = remaining * (gold > 0.5)
            new_remaining = remaining - covered
            pred_sum = covered.sum(1)

            active = (~done).float()
            loss = loss + active * step_loss * pred_sum
            transitions.append({
                "action": actions, "reward": iou.detach(),
                "mask": remaining, "next_mask": new_remaining, "done": done,
            })
            done = done | (new_remaining.sum(1) == 0)
            remaining = new_remaining
        return loss / mask_sum, transitions
