"""ReSeg: UNet backbone + SE semantic head + instance decoder (port of
``tpuseg/models/reseg.py``): the inference modes ``semantic``,
``infer_prep``, ``density`` and ``embed``, the ``loss`` mode of training
and validation, and the ``debug`` mode of the training loop's image dumps
(one method each).

Images arrive NCHW (the 21 standardised channels); ``to_inference``
prepares a model for a compute dtype: it folds the decoder's eval BNs from
the float32 weights, casts the module, and keeps the JAX package's float32
islands in float32 (count-head output layer, density-head output conv and
calibration, the masked BN of the attention score; the conv1 partial is
computed in float32 by the pyramid level itself).

Under spatial sharding (``parallel/spatial.py``) the heads run at their
levels' rows (count head: 1/16, density head: 1/4), their 3x3
convolutions read halo rows and every sum over the pixels (the count
head's mean, the density count that sets each sample's extraction budget,
the density losses) runs over the ranks' rows.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from segbench.reference.configs import Config
from segbench.reference.decoder.instance import InstanceDecoder
from segbench.reference.nn.attention import SqueezeExcite
from segbench.reference.nn.blocks import _BN, relu6
from segbench.reference.nn.unet import UNet
from segbench.reference.parallel import spatial

# count = sum(density) / DENSITY_SCALE
DENSITY_SCALE = 256.0


class _InsStem(nn.Module):
    """dw3x3 + pw to d_model, then a 1x1-expand / dw / 1x1-project
    residual."""

    def __init__(self, c: int, d_model: int):
        super().__init__()
        d2 = 2 * d_model
        self.Conv_0 = nn.Conv2d(c, c, 3, padding=1, groups=c)
        self._BN_0 = _BN(c)
        self.Conv_1 = nn.Conv2d(c, d_model, 1)
        self._BN_1 = _BN(d_model)
        self.Conv_2 = nn.Conv2d(d_model, d2, 1)
        self._BN_2 = _BN(d2)
        self.Conv_3 = nn.Conv2d(d2, d2, 3, padding=1, groups=d2)
        self._BN_3 = _BN(d2)
        self.Conv_4 = nn.Conv2d(d2, d_model, 1)
        self._BN_4 = _BN(d_model)

    def forward(self, x):
        y = relu6(self._BN_0(spatial.conv2d(self.Conv_0, x)))
        y = relu6(self._BN_1(self.Conv_1(y)))
        z = relu6(self._BN_2(self.Conv_2(y)))
        z = relu6(self._BN_3(spatial.conv2d(self.Conv_3, z)))
        return self._BN_4(self.Conv_4(z)) + y


class _CountHead(nn.Module):
    """Global-pooled bottleneck -> MLP -> count logits (output layer f32)."""

    def __init__(self, c: int, n_classes: int, hidden: int = 128):
        super().__init__()
        self.Dense_0 = nn.Linear(c, hidden)
        self.Dense_1 = nn.Linear(hidden, n_classes)

    def forward(self, x5):
        with spatial.level(16):
            y = F.relu(self.Dense_0(spatial.space_mean(x5, (2, 3))))
        with torch.autocast(y.device.type, enabled=False):
            return self.Dense_1(y.float())


class _DensityHead(nn.Module):
    """Per-pixel density at 1/4 resolution from the 1/4 + 1/8 skips; its
    integral is the instance count.  The skips are detached: the head
    trains without moving the segmentation backbone."""

    def __init__(self, c: int, hidden: int = 128):
        super().__init__()
        self.Conv_0 = nn.Conv2d(c, hidden, 3, padding=1)
        self.Conv_1 = nn.Conv2d(hidden, hidden // 2, 3, padding=1)
        self.Conv_2 = nn.Conv2d(hidden // 2, 1, 1)
        self.out_gain = nn.Parameter(torch.ones(1))
        self.out_off = nn.Parameter(torch.zeros(1))

    def forward(self, skips):
        x3, x4 = skips[2].detach(), skips[3].detach()
        rows = spatial.level_rows(4)
        x4u = spatial.upsample_rows(
            x4, lambda t: t.repeat_interleave(2, dim=2), 2,
            spatial.level_rows(8), rows).repeat_interleave(2, dim=3)
        with spatial.at_rows(rows):
            y = F.relu(spatial.conv2d(self.Conv_0, torch.cat([x3, x4u], dim=1)))
            y = F.relu(spatial.conv2d(self.Conv_1, y))
            with torch.autocast(y.device.type, enabled=False):
                dens = F.softplus(self.Conv_2(y.float()))
            h, w = dens.shape[2:]
            h = spatial.canvas_rows(h)
        return dens * self.out_gain + self.out_off * (DENSITY_SCALE / float(h * w))


def pool_density(gt: torch.Tensor, dh: int, dw: int) -> torch.Tensor:
    """Mass-preserving sum-pool of a (B, 1, H, W) density map onto the
    head's (dh, dw) grid (under spatial sharding: this rank's rows of both,
    the head's grid at 1/4 resolution)."""
    def pool(t, f):
        b, _, h, w = t.shape
        return t.reshape(b, 1, h // f, f, w // f, f).sum(dim=(3, 5))

    if not spatial.active():
        b, _, h, w = gt.shape
        return gt.reshape(b, 1, dh, h // dh, dw, w // dw).sum(dim=(3, 5))
    return spatial.pool_rows(gt, pool, gt.shape[3] // dw,
                             spatial.level_rows(1), spatial.level_rows(4))


def density_target(ins_target: torch.Tensor,
                   n_objects: torch.Tensor) -> torch.Tensor:
    """(B, N, H, W) instance masks + (B,) counts -> (B, 1, H, W) scaled GT
    density: each valid instance's mask normalised to unit mass."""
    masks = ins_target.float()
    areas = spatial.space_sum(masks, (2, 3))  # (B, N)
    slots = torch.arange(masks.shape[1], device=masks.device)
    valid = (slots[None] < n_objects[:, None]) & (areas > 0)
    w = torch.where(valid, DENSITY_SCALE / areas.clamp(min=1.0),
                    torch.zeros_like(areas))
    return torch.einsum("bnhw,bn->bhw", masks, w)[:, None]


def density_count(density) -> torch.Tensor:
    """(B, 1, h, w) scaled density -> (B,) count, rounded half-to-even."""
    with spatial.level(4):
        total = spatial.space_sum(density.float(), (1, 2, 3))
    return torch.round(total / DENSITY_SCALE).to(torch.int32)


class ReSeg(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        f = cfg.model.n_filters
        d = cfg.decoder.d_model
        self.base = UNet(cfg.data.n_channels, f, cfg.decoder.use_encode)
        self.channel_attend = SqueezeExcite(f)
        self.sem_seg_output = nn.Conv2d(f, cfg.data.n_classes, 1)
        self.ins_stem = _InsStem(f, d)
        if cfg.model.use_count_head:
            self.count_head = _CountHead(16 * f, cfg.model.count_classes)
        if cfg.model.use_density_head:
            self.density_head = _DensityHead(12 * f)
        self.decoder = InstanceDecoder(cfg.decoder, cfg.data.max_n_objects, f)

    def to_inference(self, dtype=torch.float32) -> "ReSeg":
        """Eval mode in ``dtype`` (float32 or bfloat16) with the float32
        islands kept; folds the decoder BNs from the current (float32)
        weights first.  Call after loading weights and moving devices."""
        self.eval()
        for lvl in self.decoder.bone.levels:
            lvl.fold(dtype)
        self.to(dtype)
        islands = [self.decoder.attend.MaskedBatchNorm_0]
        if self.cfg.model.use_count_head:
            islands.append(self.count_head.Dense_1)
        if self.cfg.model.use_density_head:
            dh = self.density_head
            islands.append(dh.Conv_2)
            dh.out_gain.data = dh.out_gain.data.float()
            dh.out_off.data = dh.out_off.data.float()
        for m in islands:
            m.float()
        return self

    @property
    def dtype(self) -> torch.dtype:
        return self.sem_seg_output.weight.dtype

    def _backbone(self, images):
        x_dec, skips = self.base(images.to(self.dtype))
        sem_logits = self.sem_seg_output(self.channel_attend(x_dec))
        return x_dec, skips, sem_logits

    def loss(self, images, sem_onehot, ins_target, n_objects,
             generator=None):
        """The ``loss`` mode, train or eval by ``self.training``.

        images (B, 21, H, W) standardised; sem_onehot (B, C, H, W);
        ins_target (B, N, H, W) padded instance masks; n_objects (B,).
        The decoder's mask is the GT semantic argmax for train and
        validation batches alike.  Returns (sem_logits, sem_mask,
        decoder losses); the losses also hold ``count_logits`` and the
        density terms where the heads are on."""
        cfg = self.cfg
        x_dec, skips, sem_logits = self._backbone(images)
        x_enc = self.ins_stem(x_dec)
        sem_mask = sem_onehot.argmax(dim=1, keepdim=True).to(torch.float32)
        losses = self.decoder.loss(x_enc, sem_mask, ins_target, n_objects,
                                   skips, generator=generator)
        if cfg.model.use_count_head:
            losses["count_logits"] = self.count_head(skips[-1])
        if cfg.model.use_density_head:
            density = self.density_head(skips)
            dh, dw = density.shape[2:]
            gt = pool_density(density_target(ins_target, n_objects), dh, dw)
            with spatial.level(4):
                dh = spatial.canvas_rows(dh)
                # npix/16 keeps the map term at a full-resolution head's
                # magnitude (1/4-resolution pixels carry 16x the mass)
                losses["density_loss"] = (
                    spatial.global_mean((density - gt).square())
                    * float(dh * dw / 16.0))
                est = spatial.space_sum(density, (1, 2, 3)) / DENSITY_SCALE
            losses["density_count_loss"] = (
                (est - n_objects.to(torch.float32)).square().mean())
            losses["density_count"] = est
        return sem_logits, sem_mask, losses

    @torch.no_grad()
    def semantic(self, images) -> torch.Tensor:
        """(B, 2, H, W) semantic probabilities."""
        return torch.softmax(self._backbone(images)[2], dim=1)

    @torch.no_grad()
    def infer_prep(self, images, max_instances=None):
        """Everything glimpse-independent: (sem_probs (B, 2, H, W),
        sem_mask (B, 1, H, W) float32, budget (B,) int32, score
        (B, 1, H, W) float32, conv1 partials per level)."""
        cfg = self.cfg
        x_dec, skips, sem_logits = self._backbone(images)
        sem_probs = torch.softmax(sem_logits, dim=1)
        sem_mask = sem_logits.argmax(dim=1, keepdim=True).to(torch.float32)
        x_enc = self.ins_stem(x_dec)
        k_cap = max_instances or cfg.data.max_n_objects
        if cfg.model.use_density_head:
            budget = density_count(self.density_head(skips)).clamp(1, k_cap)
        elif cfg.model.use_count_head:
            logits = self.count_head(skips[-1])
            budget = logits.argmax(dim=-1).to(torch.int32).clamp(1, k_cap)
        else:
            budget = torch.full((images.shape[0],), k_cap, dtype=torch.int32,
                                device=images.device)
        score, partials = self.decoder.prep(x_enc, sem_mask, skips)
        return sem_probs, sem_mask, budget, score, partials

    @torch.no_grad()
    def density(self, images) -> torch.Tensor:
        """The density head's map (B, 1, H/4, W/4) float32, scaled by
        ``DENSITY_SCALE`` (backbone and head only)."""
        if not self.cfg.model.use_density_head:
            raise ValueError("density mode: the configuration has no "
                             "density head")
        return self.density_head(self.base(images.to(self.dtype))[1])

    @torch.no_grad()
    def embed(self, images):
        """Per-pixel instance embeddings for clustering: (sem_probs
        (B, 2, H, W), x_enc (B, d_model, H, W), n_est (B,) int32), the
        count estimate from the density head, else the count head's
        argmax, else 16."""
        cfg = self.cfg
        x_dec, skips, sem_logits = self._backbone(images)
        sem_probs = torch.softmax(sem_logits, dim=1)
        x_enc = self.ins_stem(x_dec)
        if cfg.model.use_density_head:
            n_est = density_count(self.density_head(skips))
        elif cfg.model.use_count_head:
            n_est = self.count_head(skips[-1]).argmax(dim=-1).to(torch.int32)
        else:
            n_est = torch.full((images.shape[0],), 16, dtype=torch.int32,
                               device=images.device)
        return sem_probs, x_enc, n_est

    @torch.no_grad()
    def debug(self, images, sem_onehot, ins_target):
        """The training loop's single-glimpse debug forward in eval mode
        (``InstanceDecoder.debug`` on the GT semantic mask).  Takes the
        ``loss`` mode's NCHW inputs and returns the JAX package's layout,
        float32: preds / targets per level (B, h, w, 2) / (B, h, w, 1),
        alpha (B, H*W), pro and sem_mask (B, H, W, 1), point (B,)."""
        x_dec, skips, _ = self._backbone(images)
        x_enc = self.ins_stem(x_dec)
        sem_mask = sem_onehot.argmax(dim=1, keepdim=True).to(torch.float32)
        out = self.decoder.debug(x_enc, sem_mask, ins_target, skips)
        nhwc = lambda t: t.permute(0, 2, 3, 1).float()  # noqa: E731
        return {
            "preds": [nhwc(p) for p in out["preds"]],
            "targets": [nhwc(t) for t in out["targets"]],
            "alpha": out["alpha"].float(),
            "pro": nhwc(out["pro"]),
            "point": out["point"],
            "sem_mask": nhwc(sem_mask),
        }
