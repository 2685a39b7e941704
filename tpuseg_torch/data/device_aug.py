"""On-device training augmentation (port of ``tpuseg/data/device_aug.py``).

The transforms of the host ``AlignCollate('training')`` stack whose output
shape does not depend on the draw, as batched tensor ops on the batch's
device, NHWC as the batch arrives:

  geometric (image, semantic and instance masks alike):
    hflip / vflip / transpose, p = 0.5 each      (dataset.py:203-217)
    rot90, k in {0, 1, 2, 3}                     (dataset.py:218-222)
  photometric (image only):
    brightness, contrast, saturation factors in [0.6, 1.4)
                                                 (lib/utils.py:58-59)
    gamma in [0.7, 1.3)                          (preprocess.py:405-427)
    channel remap, drawn with replacement, p = 0.5
                                                 (preprocess.py:381-390)
    grayscale, p = 0.3                           (RandomGrayscale)

Transpose and rot90 need a square image.  The host keeps the rest
(``AlignCollate('training_host_only')``).  The colour jitter applies its
three factors in a fixed order where PIL applies them in a random one, as
the JAX function does.

``draw_augment`` takes every random draw from an explicit
``torch.Generator``; ``apply_augment`` is deterministic given the draws, so
a test can feed it the JAX function's draws.  ``device_augment`` composes
the two.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def _luma(img: torch.Tensor) -> torch.Tensor:
    """PIL 'L' weights (ITU-R 601-2), keeping a channel axis of 1."""
    return (img[..., 0] * 0.299 + img[..., 1] * 0.587
            + img[..., 2] * 0.114)[..., None]


def _bernoulli(b, p, generator, device):
    return torch.rand(b, generator=generator, device=device) < p


def _uniform(shape, lo, hi, generator, device):
    return lo + (hi - lo) * torch.rand(shape, generator=generator,
                                       device=device)


def draw_augment(b: int, square: bool, cfg,
                 generator: torch.Generator) -> Dict[str, Optional[torch.Tensor]]:
    """The draws of one batch of ``b`` samples, on the generator's device,
    each None where ``cfg`` (a ``DataConfig``) turns its transform off:
    ``hf``, ``vf``, ``tr`` (B,) bool; ``rotk`` (B,) int64 in [0, 4);
    ``fb``, ``fc``, ``fs`` (B, 1, 1, 1) factors in [0.6, 1.4); ``g``
    (B, 1, 1, 1) in [0.7, 1.3); ``swp`` (B,) bool and ``swpi`` (B, 3) in
    [0, 3) (channel remap); ``gry`` (B,) bool."""
    dev = generator.device
    col = (b, 1, 1, 1)
    d: Dict[str, Optional[torch.Tensor]] = dict.fromkeys(
        ("hf", "vf", "tr", "rotk", "fb", "fc", "fs", "g", "swp", "swpi",
         "gry"))
    if cfg.hflip:
        d["hf"] = _bernoulli(b, 0.5, generator, dev)
    if cfg.vflip:
        d["vf"] = _bernoulli(b, 0.5, generator, dev)
    if cfg.transpose and square:
        d["tr"] = _bernoulli(b, 0.5, generator, dev)
    if cfg.rot90 and square:
        d["rotk"] = torch.randint(0, 4, (b,), generator=generator, device=dev)
    if cfg.color_jitter:
        for k in ("fb", "fc", "fs"):
            d[k] = _uniform(col, 0.6, 1.4, generator, dev)
    if cfg.gamma:
        d["g"] = _uniform(col, 0.7, 1.3, generator, dev)
    if cfg.channel_swap:
        d["swp"] = _bernoulli(b, 0.5, generator, dev)
        d["swpi"] = torch.randint(0, 3, (b, 3), generator=generator,
                                  device=dev)
    if cfg.grayscale:
        d["gry"] = _bernoulli(b, 0.3, generator, dev)
    return d


def _spatial(x: torch.Tensor, d) -> torch.Tensor:
    """Per-sample flips, transpose and rot90 of one (B, H, W, C) tensor."""
    def where(flag, y):
        return torch.where(flag.to(x.device).view(-1, 1, 1, 1), y, x)

    if d["hf"] is not None:
        x = where(d["hf"], x.flip(2))
    if d["vf"] is not None:
        x = where(d["vf"], x.flip(1))
    if d["tr"] is not None:
        x = where(d["tr"], x.transpose(1, 2))
    if d["rotk"] is not None:
        rotk = d["rotk"].to(x.device)
        x = x.clone()
        for k in (1, 2, 3):
            sel = rotk == k
            x[sel] = torch.rot90(x[sel], k, dims=(1, 2))
    return x


def apply_augment(batch: dict, draws, cfg) -> dict:
    """The batch after the transforms ``cfg`` turns on, with ``draws``
    (from ``draw_augment``) choosing per sample; deterministic.  batch:
    ``images (B, H, W, 3)`` uint8, ``sem_onehot`` and ``ins_masks``
    (B, H, W, *) float32 tensors, ``n_objects``: what
    ``AlignCollate('test' | 'training_host_only')`` gives, on the device.
    Returns a new dict; images stay uint8."""
    imgs = batch["images"].float()
    out = dict(batch)

    def flag(name):
        return draws[name].to(imgs.device).view(-1, 1, 1, 1)

    if any(draws[k] is not None for k in ("hf", "vf", "tr", "rotk")):
        imgs = _spatial(imgs, draws)
        out["sem_onehot"] = _spatial(batch["sem_onehot"], draws)
        out["ins_masks"] = _spatial(batch["ins_masks"], draws)
    if cfg.color_jitter:
        fb, fc, fs = (draws[k].to(imgs.device) for k in ("fb", "fc", "fs"))
        imgs = imgs * fb
        # ImageEnhance.Contrast blends with the image's mean luminance
        mean_l = _luma(imgs).mean(dim=(1, 2), keepdim=True)
        imgs = imgs * fc + (1.0 - fc) * mean_l
        imgs = imgs * fs + (1.0 - fs) * _luma(imgs)
        imgs = imgs.clamp(0.0, 255.0)
    if cfg.gamma:
        g = draws["g"].to(imgs.device)
        imgs = 255.0 * (imgs.clamp(0.0, 255.0) / 255.0) ** g
    if cfg.channel_swap:
        b, h, w, _ = imgs.shape
        idx = draws["swpi"].to(imgs.device)[:, None, None, :].expand(b, h, w, 3)
        imgs = torch.where(flag("swp"), torch.gather(imgs, 3, idx), imgs)
    if cfg.grayscale:
        gray = torch.round(_luma(imgs)).expand_as(imgs)
        imgs = torch.where(flag("gry"), gray, imgs)
    out["images"] = torch.round(imgs).clamp(0, 255).to(torch.uint8)
    return out


def device_augment(batch: dict, generator: torch.Generator, cfg) -> dict:
    """Augment a training batch on its device: ``draw_augment`` from
    ``generator``, then ``apply_augment``."""
    images = batch["images"]
    draws = draw_augment(images.shape[0], images.shape[1] == images.shape[2],
                         cfg, generator)
    return apply_augment(batch, draws, cfg)
