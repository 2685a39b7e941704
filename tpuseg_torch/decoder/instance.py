"""Iterative hard-attention instance decoder (port of
``tpuseg/decoder/instance.py``).

The loss path (``InstanceDecoder.loss``, the JAX ``_loss`` and
``_loss_step``): spatial attention over the instance features, one
hard-attention distribution per instance, then the glimpse loop: take one
(randomly ordered) instance per sample, sample a point from its
distribution, decode that instance's mask through the 5-level pyramid, and
add up the pyramid focal + dice losses, a REINFORCE term with an EMA
baseline and an entropy regulariser.  The JAX ``nn.scan`` over static
glimpse slots is a Python loop here.

The extraction path (``prep`` and ``extract_rounds``): each extraction round picks ``G`` disk-suppressed attention peaks in the
remaining foreground, decodes all ``G`` masks in one pyramid pass with the
glimpses folded into the batch, and carves them out in peak order (an
earlier peak wins overlaps).  The JAX ``lax.scan`` over rounds becomes a
Python loop; by default it stops once every sample is done, which costs
one host sync per round (``sync_rounds=False`` runs every round without
syncing — a round in which every sample is done changes nothing).  Tie
rules follow the JAX package: ``argmax`` takes the first index and
``round`` is half-to-even.

Tensors are NCHW: masks and targets ``(B, 1, h, w)``, logits
``(B, 2, h, w)``, instance masks ``(B, N, H, W)``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from tpuseg_torch.configs import DecoderConfig
from tpuseg_torch.decoder.pyramid import AttenDecoder
from tpuseg_torch.losses.dice import dice_loss
from tpuseg_torch.losses.focal import focal_loss, softmax_cross_entropy
from tpuseg_torch.nn.attention import HardAttention, SpatialAttention
from tpuseg_torch.nn.blocks import running_stats

_NEG_INF = -1e30


# --------------------------------------------------------------------------
# loss pieces (pure functions of cfg + tensors)
# --------------------------------------------------------------------------


def _flat2(logits: torch.Tensor) -> torch.Tensor:
    """(B, 2, h, w) -> (B*h*w, 2), samples in order."""
    return logits.permute(0, 2, 3, 1).reshape(-1, 2)


def _two_class(target01: torch.Tensor) -> torch.Tensor:
    return torch.cat([1.0 - target01, target01], dim=1)


def mask_loss(cfg: DecoderConfig, pred_logits, target01, alpha: float = 0.0,
              map_weight=0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-level ``ce_weight * focal + dice(time=1)``: ((B,) multi loss,
    (B,) dice loss).  pred_logits (B, 2, h, w), target01 (B, 1, h, w)."""
    b = pred_logits.shape[0]
    t = target01.to(pred_logits.dtype)
    d = dice_loss(pred_logits, _two_class(t), optimize_bg=False,
                  smooth=cfg.smooth, reduce=False, time=1,
                  map_weight=map_weight)
    ce = focal_loss(_flat2(pred_logits), t.reshape(-1), gamma=cfg.focal_gamma,
                    alpha=alpha, map_weight=map_weight)
    return cfg.ce_weight * ce.reshape(b, -1).mean(dim=1) + d, d


def pred_loss(cfg: DecoderConfig, preds, targets):
    """Pyramid-weighted mask loss: ((B,) total, (B,) dice of the finest
    level)."""
    total, d_last = 0.0, None
    for p, t, w in zip(preds, targets, cfg.pyramid_weights):
        multi, d_last = mask_loss(cfg, p, t)
        total = total + multi * w
    return total, d_last


def alpha_entropy(cfg: DecoderConfig, alpha, mask) -> torch.Tensor:
    """Entropy regulariser over the glimpse distribution restricted to the
    instance's pixels."""
    a = alpha.clamp(cfg.entropy_clamp_lo, cfg.entropy_clamp_hi)
    return (-a * torch.log(a) * cfg.entropy_normal * mask).sum()


def evaluate_masks(pred_last, target_last, time: int = 1,
                   smooth: float = 1.0):
    """Eval CE (scalar) and per-sample dice (B,) of the finest level; the
    caller detaches as needed."""
    t = target_last.to(pred_last.dtype)
    ce = softmax_cross_entropy(_flat2(pred_last),
                               target_last.reshape(-1).long())
    d = dice_loss(pred_last, _two_class(t), optimize_bg=False, smooth=smooth,
                  reduce=False, time=time)
    return ce, d


def stop_scalars(cfg: DecoderConfig, stop_params: Optional[Sequence] = None):
    """(min_remaining_frac, max_extract_misses, peak_suppress_factor,
    stop_remaining_frac) from the override or the config defaults; a
    shorter override keeps the defaults for the trailing values, and a
    non-positive stop fraction follows ``min_remaining_frac``."""
    defaults = (
        cfg.min_remaining_frac, cfg.max_extract_misses,
        cfg.peak_suppress_factor, cfg.stop_remaining_frac,
    )
    vals = defaults if stop_params is None else (
        tuple(stop_params) + defaults[len(stop_params):]
    )
    min_frac, max_misses, suppress, stop_frac = vals
    min_frac = float(min_frac)
    stop_frac = float(stop_frac)
    if not stop_frac > 0:
        stop_frac = min_frac
    return min_frac, int(max_misses), float(suppress), stop_frac


def disk(s, h: int, w: int, radius) -> torch.Tensor:
    """(N, h*w) float disk of ``radius`` (N,) around flat points s (N,)."""
    yy = torch.arange(h, device=s.device)[None, :, None]
    xx = torch.arange(w, device=s.device)[None, None, :]
    pr = (s // w)[:, None, None]
    pc = (s % w)[:, None, None]
    r2 = (radius * radius).to(torch.int32)[:, None, None]
    return (((yy - pr) ** 2 + (xx - pc) ** 2) <= r2).to(
        torch.float32
    ).reshape(s.shape[0], h * w)


class _GlimpseStep(nn.Module):
    """Holds the pyramid decoder under the flax scan's module name."""

    def __init__(self, cfg: DecoderConfig, n_filters: int):
        super().__init__()
        self.bone = AttenDecoder(cfg, n_filters)


class InstanceDecoder(nn.Module):
    def __init__(self, cfg: DecoderConfig, max_n_objects: int = 32,
                 n_filters: int = 32):
        super().__init__()
        self.cfg = cfg
        self.max_n_objects = max_n_objects
        d = cfg.d_model
        self.s_sp = SpatialAttention(d, d, cfg.sp_reduction)
        self.attend = HardAttention(d, cfg.d_k)
        self.glimpse = _GlimpseStep(cfg, n_filters)
        # REINFORCE EMA baseline (training state; carried for the weights)
        self.register_buffer("baseline", torch.zeros(()))

    @property
    def bone(self) -> AttenDecoder:
        return self.glimpse.bone

    def attend_score(self, encode, sem_mask) -> torch.Tensor:
        """Merged hard-attention score (B, 1, H, W), float32."""
        sem = sem_mask.to(encode.dtype)
        return self.attend(self.s_sp(encode, sem), sem)

    # ---------------- training / eval loss ----------------

    def _decode_train(self, s, sem_mask, gold, feats, skips_t, generator):
        """One train-mode pyramid decode -> (per-level targets, per-level
        logits).  Under ``cfg.remat`` the decode is checkpointed: its
        activations are recomputed in the backward pass instead of being
        kept across the glimpse loop.  The dropout multipliers are drawn
        here, outside the checkpoint, so both runs see the same ones, and
        the recomputation leaves the BatchNorm running statistics alone."""
        bone = self.bone
        b, dev = s.shape[0], s.device
        drops = bone.draw_dropout(b, generator, dev, "decode")
        skip_drops = None
        if skips_t is None:
            skip_drops = bone.draw_dropout(b, generator, dev, "skips")
        runs = [0]

        def run():
            with running_stats(frozen=runs[0] > 0):
                runs[0] += 1
                targets, preds = bone(s, feats, sem_mask, gold,
                                      skips_t=skips_t, drops=drops,
                                      skip_drops=skip_drops)
            return tuple(targets), tuple(preds)

        if self.cfg.remat and torch.is_grad_enabled():
            # nothing inside draws from the global random state
            return checkpoint(run, use_reentrant=False,
                              preserve_rng_state=False)
        return run()

    def loss(self, encode, sem_mask, target, n_ins, feats,
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        """Glimpse-loop loss; train or eval by ``self.training``.

        encode (B, d_model, H, W) instance features; sem_mask (B, 1, H, W)
        semantic foreground; target (B, N, H, W) padded instance masks;
        n_ins (B,) valid instance counts; feats: UNet skips x1..x5.
        ``generator`` (on the tensors' device) drives the instance order,
        the glimpse sampling and the dropout; it may be None only where
        nothing is drawn (eval under ``deterministic_glimpse``).

        Training runs all ``cfg.max_iter`` glimpse slots: a slot beyond
        ``maxiter = min(max_iter, max(min(n_ins), 1))`` still decodes (its
        BatchNorm statistics and random draws count) and only its loss
        terms and baseline update are weighted by 0.  Eval runs
        ``max(min(n_ins), 1)`` glimpses (one host sync to learn it).

        Returns dict(loss, criterion, ins_ce_loss, ins_dice_loss), plus the
        per-slot ``debug_*`` terms under ``cfg.debug_loss_terms``."""
        cfg = self.cfg
        train = self.training
        b, n, h, w = target.shape
        hw = h * w
        dev = encode.device
        f32 = torch.float32
        sem = sem_mask.to(encode.dtype)
        pro_split, pro_merge = self.attend(self.s_sp(encode, sem), sem, target)
        del pro_merge  # feeds only the dormant PN losses of the reference

        n_min = n_ins.min().clamp(min=1)
        if train:
            k_static = int(cfg.max_iter)
            maxiter = n_min.clamp(max=k_static)
            n_run = k_static
        else:
            k_static = self.max_n_objects
            maxiter = n_min
            n_run = min(int(n_min), k_static)

        # instance order: uniform keys, invalid slots pushed to the end
        if cfg.deterministic_glimpse:
            perm = torch.arange(n, device=dev)[None].expand(b, n)
        else:
            keys = torch.rand((b, n), generator=generator, device=dev)
            keys = keys + (torch.arange(n, device=dev)[None]
                           >= n_ins[:, None]) * 1e9
            perm = keys.argsort(dim=1)

        bone = self.bone
        skips_t = None
        if not train:
            skips_t = bone.transform_skips(feats)
        elif cfg.hoist_skips_train:
            # the skip transforms do not depend on the glimpse: once per
            # step, and their one running-statistics update stands for the
            # k_static the loop would have made
            with running_stats(repeats=k_static):
                skips_t = bone.transform_skips(
                    feats, bone.draw_dropout(b, generator, dev, "skips"))

        zero = torch.zeros((), dtype=f32, device=dev)
        tot = {"loss": zero, "criterion": zero, "ce": zero, "dice": zero}
        baseline = self.baseline.detach().to(f32)
        rows = torch.arange(b, device=dev)
        debug = {"loss1": [], "loss2": [], "hent": []}
        points = []
        for k in range(n_run):
            valid = (k < maxiter).to(f32)
            idx = perm[:, k]
            gold = target[rows, idx][:, None].to(f32)        # (B, 1, H, W)
            alpha = pro_split[rows, idx].reshape(b, hw)
            alpha_sg = alpha.detach()
            if train and not cfg.deterministic_glimpse:
                # an instance with no mass draws uniformly
                any_mass = alpha_sg.sum(dim=1, keepdim=True) > 0
                weights = torch.where(any_mass, alpha_sg,
                                      torch.ones_like(alpha_sg))
                s = torch.multinomial(weights, 1, generator=generator)[:, 0]
            else:
                s = alpha_sg.argmax(dim=1)
            points.append(s)

            if train:
                targets, preds = self._decode_train(
                    s, sem_mask, gold, feats, skips_t, generator)
            else:
                targets, preds = bone.decode(s, skips_t, sem_mask, gold)
            preds = [p.to(f32) for p in preds]
            pred_last, target_last = preds[-1], targets[-1]
            with torch.no_grad():
                eval_ce, eval_dice = evaluate_masks(
                    pred_last, target_last, time=1, smooth=cfg.smooth)

            if train:
                loss_pred, dice_l = pred_loss(cfg, preds, targets)
                ce_loss = eval_ce
                # REINFORCE with an EMA baseline
                log_p_y = -eval_dice
                m = cfg.baseline_momentum
                baseline_new = m * baseline + (1.0 - m) * log_p_y.mean()
                baseline = torch.where(valid > 0, baseline_new, baseline)
                log_p_s_a = alpha.gather(1, s[:, None])[:, 0]
                loss_2 = -(log_p_y - baseline) * torch.log(log_p_s_a + 1e-30)
                criterion = ce_loss + dice_l.detach().sum()
                hent = alpha_entropy(cfg, alpha, target_last.reshape(b, -1))
                loss_vec = cfg.lambda_l * loss_pred + cfg.lambda_r * loss_2
                loss = cfg.lambda_ins * (
                    loss_vec.sum() - cfg.lambda_e * hent) / b
                dice_metric = dice_l.mean()
                if cfg.debug_loss_terms:
                    debug["loss1"].append(cfg.lambda_l * loss_pred)
                    debug["loss2"].append(cfg.lambda_r * loss_2)
                    debug["hent"].append(cfg.lambda_e * hent)
            else:
                with torch.no_grad():
                    _, eval_dice2 = evaluate_masks(
                        pred_last, target_last, time=2, smooth=cfg.smooth)
                loss = eval_dice2.mean()
                criterion = eval_ce + eval_dice.mean()
                ce_loss = eval_ce
                dice_metric = eval_dice.mean()

            tot = {
                "loss": tot["loss"] + valid * loss,
                "criterion": tot["criterion"] + valid * criterion,
                "ce": tot["ce"] + valid * ce_loss,
                "dice": tot["dice"] + valid * dice_metric,
            }
        if train:
            with torch.no_grad():
                self.baseline.copy_(baseline)
        self.last_points = points  # the glimpses of this call, (B,) each

        denom = maxiter.to(f32)
        out = {
            "loss": tot["loss"] / denom,
            "criterion": tot["criterion"] / denom,
            "ins_ce_loss": tot["ce"] / denom,
            "ins_dice_loss": tot["dice"] / denom,
        }
        if cfg.debug_loss_terms:
            if train:
                out.update({f"debug_{name}": torch.stack(v)
                            for name, v in debug.items()})
            else:
                out["debug_loss1"] = torch.zeros((k_static, b), device=dev)
                out["debug_loss2"] = torch.zeros((k_static, b), device=dev)
                out["debug_hent"] = torch.zeros((k_static,), device=dev)
        return out

    def prep(self, encode, sem_mask, feats):
        """Glimpse-independent half of extraction, once per batch: the
        attention score and the per-level conv1 partials of the
        transformed skips + semantic mask."""
        score = self.attend_score(encode, sem_mask)
        bone = self.bone
        skips_t = bone.transform_skips(feats)
        partials = bone.conv1_partials(skips_t, sem_mask.to(encode.dtype))
        return score, partials

    @torch.no_grad()
    def extract_rounds(
        self, sem_mask, score, partials, max_instances: Optional[int] = None,
        count_budget=None, n_rounds: Optional[int] = None,
        stop_params=None, sync_rounds: bool = True,
    ) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """Extraction rounds from prepped (score, partials).

        sem_mask / score: (B, 1, H, W).  Returns (idmap (B, H, W) int32
        with 0 = background, counts (B,) int32, rounds run).  With
        ``sync_rounds`` the loop ends after the first round that leaves
        every sample done (one host sync per round)."""
        cfg = self.cfg
        b, _, h, w = sem_mask.shape
        hw = h * w
        dev = sem_mask.device
        k_static = max_instances or self.max_n_objects
        G = max(int(cfg.extract_group), 1)
        if n_rounds is None:
            n_rounds = -(-k_static // G)
        min_frac, max_misses, suppress, stop_frac = stop_scalars(
            cfg, stop_params
        )
        f32 = torch.float32
        sem = sem_mask.to(f32).reshape(b, hw)
        fg_px = sem.sum(dim=1)
        min_pixels = torch.clamp(fg_px * min_frac, min=1.0)
        stop_pixels = torch.clamp(fg_px * stop_frac, min=1.0)
        if count_budget is None:
            max_count = torch.full((b,), k_static, dtype=torch.int32,
                                   device=dev)
        else:
            max_count = torch.clamp(count_budget.to(torch.int32),
                                    max=k_static)
        remaining = sem.clone()
        idmap = torch.zeros((b, hw), dtype=torch.int32, device=dev)
        count = torch.zeros((b,), dtype=torch.int32, device=dev)
        misses = torch.zeros((b,), dtype=torch.int32, device=dev)
        done = fg_px <= stop_pixels

        radius = torch.clamp(torch.sqrt(min_pixels), min=3.0)
        est_r = torch.sqrt(
            fg_px / torch.clamp(max_count.to(f32), min=1.0) / math.pi
        )
        if suppress > 0:
            sel_radius = torch.maximum(suppress * est_r, radius).clamp(
                max=min(h, w) / 6.0
            )
        else:
            sel_radius = radius
        flat_score = score.to(f32).reshape(b, hw)
        flat_iota = torch.arange(hw, device=dev)
        bone = self.bone

        rounds = 0
        for _ in range(n_rounds):
            if sync_rounds and bool(done.all()):
                break
            rounds += 1
            # -- G peaks, a disk suppressed around each before the next
            sup = remaining
            points, peak_ok = [], []
            for g in range(G):
                masked = torch.where(
                    sup > 0, flat_score, torch.full_like(flat_score, _NEG_INF)
                )
                s_g = masked.argmax(dim=1)
                points.append(s_g)
                peak_ok.append(sup.gather(1, s_g[:, None])[:, 0] > 0)
                if g + 1 < G:
                    sup = sup * (1.0 - disk(s_g, h, w, sel_radius))
            # -- decode all G glimpses in one pyramid pass (B*G batch)
            pts = torch.stack(points, dim=1).reshape(b * G)
            preds = bone.decode_split(
                pts, partials, G, window=int(cfg.extract_window),
                window_stride=int(cfg.extract_window_stride),
            )
            p = preds[-1]
            m_all = (p[:, 1] > p[:, 0]).to(f32).reshape(b, G, hw)
            # -- resolve the G masks in peak order (earlier peak wins)
            for g in range(G):
                s_g = points[g]
                avail = ~done & peak_ok[g] & (count < max_count)
                still = remaining.gather(1, s_g[:, None])[:, 0] > 0
                live = avail & still
                # the glimpse pixel always joins its mask: progress
                point_plane = (flat_iota[None] == s_g[:, None]).to(f32)
                m_g = torch.clamp(
                    m_all[:, g] * remaining + point_plane * remaining, 0.0, 1.0
                )
                valid_inst = m_g.sum(dim=1) >= min_pixels
                emit = live & valid_inst
                # a degenerate mask: carve a small disk and retry elsewhere
                miss = live & ~valid_inst
                inst_id = (count + 1).to(torch.int32)
                take = emit[:, None] & (m_g > 0) & (idmap == 0)
                idmap = torch.where(take, inst_id[:, None], idmap)
                count = count + emit.to(torch.int32)
                carve = torch.where(
                    emit[:, None], m_g,
                    torch.where(miss[:, None], disk(s_g, h, w, radius),
                                torch.zeros_like(m_g)),
                )
                remaining = remaining * (1.0 - carve)
                misses = torch.where(emit, torch.zeros_like(misses),
                                     misses + miss.to(torch.int32))
                rem_px = remaining.sum(dim=1)
                done = (
                    done | (rem_px <= stop_pixels) | (misses >= max_misses)
                    | (count >= max_count)
                )
        return idmap.reshape(b, h, w), count, rounds
