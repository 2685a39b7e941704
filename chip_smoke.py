#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpuseg_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels (``ir_chain``, ``masked_softmax``,
``sru_scan``) from
``tpuseg_torch/kernels/csrc`` with ``nvcc`` (sm_90a), then:

1. holds the ``ir_chain`` kernel against its plain PyTorch version at the
   five main-path shapes (decode batch 128 = 32 images x 4 glimpses), in
   float32 and bfloat16, with and without the mid-chain skip, and times
   both (CUDA events per chain, ``torch.profiler`` device time per launch,
   the share of the bound of the kernel's route; in float32 also the bound
   with the products on the CUDA cores); then at ``RAGGED_SHAPES`` at every
   width (tiles cut by the image edge, N = 1, fewer tiles than a persistent
   grid has blocks, an image smaller than a tile);
2. runs the batched-inference path end to end in float32 on 4 synthetic
   256x256 images on the card (kernel) and on the CPU (plain version), with
   the committed checkpoint and stopping rule: counts must be equal and
   >= 99.9% of id-map pixels;
3. drives the main path (``Predictor.predict_batch_packed``, the full-width
   CVPPP model, B=32, bfloat16) over 256 synthetic images, timed, with the
   kernel launch counter reset just before and read just after: the chain
   must have run 5 levels x 4 blocks x the rounds run; prints img/s and
   SBD / |DiC| / FG dice against the synthetic ground truth; then the same
   images in float32 (f32 img/s beside the f32 chain's ms a round, its
   launches counted), bf16-vs-f32 count agreement, and the bf16 pass
   without the per-round done-sync;
4. holds the ``masked_softmax`` kernels, forward and backward, against
   their plain PyTorch version at ``(B, N, HW)`` = (2, 32, 65536) and
   (8, 32, 65536) with the instance masks of synthetic scenes (empty
   slots, sizes that vary) and at an odd ``HW``, the backward with a dense
   cotangent and with the training path's (``SOFTMAX_K`` rows per sample
   nonzero), and times them beside the plain version, ``torch.softmax`` on
   pre-masked logits, ``torch._softmax_backward_data`` and the bytes bound
   of each cotangent;
5. runs two float32 train steps at full width (B=2, deterministic
   glimpses, no dropout) on the card (kernels) and on the CPU (plain
   versions), each from equal weights: glimpse points equal, metrics
   within 1e-3, parameters close;
6. drives the training main path (``fit``: the full-width CVPPP model,
   B=8, bfloat16 autocast, sampling and dropout on, a fixed seed) for one
   epoch of 10 steps and one validation batch after 2 warm-up steps, with
   the launch counters reset just before and read just after: the
   ``masked_softmax`` forward must have launched once per train and
   validation step, the backward once per train step, and ``ir_chain`` in
   the validation decode; prints steps/s, peak memory and a breakdown;
7. holds the ``sru_scan`` kernels, forward and backward, against their
   plain versions at the width of the SRU paper's word-level Penn Treebank
   language model (hidden 910, batch 32 x 35 steps, highway bias -3): uni
   (k = 3) and bidirectional (k = 4), the three activations, with and
   without the dropout mask ``mask_c``, one ragged ``mask_pad`` case and
   one 1024-step sequence; forward within 2e-5, backward within rtol 3e-4 /
   atol 3e-5 of the written-out backward and (35 steps) of autograd through
   the plain loop, weight gradients bit-equal over two runs; times both
   (device time, and the host time of a wrapper call) beside the bytes
   bound;
8. runs the 6-layer uni and bidirectional ``SRU`` stacks at that width in
   float32 (TF32 off), forward and backward, on the card (kernels) and on
   the CPU (plain loop) from one set of weights and inputs;
9. drives the SRU training path: 3 SGD steps of the 6-layer uni stack
   (``rnn_dropout`` and ``dropout`` 0.2 from a seeded generator) on a
   fixed random target, with the SRU launch counters reset just before and
   read just after: 6 forward and 6 backward calls per step (one launch
   each); prints ms per step with the GEMMs' and the scans' share
   (``torch.profiler``);
10. drives the inference CLIs on the frozen ``assets/eval_hard64``:
    ``tpuseg_torch.cli.pred_list`` over its 64 images with the committed
    checkpoint, once with ``--f32`` (TF32 first put back to PyTorch's
    defaults, so the CLI's own switch is what holds f32) and once in bf16,
    20 ``ir_chain`` launches a round each, then ``cli.evaluate`` on the
    card; f32 must give the JAX package's CPU counts on every image
    (``assets/eval_hard64_jax_f32.json``), SBD within 2e-3 and FG dice
    within 1e-4 of its means; bf16 SBD >= f32's - 0.01 and |DiC| <= f32's
    + 0.1; prints both beside REPORT.md's TPU numbers and the CLI's wall
    img/s;
11. drives the training CLIs: synthetic records at 530x500 (24 training,
    8 validation scenes), ``cli.train`` at the full CVPPP config, B=8,
    bf16, for 2 epochs, then resumed from its best checkpoint for 1 (the
    step count goes on), then 1 epoch with ``--device_aug``, with the
    ``masked_softmax`` (1 forward launch per train and validation step,
    ``BACKWARD_LAUNCHES`` per train step) and ``ir_chain`` (validation
    decode) counters read around each run; prints steps/s with the loader
    and the share of the train loop spent waiting on the loader; then
    ``pred_list --model`` on the resumed run's checkpoint (its weights
    must be the ones loaded) over 8 images and ``evaluate``.

Prints a ``kernels`` JSON line, the card's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``.  Any failure raises: the
script exits non-zero and prints no result.  Exits 2 when CUDA is absent.
"""

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np

# H100 SXM, dense (NVIDIA's data sheet): everything but matrix products at
# the float32 rate of the CUDA cores; the products at the rate of the route
# the ir_chain kernel takes: bf16 on the tensor cores, float32 as 3xTF32 on
# the tensor cores (three TF32 products for each float32-accurate one, at
# the TF32 dense rate of 494.7 TFLOP/s)
PEAK_F32 = 67e12
PEAK_3XTF32 = 494.7e12 / 3
PEAK_MATMUL = {"float32": PEAK_3XTF32, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
N_DECODE = 128  # B * G on the main path
# (level, H, W, C) of the main path's ir_chain calls at 256^2 with the 192
# window: three full-canvas levels, then the two windowed ones
MAIN_SHAPES = [(0, 16, 16, 256), (1, 32, 32, 128), (2, 64, 64, 64),
               (3, 96, 96, 32), (4, 192, 192, 32)]
# (N, H, W) held against the plain version at every width: H, W not
# multiples of any tile; N = 1 with fewer tiles than a persistent grid; an
# image smaller than one tile
RAGGED_SHAPES = [(5, 20, 28), (3, 40, 24), (1, 20, 28), (2, 13, 11),
                 (1, 5, 3)]


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def chain_bound(n, h, w, c, dtype_name, with_skip, cuda_cores=False):
    """(bytes ms, operations ms): the least time for one chain call is the
    larger — inputs read once and the output written once at the memory
    rate, operations at the card's peak for their type.  Per pixel and
    block: the two pointwise products (8 C^2 FLOPs) at the matrix rate of
    the kernel's route (``PEAK_MATMUL``); the depthwise taps (36 C), the two
    bias + relu6 passes (12 C) and the residual + b3 (2 C), accumulated in
    float32, at the CUDA cores' float32 rate.  The two kinds run on
    different units, so the larger time bounds.  ``cuda_cores``: the
    float32 products on the CUDA cores too, where both kinds add (the
    yardstick of a kernel that keeps its products off the tensor cores)."""
    es = 4 if dtype_name == "float32" else 2
    act = n * h * w * c * es
    weights = 4 * (2 * c * 2 * c * es + (2 * c * 2 + 2 * c * 9 + c) * 4)
    nbytes = act * (3 if with_skip else 2) + weights
    px = n * h * w * 4
    other_s = px * 50 * c / PEAK_F32
    if cuda_cores:
        ops_s = px * 8 * c * c / PEAK_F32 + other_s
    else:
        ops_s = max(px * 8 * c * c / PEAK_MATMUL[dtype_name], other_s)
    return 1e3 * nbytes / PEAK_BYTES, 1e3 * ops_s


def phase_kernel_vs_plain(model, dev):
    """ir_chain kernel vs plain at the main-path shapes."""
    import torch

    from tpuseg_torch.kernels.ir_chain import (
        ir_chain, ir_chain_plain, stack_chain_params,
    )

    KERNEL_NAME = {torch.float32: "ir_block_kernel",
                   torch.bfloat16: "ir_block_tc_kernel"}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    levels = model.decoder.bone.levels
    rows, max_abs_f32, max_rel_bf16 = [], 0.0, 0.0
    g = torch.Generator(device="cpu").manual_seed(0)
    for lvl, h, w, c in MAIN_SHAPES:
        blocks = [levels[lvl].dil1a, levels[lvl].dil1b, levels[lvl].dil2a,
                  levels[lvl].dil2b]
        x32 = torch.randn(N_DECODE, h, w, c, generator=g).to(dev)
        s32 = torch.randn(N_DECODE, h, w, c, generator=g).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            params = [t.to(dev) for t in stack_chain_params(blocks, dtype)]
            p32 = [t.float() for t in params]
            x, s = x32.to(dtype), s32.to(dtype)
            for skip in (None, s):
                got = ir_chain(x, skip, *params)
                torch.cuda.synchronize()
                want = ir_chain_plain(x.float(), None if skip is None
                                      else skip.float(), *p32)
                err = (got.float() - want).abs().max().item()
                scale = want.abs().max().item()
                tol = 1e-4 if dtype == torch.float32 else 2e-2
                if not err <= tol * scale:
                    raise AssertionError(
                        f"ir_chain {name} level {lvl} skip={skip is not None}"
                        f": max|err| {err:.3e} > {tol} * max|y| {scale:.3e}"
                    )
                if dtype == torch.float32:
                    max_abs_f32 = max(max_abs_f32, err)
                else:
                    max_rel_bf16 = max(max_rel_bf16, err / scale)
                iters = max(3, min(50, int(2e8 // (N_DECODE * h * w * c))))
                k_ms = cuda_ms(lambda: ir_chain(x, skip, *params), iters)
                p_ms = cuda_ms(lambda: ir_chain_plain(x, skip, *params), iters)
                # device time of one launch (one block of the chain)
                dev_ms = kernel_device_ms(
                    lambda: ir_chain(x, skip, *params), 3,
                    KERNEL_NAME[dtype], launches=4)
                b_ms, o_ms = chain_bound(N_DECODE, h, w, c, name,
                                         skip is not None)
                core_ms = (max(chain_bound(N_DECODE, h, w, c, name,
                                           skip is not None, True))
                           if dtype == torch.float32 else None)
                rows.append({
                    "level": lvl, "shape": [N_DECODE, h, w, c], "dtype": name,
                    "skip": skip is not None, "ms": k_ms, "plain_ms": p_ms,
                    "device_ms_per_launch": None if dev_ms is None
                    else dev_ms / 4,
                    "bound_ms": max(b_ms, o_ms), "bytes_ms": b_ms,
                    "ops_ms": o_ms,
                    # float32: the same work with every product on the
                    # CUDA cores
                    "bound_cuda_cores_ms": core_ms,
                    "bound_by": "bytes" if b_ms >= o_ms else "operations",
                    "bound_share": max(b_ms, o_ms) / k_ms,
                    "max_abs_err": err, "max_abs_y": scale,
                })
                r = rows[-1]
                dev_txt = ("not traced" if dev_ms is None
                           else f"{r['device_ms_per_launch']:.4f} ms")
                log(f"  ir_chain L{lvl} {r['shape']} {name} skip={r['skip']}: "
                    f"kernel {k_ms:.3f} ms ({r['bound_share']:.1%} of its "
                    f"bound), device per launch {dev_txt}, plain {p_ms:.3f} "
                    f"ms, bound {r['bound_ms']:.4f} ms"
                    + ("" if core_ms is None else
                       f" (products on the CUDA cores {core_ms:.4f} ms)")
                    + f", max|err| {err:.3e} (max|y| {scale:.3e})")
        del x32, s32
    # ragged tiles, N = 1 and fewer tiles than a persistent grid has
    # blocks: the level of each width, both types, with and without the skip
    ragged = []
    for lvl, c in ((0, 256), (1, 128), (2, 64), (3, 32)):
        blocks = [levels[lvl].dil1a, levels[lvl].dil1b, levels[lvl].dil2a,
                  levels[lvl].dil2b]
        for dtype in (torch.float32, torch.bfloat16):
            params = [t.to(dev) for t in stack_chain_params(blocks, dtype)]
            p32 = [t.float() for t in params]
            for n, h, w in RAGGED_SHAPES:
                x = torch.randn(n, h, w, c, generator=g).to(dev, dtype)
                s = torch.randn(n, h, w, c, generator=g).to(dev, dtype)
                for skip in (None, s):
                    got = ir_chain(x, skip, *params)
                    torch.cuda.synchronize()
                    want = ir_chain_plain(x.float(), None if skip is None
                                          else skip.float(), *p32)
                    err = (got.float() - want).abs().max().item()
                    scale = want.abs().max().item()
                    tol = 1e-4 if dtype == torch.float32 else 2e-2
                    if not err <= tol * scale:
                        raise AssertionError(
                            f"ir_chain {dtype} C={c} ({n},{h},{w}) skip="
                            f"{skip is not None}: max|err| {err:.3e} > {tol}"
                            f" * max|y| {scale:.3e}")
                    ragged.append(err / scale)
                    if dtype == torch.float32:
                        max_abs_f32 = max(max_abs_f32, err)
                    else:
                        max_rel_bf16 = max(max_rel_bf16, err / scale)
    log(f"  ir_chain ragged / N=1 / few-tile shapes {RAGGED_SHAPES} x C in "
        f"(256, 128, 64, 32) x f32, bf16 x skip: {len(ragged)} cases within "
        f"tolerance, max|err|/max|y| {max(ragged):.3e}")
    torch.cuda.empty_cache()
    return rows, max_abs_f32, max_rel_bf16


def softmax_bound_ms(b, n, hw, active=None):
    """Bytes bounds (forward, backward) in ms: each input read once, each
    output written once, at the card's memory rate.  Forward reads e and
    the float32 mask and writes p; backward reads g, p where g is nonzero
    (``active`` rows of the B*N, all of them when None) and writes de."""
    active = b * n if active is None else active
    fwd = b * hw * 4 + b * n * hw * 8
    bwd = b * n * hw * 4 + active * hw * 4 + b * hw * 4
    return 1e3 * fwd / PEAK_BYTES, 1e3 * bwd / PEAK_BYTES


SOFTMAX_K = 2  # instances per sample that the training loss differentiates


def softmax_cotangent(mask, kind, seed):
    """(g (B, N, HW) on mask's device, its count of nonzero rows).  "dense":
    every element N(0, 1).  "main": as the training path gives it (only the
    instances the glimpse loop picked get a cotangent): ``SOFTMAX_K`` rows
    per sample picked by a seeded permutation among its non-empty
    instances, N(0, 1), every other row exact zeros."""
    import torch

    b, n, hw = mask.shape
    gen = torch.Generator().manual_seed(seed)
    g = torch.randn(b, n, hw, generator=gen)
    if kind == "dense":
        return g.to(mask.device), b * n
    nonempty = (mask.sum(dim=-1) > 0).cpu()
    keep = torch.zeros(b, n, dtype=torch.bool)
    for i in range(b):
        rows = torch.nonzero(nonempty[i])[:, 0]
        keep[i, rows[torch.randperm(len(rows), generator=gen)[:SOFTMAX_K]]] = (
            True)
    g = torch.where(keep[..., None], g, torch.zeros(()))
    return g.to(mask.device), int(keep.sum())


def softmax_inputs(rng, gen, b, side, dev):
    """(e (B, HW), mask (B, 32, HW), empty instance count) on ``dev``: the
    instance masks of ``b`` synthetic scenes cut to ``side`` x ``side``
    (empty slots, sizes that vary) and scores N(0, 9) on the foreground."""
    import torch

    from tpuseg_torch.data.synthetic import make_batch

    batch = make_batch(rng, b, 256, 256, 32, hard=True)
    ins = torch.from_numpy(batch["ins_masks"][:, :side, :side])
    n, hw = ins.shape[-1], side * side
    mask = ins.permute(0, 3, 1, 2).reshape(b, n, hw).contiguous().to(dev)
    empty = int((mask.sum(dim=-1) == 0).sum())
    sem = (mask.sum(dim=1) > 0).float()
    e = (3.0 * torch.randn(b, hw, generator=gen)).to(dev) * sem
    return e, mask, empty


def sm_kernel_ms(row, sfx):
    """Forward + backward kernel time of a ``phase_masked_softmax`` row
    (the backward with cotangent ``sfx``): device time where the profiler
    traced it, else the event time."""
    fwd = row["forward_device_ms"] or row["forward_ms"]
    return fwd + (row["backward_device_ms" + sfx] or row["backward_ms" + sfx])


def phase_masked_softmax(dev):
    """masked_softmax kernels vs plain at the training path's shapes, the
    backward with a dense g and with the training path's g."""
    import torch

    from tpuseg_torch.kernels.masked_softmax import (
        BACKWARD_LAUNCHES, masked_softmax, masked_softmax_backward,
        masked_softmax_backward_plain, masked_softmax_plain,
    )

    rows, max_p_err, max_de_rel = [], 0.0, 0.0
    rng = np.random.default_rng(11)
    g_cpu = torch.Generator(device="cpu").manual_seed(1)
    for b, side in ((2, 256), (8, 256), (2, 255)):
        e, mask, empty = softmax_inputs(rng, g_cpu, b, side, dev)
        n, hw = mask.shape[1], side * side
        row = {"shape": [b, n, hw], "empty_instances": empty}
        with torch.no_grad():
            pk_d = masked_softmax(e, mask)
            pp_d = masked_softmax_plain(e, mask)
        if not torch.isfinite(pk_d).all():
            raise AssertionError("masked_softmax: non-finite output")
        p_err = (pk_d - pp_d).abs().max().item()
        if not p_err <= 1e-6:
            raise AssertionError(
                f"masked_softmax ({b},{n},{hw}): max|p err| {p_err:.3e} > 1e-6")
        max_p_err = max(max_p_err, p_err)
        # timings, forward
        logits = torch.where(mask > 0, e[:, None, :],
                             torch.full_like(e[:, None, :], -1e30))
        with torch.no_grad():
            row["forward_ms"] = cuda_ms(lambda: masked_softmax(e, mask), 20)
            row["forward_device_ms"] = kernel_device_ms(
                lambda: masked_softmax(e, mask), 10, "masked_softmax_fwd")
            row["plain_forward_ms"] = cuda_ms(
                lambda: masked_softmax_plain(e, mask), 20)
            row["torch_softmax_ms"] = cuda_ms(
                lambda: torch.softmax(logits, dim=-1), 20)
        del logits
        row["bound_forward_ms"], _ = softmax_bound_ms(b, n, hw)
        for kind in ("dense", "main"):
            g, active = softmax_cotangent(mask, kind, seed=b * 1000 + side)
            ek = e.clone().requires_grad_()
            (dk,) = torch.autograd.grad(masked_softmax(ek, mask), ek, g)
            torch.cuda.synchronize()
            ep = e.clone().requires_grad_()
            (dp,) = torch.autograd.grad(masked_softmax_plain(ep, mask), ep, g)
            de_err = (dk - dp).abs().max().item()
            de_scale = dp.abs().max().item()
            if not torch.isfinite(dk).all():
                raise AssertionError("masked_softmax: non-finite gradient")
            if not de_err <= 1e-5 * de_scale:
                raise AssertionError(
                    f"masked_softmax ({b},{n},{hw}) {kind} g: max|de err| "
                    f"{de_err:.3e} > 1e-5 * max|de| {de_scale:.3e}")
            max_de_rel = max(max_de_rel, de_err / de_scale)
            sfx = "" if kind == "dense" else "_main"
            with torch.no_grad():
                # the backward launches themselves (autograd's own host
                # time per call would outlast two kernels this short)
                row["backward_ms" + sfx] = cuda_ms(
                    lambda: masked_softmax_backward(pk_d, g), 20)
                row["backward_device_ms" + sfx] = kernel_device_ms(
                    lambda: masked_softmax_backward(pk_d, g), 10,
                    "masked_softmax_", launches=BACKWARD_LAUNCHES)
                row["plain_backward_ms" + sfx] = cuda_ms(
                    lambda: masked_softmax_backward_plain(pk_d, g), 20)
                # the per-row part of the backward, p * (g - sum p g); the
                # sum over the instances is extra
                row["library_backward_ms" + sfx] = cuda_ms(
                    lambda: torch._softmax_backward_data(
                        g, pk_d, -1, torch.float32), 20)
            row["bound_backward_ms" + sfx] = softmax_bound_ms(
                b, n, hw, active)[1]
            row["active_rows" + sfx] = active
            row["max_de_rel_err" + sfx] = de_err / de_scale
            del g, ek, ep, dk, dp
        row["max_p_err"] = p_err
        rows.append(row)
        r = row
        log(f"  masked_softmax {r['shape']} ({empty} empty instances): "
            f"forward {r['forward_ms']:.4f} ms (plain "
            f"{r['plain_forward_ms']:.3f}, torch.softmax on masked logits "
            f"{r['torch_softmax_ms']:.4f}, bound {r['bound_forward_ms']:.4f})"
            f"; backward dense g {r['backward_ms']:.4f} ms (plain "
            f"{r['plain_backward_ms']:.3f}, torch._softmax_backward_data "
            f"{r['library_backward_ms']:.4f}, bound "
            f"{r['bound_backward_ms']:.4f}); backward main-path g "
            f"({r['active_rows_main']} of {b * n} rows nonzero) "
            f"{r['backward_ms_main']:.4f} ms (plain "
            f"{r['plain_backward_ms_main']:.3f}, library "
            f"{r['library_backward_ms_main']:.4f}, bound "
            f"{r['bound_backward_ms_main']:.4f}); device ms per call: "
            f"forward {r['forward_device_ms']}, backward dense "
            f"{r['backward_device_ms']}, main {r['backward_device_ms_main']}")
        del pk_d, pp_d, e, mask
    torch.cuda.empty_cache()
    return rows, max_p_err, max_de_rel


def rebuild(cfg, model, **decoder_kw):
    """(cfg with the decoder options replaced, a fresh float32 ``ReSeg``
    built for it holding ``model``'s weights)."""
    import dataclasses

    from tpuseg_torch.models import ReSeg

    cfg = dataclasses.replace(
        cfg, decoder=dataclasses.replace(cfg.decoder, **decoder_kw))
    new = ReSeg(cfg)
    new.load_state_dict(model.state_dict())
    return cfg, new


GLIMPSE_METRICS = ("ins_cost", "criterion", "ins_ce_loss", "ins_dice_loss",
                   "cost", "grad_norm")


def glimpse_tie(cfg, model_before, batch, point_a, point_b, slot):
    """Largest relative gap between the attention mass of two candidate
    glimpses, per sample, under the (CPU) model as it stood before the
    step: ``argmax`` picks either of two pixels that tie."""
    import torch

    from tpuseg_torch.runtime.train import model_inputs

    images, sem, ins, _ = model_inputs(batch, "cpu")
    m = model_before.train()
    with torch.no_grad():
        x_dec, _, _ = m._backbone(images)
        sem_mask = sem.argmax(dim=1, keepdim=True).float()
        x_enc = m.ins_stem(x_dec)
        p, _ = m.decoder.attend(m.decoder.s_sp(x_enc, sem_mask), sem_mask, ins)
    alpha = p[:, slot].reshape(p.shape[0], -1)  # deterministic: slot k
    a = alpha.gather(1, point_a[:, None])[:, 0]
    b = alpha.gather(1, point_b[:, None])[:, 0]
    return ((a - b).abs() / torch.maximum(a, b).clamp(min=1e-30)).max().item()


def phase_train_f32(cfg, model, dev):
    """Two float32 train steps, card (kernels) against CPU (plain).  Each
    step starts from equal weights on both devices: step 0 from the
    checkpoint, step 1 from the CPU's state after step 0, copied to the
    card (parameters, statistics, optimizer slots).  Per step: the glimpse
    points equal, every metric within 1e-3 (``grad_norm``, the norm of the
    raw gradients, among them), and the parameters after the step by
    quantiles: median within 5e-6, 99% of the elements within 5e-4, none
    further apart than 6.4e-3.  Two pixels whose attention mass ties to
    within 1e-3 may turn the ``argmax`` that picks a glimpse; then what
    follows from the glimpse is not compared in that step.  Any other
    difference raises."""
    import torch

    from tpuseg_torch.data.synthetic import make_batch
    from tpuseg_torch.kernels.masked_softmax import masked_softmax
    from tpuseg_torch.runtime.state import create_train_state
    from tpuseg_torch.runtime.train import make_train_step

    rng = np.random.default_rng(5)
    batches = [make_batch(rng, 2, 256, 256, cfg.data.max_n_objects, hard=True)
               for _ in range(2)]
    side = {}
    for name, device in (("cpu", "cpu"), ("card", dev)):
        dcfg, m = rebuild(cfg, model, deterministic_glimpse=True,
                          drop_rate=0.0)
        state = create_train_state(dcfg, m, device=device)
        side[name] = dict(model=m, state=state, step=make_train_step(dcfg, m),
                          seconds=0.0)

    def flat_params(m):
        return torch.cat([p.detach().flatten().cpu() for p in m.parameters()])

    ties, worst, worst_norm, stats = [], 0.0, 0.0, []
    for i, b in enumerate(batches):
        if i > 0:
            side["card"]["state"].load_state_dict(
                copy.deepcopy(side["cpu"]["state"].state_dict()))
            if not torch.equal(flat_params(side["cpu"]["model"]),
                               flat_params(side["card"]["model"])):
                raise AssertionError("the card did not take the CPU's state")
        before = copy.deepcopy(side["cpu"]["model"])
        got = {}
        for name, sd in side.items():
            launches = masked_softmax.launches
            t = time.perf_counter()
            sd["state"], met = sd["step"](sd["state"], b, None)
            got[name] = ({k: float(v) for k, v in met.items()},
                         [p.cpu() for p in sd["model"].decoder.last_points])
            sd["seconds"] += time.perf_counter() - t
            want = 0 if name == "cpu" else 3  # 1 forward + 2 backward
            if masked_softmax.launches - launches != want:
                raise AssertionError(
                    f"masked_softmax launches on {name}: "
                    f"{masked_softmax.launches - launches}, want {want}")
        (mc, pc), (mg, pg) = got["cpu"], got["card"]
        tied = False
        for slot, (a, c) in enumerate(zip(pc, pg)):
            if not torch.equal(a, c):
                gap = glimpse_tie(dcfg, before, b, a, c, slot)
                log(f"  step {i} slot {slot}: glimpses cpu {a.tolist()} card "
                    f"{c.tolist()} tie to {gap:.2e} in the attention map")
                if not gap <= 1e-3:
                    raise AssertionError(
                        f"glimpse points differ without a tie: cpu "
                        f"{a.tolist()} card {c.tolist()} (gap {gap:.2e})")
                tied = True
        if tied:
            ties.append(i)
        for k in mc:
            if not (np.isfinite(mc[k]) and np.isfinite(mg[k])):
                raise AssertionError(f"train metric {k} not finite")
            if tied and k in GLIMPSE_METRICS:
                continue
            rel = abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-6)
            if k == "grad_norm":
                worst_norm = max(worst_norm, rel)
            else:
                worst = max(worst, rel)
            if not rel <= 1e-3:
                raise AssertionError(
                    f"step {i} metric {k}: card {mg[k]} cpu {mc[k]} "
                    f"(rel {rel:.2e})")
        diff = (flat_params(side["cpu"]["model"])
                - flat_params(side["card"]["model"])).abs()
        q = torch.quantile(diff[:: max(1, diff.numel() // 1_000_000)],
                           torch.tensor([0.5, 0.99])).tolist()
        stats.append((q[0], q[1], diff.max().item()))
        # an Adadelta step moves an element by at most 3.2e-3 whatever the
        # gradient's size and turns with its sign, so an element whose
        # gradient is float noise around zero may end 6.4e-3 apart
        if not tied and not (q[0] <= 5e-6 and q[1] <= 5e-4
                             and stats[-1][2] <= 6.4e-3):
            raise AssertionError(
                f"parameters after step {i} differ: median {q[0]:.2e}, p99 "
                f"{q[1]:.2e}, max {stats[-1][2]:.2e}")
    per_step = "; ".join(
        f"step {i} params |diff| median {a:.2e} p99 {b:.2e} max {c:.2e}"
        for i, (a, b, c) in enumerate(stats))
    log(f"phase train-f32 (256x256, B=2, 2 steps from equal weights): glimpse "
        f"points {'equal' if not ties else f'tied in steps {ties}'}, worst "
        f"metric rel diff {worst:.2e} (grad_norm {worst_norm:.2e}); "
        f"{per_step}; last cost card {mg['cost']:.4f} cpu {mc['cost']:.4f}; "
        f"cpu {side['cpu']['seconds']:.1f} s, card "
        f"{side['card']['seconds']:.1f} s")
    return {"worst_metric_rel": worst, "grad_norm_rel": worst_norm,
            "param_diff_median": [s[0] for s in stats],
            "param_diff_p99": [s[1] for s in stats],
            "param_diff_max": [s[2] for s in stats], "tied_steps": ties}


def phase_train_timed(cfg, model, dev, softmax_rows):
    """The training main path: ``fit`` at full width, B=8, bf16 autocast."""
    import tempfile

    import torch

    from tpuseg_torch.data.synthetic import make_batch
    from tpuseg_torch.kernels.ir_chain import ir_chain
    from tpuseg_torch.kernels.masked_softmax import (
        BACKWARD_LAUNCHES, FORWARD_LAUNCHES, masked_softmax,
    )
    from tpuseg_torch.runtime import train as rt
    from tpuseg_torch.runtime.loop import fit
    from tpuseg_torch.runtime.state import create_train_state

    B, n_warm, n_steps, n_val = 8, 2, 10, 1
    assert not cfg.decoder.deterministic_glimpse and cfg.decoder.drop_rate > 0
    assert cfg.decoder.remat and cfg.decoder.hoist_skips_train
    rng = np.random.default_rng(13)
    t0 = time.perf_counter()
    batches = [make_batch(rng, B, 256, 256, cfg.data.max_n_objects, hard=True)
               for _ in range(n_warm + n_steps + n_val)]
    log(f"made {len(batches)} synthetic train batches of {B} in "
        f"{time.perf_counter() - t0:.1f} s")
    warm, train_b = batches[:n_warm], batches[n_warm:n_warm + n_steps]
    val_b = batches[n_warm + n_steps:]
    m = copy.deepcopy(model)
    state = create_train_state(cfg, m, device=dev)
    gen = torch.Generator(device=dev).manual_seed(cfg.train.seed)
    dtype = torch.bfloat16
    step = rt.make_train_step(cfg, m, dtype=dtype)
    costs = []
    for b in warm:  # cuDNN plans, allocator, kernel load
        state, met = step(state, b, gen)
        costs.append(float(met["cost"]))

    # -- a timed loop of steps (host clock around synchronize)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    mets = []
    for b in train_b:
        state, met = step(state, b, gen)
        mets.append(met)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    costs += [float(x["cost"]) for x in mets]
    if not np.isfinite(costs).all():
        raise AssertionError(f"non-finite training cost: {costs}")

    # -- where a step's time goes: forward / backward / optimizer
    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, 1e3 * (time.perf_counter() - t)

    parts = {"forward": [], "backward": [], "optimizer": []}
    for b in train_b[:3]:
        m.train()
        m.zero_grad(set_to_none=True)
        (cost, _), f_ms = timed(lambda: rt._forward(
            cfg, m, b, dev, dtype, gen, train=True))
        _, b_ms = timed(cost.backward)
        _, o_ms = timed(state.apply_gradients)
        for k, v in zip(parts, (f_ms, b_ms, o_ms)):
            parts[k].append(v)
    parts = {k: float(np.median(v)) for k, v in parts.items()}

    # -- the entry point, with the launch counters around it
    run_dir = tempfile.mkdtemp(prefix="chip_smoke_fit_")
    step0 = state.step
    masked_softmax.launches = 0
    masked_softmax.forward_launches = 0
    masked_softmax.backward_launches = 0
    ir_chain.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    state = fit(cfg, m, state, lambda epoch: train_b, lambda epoch: val_b,
                run_dir, n_epochs=1, generator=gen, dtype=dtype)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    counts = {
        "forward": masked_softmax.forward_launches,
        "backward": masked_softmax.backward_launches,
        "total": masked_softmax.launches,
        "ir_chain": ir_chain.launches,
    }
    want_f = FORWARD_LAUNCHES * (n_steps + n_val)
    want_b = BACKWARD_LAUNCHES * n_steps
    if state.step - step0 != n_steps:
        raise AssertionError(f"fit took {state.step - step0} steps")
    if counts["forward"] != want_f or counts["backward"] != want_b:
        raise AssertionError(
            f"masked_softmax launches {counts}: want forward {want_f} "
            f"({n_steps} train + {n_val} validation steps), backward "
            f"{want_b} ({BACKWARD_LAUNCHES} per train step)")
    if counts["ir_chain"] <= 0 or counts["ir_chain"] % 20:
        raise AssertionError(
            f"ir_chain launches {counts['ir_chain']} in the validation "
            f"decode: want a positive multiple of 5 levels x 4 blocks")
    files = sorted(os.listdir(run_dir))
    if not ({"training.log", "validation.log", "metrics.jsonl"} <= set(files)
            and any(f.startswith("model_0_") for f in files)):
        raise AssertionError(f"fit wrote {files}")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    for rec in recs:
        bad = [k for k, v in rec.items()
               if isinstance(v, float) and not np.isfinite(v)]
        if bad:
            raise AssertionError(f"fit logged non-finite {bad}: {rec}")
    import shutil

    shutil.rmtree(run_dir, ignore_errors=True)

    row8 = [r for r in softmax_rows if r["shape"][0] == B][0]
    k_ms = sm_kernel_ms(row8, "_main")
    ms_step = 1e3 * dt / n_steps
    log(f"phase train-timed (256x256 full width, B={B}, bf16 autocast, "
        f"sampling + dropout, remat): {n_steps / dt:.3f} steps/s, "
        f"{ms_step:.1f} ms/step, {B * n_steps / dt:.2f} img/s, peak memory "
        f"{peak / 2**30:.2f} GiB; cost first {costs[0]:.4f} last "
        f"{costs[-1]:.4f}")
    log(f"  step breakdown (median of 3, host clock around synchronize): "
        f"forward {parts['forward']:.1f} ms, backward {parts['backward']:.1f}"
        f" ms, optimizer {parts['optimizer']:.1f} ms; masked_softmax "
        f"forward + backward {k_ms:.3f} ms = {100 * k_ms / ms_step:.2f}% of "
        f"a step")
    log(f"  fit (1 epoch: {n_steps} train steps + {n_val} validation batch + "
        f"checkpoint): {fit_s:.1f} s; masked_softmax launches forward "
        f"{counts['forward']} backward {counts['backward']}, ir_chain "
        f"launches {counts['ir_chain']} (validation decode); val "
        f"ins_dice_loss {recs[-1]['ins_dice_loss']:.4f}")
    return {
        "steps_per_s": n_steps / dt, "ms_per_step": ms_step,
        "img_per_s": B * n_steps / dt, "peak_memory_gib": peak / 2**30,
        "cost_first": costs[0], "cost_last": costs[-1],
        "forward_ms": parts["forward"], "backward_ms": parts["backward"],
        "optimizer_ms": parts["optimizer"],
        "masked_softmax_share": k_ms / ms_step, "fit_seconds": fit_s,
        "launches": counts,
    }


# The SRU path's full width: the word-level Penn Treebank language model of
# Lei et al. (2018), "Simple Recurrent Units for Highly Parallelizable
# Recurrence" (the public taolei87/sru language_model example): 6 layers,
# input = hidden = 910, batch 32 x 35 steps, highway bias -3.
SRU_LM = dict(layers=6, width=910, batch=32, length=35, highway_bias=-3.0)
SRU_LONG = 1024  # one long sequence, where the scan outlasts a launch
SRU_FWD_TOL = dict(rtol=2e-5, atol=2e-5)  # tests/test_sru.py
SRU_BWD_TOL = dict(rtol=3e-4, atol=3e-5)


def bytes_ms(*tensors):
    """The bytes bound in ms: each tensor moved once at the memory rate."""
    moved = sum(4 * t.numel() for t in tensors if t is not None)
    return 1e3 * moved / PEAK_BYTES


def host_ms(fn, calls):
    """Host time per call: ``calls`` back-to-back calls on the host clock,
    the queue drained before and after (valid where a call's host work
    outlasts its kernels, as the wrappers' do at L = 35)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return 1e3 * dt / calls


def kernel_device_ms(fn, calls, name_part, launches=1):
    """Device time per call of the kernels whose name holds ``name_part``,
    ``launches`` launches per call, from ``torch.profiler`` over ``calls``
    calls, or None when the trace holds none.  Per kernel name it takes the
    mean time of the launches the trace recorded (a trace may miss some),
    sums the names' means and scales the sum to ``launches`` launches.
    Where a kernel takes tens of microseconds, back-to-back calls timed with
    events read the pace of the Python wrapper instead."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per_name = {}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and name_part in e.name):
            us, n = per_name.get(e.name, (0.0, 0))
            per_name[e.name] = (us + e.device_time, n + 1)
    if not per_name:
        return None
    means = sum(us / n for us, n in per_name.values())
    return means * launches / len(per_name) / 1e3


def within(got, want, rtol, atol, what):
    """Max |got - want|; raises unless every element is within
    ``atol + rtol * |want|``."""
    import torch

    if (got is None) != (want is None):
        raise AssertionError(f"{what}: one side has no result")
    if got is None:
        return 0.0
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite values")
    diff = (got - want).abs()
    if not (diff <= atol + rtol * want.abs()).all():
        raise AssertionError(
            f"{what}: max|err| {diff.max().item():.3e} beyond atol {atol} + "
            f"rtol {rtol} (max|want| {want.abs().max().item():.3e})")
    return diff.max().item()


def sru_case(dev, length, bidir, activation, mask_c, pad, seed):
    """Inputs of one scan at the language-model width: u = x @ W with the
    init recipe's W (highway bias -3), x ~ N(0, 1), a small c0; k = 3 uni,
    k = 4 bidirectional (input 910, output 1820)."""
    import torch

    from tpuseg_torch.nn import SRUCell

    w, b = SRU_LM["width"], SRU_LM["batch"]
    g = torch.Generator().manual_seed(seed)
    cell = SRUCell(w, w, bidirectional=bidir, activation=activation,
                   highway_bias=SRU_LM["highway_bias"], generator=g)
    ndir = 2 if bidir else 1
    x = torch.randn(length, b, w, generator=g).to(dev)
    u = (x.reshape(-1, w) @ cell.weight.detach().to(dev)).reshape(
        length, b, -1)
    a = {"u": u, "x": x, "weight_c": cell.weight_c.detach().to(dev),
         "bias": cell.bias.detach().to(dev),
         "c0": (0.5 * torch.randn(b, ndir * w, generator=g)).to(dev),
         "mask_c": None, "mask_pad": None}
    if mask_c:
        a["mask_c"] = (torch.bernoulli(torch.full((b, ndir * w), 0.8),
                                       generator=g) / 0.8).to(dev)
    if pad:
        lengths = torch.randint(1, length + 1, (b,), generator=g)
        lengths[0] = length
        a["mask_pad"] = (torch.arange(length)[:, None]
                         >= lengths[None]).float().to(dev)
    spec = (w, activation, bidir, True, cell.scale_x)
    return a, spec, cell._k()


def phase_sru_kernels(dev):
    """sru_scan kernels vs plain at the language model's width."""
    import torch

    from tpuseg_torch.kernels.sru_scan import (
        BACKWARD_LAUNCHES, sru_scan_backward, sru_scan_backward_plain,
        sru_scan_forward,
    )
    from tpuseg_torch.nn import sru_recurrence
    from tpuseg_torch.nn.sru import sru_states

    torch.backends.cuda.matmul.allow_tf32 = False
    length = SRU_LM["length"]
    cases = [(length, bidir, act, mc, False)
             for bidir in (False, True) for act in (0, 1, 2)
             for mc in (False, True)]
    cases += [(length, False, 1, True, True),
              (SRU_LONG, False, 0, True, False)]
    names = ("u", "x", "weight_c", "bias", "c0", "mask_c", "mask_pad")
    rows, max_fwd, max_bwd = [], 0.0, 0.0
    for i, (length, bidir, act, mc, pad) in enumerate(cases):
        a, spec, k = sru_case(dev, length, bidir, act, mc, pad, seed=100 + i)
        args = [a[n] for n in names]
        kw = dict(d=spec[0], activation=act, bidirectional=bidir,
                  has_skip_term=True, scale_x=spec[4], mask_pad=a["mask_pad"],
                  mask_c=a["mask_c"])
        label = (f"sru L={length} {'bi' if bidir else 'uni'} k={k} act={act}"
                 f"{' mask_c' if mc else ''}{' mask_pad' if pad else ''}")
        h, cf, c_all = sru_scan_forward(*args, *spec)
        hp, cfp, c_allp = sru_states(*args[:5], **kw)
        err_f = max(within(h, hp, **SRU_FWD_TOL, what=f"{label} h"),
                    within(cf, cfp, **SRU_FWD_TOL, what=f"{label} c_final"),
                    within(c_all, c_allp, **SRU_FWD_TOL, what=f"{label} c"))
        gen = torch.Generator().manual_seed(200 + i)
        gh = torch.randn(h.shape, generator=gen).to(dev)
        gcf = torch.randn(cf.shape, generator=gen).to(dev)
        got = sru_scan_backward(*args, c_all, gh, gcf, *spec)
        again = sru_scan_backward(*args, c_all, gh, gcf, *spec)
        torch.cuda.synchronize()
        for gname, g1, g2 in zip(("du", "dx", "dweight_c", "dbias", "dc0"),
                                 got, again):
            if not (g1 is None or torch.equal(g1, g2)):
                raise AssertionError(f"{label}: {gname} differs between two "
                                     f"backward runs")
        want = sru_scan_backward_plain(*args, c_all, gh, gcf, *spec)
        gnames = ("du", "dx", "dweight_c", "dbias", "dc0")
        err_b = max(within(g, w, **SRU_BWD_TOL, what=f"{label} {n}")
                    for n, g, w in zip(gnames, got, want))
        if length == SRU_LM["length"]:
            leaves = [t.clone().requires_grad_() for t in args[:5]]
            hh, cc = sru_recurrence(*leaves, **kw)
            ((hh * gh).sum() + (cc * gcf).sum()).backward()
            err_b = max(err_b, *(
                within(g, leaf.grad, **SRU_BWD_TOL,
                       what=f"{label} {n} vs autograd")
                for n, g, leaf in zip(gnames, got, leaves)
                if leaf.grad is not None or g is not None))
            del leaves, hh, cc
        max_fwd, max_bwd = max(max_fwd, err_f), max(max_bwd, err_b)
        # times: the kernels' device time (profiler) and a call's time
        # (CUDA events over back-to-back calls, wrapper included); plain at
        # few iterations (it is thousands of launches)
        p_iters = 2 if length > 100 else 5
        def fwd():
            return sru_scan_forward(*args, *spec)

        def bwd():
            return sru_scan_backward(*args, c_all, gh, gcf, *spec)

        with torch.no_grad():
            fc_ms, bc_ms = cuda_ms(fwd, 20), cuda_ms(bwd, 20)
            f_ms = kernel_device_ms(fwd, 10, "sru_") or fc_ms
            b_ms = kernel_device_ms(bwd, 10, "sru_",
                                    launches=BACKWARD_LAUNCHES) or bc_ms
            fh_ms, bh_ms = host_ms(fwd, 50), host_ms(bwd, 50)
            pf_ms = cuda_ms(lambda: sru_states(*args[:5], **kw), p_iters, 1)
            pb_ms = cuda_ms(lambda: sru_scan_backward_plain(
                *args, c_all, gh, gcf, *spec), p_iters, 1)
        x_in = a["x"] if k == 3 else None
        small = (a["weight_c"], a["bias"], a["c0"], a["mask_c"],
                 a["mask_pad"])
        bf = bytes_ms(a["u"], x_in, *small, h, c_all, cf)
        bb = bytes_ms(a["u"], x_in, *small, c_all, gh, gcf, *got)
        rows.append({
            "case": label, "length": length, "bidirectional": bidir, "k": k,
            "activation": act, "mask_c": mc, "mask_pad": pad,
            "forward_ms": f_ms, "backward_ms": b_ms,
            "forward_call_ms": fc_ms, "backward_call_ms": bc_ms,
            "forward_host_ms": fh_ms, "backward_host_ms": bh_ms,
            "plain_forward_ms": pf_ms, "plain_backward_ms": pb_ms,
            "bound_forward_ms": bf, "bound_backward_ms": bb,
            "max_abs_err_forward": err_f, "max_abs_err_backward": err_b,
        })
        log(f"  {label}: forward {f_ms:.4f} ms (call {fc_ms:.4f}, host "
            f"{fh_ms:.4f}, plain {pf_ms:.3f}, bound {bf:.4f}), backward "
            f"{b_ms:.4f} ms (call {bc_ms:.4f}, host {bh_ms:.4f}, plain "
            f"{pb_ms:.3f}, bound {bb:.4f}); max|err| forward {err_f:.2e} "
            f"backward {err_b:.2e}")
        del a, args, h, c_all, got, again, want
    torch.cuda.empty_cache()
    return rows, max_fwd, max_bwd


def phase_sru_stack(dev):
    """The 6-layer uni and bi SRU stacks, f32, card (kernels) vs CPU
    (plain): h, per-layer c, the input's and every parameter's gradient.
    Tolerances: h and c within 1e-4 of max|h|, each gradient within 1e-3
    of its largest element (and 1e-4 in relative L2): the two devices'
    float32 GEMMs sum 910 or 1820 products in other orders, and six layers
    carry that on."""
    import torch

    from tpuseg_torch.kernels.sru_scan import BACKWARD_LAUNCHES, sru_scan
    from tpuseg_torch.nn import SRU

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w, b, length, layers = (SRU_LM["width"], SRU_LM["batch"],
                            SRU_LM["length"], SRU_LM["layers"])
    out = {}
    for bidir in (False, True):
        ndir = 2 if bidir else 1
        g = torch.Generator().manual_seed(300 + ndir)
        cpu = SRU(w, w, layers, bidirectional=bidir,
                  highway_bias=SRU_LM["highway_bias"], generator=g).eval()
        card = copy.deepcopy(cpu).to(dev)
        x = torch.randn(length, b, w, generator=g)
        gh = torch.randn(length, b, ndir * w, generator=g)
        gc = torch.randn(layers, b, ndir * w, generator=g)
        res = {}
        for name, m, dv in (("cpu", cpu, "cpu"), ("card", card, dev)):
            launches = (sru_scan.forward_launches, sru_scan.backward_launches)
            t = time.perf_counter()
            xx = x.to(dv, copy=True).requires_grad_()
            h, c = m(xx)
            ((h * gh.to(dv)).sum() + (c * gc.to(dv)).sum()).backward()
            res[name] = (h.detach().cpu(), c.detach().cpu(), xx.grad.cpu(),
                         {n: p.grad.cpu() for n, p in m.named_parameters()})
            secs = time.perf_counter() - t
            got = (sru_scan.forward_launches - launches[0],
                   sru_scan.backward_launches - launches[1])
            want = (0, 0) if name == "cpu" else (layers,
                                                 layers * BACKWARD_LAUNCHES)
            if got != want:
                raise AssertionError(f"SRU stack on {name}: launches {got}, "
                                     f"want {want}")
            log(f"  {layers}-layer {'bi' if bidir else 'uni'} stack on "
                f"{name}: {secs:.2f} s forward + backward")
        (hc, cc, xc, gcpu), (hg, cg, xg, gcard) = res["cpu"], res["card"]
        errs = {}
        for what, got, want in (("h", hg, hc), ("c", cg, cc)):
            e = (got - want).abs().max().item()
            if not e <= 1e-4 * want.abs().max().item():
                raise AssertionError(f"SRU stack {what}: max|err| {e:.3e}")
            errs[what] = e
        worst_rel, worst_l2 = 0.0, 0.0
        for name, got, want in [("x", xg, xc)] + [
                (n, gcard[n], gcpu[n]) for n in gcpu]:
            e = (got - want).abs().max().item() / want.abs().max().item()
            l2 = ((got - want).norm() / want.norm()).item()
            if not (e <= 1e-3 and l2 <= 1e-4):
                raise AssertionError(
                    f"SRU stack grad {name}: max|err|/max {e:.3e}, rel L2 "
                    f"{l2:.3e}")
            worst_rel, worst_l2 = max(worst_rel, e), max(worst_l2, l2)
        key = "bi" if bidir else "uni"
        out[key] = {"h_max_abs_err": errs["h"], "c_max_abs_err": errs["c"],
                    "grad_max_err_over_max": worst_rel,
                    "grad_rel_l2": worst_l2}
        log(f"  {layers}-layer {key} stack card vs CPU: max|err| h "
            f"{errs['h']:.2e} c {errs['c']:.2e}; gradients (x and "
            f"{len(gcpu)} parameters) worst max|err|/max {worst_rel:.2e}, "
            f"rel L2 {worst_l2:.2e}")
        del cpu, card, res
    torch.cuda.empty_cache()
    return out


def phase_sru_train(dev):
    """The SRU training path: 3 SGD steps of the 6-layer uni stack with
    dropout, launch counters reset just before and read just after."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpuseg_torch.kernels.sru_scan import (
        BACKWARD_LAUNCHES, FORWARD_LAUNCHES, sru_scan,
    )
    from tpuseg_torch.nn import SRU

    w, b, length, layers = (SRU_LM["width"], SRU_LM["batch"],
                            SRU_LM["length"], SRU_LM["layers"])
    g = torch.Generator().manual_seed(400)
    model = SRU(w, w, layers, dropout=0.2, rnn_dropout=0.2,
                highway_bias=SRU_LM["highway_bias"], generator=g).to(dev)
    model.train()
    x = torch.randn(length, b, w, generator=g).to(dev)
    target = torch.randn(length, b, w, generator=g).to(dev)
    opt = torch.optim.SGD(model.parameters(), lr=0.5)
    gen = torch.Generator(device=dev).manual_seed(401)

    def step():
        opt.zero_grad(set_to_none=True)
        h, _ = model(x, generator=gen)
        loss = torch.nn.functional.mse_loss(h, target)
        loss.backward()
        opt.step()
        return loss

    sru_scan.launches = 0
    sru_scan.forward_launches = 0
    sru_scan.backward_launches = 0
    losses, step_ms = [], []
    for i in range(3):
        before = (sru_scan.forward_launches, sru_scan.backward_launches)
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(float(step().detach()))
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t))
        got = (sru_scan.forward_launches - before[0],
               sru_scan.backward_launches - before[1])
        if got != (layers * FORWARD_LAUNCHES, layers * BACKWARD_LAUNCHES):
            raise AssertionError(
                f"SRU train step {i}: launches forward/backward {got}, want "
                f"{layers} forward and {layers} backward calls of "
                f"{FORWARD_LAUNCHES} and {BACKWARD_LAUNCHES} launches")
    counts = {"forward": sru_scan.forward_launches,
              "backward": sru_scan.backward_launches,
              "total": sru_scan.launches}
    want_total = 3 * layers * (FORWARD_LAUNCHES + BACKWARD_LAUNCHES)
    if counts["total"] != want_total:
        raise AssertionError(f"SRU train: {counts['total']} launches in 3 "
                             f"steps, want {want_total}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"SRU train losses not finite: {losses}")
    # where a step's device time goes: two more steps under the profiler
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            step()
        torch.cuda.synchronize()
    parts = {"gemm": 0.0, "scan": 0.0, "other": 0.0}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA or "#" in e.name:
            continue
        low = e.name.lower()
        kind = ("scan" if "sru_" in low else
                "gemm" if "gemm" in low or "xmma" in low or "cutlass" in low
                else "other")
        parts[kind] += e.device_time / 1e3 / 2
    busy = sum(parts.values())
    breakdown = parts if busy > 0 else None
    log(f"phase sru-train ({layers}-layer uni stack, {w} wide, B={b} x "
        f"{length} steps, dropout 0.2 / 0.2, SGD): losses "
        f"{', '.join(f'{v:.5f}' for v in losses)}; ms per step "
        f"{', '.join(f'{v:.2f}' for v in step_ms)}; launches forward "
        f"{counts['forward']} backward {counts['backward']}")
    if breakdown:
        log(f"  device time per step (torch.profiler, 2 steps): GEMMs "
            f"{parts['gemm']:.3f} ms, SRU scans {parts['scan']:.3f} ms, other "
            f"{parts['other']:.3f} ms; busy {busy:.3f} of "
            f"{float(np.median(step_ms)):.2f} ms")
    else:
        log("  device time per step: not measured (the trace holds no "
            "device activity)")
    del model, opt
    torch.cuda.empty_cache()
    return {"losses": losses, "step_ms": step_ms,
            "device_ms_per_step": breakdown, "launches": counts}


# The JAX package's bf16 numbers on eval_hard64, taken on a TPU v5e
# (REPORT.md: evaluate.py output); printed beside the port's, not a gate
REPORT_TPU_BF16 = {"sbd": 0.8127, "abs_dic": 0.500, "fg_dice": 0.9997}
A1 = ("data", "raw", "CVPPP", "CVPPP2017_LSC_training", "training", "A1")


def _recording_predictors():
    """Swap ``cli.pred_list``'s ``Predictor`` for a subclass that keeps each
    instance, so a phase can read the rounds a CLI run took."""
    from tpuseg_torch.cli import pred_list
    from tpuseg_torch.runtime.predict import Predictor

    made = []

    class Recording(Predictor):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    pred_list.Predictor = Recording
    return made


def _per_image(pred_dir, names):
    import hashlib

    from PIL import Image

    out = {}
    for name in names:
        base = os.path.join(pred_dir, name, name)
        ins = np.ascontiguousarray(np.asarray(Image.open(base + "-ins_mask.png")))
        out[name] = (int(np.load(base + "-n_objects.npy")),
                     hashlib.sha256(ins.tobytes()).hexdigest())
    return out


def phase_cli_eval(root, smi):
    """pred_list -> evaluate through the CLIs on the frozen eval_hard64,
    f32 (held to the JAX package's CPU result) and bf16 (held to f32)."""
    import torch

    from tpuseg_torch.cli import evaluate, pred_list
    from tpuseg_torch.data.eval_asset import (
        default_asset_prefix, materialize_eval_tree,
    )
    from tpuseg_torch.kernels.ir_chain import ir_chain

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "assets", "eval_hard64_jax_f32.json")) as f:
        ref = json.load(f)
    want = {r["name"]: (r["count"], r["ins_mask_sha256"]) for r in ref["images"]}
    lst = materialize_eval_tree(default_asset_prefix(), os.path.join(root, "gt"))
    meta = os.path.dirname(lst)
    with open(lst) as f:
        names = [os.path.splitext(os.path.basename(p))[0]
                 for p in f.read().splitlines() if p]
    if len(names) != 64 or set(names) != set(want):
        raise AssertionError(f"eval_hard64 materialized {len(names)} images")
    # phase 2 turned TF32 off for the whole process: back to PyTorch's
    # defaults, so the f32 gate below shows the CLI's own setting
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    made = _recording_predictors()
    ckpt = os.path.join(here, "assets", "synthetic_ckpt.msgpack")
    out = {}
    for mode, flags in (("f32", ["--f32"]), ("bf16", [])):
        pred_dir = os.path.join(root, "pred_" + mode)
        ir_chain.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        pred_list.main(["--lst", lst, "--model", ckpt, "--dataset", "CVPPP",
                        "--batchsize", "16", "--output", pred_dir] + flags)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches, rounds = ir_chain.launches, made[-1].rounds_run
        if launches == 0 or launches != 5 * 4 * rounds:
            raise AssertionError(
                f"cli-eval {mode}: ir_chain launches {launches} != 5 levels x"
                f" 4 blocks x {rounds} rounds")
        if not torch.backends.cudnn.allow_tf32:
            raise AssertionError("pred_list left cuDNN's TF32 switch off")
        sbd, dic, fg = evaluate.main(["--pred_dir", pred_dir, "--dataset",
                                      "CVPPP", "--metadata", meta, "--img_dir",
                                      os.path.join(root, "gt", *A1),
                                      "--device", "cuda"])
        got = _per_image(pred_dir, names)
        out[mode] = {
            "sbd": sbd, "abs_dic": dic, "fg_dice": fg,
            "wall_img_per_s": len(names) / wall, "wall_s": wall,
            "ir_chain_launches": launches, "rounds": rounds,
            "counts_equal_jax_f32": sum(got[n][0] == want[n][0] for n in names),
            "idmaps_equal_jax_f32": sum(got[n][1] == want[n][1] for n in names),
        }
        log(f"  cli-eval {mode}: SBD {sbd:.6f} |DiC| {dic:.4f} FG dice "
            f"{fg:.6f}; counts equal to the JAX f32 reference on "
            f"{out[mode]['counts_equal_jax_f32']}/64 images, id maps (sha256) "
            f"on {out[mode]['idmaps_equal_jax_f32']}/64; {launches} ir_chain "
            f"launches over {rounds} rounds; pred_list wall {wall:.2f} s = "
            f"{len(names) / wall:.2f} img/s incl. weights and PNG writes "
            f"[{smi}]")
    f32, bf16 = out["f32"], out["bf16"]
    log(f"  JAX package f32 on the CPU (assets/eval_hard64_jax_f32.json): "
        f"SBD {ref['mean_sbd']:.6f} |DiC| {ref['mean_abs_dic']:.4f} FG dice "
        f"{ref['mean_fg_dice']:.6f}; JAX package bf16 on a TPU v5e "
        f"(REPORT.md): SBD {REPORT_TPU_BF16['sbd']} |DiC| "
        f"{REPORT_TPU_BF16['abs_dic']} FG dice {REPORT_TPU_BF16['fg_dice']}")
    if f32["counts_equal_jax_f32"] != 64:
        raise AssertionError(
            f"f32 counts equal the JAX reference on only "
            f"{f32['counts_equal_jax_f32']}/64 images")
    if not (abs(f32["sbd"] - ref["mean_sbd"]) <= 2e-3
            and abs(f32["fg_dice"] - ref["mean_fg_dice"]) <= 1e-4):
        raise AssertionError(
            f"f32 SBD {f32['sbd']} / FG {f32['fg_dice']} against the JAX "
            f"package's {ref['mean_sbd']} / {ref['mean_fg_dice']} (2e-3 / 1e-4)")
    if not (bf16["sbd"] >= f32["sbd"] - 0.01
            and bf16["abs_dic"] <= f32["abs_dic"] + 0.1):
        raise AssertionError(
            f"bf16 SBD {bf16['sbd']} |DiC| {bf16['abs_dic']} against f32 "
            f"{f32['sbd']} / {f32['abs_dic']} (-0.01 / +0.1)")
    return out, lst


def phase_cli_train(root, lst, smi):
    """records -> train CLI (2 epochs) -> resume -> --device_aug ->
    pred_list --model <its checkpoint> -> evaluate, launches counted."""
    import torch

    from tpuseg_torch.cli import evaluate, pred_list, train
    from tpuseg_torch.cli.common import load_model
    from tpuseg_torch.data.synthetic import write_synthetic_records
    from tpuseg_torch.kernels.ir_chain import ir_chain
    from tpuseg_torch.kernels.masked_softmax import (
        BACKWARD_LAUNCHES, FORWARD_LAUNCHES, masked_softmax,
    )
    from tpuseg_torch.runtime.checkpoint import read_model_state

    # a CVPPP 2017 A1 image is 500 wide, 530 high
    t0 = time.perf_counter()
    write_synthetic_records(os.path.join(root, "train"), 24, seed=21,
                            height=530, width=500)
    write_synthetic_records(os.path.join(root, "val"), 8, seed=22, height=530,
                            width=500)
    log(f"  cli-train: wrote 24 + 8 synthetic records at 530x500 in "
        f"{time.perf_counter() - t0:.1f} s")
    base = ["--dataset", "CVPPP", "--batchsize", "8", "--bf16",
            "--train_data", os.path.join(root, "train"),
            "--val_data", os.path.join(root, "val"),
            "--runs_dir", os.path.join(root, "runs")]

    def best_checkpoint(run_dir):
        ckpts = [f for f in os.listdir(run_dir) if f.startswith("model_")]
        if not ckpts:
            raise AssertionError(f"no checkpoint in {run_dir}")
        return os.path.join(run_dir, max(ckpts, key=lambda f: int(
            f.split("_")[1])))

    runs, step = {}, 0
    for name, extra, epochs in (("train", [], 2), ("resume", None, 1),
                                ("device_aug", ["--device_aug"], 1)):
        if extra is None:
            extra = ["--model", best_checkpoint(runs["train"]["run_dir"])]
            step0 = torch.load(extra[1], map_location="cpu",
                               weights_only=True)["step"]
        else:
            step0 = 0
        masked_softmax.launches = 0
        masked_softmax.forward_launches = 0
        masked_softmax.backward_launches = 0
        ir_chain.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = train.main(base + ["--nepochs", str(epochs)] + extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        n_train = sum(e["steps"] for e in res["epochs"])
        n_val = epochs  # 8 validation scenes: one batch of 8 an epoch
        counts = {"forward": masked_softmax.forward_launches,
                  "backward": masked_softmax.backward_launches,
                  "ir_chain": ir_chain.launches}
        if n_train != 3 * epochs or res["step"] != step0 + n_train:
            raise AssertionError(
                f"cli-train {name}: {n_train} steps, step {res['step']} from "
                f"{step0}")
        if (counts["forward"] != FORWARD_LAUNCHES * (n_train + n_val)
                or counts["backward"] != BACKWARD_LAUNCHES * n_train):
            raise AssertionError(
                f"cli-train {name}: masked_softmax launches {counts} for "
                f"{n_train} train + {n_val} validation steps")
        if counts["ir_chain"] <= 0 or counts["ir_chain"] % 20:
            raise AssertionError(
                f"cli-train {name}: ir_chain launches {counts['ir_chain']} in "
                f"the validation decode")
        loop = sum(e["wall_s"] for e in res["epochs"])
        wait = sum(e["loader_wait_s"] for e in res["epochs"])
        first = sum(e["first_batch_wait_s"] for e in res["epochs"])
        with open(os.path.join(res["run_dir"], "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        if not all(np.isfinite(v) for r in recs for v in r.values()
                   if isinstance(v, float)):
            raise AssertionError(f"cli-train {name}: non-finite metrics")
        runs[name] = {
            "run_dir": res["run_dir"], "step": res["step"], "wall_s": wall,
            "train_steps": n_train, "train_loop_s": loop,
            "steps_per_s_with_loader": n_train / loop,
            "loader_wait_s": wait, "loader_wait_share": wait / loop,
            "first_batch_wait_s": first,
            "launches": counts,
            "val_ins_dice_loss": recs[-1].get("ins_dice_loss"),
        }
        log(f"  cli-train {name}: {n_train} steps (step {step0} -> "
            f"{res['step']}) + {n_val} validation batches in {wall:.1f} s; "
            f"train loop {n_train / loop:.3f} steps/s with the loader, "
            f"waiting on the PrefetchLoader {wait:.2f} s = "
            f"{100 * wait / loop:.1f}% of it ({first:.2f} s for the epochs' "
            f"first batches); masked_softmax forward "
            f"{counts['forward']} backward {counts['backward']}, ir_chain "
            f"{counts['ir_chain']} (validation decode) [{smi}]")

    # serve the resumed run's checkpoint: pred_list loads its weights
    ckpt = best_checkpoint(runs["resume"]["run_dir"])
    loaded = []

    def spy(cfg, path):
        out = load_model(cfg, path)
        loaded.append({k: v.detach().clone()
                       for k, v in out[1].state_dict().items()})
        return out

    pred_list.load_model = spy
    lst8 = os.path.join(root, "meta8", "validation_image_paths.txt")
    os.makedirs(os.path.dirname(lst8))
    with open(lst) as f:
        head = f.read().splitlines()[:8]
    with open(lst8, "w") as f:
        f.write("\n".join(head) + "\n")
    pred_dir = os.path.join(root, "pred_trained")
    pred_list.main(["--lst", lst8, "--model", ckpt, "--dataset", "CVPPP",
                    "--batchsize", "8", "--output", pred_dir])
    pred_list.load_model = load_model
    state = read_model_state(ckpt)
    if not (len(loaded) == 1 and loaded[0].keys() == state.keys() and all(
            torch.equal(loaded[0][k].cpu(), v) for k, v in state.items())):
        raise AssertionError("pred_list did not load the trained checkpoint")
    scores = evaluate.main(["--pred_dir", pred_dir, "--dataset", "CVPPP",
                            "--metadata", os.path.dirname(lst),
                            "--img_dir", os.path.dirname(head[0]),
                            "--device", "cuda"])
    if not np.isfinite(scores).all():
        raise AssertionError(f"trained model's metrics {scores}")
    log(f"  cli-train serve: pred_list --model {os.path.basename(ckpt)} "
        f"loaded the checkpoint's {len(state)} tensors; 8 images: SBD "
        f"{scores[0]:.4f} |DiC| {scores[1]:.4f} FG dice {scores[2]:.4f} "
        "(9 bf16 steps from a random init)")
    runs["served"] = {"sbd": scores[0], "abs_dic": scores[1],
                      "fg_dice": scores[2]}
    return runs


def make_images(n, seed):
    from tpuseg_torch.data.synthetic import label_map, make_scene

    rng = np.random.default_rng(seed)
    imgs, labels, sems, counts = [], [], [], []
    for _ in range(n):
        rgb, sem, ins, k = make_scene(rng, 256, 256, hard=True)
        imgs.append(rgb)
        labels.append(label_map(ins))
        sems.append(sem)
        counts.append(k)
    return (np.stack(imgs), np.stack(labels), np.stack(sems),
            np.asarray(counts))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpuseg_torch.cli.common import load_model
    from tpuseg_torch.evalm import metrics
    from tpuseg_torch.kernels import build
    from tpuseg_torch.kernels.ir_chain import ir_chain
    from tpuseg_torch.runtime.predict import Predictor, unpack_masks
    from tpuseg_torch.settings import get_config
    from tpuseg_torch.utils.checkpoint_io import load_stop_params

    t_all = time.perf_counter()
    smi = smi_line()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda}")

    # -- phase 1: build every kernel from the checkout's sources
    t0 = time.perf_counter()
    libs = build.build()
    for name, path in libs.items():
        log(f"built {name}: {path.name}")
        for line in build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas:", line.strip())
    log(f"phase build: {time.perf_counter() - t0:.1f} s")

    ckpt = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                        "synthetic_ckpt.msgpack")
    cfg, model = load_model(get_config("CVPPP"), ckpt)
    stop = load_stop_params()
    log(f"model: n_filters {cfg.model.n_filters}, max_n_objects "
        f"{cfg.data.max_n_objects}, extract_group {cfg.decoder.extract_group},"
        f" window {cfg.decoder.extract_window}/"
        f"{cfg.decoder.extract_window_stride}, stop_params {stop}")

    # -- phase 2: kernel vs plain on the card at the main-path shapes
    t0 = time.perf_counter()
    rows, max_abs_f32, max_rel_bf16 = phase_kernel_vs_plain(
        copy.deepcopy(model).to(dev).eval(), dev)
    log(f"phase kernel-vs-plain: {time.perf_counter() - t0:.1f} s "
        f"(f32 max|err| {max_abs_f32:.3e}, bf16 max rel err "
        f"{max_rel_bf16:.3e})")

    # -- phase 3: end to end in f32, card (kernel) vs CPU (plain)
    t0 = time.perf_counter()
    torch.set_num_threads(os.cpu_count() or 1)
    small, _, _, _ = make_images(4, seed=3)
    p_cpu = Predictor(cfg, copy.deepcopy(model), batch_size=4, device="cpu",
                      dtype=torch.float32, stop_params=stop)
    _, fg_c, id_c, n_c = p_cpu.predict_batch_arrays(small, with_probs=False)
    p_f32 = Predictor(cfg, copy.deepcopy(model), batch_size=32, device=dev,
                      dtype=torch.float32, stop_params=stop)
    before = ir_chain.launches
    _, fg_g, id_g, n_g = p_f32.predict_batch_arrays(small, with_probs=False)
    f32_parity_launches = ir_chain.launches - before
    n_g, id_g, fg_g = n_g.cpu(), id_g.cpu(), fg_g.cpu()
    agree = (id_g == id_c).float().mean().item()
    log(f"phase e2e-f32: counts card {n_g.tolist()} cpu {n_c.tolist()}, "
        f"id-map agreement {agree:.6f}, fg agreement "
        f"{(fg_g == fg_c).float().mean().item():.6f}, "
        f"{time.perf_counter() - t0:.1f} s")
    if not torch.equal(n_g, n_c):
        raise AssertionError("f32 counts differ between card and CPU")
    if not agree >= 0.999:
        raise AssertionError(f"f32 id maps agree on only {agree:.4%}")

    # -- phase 4: the main path, timed: B=32, bf16, 256 images
    t0 = time.perf_counter()
    imgs, labels, sems, n_gt = make_images(256, seed=7)
    log(f"made 256 synthetic scenes in {time.perf_counter() - t0:.1f} s")
    B = 32
    batches = [imgs[i:i + B] for i in range(0, len(imgs), B)]
    pred = Predictor(cfg, copy.deepcopy(model), batch_size=B, device=dev,
                     stop_params=stop)
    assert pred.dtype == torch.bfloat16

    def run(p, label):
        outs = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        for b in batches:
            packed, counts = p.predict_batch_packed(b)
            outs.append((packed.cpu().numpy(), counts.cpu().numpy()))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        log(f"  {label}: {len(imgs) / dt:.2f} img/s, "
            f"{1e3 * dt / len(batches):.1f} ms/batch")
        return outs, dt

    pred.predict_batch_packed(batches[0])  # warm-up (cuDNN plans, allocator)
    torch.cuda.synchronize()
    ir_chain.launches = 0
    pred.rounds_run = 0
    outs, dt_main = run(pred, "main path bf16 (round loop ends when all done)")
    launches = ir_chain.launches
    rounds = pred.rounds_run
    log(f"ir_chain launches {launches} over {rounds} rounds "
        f"({len(batches)} batches)")
    if launches == 0 or launches != 5 * 4 * rounds:
        raise AssertionError(
            f"ir_chain launches {launches} != 5 levels x 4 blocks x "
            f"{rounds} rounds")

    fg, idmap = zip(*[unpack_masks(o[0]) for o in outs])
    fg, idmap = np.concatenate(fg), np.concatenate(idmap)
    counts_bf16 = np.concatenate([o[1] for o in outs])
    sbd = metrics.symmetric_best_dice_batch(labels, idmap).mean().item()
    dic = np.abs(n_gt - counts_bf16).mean()
    fgd = metrics.fg_dice_batch(sems, fg).mean().item()
    if not (np.isfinite([sbd, dic, fgd]).all() and idmap.shape == labels.shape):
        raise AssertionError("non-finite metrics or wrong output shape")
    log(f"quality bf16 (256 hard synthetic scenes): SBD {sbd:.4f}, |DiC| "
        f"{dic:.4f}, FG dice {fgd:.4f}, mean count {counts_bf16.mean():.3f} "
        f"vs GT {n_gt.mean():.3f}")

    # the same images through the f32 card predictor, and through bf16
    # without the per-round done-sync (always all rounds)
    p_f32.rounds_run = 0
    before = ir_chain.launches
    outs32, dt_f32 = run(p_f32, "f32")
    f32_launches = ir_chain.launches - before
    if f32_launches != 5 * 4 * p_f32.rounds_run:
        raise AssertionError(
            f"f32 ir_chain launches {f32_launches} != 5 levels x 4 blocks x "
            f"{p_f32.rounds_run} rounds")
    counts_f32 = np.concatenate([o[1] for o in outs32])
    f32_rows = [r for r in rows
                if r["dtype"] == "float32" and r["skip"] == (r["level"] > 0)]
    f32_round_ms = sum(r["ms"] for r in f32_rows)
    log(f"  f32 ir_chain: {f32_round_ms:.2f} ms a round (phase 2's five "
        f"chain calls) beside {len(imgs) / dt_f32:.2f} f32 img/s, "
        f"{f32_launches} launches in that pass")
    log(f"bf16-vs-f32 count agreement {np.mean(counts_f32 == counts_bf16):.4f}"
        f" (mean |diff| {np.abs(counts_f32 - counts_bf16).mean():.4f}); f32 "
        f"rounds {p_f32.rounds_run}, f32 ir_chain launches {f32_launches} "
        f"(and {f32_parity_launches} in the 4-image card-vs-CPU run)")
    pred.sync_rounds = False
    pred.rounds_run = 0
    outs_ns, dt_nosync = run(pred, "bf16, all rounds, no per-round sync")
    counts_ns = np.concatenate([o[1] for o in outs_ns])
    if not np.array_equal(counts_ns, counts_bf16):
        raise AssertionError("rounds after all-done changed the counts")
    log(f"no-sync rounds {pred.rounds_run}")

    # -- where one batch's time goes (bf16, host clock around synchronize)
    pred.sync_rounds = True
    x = torch.from_numpy(batches[0]).to(dev)
    from tpuseg_torch.data.colorspace import image_ex_standardize

    def prep():
        xx = image_ex_standardize(x).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        return pred.model.infer_prep(xx)

    prep_ms = cuda_ms(prep, 5)
    prep_out = prep()
    ext_ms = cuda_ms(lambda: pred.model.decoder.extract_rounds(
        prep_out[1], prep_out[3], prep_out[4], count_budget=prep_out[2],
        n_rounds=pred.max_rounds, stop_params=stop), 3)
    _, _, r1 = pred.model.decoder.extract_rounds(
        prep_out[1], prep_out[3], prep_out[4], count_budget=prep_out[2],
        n_rounds=pred.max_rounds, stop_params=stop)
    # the main path's chain calls: bf16, the mid-chain skip on every
    # level but the first
    path_rows = [r for r in rows
                 if r["dtype"] == "bfloat16" and r["skip"] == (r["level"] > 0)]
    chain_round_ms = sum(r["ms"] for r in path_rows)
    log(f"batch 0 breakdown (bf16): preprocess+backbone+prep {prep_ms:.1f} ms,"
        f" extraction {ext_ms:.1f} ms over {r1} rounds; ir_chain "
        f"microbench {chain_round_ms:.1f} ms per round -> "
        f"{chain_round_ms * r1:.1f} ms")

    del pred, p_f32, p_cpu, prep_out, x
    torch.cuda.empty_cache()

    # -- phase 5: masked_softmax kernels vs plain, forward and backward
    t0 = time.perf_counter()
    sm_rows, sm_p_err, sm_de_rel = phase_masked_softmax(dev)
    log(f"phase masked-softmax-vs-plain: {time.perf_counter() - t0:.1f} s "
        f"(max|p err| {sm_p_err:.3e}, max|de err| / max|de| {sm_de_rel:.3e})")

    # -- phase 6: two f32 train steps, card vs CPU
    t0 = time.perf_counter()
    train_f32 = phase_train_f32(cfg, model, dev)
    log(f"phase train-f32: {time.perf_counter() - t0:.1f} s")

    # -- phase 7: the training main path, timed
    t0 = time.perf_counter()
    train = phase_train_timed(cfg, model, dev, sm_rows)
    log(f"phase train-timed: {time.perf_counter() - t0:.1f} s")

    # -- phase 8: sru_scan kernels vs plain, forward and backward
    t0 = time.perf_counter()
    sru_rows, sru_fwd_err, sru_bwd_err = phase_sru_kernels(dev)
    log(f"phase sru-vs-plain: {time.perf_counter() - t0:.1f} s (max|err| "
        f"forward {sru_fwd_err:.3e}, backward {sru_bwd_err:.3e})")

    # -- phase 9: the 6-layer SRU stacks, card vs CPU, f32
    t0 = time.perf_counter()
    sru_stack = phase_sru_stack(dev)
    log(f"phase sru-stack: {time.perf_counter() - t0:.1f} s")

    # -- phase 10: the SRU training path, 3 SGD steps, launches counted
    t0 = time.perf_counter()
    sru_train = phase_sru_train(dev)
    log(f"phase sru-train: {time.perf_counter() - t0:.1f} s")

    import shutil
    import tempfile

    work = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        # -- phase 11: pred_list -> evaluate through the CLIs, eval_hard64
        t0 = time.perf_counter()
        cli_eval, eval_lst = phase_cli_eval(os.path.join(work, "eval"), smi)
        log(f"phase cli-eval: {time.perf_counter() - t0:.1f} s")

        # -- phase 12: records -> train CLI -> resume -> pred_list, evaluate
        t0 = time.perf_counter()
        cli_train = phase_cli_train(os.path.join(work, "train"), eval_lst,
                                    smi)
        log(f"phase cli-train: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    summary = {
        "train": train, "train_f32": train_f32,
        "img_per_s_bf16": len(imgs) / dt_main,
        "ms_per_batch_bf16": 1e3 * dt_main / len(batches),
        "img_per_s_f32": len(imgs) / dt_f32,
        "f32_ir_chain_ms_per_round": f32_round_ms,
        "img_per_s_bf16_nosync": len(imgs) / dt_nosync,
        "sbd": sbd, "abs_dic": float(dic), "fg_dice": fgd,
        "rounds": rounds, "batches": len(batches),
        "ir_chain_launches_per_batch": launches / len(batches),
        "count_agreement_bf16_f32": float(np.mean(counts_f32 == counts_bf16)),
        "e2e_f32_idmap_agreement": agree,
        "sru_stack": sru_stack, "sru_train": sru_train,
        "cli_eval": cli_eval, "cli_train": cli_train,
        "seconds": time.perf_counter() - t_all,
    }
    log("summary " + json.dumps(summary))
    log("ir_chain rows " + json.dumps(rows))
    log("masked_softmax rows " + json.dumps(sm_rows))
    log("sru_scan rows " + json.dumps(sru_rows))
    # the training path's scan: uni, k = 3, identity, dropout mask, 35 steps
    sru_main = [r for r in sru_rows if r["length"] == SRU_LM["length"]
                and not r["bidirectional"] and r["activation"] == 0
                and r["mask_c"] and not r["mask_pad"]][0]
    sru_note = ("no PyTorch call computes the SRU recurrence: the plain "
                "version is a loop of elementwise calls over time")
    sm8 = [r for r in sm_rows if r["shape"][0] == 8][0]
    kernels = {"kernels": [{
        "name": "ir_chain",
        "route": "cuda",
        "source": "tpuseg_torch/kernels/csrc/ir_chain.cu",
        "replaces": "tpuseg/kernels/ir_chain.py:136",
        "launches": launches,
        "checked": True,
        "max_abs_err": max_abs_f32,
        "max_rel_err_bf16": max_rel_bf16,
        # one round's chain calls on the main path (bf16, the five shapes)
        "ms": chain_round_ms,
        "plain_ms": sum(r["plain_ms"] for r in path_rows),
        "bound_ms": sum(r["bound_ms"] for r in path_rows),
        "bound_by": "bytes" if sum(r["bytes_ms"] for r in path_rows)
        >= sum(r["ops_ms"] for r in path_rows) else "operations",
        "library_ms": None,
        # levels 0-4: device time of one launch (one block of the chain)
        "device_ms_per_launch": [r["device_ms_per_launch"] for r in path_rows],
        "launches_validation_decode": train["launches"]["ir_chain"],
        # the float32 instance (f32 inference, the card-vs-CPU runs): per
        # level of the main path's calls, ms per chain call and bound
        "f32_ms_per_level": [r["ms"] for r in f32_rows],
        "f32_device_ms_per_launch": [r["device_ms_per_launch"]
                                     for r in f32_rows],
        "f32_bound_ms_per_level": [r["bound_ms"] for r in f32_rows],
        "f32_bound_cuda_cores_ms_per_level": [r["bound_cuda_cores_ms"]
                                              for r in f32_rows],
        "f32_plain_ms_per_level": [r["plain_ms"] for r in f32_rows],
        "launches_f32_inference": f32_launches,
        "launches_f32_parity": f32_parity_launches,
        # phases 11-12: the CLIs (pred_list on eval_hard64; the train
        # CLI's validation decode over its three runs)
        "launches_cli_eval": {m: cli_eval[m]["ir_chain_launches"]
                              for m in ("f32", "bf16")},
        "launches_cli_train_validation": sum(
            cli_train[r]["launches"]["ir_chain"]
            for r in ("train", "resume", "device_aug")),
    }, {
        "name": "masked_softmax",
        "route": "cuda",
        "source": "tpuseg_torch/kernels/csrc/masked_softmax.cu",
        "replaces": "tpuseg/kernels/masked_softmax.py:38",
        # forward + backward launches of the fit run (10 train steps + 1
        # validation batch): 1 per forward, 2 per backward
        "launches": train["launches"]["total"],
        "launches_forward": train["launches"]["forward"],
        "launches_backward": train["launches"]["backward"],
        # phase 12: the train CLI's three runs (forward + backward)
        "launches_cli_train": sum(
            cli_train[r]["launches"]["forward"]
            + cli_train[r]["launches"]["backward"]
            for r in ("train", "resume", "device_aug")),
        "checked": True,
        "max_abs_err": sm_p_err,
        "max_rel_err_backward": sm_de_rel,
        # one train step's calls at the timed path's shape (8, 32, 65536):
        # forward + backward with the training path's g (K rows per
        # sample nonzero), device time (profiler; events over back-to-back
        # calls read the wrapper's host pace); the dense-g backward beside
        "ms": sm_kernel_ms(sm8, "_main"),
        "forward_ms": sm8["forward_device_ms"],
        "backward_ms": sm8["backward_device_ms_main"],
        "backward_dense_g_ms": sm8["backward_device_ms"],
        "event_ms": {k: sm8[k] for k in (
            "forward_ms", "backward_ms_main", "backward_ms")},
        "plain_ms": sm8["plain_forward_ms"] + sm8["plain_backward_ms_main"],
        "bound_ms": sm8["bound_forward_ms"] + sm8["bound_backward_ms_main"],
        "bound_backward_dense_g_ms": sm8["bound_backward_ms"],
        "active_rows": sm8["active_rows_main"],
        "bound_by": "bytes",
        "library_ms": sm8["torch_softmax_ms"]
        + sm8["library_backward_ms_main"],
        "library_call": "torch.softmax(logits, dim=-1) on already-masked "
                        "(B, N, HW) logits + torch._softmax_backward_data(g, "
                        "p, -1, float32) (the per-row part; the sum over "
                        "the instances is extra)",
    }, {
        "name": "sru_scan_forward",
        "route": "cuda",
        "source": "tpuseg_torch/kernels/csrc/sru_scan.cu",
        "replaces": "tpuseg/kernels/sru_scan.py:275",
        # the 3 SGD steps of the 6-layer stack: one launch per layer
        "launches": sru_train["launches"]["forward"],
        "checked": True,
        "max_abs_err": sru_fwd_err,
        # one layer of the training path: (35, 32, 910), k = 3; device
        # time (profiler), and a call's time with the wrapper (events)
        "ms": sru_main["forward_ms"],
        "call_ms": sru_main["forward_call_ms"],
        "host_ms_per_call": sru_main["forward_host_ms"],
        "plain_ms": sru_main["plain_forward_ms"],
        "bound_ms": sru_main["bound_forward_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "library_call": sru_note,
    }, {
        "name": "sru_scan_backward",
        "route": "cuda",
        "source": "tpuseg_torch/kernels/csrc/sru_scan.cu",
        "replaces": "tpuseg/kernels/sru_scan.py:375",
        # one launch per layer and step: the reverse scan, with the batch
        # sum of the weight gradients folded in
        "launches": sru_train["launches"]["backward"],
        "checked": True,
        "max_abs_err": sru_bwd_err,
        "ms": sru_main["backward_ms"],
        "call_ms": sru_main["backward_call_ms"],
        "host_ms_per_call": sru_main["backward_host_ms"],
        "plain_ms": sru_main["plain_backward_ms"],
        "bound_ms": sru_main["bound_backward_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "library_call": sru_note,
    }]}
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps(kernels), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
