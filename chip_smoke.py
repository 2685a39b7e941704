#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpuseg_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels (``ir_chain``, ``masked_softmax`` with its
split-row entry points, ``sru_scan``) from
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
    must be the ones loaded) over 8 images and ``evaluate``;
12. holds the staged extraction dispatch (one window of 3's 8 batches)
    to the monolithic predictor in bf16 and f32: fg, id maps and counts
    bit-equal; img/s of both alternated, 2 passes each; the rounds, host
    syncs and ``ir_chain`` launches (20 a round) of one pass each;
13. holds ``ir_chain`` against its plain version (phase 2's gates) at every
    level shape that the decodes of the CVPPP 2017 shape buckets make
    (A1 530x500 -> 576x512, unwindowed; A2 530x565 -> 576x576 and A4 441x441
    -> 448x448, the window scaled; an A3-sized 2448x2048 capped at 1024),
    N = 8 x 4, f32 and bf16, with ms a call, device ms a launch and the
    bound;
14. runs ``predict_paths_bucketed`` in bf16 and f32 over synthetic scenes
    at those sizes: masks at each native size, 20 ``ir_chain`` launches a
    round; SBD / |DiC| / FG dice and img/s beside fixed-256 inference; f32
    on the card vs the CPU's plain path at the A4 bucket, B=2 (counts
    equal, >= 99.9% of id-map pixels);
15. runs the pred CLI's ``main`` in this process on one eval_hard64 image,
    semantic and ``--instances`` (count equal and >= 99.9% of the id map
    and fg mask equal to the CPU's plain path with the CLI's settings:
    f32, batch 1, the config's stopping rule), then ``pred_list --staged
    --f32`` and ``--bucketed --f32`` on eval_hard64, each equal to phase
    10's f32 artifacts on 64/64 images;
16. runs ``predict_cluster`` on one image: ids in 0..n, background 0;
17. holds the ``debug`` mode in f32 on the card to the CPU (glimpse points
    and pooled targets equal, alpha, score and logits within 1e-3 of their
    max) with 1 ``masked_softmax`` and 20 ``ir_chain`` launches a debug
    forward, then ``fit(debug_dir=...)`` for 2 steps at B=8 bf16: two dumps
    of the JAX writer's 18 files, the launches counted;
18. drives the data-parallel ``fit`` (``parallel.run_ranks``): 2 gloo
    ranks both on the card against one process, f32 (TF32 off),
    deterministic glimpses, no dropout, SGD, global B=4, 2 steps + 1
    validation batch from equal weights: parameters, BN statistics and the
    REINFORCE baseline within rtol 5e-3 / atol 1.6e-2 of the one process,
    the parameters' update within ``UPDATE_TOL`` of the one process's
    (relative, over all of them), the logged metrics (``grad_norm`` among
    them) within ``METRIC_TOL``, the ranks bit-identical; then 1 rank over NCCL, equal
    to the one process bit for bit where the one process repeats itself
    bit for bit (else within that tolerance); then timed: bf16, sampling
    and dropout on, global B=8 (2 x 4), 4 steps after 1 warm-up, steps/s
    beside item 6's one process, each rank's ``masked_softmax`` launches
    (1 forward, ``BACKWARD_LAUNCHES`` backward a step), and one more step
    traced: its all-reduces and their ms, read from the trace; the same
    spawn of the 2 ranks runs item 23's rank calls between the fit and
    the timed steps;
19. drives the mesh predictor (``Predictor(use_mesh=True, n_devices=2)``:
    two replicas on the card, one after the other, each batch split) over
    item 3's 256 images,
    B=32: f32 counts equal to the one-replica predictor's and >= 99.9% of
    id-map pixels, 20 ``ir_chain`` launches a round of each replica; bf16
    img/s of both, alternated;
20. drives ``cli.train --ndevices 2 --live --tensorboard --bf16`` for 2
    epochs on item 11's records: one run directory, a checkpoint for each
    improving epoch and no other, the live rows on stdout, TensorBoard
    events or the writer's skip line (which is printed), finite costs,
    each rank's launches counted; then ``pred_list --ndevices 2 --f32`` on
    eval_hard64 (two rank processes on the card, each with its own whole
    batches: artifacts equal to item 10's f32 on 64/64 images, 20
    ``ir_chain`` launches a round of each rank, img/s of 2 ranks beside
    item 10's one process) and ``evaluate``;
21. runs one of item 3's batches inside ``utils.tracing.trace_context``,
    a ``StepTimer`` around it: a Chrome trace with the card's kernels is
    written, one time recorded;
22. holds the split-row entry points of ``masked_softmax`` (spatial
    training's: each rank's partial (max, sum of exp), then p from the
    combined pairs; the row dots all-reduced between the backward's two
    launches) against their plain versions at item 4's shapes with each
    image's rows cut in two: p within 1e-6 and de (training path's g)
    within 1e-5 of max|de| of the whole-row plain version; times one half
    of (8, 32, 65536) beside the plain pieces, the library calls and the
    bytes bound;
23. drives the spatial (H-sharded) path, ``parallel/spatial.py``, over 2
    gloo ranks on the card (in item 18's spawn) against one process:
    instance inference at full width on two 512 x 512 synthetic scenes in
    f32 (id maps and counts equal, semantic within rtol 2e-4 / atol 2e-5,
    no gather of a full-size map, each rank's ``ir_chain`` launches), bf16
    ms a batch of the ranks beside one process's; training at 256 x 256,
    f32, 2 SGD steps under deterministic glimpses (parameters within rtol
    5e-3 / atol 1.6e-2 of one process), each rank's launches of the split
    entry points (2 a direction and step, and no whole-row launch);
25. runs the capability modules (the JAX package's modules off the main
    paths: the CoordConv family, VGG16, the hourglass, the ASPP modules,
    the DQN and the legacy AtteNet with its ``q_fn``, the transformer
    stack, the embedding, the DCGAN decoder, the discriminative, PN and
    MMD losses, ``window_origin_fg``, ``calc_bd``) at the JAX package's
    default widths on 256 x 256 maps, f32 with TF32 off, on the card and
    on the CPU from the same weights: every output within ``CAP_TOL``;
    one ``MatchLoss.step`` and one ``DQNSelecter.update`` likewise; each
    forward timed; then the C++ host library (``native/*.cpp``) is built
    with the machine's compiler and its SRU forward held to the Hopper
    ``sru_fwd_kernel`` at item 7's shape;
26. runs the model-production recipes of ``tpuseg_torch/tools`` at the
    full CVPPP width, cut only in epochs, steps, pools and scenes
    (``RECIPE_CUTS``): ``overfit_check`` (its cost must drop),
    ``train_synthetic_e2e`` resumed from the asset (``TPUSEG_RESUME=1``;
    its trained model written by ``write_msgpack`` and read back by
    ``load_model`` gives the same f32 fg, id maps and counts bit for
    bit), ``train_density`` (every leaf outside ``density_head`` of its
    checkpoint bitwise the asset's), the stopping sweep at the JAX
    defaults with the installed rule's row beside ``stop_params.json``'s
    record, ``count_diagnosis``, and ``train_hard_r3 --freeze_subtrees
    count_head,density_head --freeze_bn`` (those subtrees and every batch
    statistic bitwise the asset's); ``assets/`` must hash the same after;
    the kernels' launches over the phase are printed.
27. runs the report tools of ``tpuseg_torch/tools``: ``ir_chain``
    against its plain version (item 13's gates) at every level shape of
    the 512x512 bucket's windowed decode (window 384 / stride 128), f32 and
    bf16; ``native_res_report`` at its defaults (24 hard scenes at 512x512,
    f32, the 256 resize and ``--bucketed``), both paths held to the JAX
    package's CPU result (``assets/native_res512_jax_f32.json``: counts on
    every scene, SBD within 1/(8 n), FG dice within 1e-4); then
    ``quality_report`` at its defaults (eval_hard64, bf16, cold and warm
    wall seconds, ab_infer's img/s): SBD >= item 10's f32 - 0.01, |DiC|
    <= f32 + 0.1; each ``pred_list`` process's ``ir_chain`` launches (20 a
    round); the root ``REPORT.md`` and ``assets/`` must hash the same
    after.
28. runs the measurement tools of ``tpuseg_torch/tools`` in this process:
    ``trace_summary`` of item 21's trace (device busy time, idle share,
    buckets, the longest gaps and their host events; its ``ir_chain``
    launches equal to that batch's counter), ``roofline`` at B=32 bf16 (the
    infer stage's counted ``ir_chain`` operations = its launches' rounds x
    a round's five calls' formula; every share <= ``SHARE_MAX`` %),
    ``profile_stages --ks 1,32 --trace`` (its traced batch of the tools'
    scenes, through the same ``Predictor`` call as item 21's, held to the
    same checks, its ``ir_chain`` launches 20 a round; both batches' idle
    ms a round and a device event printed side by side),
    ``profile_components``, ``profile_decode_scaling`` at B 32 and 128,
    and ``warmup`` (every library reused: phase 1 built them).

Prints a ``kernels`` JSON line, the card's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``.  Any failure raises: the
script exits non-zero and prints no result.  Exits 2 when CUDA is absent.
"""

import copy
import json
import os
import sys
import time

import numpy as np

# the bounds of a kernel call at the card's data-sheet peaks: the port's
# count module holds them
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from tpuseg_torch.utils.roofline import (  # noqa: E402
    bytes_ms, chain_bound, chain_ops, softmax_bound_ms,
)
from tpuseg_torch.utils.roofline import card_line as smi_line  # noqa: E402

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
# its f32 NATIVE_RES rows (SBD, |DiC|, FG dice) on a TPU v5e (REPORT.md);
# printed beside the port's, not a gate
REPORT_TPU_NATIVE = {
    "resize256": (0.8095716238021851, 0.5416666666666666, 0.9926018888751665),
    "native_bucketed": (0.5519036687910557, 5.291666666666667,
                        0.9998220751682917)}
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


# CVPPP 2017 image sizes (h, w) and how many scenes of each the bucketed
# phases write: A1 530x500, A2 530x565, A4 441x441, and an A3-sized
# 2448x2048 that the 1024 cap downscales
CVPPP_SIZES = {"A1": (530, 500), "A2": (530, 565), "A4": (441, 441),
               "A3": (2448, 2048)}
CVPPP_COUNTS = {"A1": 8, "A2": 8, "A4": 8, "A3": 2}
BUCKET_B = 8  # the bucketed predictor's batch (pred_list's default)
IR_KERNEL_NAME = {"float32": "ir_block_kernel",
                  "bfloat16": "ir_block_tc_kernel"}
# the files one debug dump holds (tpuseg/utils/debug_images.py)
DUMP_FILES = sorted([f"{kind}_{lvl}.jpg" for kind in ("p", "pred", "target")
                     for lvl in range(5)] + ["proall.jpg", "pro.jpg",
                                             "mas.jpg"])


def reset_counts():
    from tpuseg_torch.kernels.ir_chain import ir_chain
    from tpuseg_torch.kernels.masked_softmax import masked_softmax

    ir_chain.launches = 0
    masked_softmax.launches = 0
    masked_softmax.forward_launches = 0
    masked_softmax.backward_launches = 0


def phase_staged(cfg, model, dev, stop, batches, smi):
    """The staged dispatch (one window of all 8 batches) against the
    monolithic predictor on phase 4's images, bf16 and f32: outputs
    bit-equal; img/s alternated in one call; host syncs, rounds and
    ir_chain launches of one pass each."""
    import torch

    from tpuseg_torch.kernels.ir_chain import ir_chain
    from tpuseg_torch.runtime.predict import Predictor

    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        preds = {kind: Predictor(cfg, copy.deepcopy(model),
                                 batch_size=len(batches[0]), device=dev,
                                 dtype=dtype, stop_params=stop,
                                 staged=kind == "staged")
                 for kind in ("monolithic", "staged")}
        run = {
            "monolithic": lambda: [preds["monolithic"].predict_batch_packed(b)
                                   for b in batches],
            "staged": lambda: preds["staged"].predict_batches_staged(
                batches, packed=True),
        }
        for fn in run.values():  # warm-up: cuDNN plans, allocator
            fn()
        res, secs, counts = {}, {k: [] for k in run}, {}
        for i, kind in enumerate(["monolithic", "staged"] * 2):
            p = preds[kind]
            if i < 2:
                reset_counts()
                p.rounds_run = p.host_syncs = 0
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = [(a.cpu().numpy(), c.cpu().numpy()) for a, c in run[kind]()]
            torch.cuda.synchronize()
            secs[kind].append(time.perf_counter() - t)
            if i < 2:
                counts[kind] = {"rounds": p.rounds_run,
                                "host_syncs": p.host_syncs,
                                "ir_chain_launches": ir_chain.launches}
                if ir_chain.launches != 20 * p.rounds_run:
                    raise AssertionError(
                        f"{name} {kind}: ir_chain launches "
                        f"{ir_chain.launches} != 5 levels x 4 blocks x "
                        f"{p.rounds_run} rounds")
                res[kind] = got
        for (a0, c0), (a1, c1) in zip(res["monolithic"], res["staged"]):
            if not (np.array_equal(a0, a1) and np.array_equal(c0, c1)):
                raise AssertionError(
                    f"{name}: staged fg / id maps / counts differ from the "
                    "monolithic dispatch")
        n_img = sum(len(b) for b in batches)
        rate = {k: [n_img / s for s in v] for k, v in secs.items()}
        out[name] = {"img_per_s": rate, "counts": counts,
                     "round_chunks": sorted(preds["staged"].round_chunks)}
        log(f"  staged {name}: bit-equal to the monolithic dispatch on "
            f"{n_img} images; img/s monolithic "
            f"{', '.join(f'{r:.2f}' for r in rate['monolithic'])} | staged "
            f"{', '.join(f'{r:.2f}' for r in rate['staged'])} (alternated); "
            f"one pass: monolithic {counts['monolithic']}, staged "
            f"{counts['staged']}, staged chunks of "
            f"{out[name]['round_chunks']} rounds [{smi}]")
        del preds
        torch.cuda.empty_cache()
    return out


def bucket_chain_shapes(cfg, sizes=CVPPP_SIZES):
    """{(level, h, w): bucket names} of the ir_chain calls that the decodes
    of the buckets of ``sizes`` make, windowed as ``decode_split`` windows
    them."""
    from tpuseg_torch.decoder.pyramid import window_plan
    from tpuseg_torch.runtime.predict import Predictor

    shapes = {}
    for name, (h, w) in sizes.items():
        bh, bw = Predictor._bucket_shape(h, w)
        plan = window_plan(bh, bw, cfg.decoder.extract_window,
                           cfg.decoder.extract_window_stride)
        for lvl, f in enumerate((16, 8, 4, 2, 1)):
            if plan is not None and f <= 2:
                hw = (plan[0] // f, plan[0] // f)
            else:
                hw = (bh // f, bw // f)
            shapes.setdefault((lvl, *hw), []).append(name)
    return shapes


def phase_bucket_chains(cfg, model, dev, smi, sizes=CVPPP_SIZES):
    """ir_chain kernel vs plain at every level shape of the decodes of the
    buckets of ``sizes`` (N = BUCKET_B x G), f32 and bf16, with phase 2's
    gates; ms a call (events), device ms a launch (profiler) and the
    bound."""
    import torch

    from tpuseg_torch.kernels.ir_chain import (
        ir_chain, ir_chain_plain, stack_chain_params,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    n = BUCKET_B * max(int(cfg.decoder.extract_group), 1)
    levels = model.decoder.bone.levels
    g = torch.Generator(device="cpu").manual_seed(1)
    rows = []
    for (lvl, h, w), names in sorted(bucket_chain_shapes(cfg, sizes).items()):
        c = levels[lvl].out_ch
        blocks = [levels[lvl].dil1a, levels[lvl].dil1b, levels[lvl].dil2a,
                  levels[lvl].dil2b]
        x32 = torch.randn(n, h, w, c, generator=g).to(dev)
        s32 = torch.randn(n, h, w, c, generator=g).to(dev) if lvl else None
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[1]
            params = [t.to(dev) for t in stack_chain_params(blocks, dtype)]
            p32 = [t.float() for t in params]
            x = x32.to(dtype)
            s = None if s32 is None else s32.to(dtype)
            got = ir_chain(x, s, *params)
            torch.cuda.synchronize()
            want = ir_chain_plain(x.float(), None if s is None else s.float(),
                                  *p32)
            err = (got.float() - want).abs().max().item()
            scale = want.abs().max().item()
            del got, want
            tol = 1e-4 if dtype == torch.float32 else 2e-2
            if not err <= tol * scale:
                raise AssertionError(
                    f"ir_chain {name} at bucket shape L{lvl} ({n},{h},{w},{c})"
                    f" skip={s is not None} ({names}): max|err| {err:.3e} > "
                    f"{tol} * max|y| {scale:.3e}")
            iters = max(3, min(30, int(2e8 // (n * h * w * c))))
            k_ms = cuda_ms(lambda: ir_chain(x, s, *params), iters)
            dev_ms = kernel_device_ms(lambda: ir_chain(x, s, *params), 3,
                                      IR_KERNEL_NAME[name], launches=4)
            b_ms, o_ms = chain_bound(n, h, w, c, name, s is not None)
            rows.append({
                "level": lvl, "shape": [n, h, w, c], "dtype": name,
                "skip": s is not None, "buckets": names, "ms": k_ms,
                "device_ms_per_launch": None if dev_ms is None else dev_ms / 4,
                "bound_ms": max(b_ms, o_ms),
                "bound_by": "bytes" if b_ms >= o_ms else "operations",
                "max_abs_err": err, "max_abs_y": scale,
            })
            r = rows[-1]
            dev_txt = ("not traced" if dev_ms is None
                       else f"{r['device_ms_per_launch']:.4f} ms")
            log(f"  ir_chain bucket L{lvl} {r['shape']} {name} "
                f"({'/'.join(names)}): {k_ms:.3f} ms a call, device "
                f"{dev_txt} a launch, bound {r['bound_ms']:.4f} ms a call "
                f"({r['bound_by']}), max|err|/max|y| {err / scale:.2e}")
        del x32, s32
        torch.cuda.empty_cache()
    log(f"  ir_chain at {len(rows) // 2} bucket level shapes x f32, bf16: "
        f"within phase 2's gates [{smi}]")
    return rows


def write_cvppp_scenes(root, seed):
    """Synthetic scenes at the CVPPP 2017 sizes as PNGs: (paths, {path:
    (label map, semantic mask, count)})."""
    from PIL import Image

    from tpuseg_torch.data.synthetic import label_map, make_scene

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths, gt = [], {}
    for name, (h, w) in CVPPP_SIZES.items():
        for k in range(CVPPP_COUNTS[name]):
            rgb, sem, ins, n = make_scene(rng, h, w, hard=True)
            p = os.path.join(root, f"{name}_{k}_rgb.png")
            Image.fromarray(rgb).save(p)
            paths.append(p)
            gt[p] = (label_map(ins), sem, n)
    return paths, gt


def scores(results, gt, dev):
    """Mean SBD, |DiC| and FG dice of predictions against the scenes'
    ground truth at native resolution."""
    import torch

    from tpuseg_torch.evalm import metrics

    sbd, dic, fgd = [], [], []
    for r in results:
        label, sem, n = gt[r["path"]]
        sbd.append(metrics.calc_sbd(torch.from_numpy(label).to(dev),
                                    torch.from_numpy(r["ins_mask"]).to(dev)
                                    ).item())
        dic.append(abs(n - r["n_objects"]))
        fgd.append(metrics.calc_dice(torch.from_numpy(sem).to(dev),
                                     torch.from_numpy(r["fg_mask"]).to(dev)
                                     ).item())
    return float(np.mean(sbd)), float(np.mean(dic)), float(np.mean(fgd))


def phase_bucketed(cfg, model, dev, stop, root, smi):
    """predict_paths_bucketed in bf16 and f32 on scenes at the CVPPP 2017
    sizes: outputs pixel-aligned; launches counted; quality and img/s
    beside fixed-256 inference; f32 card vs the CPU's plain path at the
    A4 bucket (448x448, B=2)."""
    import torch

    from tpuseg_torch.kernels.ir_chain import ir_chain
    from tpuseg_torch.runtime.predict import Predictor

    from PIL import Image

    t0 = time.perf_counter()
    paths, gt = write_cvppp_scenes(root, seed=31)
    log(f"  bucketed: wrote {len(paths)} scenes at the CVPPP 2017 sizes in "
        f"{time.perf_counter() - t0:.1f} s")
    # the host's share of a pass: the PNG decodes alone
    t0 = time.perf_counter()
    for q in paths:
        np.array(Image.open(q).convert("RGB"))
    png_s = time.perf_counter() - t0
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        p = Predictor(cfg, copy.deepcopy(model), batch_size=BUCKET_B,
                      device=dev, dtype=dtype, stop_params=stop)
        with_fixed = dtype == torch.bfloat16  # fixed-256 beside bf16 only
        for fn in (p.predict_paths_bucketed, p.predict_paths)[:1 + with_fixed]:
            list(fn(paths))  # warm-up: cuDNN plans per canvas, allocator
        reset_counts()
        p.rounds_run = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = list(p.predict_paths_bucketed(paths))
        torch.cuda.synchronize()
        dt_b = time.perf_counter() - t
        launches, rounds = ir_chain.launches, p.rounds_run
        if launches == 0 or launches != 20 * rounds:
            raise AssertionError(
                f"bucketed {name}: ir_chain launches {launches} != 5 levels x"
                f" 4 blocks x {rounds} rounds")
        if [r["path"] for r in res] != paths:
            raise AssertionError("bucketed results out of order")
        for r in res:
            h, w = gt[r["path"]][0].shape
            if not (r["fg_mask"].shape == r["ins_mask"].shape == (h, w)):
                raise AssertionError(
                    f"bucketed {name}: {os.path.basename(r['path'])} masks "
                    f"{r['ins_mask'].shape}, not its native {(h, w)}")
        q_b = scores(res, gt, dev)
        out[name] = {
            "bucketed": {"sbd": q_b[0], "abs_dic": q_b[1], "fg_dice": q_b[2],
                         "img_per_s": len(paths) / dt_b},
            "ir_chain_launches": launches, "rounds": rounds,
            "png_decode_s": png_s,
        }
        fixed_txt = ""
        if with_fixed:
            torch.cuda.synchronize()
            t = time.perf_counter()
            fixed = list(p.predict_paths(paths))
            torch.cuda.synchronize()
            dt_f = time.perf_counter() - t
            q_f = scores(fixed, gt, dev)
            out[name]["fixed_256"] = {"sbd": q_f[0], "abs_dic": q_f[1],
                                      "fg_dice": q_f[2],
                                      "img_per_s": len(paths) / dt_f}
            fixed_txt = (f"; fixed 256: SBD {q_f[0]:.4f} |DiC| {q_f[1]:.4f} "
                         f"FG dice {q_f[2]:.4f} at {len(paths) / dt_f:.2f} "
                         "img/s")
            q_b = q_b + q_f
        if not np.isfinite(q_b).all():
            raise AssertionError(f"bucketed {name}: non-finite metrics")
        log(f"  bucketed {name} ({len(paths)} scenes: "
            f"{', '.join(f'{k} x{v}' for k, v in CVPPP_COUNTS.items())}): SBD "
            f"{q_b[0]:.4f} |DiC| {q_b[1]:.4f} FG dice {q_b[2]:.4f} at "
            f"{len(paths) / dt_b:.2f} img/s, {launches} ir_chain launches over"
            f" {rounds} rounds{fixed_txt} (PNG reads, resizes and mask "
            f"upsampling included; decoding the PNGs alone takes "
            f"{png_s:.2f} s of the bucketed pass's {dt_b:.2f} s) [{smi}]")
        del p
        torch.cuda.empty_cache()

    # f32, card vs the CPU's plain path at the A4 bucket, B=2
    a4 = [q for q in paths if os.path.basename(q).startswith("A4_")][:2]
    got = {}
    t0 = time.perf_counter()
    for side, device in (("card", dev), ("cpu", "cpu")):
        p = Predictor(cfg, copy.deepcopy(model), batch_size=2, device=device,
                      dtype=torch.float32, stop_params=stop)
        got[side] = list(p.predict_paths_bucketed(a4))
    agree = np.mean([np.mean(a["ins_mask"] == b["ins_mask"])
                     for a, b in zip(got["card"], got["cpu"])])
    n_card = [r["n_objects"] for r in got["card"]]
    n_cpu = [r["n_objects"] for r in got["cpu"]]
    log(f"  bucketed f32 card vs CPU at the A4 bucket (448x448, B=2): counts "
        f"card {n_card} cpu {n_cpu}, id-map agreement {agree:.6f}, "
        f"{time.perf_counter() - t0:.1f} s")
    if n_card != n_cpu:
        raise AssertionError("bucketed f32 counts differ between card and CPU")
    if not agree >= 0.999:
        raise AssertionError(f"bucketed f32 id maps agree on only {agree:.4%}")
    out["card_vs_cpu"] = {"bucket": [448, 448], "batch": 2,
                          "idmap_agreement": float(agree), "counts": n_card}
    return out


def phase_pred_cli(cfg, model, root, eval_lst, smi):
    """The pred CLI's ``main`` (``python -m tpuseg_torch.cli.pred``) in
    this process on one eval_hard64 image (semantic and --instances), held
    to the CPU's plain path with the CLI's own settings (f32, batch 1, the
    config's stopping rule: the JAX CLI loads no calibrated stop_params,
    unlike pred_list); pred_list --staged and --bucketed through the CLI
    on eval_hard64, f32, held to phase 11's f32 artifacts."""
    import torch
    from PIL import Image

    from tpuseg_torch.cli import pred, pred_list
    from tpuseg_torch.kernels.ir_chain import ir_chain
    from tpuseg_torch.runtime.predict import Predictor

    here = os.path.dirname(os.path.abspath(__file__))
    ckpt = os.path.join(here, "assets", "synthetic_ckpt.msgpack")
    with open(eval_lst) as f:
        images = [q for q in f.read().splitlines() if q]
    names = [os.path.splitext(os.path.basename(q))[0] for q in images]
    f32_dir = os.path.join(root, "eval", "pred_f32")
    want = _per_image(f32_dir, names)
    out = {}
    img, name = images[0], names[0]
    for mode, flags in (("semantic", []), ("instances", ["--instances"])):
        d = os.path.join(root, "pred_" + mode)
        torch.cuda.synchronize()
        t = time.perf_counter()
        pred.main(["--image", img, "--model", ckpt, "--output", d] + flags)
        torch.cuda.synchronize()
        out[mode + "_wall_s"] = time.perf_counter() - t
        files = sorted(os.listdir(d))
        n_files = 5 if flags else 1
        if len(files) != n_files:
            raise AssertionError(f"pred {mode} wrote {files}")
    base = os.path.join(root, "pred_instances", name)
    count = int(np.load(base + "-n_objects.npy"))
    ins = np.asarray(Image.open(base + "-ins_mask.png"))
    fg = np.asarray(Image.open(os.path.join(root, "pred_semantic",
                                            name + "-fg_mask.png"))) > 0
    cpu = Predictor(cfg, copy.deepcopy(model), batch_size=1, device="cpu",
                    dtype=torch.float32)
    ref = cpu.predict_attend(img)
    ref_fg = cpu.predict_semantic(img)["fg_prob"] > 0.5
    agree = float(np.mean(ins == ref["ins_mask"]))
    fg_agree = float(np.mean(fg == ref_fg))
    f32_ins = np.asarray(Image.open(os.path.join(f32_dir, name,
                                                 name + "-ins_mask.png")))
    out.update({"image": name, "count": count, "count_cpu": ref["n_objects"],
                "idmap_agreement_cpu": agree, "fg_agreement_cpu": fg_agree,
                "count_pred_list_f32": want[name][0],
                "idmap_agreement_pred_list_f32": float(np.mean(
                    ins == f32_ins))})
    log(f"  pred CLI on {name}: semantic {out['semantic_wall_s']:.1f} s, "
        f"--instances {out['instances_wall_s']:.1f} s (in this process: "
        f"weights, f32 forward, PNG writes); card vs the CPU's "
        f"plain path: count {count} / {ref['n_objects']}, id-map agreement "
        f"{agree:.6f}, fg {fg_agree:.6f}; beside pred_list --f32 (calibrated"
        f" stopping rule): count {want[name][0]}, id-map agreement "
        f"{out['idmap_agreement_pred_list_f32']:.6f} [{smi}]")
    if count != ref["n_objects"] or not (agree >= 0.999
                                         and fg_agree >= 0.999):
        raise AssertionError(
            f"pred on {name}: count {count} (CPU {ref['n_objects']}), "
            f"id-map agreement {agree:.4%}, fg {fg_agree:.4%}")

    made = _recording_predictors()
    for mode in ("staged", "bucketed"):
        d = os.path.join(root, "pred_list_" + mode)
        ir_chain.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        pred_list.main(["--lst", eval_lst, "--model", ckpt, "--dataset",
                        "CVPPP", "--batchsize", "16", "--f32", "--output", d,
                        "--" + mode])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        got = _per_image(d, names)
        same = sum(got[k] == want[k] for k in names)
        p = made[-1]
        out[mode] = {"wall_s": wall, "artifacts_equal_f32": same,
                     "ir_chain_launches": ir_chain.launches,
                     "rounds": p.rounds_run, "host_syncs": p.host_syncs}
        log(f"  pred_list --{mode} --f32 on eval_hard64: counts and id maps "
            f"(sha256) equal to phase 11's f32 on {same}/64 images; "
            f"{ir_chain.launches} ir_chain launches over {p.rounds_run} "
            f"rounds, {p.host_syncs} host syncs; wall {wall:.2f} s")
        if p.staged != (mode == "staged"):
            raise AssertionError(f"pred_list --{mode} built staged={p.staged}")
        if same != 64:
            raise AssertionError(
                f"pred_list --{mode} --f32 differs from phase 11's f32 "
                f"artifacts on {64 - same} images")
    return out


def phase_cluster(cfg, model, dev, eval_lst, smi):
    """predict_cluster on one image on the card: ids in 0..n, background 0."""
    import torch

    from tpuseg_torch.runtime.predict import Predictor

    with open(eval_lst) as f:
        img = f.read().splitlines()[0]
    p = Predictor(cfg, copy.deepcopy(model), batch_size=1, device=dev)
    p.predict_cluster(img, seed=0)  # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = p.predict_cluster(img, seed=0)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t)
    ins, fg, n = res["ins_mask"], res["fg_mask"], res["n_objects"]
    ids = set(np.unique(ins).tolist())
    if not (1 <= n <= cfg.data.max_n_objects and ids <= set(range(n + 1))
            and (ins[fg == 0] == 0).all()):
        raise AssertionError(
            f"predict_cluster: n {n}, ids {sorted(ids)}, ids off the "
            f"foreground {int((ins[fg == 0] > 0).sum())}")
    log(f"  predict_cluster ({p.dtype}, {os.path.basename(img)}): {n} "
        f"clusters, {len(ids - {0})} non-empty, {ms:.1f} ms with the PNG read"
        f" (KMeans: 8 restarts x 50 Lloyd steps, one program) [{smi}]")
    return {"ms": ms, "n_objects": n, "ids_used": len(ids - {0})}


def phase_debug(cfg, model, dev, root, smi):
    """The debug mode in f32, card vs CPU, at 256x256 B=2; the card's
    debug forward's launches; then fit(debug_dir=...) for 2 steps at B=8
    bf16 with the dumps checked and the launches counted."""
    import torch

    from tpuseg_torch.data.synthetic import make_batch
    from tpuseg_torch.kernels.ir_chain import ir_chain
    from tpuseg_torch.kernels.masked_softmax import (
        BACKWARD_LAUNCHES, FORWARD_LAUNCHES, masked_softmax,
    )
    from tpuseg_torch.runtime.loop import fit
    from tpuseg_torch.runtime.predict import tf32_off
    from tpuseg_torch.runtime.state import create_train_state
    from tpuseg_torch.runtime.train import make_debug_step

    rng = np.random.default_rng(41)
    batch = make_batch(rng, 2, 256, 256, cfg.data.max_n_objects, hard=True)
    got, launches = {}, {}
    for side, device in (("cpu", "cpu"), ("card", dev)):
        m = copy.deepcopy(model)
        state = create_train_state(cfg, m, device=device)
        step = make_debug_step(cfg, m)
        with tf32_off():
            reset_counts()
            dbg = step(state, batch)
            if side == "card":
                torch.cuda.synchronize()
                launches = {"masked_softmax": masked_softmax.forward_launches,
                            "ir_chain": ir_chain.launches}
        got[side] = {k: ([t.cpu() for t in v] if isinstance(v, list)
                         else v.cpu()) for k, v in dbg.items()}
    if launches != {"masked_softmax": FORWARD_LAUNCHES, "ir_chain": 20}:
        raise AssertionError(
            f"debug forward launches {launches}: want masked_softmax "
            f"{FORWARD_LAUNCHES} (one attend) and ir_chain 20 (one decode: "
            "5 levels x 4 blocks)")
    c, g = got["cpu"], got["card"]
    if not torch.equal(c["point"], g["point"]):
        # two pixels whose attention mass ties may turn the argmax; then
        # the decodes of different glimpses are not compared
        rows = torch.arange(len(c["point"]))
        a = c["alpha"][rows, c["point"]]
        b = c["alpha"][rows, g["point"]]
        gap = ((a - b).abs() / torch.maximum(a, b).clamp(min=1e-30)).max()
        log(f"  debug glimpse points cpu {c['point'].tolist()} card "
            f"{g['point'].tolist()}: attention mass ties to {gap:.2e}")
        if not gap <= 1e-3:
            raise AssertionError("debug glimpse points differ without a tie")
        g["preds"], g["targets"] = c["preds"], c["targets"]
    errs = {}
    for k in ("alpha", "pro"):
        errs[k] = (g[k] - c[k]).abs().max().item() / c[k].abs().max().item()
    errs["preds"] = max((a - b).abs().max().item() / b.abs().max().item()
                        for a, b in zip(g["preds"], c["preds"]))
    same_t = all(torch.equal(a, b) for a, b in zip(g["targets"], c["targets"]))
    log(f"  debug f32 card vs CPU (256x256, B=2): points equal "
        f"{g['point'].tolist()}, targets equal {same_t}, max|err|/max|ref| "
        f"alpha {errs['alpha']:.2e} pro {errs['pro']:.2e} preds (worst level) "
        f"{errs['preds']:.2e}; card launches {launches}")
    if not (same_t and errs["alpha"] <= 1e-3 and errs["pro"] <= 1e-3
            and errs["preds"] <= 1e-3):
        raise AssertionError(f"debug card vs CPU: targets equal {same_t}, "
                             f"errors {errs} (gate 1e-3 of max|ref|)")

    # fit with the dumps: 2 train steps + 1 validation batch, B=8, bf16
    batches = [make_batch(rng, 8, 256, 256, cfg.data.max_n_objects,
                          hard=True) for _ in range(3)]
    m = copy.deepcopy(model)
    state = create_train_state(cfg, m, device=dev)
    gen = torch.Generator(device=dev).manual_seed(cfg.train.seed)
    dump = os.path.join(root, "debug")
    reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fit(cfg, m, state, lambda e: batches[:2], lambda e: batches[2:],
        os.path.join(root, "run"), n_epochs=1, generator=gen,
        dtype=torch.bfloat16, debug_dir=dump, debug_every=1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    counts = {"forward": masked_softmax.forward_launches,
              "backward": masked_softmax.backward_launches,
              "ir_chain": ir_chain.launches}
    dirs = sorted(os.listdir(dump))
    if dirs != ["ep000_it00001", "ep000_it00002"] or any(
            sorted(os.listdir(os.path.join(dump, d))) != DUMP_FILES
            for d in dirs):
        raise AssertionError(f"fit debug dumps: {dirs}: "
                             f"{[os.listdir(os.path.join(dump, d)) for d in dirs]}")
    # 2 train + 1 validation + 2 debug forwards; 2 backwards; 2 debug
    # decodes and the validation decode's glimpses
    if (counts["forward"] != FORWARD_LAUNCHES * 5
            or counts["backward"] != BACKWARD_LAUNCHES * 2
            or counts["ir_chain"] < 20 * 3 or counts["ir_chain"] % 20):
        raise AssertionError(f"fit with debug dumps: launches {counts}")
    log(f"  fit(debug_dir=..., debug_every=1): 2 steps B=8 bf16 + 1 "
        f"validation batch in {fit_s:.1f} s; dumps {dirs} with the JAX "
        f"writer's {len(DUMP_FILES)} files each; masked_softmax forward "
        f"{counts['forward']} (2 train + 1 validation + 2 debug) backward "
        f"{counts['backward']}, ir_chain {counts['ir_chain']} (2 debug "
        f"decodes = 40 + the validation decode) [{smi}]")
    return {"card_vs_cpu": errs, "debug_forward_launches": launches,
            "fit_launches": counts, "fit_seconds": fit_s}


DP_TOL = dict(rtol=5e-3, atol=1.6e-2)  # tests/test_fit_mesh.py's
# dp-fit's gates on what the gradient's reductions decide: the relative
# error of the parameters' update and the logged metrics' (grad_norm among
# them) against one process.  tools/dp_gate.py on the card read up to
# 1.0e-3 / 2.4e-3 for the sound reductions, >= 0.25 / 0.76 with the
# statistics' backward all-reduce dropped or the gradients summed
# (PERF.md, PR 10)
UPDATE_TOL = 2e-2
METRIC_TOL = 4e-2


def _state_diff(a, b):
    """max |a - b| over the floating tensors of two model states, and the
    keys outside rtol/atol of ``DP_TOL``."""
    import torch

    worst, bad = 0.0, []
    for k, v in a.items():
        w = b[k]
        if not v.is_floating_point():
            if not torch.equal(v, w):
                bad.append(k)
            continue
        d = (v.double() - w.double()).abs()
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
        if not torch.allclose(v, w, **DP_TOL):
            bad.append(k)
    return worst, bad


def _update_error(got, want, init, names):
    """``||d_got - d_want|| / ||d_want||`` over the parameters ``names``
    at once, ``d`` the change from ``init``; and the parameter with the
    largest share of the miss."""
    import torch

    miss, norm = {}, 0.0
    for k in names:
        d_want = want[k].double() - init[k].double()
        miss[k] = float(torch.linalg.vector_norm(
            got[k].double() - want[k].double())) ** 2
        norm += float(torch.linalg.vector_norm(d_want)) ** 2
    total = sum(miss.values())
    ratio = (total / norm) ** 0.5 if norm else (0.0 if total == 0 else
                                                  float("inf"))
    return ratio, max(miss, key=miss.get)


def _logged_metrics(run_dir):
    """{(split, metric): value} of the epochs ``fit`` logged in the run's
    ``metrics.jsonl``."""
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    return {(r["split"], r["epoch"], k): v for r in recs for k, v in r.items()
            if k not in ("ts", "split", "epoch")}


def _metric_errors(got, want):
    """max over the logged metrics of |got - want| / max(|want|, 1e-3),
    and the metric."""
    if got.keys() != want.keys():
        return float("inf"), "keys differ"
    errs = {k: abs(got[k] - v) / max(abs(v), 1e-3) for k, v in want.items()}
    k = max(errs, key=errs.get)
    return errs[k], "/".join(map(str, k))


def dp_readings(two, one, init, names, two_dir, one_dir):
    """What dp-fit holds two ranks' ``fit`` to against one process: the
    worst |diff| over the state and the tensors outside ``DP_TOL``, the
    parameters' update error (``_update_error``) and the logged metrics'
    relative error (``_metric_errors``)."""
    worst, bad = _state_diff(two, one)
    upd, upd_at = _update_error(two, one, init, names)
    met, met_at = _metric_errors(_logged_metrics(two_dir),
                                 _logged_metrics(one_dir))
    return {"max_abs_diff": worst, "outside_tol": bad,
            "update_err": upd, "update_err_at": upd_at,
            "metric_err": met, "metric_err_at": met_at}


def _states_equal(a, b):
    import torch

    return a.keys() == b.keys() and all(torch.equal(v, b[k])
                                        for k, v in a.items())


def dp_fit_inputs(cfg, model):
    """dp-fit's f32 comparison: the model state, the configuration
    (deterministic glimpses, no dropout, SGD at 0.01, global B=4), 2
    train batches and 1 validation batch."""
    import dataclasses

    from tpuseg_torch.data.synthetic import make_batch

    sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    det = dataclasses.replace(
        cfg, decoder=dataclasses.replace(cfg.decoder, deterministic_glimpse=True,
                                         drop_rate=0.0),
        train=dataclasses.replace(cfg.train, optimizer="SGD",
                                  learning_rate=0.01, batch_size=4))
    rng = np.random.default_rng(31)
    batches = [make_batch(rng, 4, 256, 256, cfg.data.max_n_objects, hard=True)
               for _ in range(3)]
    return sd, det, batches[:2], batches[2:]


def dp_fit_args(det, sd, train_b, val_b, run_dir):
    """``tasks.fit_run``'s arguments after the mesh: 1 epoch, f32."""
    import torch

    return (det, sd, train_b, val_b, run_dir, 1, torch.float32)


def phase_dp_fit(cfg, model, dev, train, smi, more=()):
    """Data-parallel fit over 2 gloo ranks on the card against one process
    (f32), 1 NCCL rank, then the timed bf16 data-parallel steps.  The
    ranks run ``more`` (``(task, args)`` pairs) in the same spawn, after
    the fit and before the timed steps (run after them and their traced
    step, phase 24's bf16 batches took 2.5x longer); returns the readings
    and each rank's results of ``more``."""
    import tempfile

    import torch

    from tpuseg_torch.data.synthetic import make_batch
    from tpuseg_torch.kernels.masked_softmax import (
        BACKWARD_LAUNCHES, FORWARD_LAUNCHES,
    )
    from tpuseg_torch.parallel import make_mesh, run_ranks, tasks

    sd, det, train_b, val_b = dp_fit_inputs(cfg, model)
    root = tempfile.mkdtemp(prefix="chip_smoke_dp_")

    def args(name):
        return dp_fit_args(det, sd, train_b, val_b, os.path.join(root, name))

    out = {}
    t = time.perf_counter()
    one = tasks.fit_run(make_mesh(1, dev), *args("one"))
    again = tasks.fit_run(make_mesh(1, dev), *args("again"))
    out["one_process_s"] = (time.perf_counter() - t) / 2
    repeats = _states_equal(one["model"], again["model"])
    # the timed run's batches: bf16, sampling + dropout (phase 7's
    # configuration); the fit, phase 24's calls and these in one spawn
    # (the last batch's step traced, untimed: its all-reduces)
    B, n_warm, n_steps = 8, 1, 4
    rng = np.random.default_rng(13)
    steps_b = [make_batch(rng, B, 256, 256, cfg.data.max_n_objects, hard=True)
               for _ in range(n_warm + n_steps + 1)]
    t = time.perf_counter()
    runs = run_ranks(tasks.in_turn, 2, ([
        (tasks.fit_run, args("two")),
        *more,
        (tasks.train_steps, (cfg, sd, steps_b, torch.bfloat16, n_warm,
                             os.path.join(root, "trace"))),
    ],), device="cuda", backend="gloo", timeout=900)
    out["two_ranks_wall_s"] = time.perf_counter() - t
    two, timed = [r[0] for r in runs], [r[-1] for r in runs]
    more_results = [r[1:-1] for r in runs]
    names = [n for n, _ in model.named_parameters()]
    read = dp_readings(two[0]["model"], one["model"], sd, names,
                       os.path.join(root, "two"), os.path.join(root, "one"))
    worst, bad = read["max_abs_diff"], read["outside_tol"]
    identical = _states_equal(two[0]["model"], two[1]["model"])
    nccl = run_ranks(tasks.fit_run, 1, args("nccl"), device="cuda",
                     backend="nccl", timeout=600)[0]
    nccl_equal = _states_equal(nccl["model"], one["model"])
    nccl_worst, nccl_bad = _state_diff(nccl["model"], one["model"])
    rerun_worst = _state_diff(again["model"], one["model"])[0]
    out.update({
        "f32_max_abs_diff_vs_one": worst, "ranks_bit_identical": identical,
        "f32_update_err": read["update_err"],
        "f32_update_err_at": read["update_err_at"],
        "f32_metric_err": read["metric_err"],
        "f32_metric_err_at": read["metric_err_at"],
        "one_process_repeats_bit_for_bit": repeats,
        "one_process_rerun_max_abs_diff": rerun_worst,
        "nccl_one_rank_bit_equal": nccl_equal,
        "nccl_one_rank_max_abs_diff": nccl_worst,
        "steps": [r["step"] for r in two],
        "launches_f32": [r["launches"] for r in two],
    })
    log(f"  dp-fit f32 (256x256 full width, global B=4 = 2 gloo ranks x 2 on "
        f"one card, 2 SGD steps + 1 validation batch, deterministic "
        f"glimpses, TF32 off): max |two ranks - one process| {worst:.3e} "
        f"over parameters, BN statistics and baseline, {len(bad)} tensors "
        f"outside rtol 5e-3 / atol 1.6e-2; the parameters' update off by "
        f"{read['update_err']:.3e} of its norm (gate {UPDATE_TOL:g}; most "
        f"of it in {read['update_err_at']}); "
        f"logged metrics off by {read['metric_err']:.3e} at worst "
        f"({read['metric_err_at']}, gate {METRIC_TOL:g}); ranks "
        f"bit-identical {identical}; "
        f"one process rerun: bit-equal {repeats} (max |diff| "
        f"{rerun_worst:.3e}); 1 NCCL rank vs one process: bit-equal "
        f"{nccl_equal}, max |diff| {nccl_worst:.3e}; spawn + 2 ranks (this "
        f"fit, phase 24's {len(more)} calls and the timed steps below) "
        f"{out['two_ranks_wall_s']:.1f} s [{smi}]")
    if bad or not identical or [r["step"] for r in two] != [2, 2]:
        raise AssertionError(
            f"dp-fit f32: steps {[r['step'] for r in two]}, ranks identical "
            f"{identical}, outside the tolerance: {bad[:8]}")
    if read["update_err"] > UPDATE_TOL or read["metric_err"] > METRIC_TOL:
        raise AssertionError(f"dp-fit f32: {read}")
    if (repeats and not nccl_equal) or nccl_bad:
        raise AssertionError(
            f"dp-fit: 1 NCCL rank differs from one process (bit-equal "
            f"{nccl_equal}, outside the tolerance {nccl_bad[:8]})")
    for r, launches in enumerate(out["launches_f32"]):
        if (launches["masked_softmax_forward"] != FORWARD_LAUNCHES * 3
                or launches["masked_softmax_backward"]
                != BACKWARD_LAUNCHES * 2):
            raise AssertionError(f"dp-fit rank {r} launches {launches}")

    # -- timed: bf16, sampling + dropout
    r0 = timed[0]
    sps = r0["steps"] / r0["seconds"]
    costs = [m["cost"] for r in timed for m in r["metrics"]]
    launches = [r["launches"] for r in timed]
    out.update({
        "steps_per_s_bf16": sps, "ms_per_step_bf16": 1e3 / sps,
        "one_process_steps_per_s_bf16": train["steps_per_s"],
        "collectives_per_step": r0["collectives_per_step"],
        "collective_ms_per_step": [r["collective_ms_per_step"]
                                   for r in timed],
        "launches_bf16": launches,
    })
    log(f"  dp-fit bf16 timed (global B={B} = 2 gloo ranks x 4 on one card, "
        f"sampling + dropout, {n_steps} steps after {n_warm}): "
        f"{sps:.3f} steps/s ({1e3 / sps:.1f} ms/step) against phase 7's one "
        f"process at B={B} {train['steps_per_s']:.3f} steps/s; "
        f"{r0['collectives_per_step']:.0f} all-reduces in a traced step take "
        f"{r0['collective_ms_per_step']:.1f} ms (rank 1: "
        f"{timed[1]['collective_ms_per_step']:.1f}); "
        f"masked_softmax launches per rank {launches} [{smi}]")
    if not np.isfinite(costs).all():
        raise AssertionError(f"dp-fit bf16: non-finite costs {costs}")
    if not r0["collectives_per_step"] or any(
            r["collectives_per_step"] != r0["collectives_per_step"]
            for r in timed):
        raise AssertionError(f"dp-fit bf16: all-reduces a traced step "
                             f"{[r['collectives_per_step'] for r in timed]}")
    for r, lc in enumerate(launches):
        if (lc["masked_softmax_forward"] != FORWARD_LAUNCHES * n_steps
                or lc["masked_softmax_backward"]
                != BACKWARD_LAUNCHES * n_steps):
            raise AssertionError(f"dp-fit bf16 rank {r} launches {lc}")
    import shutil

    shutil.rmtree(root, ignore_errors=True)
    return out, more_results


def phase_mesh_predict(cfg, model, dev, stop, batches, smi):
    """``Predictor(use_mesh=True, n_devices=2)`` against one replica on
    phase 4's images: f32 outputs, launches a replica, bf16 img/s."""
    import torch

    from tpuseg_torch.kernels.ir_chain import ir_chain
    from tpuseg_torch.runtime.predict import Predictor, unpack_masks

    def make(dtype, mesh):
        kw = dict(use_mesh=True, n_devices=2) if mesh else {}
        return Predictor(cfg, copy.deepcopy(model), batch_size=32, device=dev,
                         dtype=dtype, stop_params=stop, **kw)

    def run(p):
        outs = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        for b in batches:
            packed, counts = p.predict_batch_packed(b)
            outs.append((packed.cpu().numpy(), counts.cpu().numpy()))
        torch.cuda.synchronize()
        return outs, time.perf_counter() - t

    n_img = sum(len(b) for b in batches)
    one32, two32 = make(torch.float32, False), make(torch.float32, True)
    if not (two32.batch_size == 32 and len(two32.replicas) == 2 and all(
            r.device.type == torch.device(dev).type
            for r in two32.replicas)):
        raise AssertionError("mesh predictor: wrong replicas or batch size")
    run(two32)  # warm-up (cuDNN plans at the replicas' batch of 16)
    want, _ = run(one32)
    ir_chain.launches = 0
    for r in two32.replicas:
        r.rounds_run = 0
    got, _ = run(two32)
    launches = ir_chain.launches
    rounds = [r.rounds_run for r in two32.replicas]
    fg0, id0 = map(np.concatenate, zip(*[unpack_masks(o[0]) for o in want]))
    fg1, id1 = map(np.concatenate, zip(*[unpack_masks(o[0]) for o in got]))
    n0 = np.concatenate([o[1] for o in want])
    n1 = np.concatenate([o[1] for o in got])
    agree = float(np.mean(id0 == id1))
    del one32, two32
    one16, two16 = make(torch.bfloat16, False), make(torch.bfloat16, True)
    run(one16)
    run(two16)
    times = {"one": [], "mesh": []}
    for name, p in (("mesh", two16), ("one", one16), ("one", one16),
                    ("mesh", two16)):
        times[name].append(run(p)[1])
    ips = {k: n_img / float(np.mean(v)) for k, v in times.items()}
    out = {"counts_equal": bool(np.array_equal(n0, n1)),
           "idmap_agreement": agree, "fg_equal": bool(np.array_equal(fg0, fg1)),
           "ir_chain_launches": launches, "rounds_per_replica": rounds,
           "img_per_s_bf16_mesh": ips["mesh"], "img_per_s_bf16_one": ips["one"]}
    log(f"  mesh-predict f32 (2 replicas on one card, B=32 = 2 x 16, {n_img} "
        f"images): counts equal {out['counts_equal']}, id-map agreement "
        f"{agree:.6f}, fg equal {out['fg_equal']}; {launches} ir_chain "
        f"launches over rounds {rounds} of the replicas; bf16 img/s mesh "
        f"{ips['mesh']:.2f} vs one replica {ips['one']:.2f} (alternated, 2 "
        f"passes each) [{smi}]")
    if not out["counts_equal"] or agree < 0.999:
        raise AssertionError(f"mesh predictor f32: {out}")
    if launches == 0 or launches != 5 * 4 * sum(rounds) or 0 in rounds:
        raise AssertionError(
            f"mesh predictor: ir_chain launches {launches} != 5 x 4 x rounds "
            f"{rounds}")
    return out


class _Stdout:
    """Within the block, file descriptor 1 (this process's and every
    child's standard output) goes to a file; ``text`` holds it after."""

    def __init__(self, path):
        self.path = path
        self.text = ""

    def __enter__(self):
        sys.stdout.flush()
        self._saved = os.dup(1)
        self._file = open(self.path, "w")
        os.dup2(self._file.fileno(), 1)
        return self

    def __exit__(self, *exc):
        sys.stdout.flush()
        os.dup2(self._saved, 1)
        os.close(self._saved)
        self._file.close()
        with open(self.path) as f:
            self.text = f.read()
        sys.stdout.write(self.text)
        sys.stdout.flush()


def phase_dp_cli(work, eval_lst, smi):
    """train --ndevices 2 --live --tensorboard on phase 12's records, then
    pred_list --ndevices 2 --f32 and evaluate."""
    import torch

    from tpuseg_torch.cli import evaluate, pred_list, train
    from tpuseg_torch.kernels.masked_softmax import (
        BACKWARD_LAUNCHES, FORWARD_LAUNCHES,
    )

    rec = os.path.join(work, "train")
    runs = os.path.join(work, "dp_runs")
    epochs = 2
    t = time.perf_counter()
    with _Stdout(os.path.join(work, "dp_cli_stdout.txt")) as cap:
        res = train.main([
            "--dataset", "CVPPP", "--batchsize", "8", "--bf16",
            "--train_data", os.path.join(rec, "train"),
            "--val_data", os.path.join(rec, "val"), "--runs_dir", runs,
            "--ndevices", "2", "--live", "--tensorboard",
            "--nepochs", str(epochs)])
    wall = time.perf_counter() - t
    run_dir = res["run_dir"]
    dirs = os.listdir(os.path.join(runs, "CVPPP"))
    with open(os.path.join(run_dir, "validation.log")) as f:
        val = [float(line.split(",")[1]) for line in f.read().split()[1:]]
    with open(os.path.join(run_dir, "training.log")) as f:
        costs = [float(line.split(",")[1]) for line in f.read().split()[1:]]
    best, want_ckpt = np.inf, []
    for e, v in enumerate(val):
        if v <= best:
            best = v
            want_ckpt.append(e)
    ckpts = sorted(int(f.split("_")[1]) for f in os.listdir(run_dir)
                   if f.startswith("model_"))
    tb_dir = os.path.join(run_dir, "tb")
    tb_events = os.path.isdir(tb_dir) and any(
        f.startswith("events") for f in os.listdir(tb_dir))
    tb_skip = "tensorboard writer unavailable" in cap.text
    live_rows = cap.text.count("live metrics:")
    n_train = sum(e["steps"] for e in res["epochs"])
    launches = res["rank_launches"]
    out = {"run_dirs": len(dirs), "checkpoint_epochs": ckpts,
           "improving_epochs": want_ckpt, "live_blocks": live_rows,
           "tensorboard": "events" if tb_events else (
               "skipped" if tb_skip else "none"),
           "train_costs": costs, "wall_s": wall, "train_steps": n_train,
           "rank_launches": launches}
    log(f"  dp-cli train --ndevices 2 --live --tensorboard --bf16 ({epochs} "
        f"epochs, global B=8 on 24 + 8 records at 530x500): {len(dirs)} run "
        f"dir, checkpoints for epochs {ckpts} (improving {want_ckpt}), "
        f"{live_rows} live blocks on stdout, TensorBoard "
        f"{out['tensorboard']}, train costs {costs}, rank launches "
        f"{launches}; {wall:.1f} s [{smi}]")
    if len(dirs) != 1 or ckpts != want_ckpt or live_rows != 2 * epochs:
        raise AssertionError(f"dp-cli train: {out}")
    if tb_events == tb_skip or not any(c in cap.text for c in "▁█"):
        raise AssertionError(f"dp-cli train: TensorBoard events {tb_events}, "
                             f"skip line {tb_skip}, or no sparkline")
    if len(costs) != epochs or not np.isfinite(costs).all():
        raise AssertionError(f"dp-cli train: costs {costs}")
    for r, lc in enumerate(launches):
        if (lc["masked_softmax_forward"] != FORWARD_LAUNCHES * (n_train + epochs)
                or lc["masked_softmax_backward"] != BACKWARD_LAUNCHES * n_train
                or lc["ir_chain"] <= 0 or lc["ir_chain"] % 20):
            raise AssertionError(f"dp-cli train rank {r} launches {lc}")

    # pred_list over two rank processes, f32: phase 11's f32 artifacts
    here = os.path.dirname(os.path.abspath(__file__))
    with open(eval_lst) as f:
        images = [q for q in f.read().splitlines() if q]
    names = [os.path.splitext(os.path.basename(q))[0] for q in images]
    want = _per_image(os.path.join(work, "eval", "pred_f32"), names)
    d = os.path.join(work, "pred_list_ndevices2")
    torch.cuda.synchronize()
    t = time.perf_counter()
    pred_list.main(["--lst", eval_lst, "--model",
                    os.path.join(here, "assets", "synthetic_ckpt.msgpack"),
                    "--dataset", "CVPPP", "--batchsize", "16", "--f32",
                    "--ndevices", "2", "--output", d])
    torch.cuda.synchronize()
    p_wall = time.perf_counter() - t
    ranks = list(pred_list.last_ranks)
    rounds = [r["rounds"] for r in ranks]
    p_launches = [r["launches"]["ir_chain"] for r in ranks]
    got = _per_image(d, names)
    same = sum(got[k] == want[k] for k in names)
    scores = evaluate.main(["--pred_dir", d, "--dataset", "CVPPP",
                            "--metadata", os.path.dirname(eval_lst),
                            "--img_dir", os.path.dirname(images[0]),
                            "--device", "cuda"])
    out.update({"pred_list_artifacts_equal_f32": same,
                "pred_list_ir_chain_launches_per_rank": p_launches,
                "pred_list_rounds_per_rank": rounds,
                "pred_list_images_per_rank": [r["images"] for r in ranks],
                "pred_list_rank_seconds": [r["seconds"] for r in ranks],
                "pred_list_wall_s": p_wall,
                "pred_list_img_per_s_2_ranks": len(names) / p_wall,
                "sbd": scores[0], "abs_dic": scores[1], "fg_dice": scores[2]})
    log(f"  dp-cli pred_list --ndevices 2 --f32 on eval_hard64 (2 rank "
        f"processes, images a rank {out['pred_list_images_per_rank']}): "
        f"artifacts (counts, id-map sha256) equal to phase 11's f32 on "
        f"{same}/64; ir_chain launches a rank {p_launches} over rounds "
        f"{rounds}; evaluate SBD {scores[0]:.6f} |DiC| {scores[1]:.4f} FG "
        f"{scores[2]:.6f}; wall {p_wall:.2f} s = {len(names) / p_wall:.2f} "
        f"img/s incl. the ranks' start, weights and PNG writes (each rank's "
        f"images took {out['pred_list_rank_seconds']} s) [{smi}]")
    if same != 64 or len(rounds) != 2 or 0 in out["pred_list_images_per_rank"]:
        raise AssertionError(f"pred_list --ndevices 2: {same}/64 equal, "
                             f"images a rank {out['pred_list_images_per_rank']}")
    for n_l, n_r in zip(p_launches, rounds):
        if n_l == 0 or n_l != 5 * 4 * n_r:
            raise AssertionError(
                f"pred_list --ndevices 2: ir_chain launches {p_launches} for "
                f"rounds {rounds}")
    return out


def phase_trace(cfg, model, dev, stop, batch, root, smi):
    """One phase-4 batch inside ``trace_context`` under a ``StepTimer``;
    the ``ir_chain`` launches of the traced batch counted."""
    from tpuseg_torch.kernels.ir_chain import ir_chain
    from tpuseg_torch.runtime.predict import Predictor
    from tpuseg_torch.utils.tracing import (
        TRACE_FILE, StepTimer, annotate, trace_context,
    )

    pred = Predictor(cfg, copy.deepcopy(model), batch_size=32, device=dev,
                     stop_params=stop)
    pred.predict_batch_packed(batch)  # warm-up
    timer = StepTimer()
    before = ir_chain.launches
    with trace_context(root):
        with annotate("predict_batch"):
            timer.time("batch", pred.predict_batch_packed, batch)
    launches = ir_chain.launches - before
    path = os.path.join(root, TRACE_FILE)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    named = any(e.get("name") == "predict_batch" for e in events)
    rec = timer.summary().get("batch", {})
    out = {"trace_bytes": os.path.getsize(path), "events": len(events),
           "kernel_events": len(kernels), "annotated": named,
           "timer_count": rec.get("count", 0),
           "batch_ms": 1e3 * rec.get("mean_s", float("nan")),
           "ir_chain_launches": launches, "trace_dir": root}
    log(f"  trace: {path} ({out['trace_bytes']} bytes, {len(events)} events, "
        f"{len(kernels)} device kernels, annotation {named}); StepTimer "
        f"{out['timer_count']} record, {out['batch_ms']:.1f} ms for the batch "
        f"(profiler on) [{smi}]")
    if not kernels or not named or out["timer_count"] != 1:
        raise AssertionError(f"trace: {out}")
    return out


def split_halves(e, mask, side):
    """The rows of each (B, HW) / (B, N, HW) image cut in two, as two ranks
    of a spatial mesh hold them: [(e_half, mask_half), ...] contiguous."""
    b, n, _ = mask.shape
    cut = [(0, side // 2), (side // 2, side)]
    img_e = e.reshape(b, side, side)
    img_m = mask.reshape(b, n, side, side)
    return [(img_e[:, a:z].reshape(b, -1).contiguous(),
             img_m[:, :, a:z].reshape(b, n, -1).contiguous()) for a, z in cut]


def phase_split_softmax(dev, smi):
    """The split-row entry points of masked_softmax (spatial training's)
    against their plain versions at phase 5's shapes with each image's rows
    cut in two: the two halves' partials combined, p against the whole-row
    plain version (1e-6), de with the training path's g against autograd
    through it (1e-5 of max|de|); then timed at (8, 32, 65536) (one half:
    (8, 32, 32768)) beside the plain pieces, the library calls and the
    bytes bound."""
    import torch

    from tpuseg_torch.kernels import masked_softmax as ms
    from tpuseg_torch.parallel.spatial import _combine_stats

    rows, max_p_err, max_de_rel = [], 0.0, 0.0
    rng = np.random.default_rng(11)
    g_cpu = torch.Generator(device="cpu").manual_seed(1)
    for b, side in ((2, 256), (8, 256), (2, 255)):
        e, mask, _ = softmax_inputs(rng, g_cpu, b, side, dev)
        n = mask.shape[1]
        g, active = softmax_cotangent(mask, "main", seed=b * 1000 + side)
        halves = split_halves(e, mask, side)
        gs = [h[1] for h in split_halves(torch.zeros_like(e), g, side)]
        with torch.no_grad():
            parts = [ms.masked_softmax_stats(eh, mh) for eh, mh in halves]
            for (eh, mh), part in zip(halves, parts):
                want = ms.masked_softmax_stats_plain(eh, mh)
                if not torch.allclose(part, want, rtol=1e-5, atol=1e-6):
                    raise AssertionError("split stats differ from plain")
            stats = _combine_stats(parts)
            ps = [ms.masked_softmax_apply(eh, mh, stats) for eh, mh in halves]
            dots = sum(ms.masked_softmax_row_dots(p, gh)
                       for p, gh in zip(ps, gs))
            des = [ms.masked_softmax_tiles(p, gh, dots)
                   for p, gh in zip(ps, gs)]
        ep = e.clone().requires_grad_()
        pp = ms.masked_softmax_plain(ep, mask)
        (dp,) = torch.autograd.grad(pp, ep, g)
        got_p = torch.cat([p.reshape(b, n, -1, side) for p in ps], dim=2)
        got_de = torch.cat([d.reshape(b, -1, side) for d in des], dim=1)
        p_err = (got_p.reshape(b, n, -1) - pp.detach()).abs().max().item()
        de_scale = dp.abs().max().item()
        de_rel = (got_de.reshape(b, -1) - dp).abs().max().item() / de_scale
        if not (torch.isfinite(got_p).all() and torch.isfinite(got_de).all()):
            raise AssertionError("split masked_softmax: non-finite output")
        if not (p_err <= 1e-6 and de_rel <= 1e-5):
            raise AssertionError(
                f"split masked_softmax ({b},{n},{side * side}): max|p err| "
                f"{p_err:.3e} (1e-6), max|de err| / max|de| {de_rel:.3e} "
                f"(1e-5)")
        max_p_err, max_de_rel = max(max_p_err, p_err), max(max_de_rel, de_rel)
        row = {"shape": [b, n, side * side], "half_shape": list(
            halves[0][1].shape), "max_p_err": p_err, "max_de_rel_err": de_rel,
            "active_rows": active}
        if b == 8:
            eh, mh = halves[0]
            p0, g0 = ps[0], gs[0]
            hw = eh.shape[1]
            act0 = int((g0 != 0).any(dim=-1).sum())

            def fwd():
                return ms.masked_softmax_apply(
                    eh, mh, ms.masked_softmax_stats(eh, mh))

            def bwd():
                return ms.masked_softmax_tiles(
                    p0, g0, ms.masked_softmax_row_dots(p0, g0))

            def fwd_plain():
                return ms.masked_softmax_apply_plain(
                    eh, mh, ms.masked_softmax_stats_plain(eh, mh))

            def bwd_plain():
                return ms.masked_softmax_tiles_plain(
                    p0, g0, ms.masked_softmax_row_dots_plain(p0, g0))

            logits = torch.where(mh > 0, eh[:, None, :],
                                 torch.full_like(eh[:, None, :], -1e30))
            with torch.no_grad():
                row["forward_ms"] = cuda_ms(fwd, 20)
                row["backward_ms"] = cuda_ms(bwd, 20)
                row["forward_device_ms"] = kernel_device_ms(
                    fwd, 10, "masked_softmax_", launches=2)
                row["backward_device_ms"] = kernel_device_ms(
                    bwd, 10, "masked_softmax_", launches=2)
                row["plain_forward_ms"] = cuda_ms(fwd_plain, 20)
                row["plain_backward_ms"] = cuda_ms(bwd_plain, 20)
                row["library_ms"] = cuda_ms(
                    lambda: torch.softmax(logits, dim=-1), 20) + cuda_ms(
                    lambda: torch._softmax_backward_data(
                        g0, p0, -1, torch.float32), 20)
            del logits
            fb, bb = softmax_bound_ms(b, n, hw, act0)
            row.update(bound_forward_ms=fb, bound_backward_ms=bb,
                       active_rows_half=act0)
            log(f"  split masked_softmax, one half {row['half_shape']}: "
                f"forward (stats + apply) {row['forward_ms']:.4f} ms "
                f"(device {row['forward_device_ms']}, plain "
                f"{row['plain_forward_ms']:.3f}, bound {fb:.4f}); backward "
                f"(row dots + tiles, {act0} rows nonzero) "
                f"{row['backward_ms']:.4f} ms (device "
                f"{row['backward_device_ms']}, plain "
                f"{row['plain_backward_ms']:.3f}, bound {bb:.4f}); "
                f"torch.softmax + _softmax_backward_data "
                f"{row['library_ms']:.4f} ms [{smi}]")
        rows.append(row)
        del e, mask, g, halves, gs, ps, des, dp, pp, ep
    log(f"  split masked_softmax vs plain: max|p err| {max_p_err:.3e}, "
        f"max|de err| / max|de| {max_de_rel:.3e}")
    torch.cuda.empty_cache()
    return rows, max_p_err, max_de_rel


SPATIAL_SIDE = 512       # spatial inference: 2 ranks at 512 x 512
SPATIAL_TRAIN_SIDE = 256


def spatial_calls(cfg, model, stop):
    """Phase 24's rank calls: f32 and bf16 spatial inference on two
    ``SPATIAL_SIDE``² hard scenes, 2 f32 SGD steps of spatial training.
    They run in phase 19's spawn of the 2 ranks, after its fit (a
    spawn costs the ranks' start-up and first-call warm-up, tens of
    seconds); phase 24 runs them again in one process."""
    import dataclasses

    import torch

    from tpuseg_torch.data.synthetic import make_batch, make_scene
    from tpuseg_torch.parallel import tasks

    sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(41)
    imgs = np.stack([make_scene(rng, SPATIAL_SIDE, SPATIAL_SIDE, hard=True)[0]
                     for _ in range(2)])
    tcfg = dataclasses.replace(
        cfg, decoder=dataclasses.replace(cfg.decoder, deterministic_glimpse=True,
                                         drop_rate=0.0),
        train=dataclasses.replace(cfg.train, optimizer="SGD",
                                  learning_rate=0.01, batch_size=2))
    batches = [make_batch(rng, 2, SPATIAL_TRAIN_SIDE, SPATIAL_TRAIN_SIDE,
                          cfg.data.max_n_objects, hard=True)] * 2
    f32, bf16 = torch.float32, torch.bfloat16
    return [(tasks.spatial_infer, (cfg, sd, [imgs], None, stop, f32, True)),
            (tasks.spatial_infer, (cfg, sd, [imgs], None, stop, bf16, False,
                                   3)),
            (tasks.spatial_train, (tcfg, sd, batches, f32, True))]


def phase_spatial(dev, smi, calls, ranks):
    """The spatial (H-sharded) path of ``parallel/spatial.py`` over 2 gloo
    ranks on the card against one process: inference at full width on two
    512 x 512 synthetic scenes, f32 (id maps and counts equal, semantic
    within rtol 2e-4 / atol 2e-5), each rank's ir_chain launches, then bf16
    ms a batch beside one process's; training at 256 x 256, f32, 2 SGD
    steps under deterministic glimpses (parameters within rtol 5e-3 / atol
    1.6e-2), each rank's launches of masked_softmax's split entry points.
    ``ranks``: each rank's results of ``calls`` (``spatial_calls``), run
    in phase 19's spawn."""
    import torch

    from tpuseg_torch.parallel import make_mesh

    batches = calls[2][1][2]  # spatial_train's (cfg, state, batches, ...)
    one = make_mesh(1, dev)
    t0 = time.perf_counter()
    ref = [task(one, *args) for task, args in calls]
    one_s = time.perf_counter() - t0
    want = ref[0]["outs"][0]
    idmap = torch.cat([r[0]["outs"][0]["idmap"] for r in ranks], dim=1)
    sem = torch.cat([r[0]["outs"][0]["sem"] for r in ranks], dim=2)
    same_id = float((idmap == want["idmap"]).float().mean())
    counts = [r[0]["outs"][0]["counts"].tolist() for r in ranks]
    sem_err = (sem - want["sem"]).abs().max().item()
    sem_ok = torch.allclose(sem, want["sem"], rtol=2e-4, atol=2e-5)
    launches = [r[0]["launches"]["ir_chain"] for r in ranks]
    gathers = [c for c in ranks[0][0]["comms"] if c["op"] == "gather"]
    halos = sum(c["op"] == "halo" for c in ranks[0][0]["comms"])
    worst = 0.0
    for k, v in ref[2]["model"].items():
        if v.dtype.is_floating_point:
            for r in ranks:
                ex = ((r[2]["model"][k] - v).abs() - 5e-3 * v.abs()).max()
                worst = max(worst, float(ex))
    split = [(r[2]["launches"]["masked_softmax_split_forward"],
              r[2]["launches"]["masked_softmax_split_backward"],
              r[2]["launches"]["masked_softmax_forward"]) for r in ranks]
    out = {
        "infer_idmap_agreement": same_id, "infer_counts": counts,
        "infer_counts_one_process": want["counts"].tolist(),
        "infer_sem_max_err": sem_err,
        "infer_rounds": [r[0]["rounds"] for r in ranks],
        "infer_rounds_one_process": ref[0]["rounds"],
        "ir_chain_launches_per_rank": launches,
        "ir_chain_launches_one_process": ref[0]["launches"]["ir_chain"],
        "infer_halos_rank0": halos,
        "infer_gathers_rank0": [c["shape"] for c in gathers],
        "bf16_ms_per_batch_ranks": [r[1]["ms_per_batch"] for r in ranks],
        "bf16_ms_per_batch_one_process": ref[1]["ms_per_batch"],
        "train_param_excess_over_rtol": worst,
        "train_costs": [m["cost"] for m in ranks[0][2]["metrics"]],
        "train_costs_one_process": [m["cost"] for m in ref[2]["metrics"]],
        "split_launches_per_rank": [{"forward": f, "backward": b}
                                    for f, b, _ in split],
        "one_process_seconds": one_s,
    }
    log(f"  spatial inference, 2 ranks on one card vs one process, f32 "
        f"{SPATIAL_SIDE}x{SPATIAL_SIDE} B=2 full width: id maps agree on "
        f"{same_id:.6f}, counts {counts} vs {want['counts'].tolist()}, rounds "
        f"{out['infer_rounds']} vs {ref[0]['rounds']}, semantic max|err| "
        f"{sem_err:.3e}; ir_chain launches a rank {launches} (one process "
        f"{out['ir_chain_launches_one_process']}); rank 0 moved {halos} halos "
        f"and gathered {out['infer_gathers_rank0']}; bf16 ms a batch: ranks "
        f"{out['bf16_ms_per_batch_ranks']} vs one process "
        f"{ref[1]['ms_per_batch']:.1f} (both ranks share one card, and each "
        f"halo crosses host memory through gloo) [{smi}]")
    log(f"  spatial training, 2 ranks, f32 {SPATIAL_TRAIN_SIDE}^2 B=2, 2 SGD "
        f"steps: parameters' largest excess over rtol 5e-3 {worst:.3e} (atol "
        f"1.6e-2), costs {out['train_costs']} vs {out['train_costs_one_process']}"
        f"; masked_softmax split launches a rank (forward, backward) "
        f"{[(f, b) for f, b, _ in split]}; the ranks ran in phase 19's "
        f"spawn; one process {one_s:.1f} s [{smi}]")
    if same_id != 1.0 or any(c != want["counts"].tolist() for c in counts):
        raise AssertionError(f"spatial inference differs from one process: {out}")
    if not sem_ok:
        raise AssertionError(f"spatial semantic max|err| {sem_err:.3e}")
    if min(launches) <= 0:
        raise AssertionError(f"spatial inference: ir_chain launches {launches}")
    if any(max(c["shape"][2:]) >= SPATIAL_SIDE for c in gathers):
        raise AssertionError(f"spatial inference gathered a full-size map: "
                             f"{out['infer_gathers_rank0']}")
    if worst > 1.6e-2:
        raise AssertionError(f"spatial training parameters off by {worst:.3e}")
    for f, b, whole in split:
        if f != 2 * len(batches) or b != 2 * len(batches) or whole != 0:
            raise AssertionError(
                f"spatial training launches: split forward {f}, backward {b}, "
                f"whole-row forward {whole} for {len(batches)} steps")
    return out


CAP_SIDE = 256     # the model's input size: the capability phase's maps
CAP_TOL = 1e-4     # card vs CPU: max|card - cpu| / max|cpu|, per output
NATIVE_TOL = 1e-5  # the C++ host SRU forward vs the Hopper sru_fwd_kernel


def rel_err(got, want) -> float:
    """max|got - want| / max|want| on the CPU in float32."""
    got = got.detach().float().cpu()
    want = want.detach().float().cpu()
    scale = float(want.abs().max()) if want.numel() else 0.0
    return float((got - want).abs().max()) / max(scale, 1e-30) \
        if want.numel() else 0.0


def flat_outputs(x) -> list:
    """The tensors of a nested output (tuples, lists, dicts), bool as
    float."""
    import torch

    if x is None:
        return []
    if isinstance(x, (int, float)):
        return [torch.tensor(float(x))]
    if torch.is_tensor(x):
        return [x.float() if x.dtype == torch.bool else x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in flat_outputs(v)]
    return [t for v in x for t in flat_outputs(v)]


def adam_step_gate(name, card, cpu, before, grads, step_max):
    """The parameters after one Adam step on the card and the CPU (flax
    trees of numpy leaves) within ``CAP_TOL`` of each other, leaf by leaf,
    except where the CPU gradient is below 1e-6 of its largest: there
    Adam's first step (lr * g / (|g| + eps)) turns rounding noise into a
    step, and each side is held to a step of at most ``step_max``.
    Returns (the worst relative error, the elements so held)."""
    def flat(tree, path=()):
        if isinstance(tree, dict):
            return {p: v for k, sub in tree.items()
                    for p, v in flat(sub, path + (k,)).items()}
        return {".".join(path): tree}

    grads, card, cpu, before = map(flat, (grads, card, cpu, before))
    noise = 1e-6 * max(float(np.abs(v).max()) for v in grads.values())
    worst, held = 0.0, 0
    for k, grad in grads.items():
        small = np.abs(grad) < noise
        held += int(small.sum())
        for side in (card, cpu):
            step = np.abs(side[k] - before[k])[small]
            if step.size and step.max() > step_max:
                raise AssertionError(f"{name}: {k} moved {step.max()} on a "
                                     f"noise gradient")
        a, b = card[k][~small], cpu[k][~small]
        if b.size:
            worst = max(worst, float(np.abs(a - b).max())
                        / max(float(np.abs(b).max()), 1e-30))
    if not worst <= CAP_TOL:
        raise AssertionError(f"{name}: card vs CPU update rel err {worst}")
    return worst, held


def phase_capability(dev, smi, side=CAP_SIDE):
    """The capability modules (the JAX package's modules off the main
    paths) at the JAX package's default widths, on ``side``-square maps
    (the model's input size): each run in float32 with TF32 off on the card
    and on the CPU from the same weights and inputs, every output within
    ``CAP_TOL`` (max|card - cpu| / max|cpu|), the card forward timed (CUDA
    events); one ``MatchLoss.step`` and one ``DQNSelecter.update`` on both
    (``adam_step_gate``); ``AtteNetLegacy`` with the DQN's ``q_fn``; the
    C++ host library built here and its SRU forward held to the Hopper
    ``sru_fwd_kernel`` at the language-model shape (``NATIVE_TOL``)."""
    import dataclasses

    import torch

    from tpuseg_torch.configs import DecoderConfig
    from tpuseg_torch.decoder import pn_losses
    from tpuseg_torch.decoder.pyramid import window_origin_fg
    from tpuseg_torch.evalm.metrics import calc_bd
    from tpuseg_torch.kernels.sru_scan import sru_scan
    from tpuseg_torch.losses import discriminative, mmd
    from tpuseg_torch.models.attenet_legacy import AtteNetLegacy
    from tpuseg_torch.nn import (
        VGG16, ChannelAttention, CoordConv, CoordConvNet, CoordConvTranspose,
        DcganDecoder, DenseASPP, MaskedAsppEncoder, MobileV1ASPP,
        NonLocalLayer, ScalePDAttention, SkipVGG16, TransformerDecoderLayer,
        retrofit_coordconv_params)
    from tpuseg_torch.nn import native
    from tpuseg_torch.nn.dqn import DQNSelecter, RLSelect
    from tpuseg_torch.nn.embedding import Embedding
    from tpuseg_torch.nn.hourglass import StackedRecurrentHourglass
    from tpuseg_torch.runtime.predict import tf32_off
    from tpuseg_torch.runtime.wae import MatchLoss
    from tpuseg_torch.weights import grads_to_flax, to_flax

    t_phase = time.perf_counter()
    torch.manual_seed(0)
    g = torch.Generator().manual_seed(0)
    cpu = torch.device("cpu")
    rows = []

    def randn(*shape):
        return torch.randn(shape, generator=g)

    def mask(*shape, p=0.5):
        return (torch.rand(shape, generator=g) < p).float()

    def to(a, d):
        if torch.is_tensor(a):
            return a.to(d)
        if isinstance(a, (list, tuple)):
            return type(a)(to(v, d) for v in a)
        return a

    def pair(name, fn_cpu, fn_card, *inputs, **kw):
        args, kwc = to(inputs, dev), {k: to(v, dev) for k, v in kw.items()}
        with torch.no_grad():
            want = flat_outputs(fn_cpu(*inputs, **kw))
            got = flat_outputs(fn_card(*args, **kwc))
            if len(got) != len(want):
                raise AssertionError(f"{name}: {len(got)} outputs on the "
                                     f"card, {len(want)} on the CPU")
            err = max(rel_err(a, b) for a, b in zip(got, want))
            ms = cuda_ms(lambda: fn_card(*args, **kwc), 3, 1)
        if not err <= CAP_TOL:
            raise AssertionError(f"{name}: card vs CPU rel err {err}")
        rows.append({"module": name, "rel_err": err, "ms": ms})
        log(f"  {name}: rel err {err:.2e}, {ms:.3f} ms on the card")

    def module(name, m, *inputs, **kw):
        m = m.eval()
        pair(name, m, copy.deepcopy(m).to(dev), *inputs, **kw)

    s = side
    x3 = randn(1, 3, s, s)
    x24 = randn(2, 24, s, s)
    x32 = randn(2, 32, s, s)
    fg = mask(2, 1, s, s, p=0.6)
    with tf32_off():
        # -- CoordConv family, VGG16
        module("CoordConv", CoordConv(32, 32, 3, padding=1, with_r=True), x32)
        module("CoordConvTranspose", CoordConvTranspose(32, 16),
               randn(2, 32, s // 2, s // 2))
        vgg = VGG16(3).eval()
        module("VGG16", vgg, x3)
        skip = SkipVGG16(3).eval()
        skip.features.load_state_dict(
            {k: v for k, v in vgg.state_dict().items()
             if k in skip.features.state_dict()})
        module("SkipVGG16", skip, x3)
        net = CoordConvNet(3, n_layers=16).eval()
        net.load_state_dict(retrofit_coordconv_params(
            skip.features.state_dict()))
        module("CoordConvNet", net, x3)
        with torch.no_grad():  # the retrofit starts out equal
            retro_err = rel_err(net(x3)[-1], skip(x3)[-1])
        if not retro_err <= CAP_TOL:
            raise AssertionError(f"CoordConvNet retrofit rel err {retro_err}")
        # -- ConvGRU / hourglass
        module("StackedRecurrentHourglass", StackedRecurrentHourglass(3), x3)
        # -- attention, blocks, ASPP
        module("ChannelAttention", ChannelAttention(24, 24).eval(), x24, fg)
        module("MobileV1ASPP", MobileV1ASPP(32, 32, dilation=2), x32)
        module("DenseASPP", DenseASPP(3), x3)
        module("MaskedAsppEncoder", MaskedAsppEncoder(24, 24, (3, 6, 12)),
               x24, fg)
        # -- DQN, legacy AtteNet with the DQN's q_fn
        sel = DQNSelecter.create(24, seed=0, device="cpu")
        sel_card = DQNSelecter(copy.deepcopy(sel.net).to(dev))
        flat_fg = fg.reshape(2, -1)
        pair("RLSelect", sel.q_values, sel_card.q_values, x24, flat_fg)
        leg = AtteNetLegacy(DecoderConfig(), 24).eval()
        leg_card = copy.deepcopy(leg).to(dev)
        ins = torch.zeros(2, 8, s, s)
        for i in range(8):
            ins[:, i, (i // 4) * s // 2:(i // 4 + 1) * s // 2,
                (i % 4) * s // 4:(i % 4 + 1) * s // 4] = 1.0
        ins_fg = ins.amax(1, keepdim=True) * fg
        pair("AtteNetLegacy+DQN",
             lambda *a: leg(*a, q_fn=sel.q_values),
             lambda *a: leg_card(*a, q_fn=sel_card.q_values),
             x24, ins_fg, ins)
        # -- transformer, embedding
        dec_in, enc = randn(2, 16, 24), randn(2, s * s, 24)
        key_mask = mask(2, s * s, p=0.7)
        for last in (False, True):
            module(f"TransformerDecoderLayer(last={last})",
                   TransformerDecoderLayer(24, 48, 2, 12, 12, last=last),
                   dec_in, enc, key_mask)
        module("ScalePDAttention", ScalePDAttention(24, 12, 12, 24, 2),
               x24, x24, mask(2, 1, s, s, p=0.2))
        module("NonLocalLayer", NonLocalLayer(24, 24, 12, 24), x24,
               randn(2, 24))
        pts = torch.tensor([[s // 3, s // 2], [s - 1, 0]])
        module("Embedding", Embedding(24, 24), x24, pts, randn(2, 24))
        # -- losses
        emb = randn(2, 32, s, s)
        ids = torch.randint(0, 17, (2, s, s), generator=g)
        onehot = (ids[:, None] == torch.arange(1, 17)[None, :, None, None])
        n_obj = torch.tensor([16, 9])
        pair("discriminative_loss", discriminative.discriminative_loss,
             discriminative.discriminative_loss, emb, onehot.float(), n_obj)
        hw = s * s
        probs = torch.rand(2, hw, generator=g)
        pair("pn_loss", pn_losses.pn_loss, pn_losses.pn_loss, probs,
             randn(2, hw), torch.rand(2, hw, generator=g),
             torch.full((2, 1), 0.5), mask(2, hw), focal_weight=0.3)
        maps = [torch.rand(2, 1, s, s, generator=g) for _ in range(4)]
        pair("pn_loss2", pn_losses.pn_loss2, pn_losses.pn_loss2, *maps, fg)
        peak = torch.zeros(2, 1, s, s)
        peak[:, 0, s // 2, s // 3] = 1.0
        pair("pn_loss3", pn_losses.pn_loss3, pn_losses.pn_loss3, peak,
             randn(2, 1, s, s), maps[0], torch.tensor([0.3, 0.6]), fg)
        pair("mmd_penalty", mmd.mmd_penalty, mmd.mmd_penalty,
             randn(300, 24), randn(300, 24))
        pair("mmd_penalty_with_p", mmd.mmd_penalty_with_p,
             mmd.mmd_penalty_with_p, randn(300, 2) * 16, randn(280, 2) * 16,
             torch.rand(300, generator=g), torch.rand(280, generator=g))
        recon = torch.rand(16, 64, 64, generator=g)
        gold = mask(16, 64, 64, p=0.3)
        pair("decoder_mmd_loss", mmd.decoder_mmd_loss, mmd.decoder_mmd_loss,
             recon, gold, draws=mmd.decoder_mmd_draws(16, 64, 64, g))
        pair("mmd_loss_pooled", mmd.mmd_loss_pooled, mmd.mmd_loss_pooled,
             torch.rand(2, hw, generator=g), mask(2, s, s, p=0.3),
             draws=torch.rand(2, 2, s, s, generator=g))
        pair("gl_loss", mmd.gl_loss, mmd.gl_loss, randn(16, 24), recon)
        module("DcganDecoder", DcganDecoder(), randn(16, 24))
        points = torch.randint(0, hw, (64,), generator=g)
        pair("window_origin_fg", window_origin_fg, window_origin_fg, points,
             (s, s), 192 * s // 256, 64 * s // 256,
             mask(32, 1, s, s, p=0.3), 2)
        idmap = torch.randint(0, 9, (s, s), generator=g)
        noisy = torch.where(torch.rand(s, s, generator=g) < 0.9, idmap,
                            torch.zeros_like(idmap))
        pair("calc_bd", calc_bd, calc_bd, idmap, noisy)

        # -- one MatchLoss step and one DQNSelecter update on both
        ml = MatchLoss.create(device="cpu", weight_decay=1e-2)
        ml_card = MatchLoss.create(device=dev, weight_decay=1e-2)
        ml_card.decoder.load_state_dict(ml.decoder.state_dict())
        before = to_flax(ml.decoder)["params"]
        z = randn(16, 24)
        draws = mmd.decoder_mmd_draws(16, 64, 64, g)
        t0 = time.perf_counter()
        total, _ = ml.step(z, gold, draws=draws)
        total_card, _ = ml_card.step(z.to(dev), gold.to(dev),
                                     draws=draws.to(dev))
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        loss_err = rel_err(total_card, total)
        upd_err, held = adam_step_gate(
            "MatchLoss.step", to_flax(ml_card.decoder)["params"],
            to_flax(ml.decoder)["params"], before, grads_to_flax(ml.decoder),
            ml.learning_rate * ml.plateau.lr * (1 + 1e-2) + 1e-7)
        if not loss_err <= CAP_TOL:
            raise AssertionError(f"MatchLoss loss rel err {loss_err}")
        rows.append({"module": "MatchLoss.step", "rel_err": upd_err,
                     "loss_rel_err": loss_err, "noise_elements": held,
                     "s": step_s})
        log(f"  MatchLoss.step: loss rel err {loss_err:.2e}, update rel err "
            f"{upd_err:.2e} ({held} noise-gradient elements held to a step)")

        sel = DQNSelecter.create(24, seed=1, device="cpu", buffer_start=4,
                                 dqn_batch_size=4)
        sel_card = DQNSelecter(copy.deepcopy(sel.net).to(dev), seed=1,
                               buffer_start=4, dqn_batch_size=4)
        state = randn(4, 24, s, s).numpy()
        masks = mask(4, hw, p=0.6).numpy()
        next_masks = masks * mask(4, hw, p=0.5).numpy()
        acts = np.array([int(np.flatnonzero(m)[0]) for m in masks])
        fields = (state, acts, np.random.default_rng(0).random(4).astype(
            np.float32), masks, next_masks, np.array([0, 1, 0, 0], bool))
        for sl in (sel, sel_card):
            sl.buffer.push(fields)
        before = to_flax(sel.net)["params"]
        # the gradient the CPU step takes, for the noise rule
        sel.opt.zero_grad()
        sel.td_loss([torch.as_tensor(a) for a in fields]).backward()
        dqn_grads = grads_to_flax(sel.net)
        t0 = time.perf_counter()
        sel.update()
        sel_card.update()
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        upd_err, held = adam_step_gate(
            "DQNSelecter.update", to_flax(sel_card.net)["params"],
            to_flax(sel.net)["params"], before, dqn_grads, 1e-3 + 1e-7)
        rows.append({"module": "DQNSelecter.update", "rel_err": upd_err,
                     "noise_elements": held, "s": step_s})
        log(f"  DQNSelecter.update: update rel err {upd_err:.2e} ({held} "
            f"noise-gradient elements held to a step)")

    # -- the C++ host library, built here, vs the Hopper sru_fwd_kernel
    t0 = time.perf_counter()
    lib = native.load()
    build_s = time.perf_counter() - t0
    native_rows = []
    for bidir, pad in ((False, False), (True, True)):
        a, spec, _ = sru_case(cpu, SRU_LM["length"], bidir, 0, False, pad, 3)
        d, act, _, _, scale_x = spec
        np_args = {k: (None if v is None else v.numpy()) for k, v in a.items()}
        t0 = time.perf_counter()
        h_host, c_host = native.sru_forward_cpu(
            np_args["u"], np_args["x"], np_args["weight_c"], np_args["bias"],
            np_args["c0"], d=d, activation=act, scale_x=scale_x,
            bidirectional=bidir, mask_pad=np_args["mask_pad"])
        host_ms = 1e3 * (time.perf_counter() - t0)
        ca = {k: to(v, dev) for k, v in a.items()}
        with torch.no_grad():
            h_k, c_k = sru_scan(ca["u"], ca["x"], ca["weight_c"], ca["bias"],
                                ca["c0"], d=d, activation=act,
                                bidirectional=bidir, scale_x=scale_x,
                                mask_pad=ca["mask_pad"])
        err = max(float(np.abs(h_host - h_k.cpu().numpy()).max()),
                  float(np.abs(c_host - c_k.cpu().numpy()).max()))
        if not err <= NATIVE_TOL:
            raise AssertionError(f"native SRU vs sru_fwd_kernel: {err}")
        native_rows.append({"bidirectional": bidir, "mask_pad": pad,
                            "shape": list(a["u"].shape), "max_abs_err": err,
                            "host_ms": host_ms})
        log(f"  native sru_forward_cpu vs sru_fwd_kernel "
            f"{'bi' if bidir else 'uni'}{' mask_pad' if pad else ''} "
            f"{tuple(a['u'].shape)}: max|err| {err:.2e}, host {host_ms:.1f} ms")
    seconds = time.perf_counter() - t_phase
    log(f"  capability phase: {len(rows)} checks, {seconds:.1f} s wall; "
        f"card: {smi}")
    return {"rows": rows, "native": native_rows,
            "native_build_s": build_s, "native_lib": str(lib._name),
            "seconds": seconds, "card": smi}


# phase 26's cuts of the recipes' epochs, steps, pools and scene counts
# (widths, resolutions, batch sizes and learning rates are the recipes')
RECIPE_CUTS = {
    # resumed from the asset (TPUSEG_RESUME=1, the tool's own mode, which
    # has no FG-dice gate): from random init the instance decoder emits no
    # mask for 80-120 epochs (PERF.md §6), 300 s of the script's 1200;
    # overfit_check keeps the phase's learning gate
    "train_synthetic_e2e": {"epochs": 12, "eval_every": 6},
    "train_density": {"steps": 100, "eval_every": 50, "pool": 128,
                      "n_val": 32},
    "train_hard_r3": {"epochs": 2, "n_train": 16, "n_val": 16,
                      "eval_every": 1, "warm_opt": 1, "swa_frac": 1.0},
}
# what assets/stop_params.json records for the installed rule (the JAX
# package's result on its TPU, "hard64@256 seed77")
STOP_RECORD = {"n": 64, "seed": 77}


def _asset_hashes(root):
    import hashlib

    return {name: hashlib.sha256(open(os.path.join(root, name), "rb")
                                 .read()).hexdigest()
            for name in sorted(os.listdir(root))}


def phase_recipes(dev, smi, work, cfg=None, asset=None, cuts=RECIPE_CUTS,
                  res=(256, 128), calib_n=32):
    """The model-production recipes of ``tpuseg_torch/tools`` at the JAX
    tools' width (``cfg``: ``cvppp_config()``), each cut only in epochs,
    steps, pools and scenes (``cuts``, printed), the e2e resumed from
    ``asset``.  Gates: the tools' own asserts (overfit), a written and
    re-loaded checkpoint giving the in-memory model's f32 id maps and
    counts bit for bit, ``train_density`` leaving every leaf but
    ``density_head`` bitwise, ``train_hard_r3 --freeze_subtrees
    count_head,density_head --freeze_bn`` leaving those subtrees and every
    batch statistic bitwise, and ``assets/`` unchanged.  Printed, no gate:
    the calibration sweep at the JAX defaults, the installed rule's row
    beside its record, the count diagnosis, each kernel's launches over
    the phase."""
    import torch

    from tpuseg_torch.cli.common import load_model
    from tpuseg_torch.configs import cvppp_config
    from tpuseg_torch.data.synthetic import make_scene
    from tpuseg_torch.kernels.ir_chain import ir_chain
    from tpuseg_torch.kernels.masked_softmax import masked_softmax
    from tpuseg_torch.runtime.predict import Predictor
    from tpuseg_torch.tools import (
        calibrate_stopping, count_diagnosis, overfit_check, train_density,
        train_hard_r3, train_synthetic_e2e,
    )
    from tpuseg_torch.utils.checkpoint_io import (
        flatten, load_stop_params, read_msgpack, write_msgpack,
    )
    from tpuseg_torch.weights import to_flax

    def same_leaf(a, b):
        a, b = np.asarray(a), np.asarray(b)
        return a.dtype == b.dtype and a.tobytes() == b.tobytes()

    cfg = cfg or cvppp_config()
    assets = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "assets")
    asset = asset or os.path.join(assets, "synthetic_ckpt.msgpack")
    hashes = _asset_hashes(assets)
    hi, lo = res
    out = {"cuts": cuts, "card": smi}
    for name, cut in cuts.items():
        log(f"  {name}: cut to {cut}")
    reset_counts()
    t_phase = time.perf_counter()

    def timed(label, fn):
        torch.cuda.synchronize() if dev.type == "cuda" else None
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize() if dev.type == "cuda" else None
        out.setdefault("seconds", {})[label] = time.perf_counter() - t
        log(f"  {label}: {out['seconds'][label]:.1f} s")
        return r

    # -- overfit: two 256^2 scenes, 40 f32 steps; last-5 mean < first-5
    costs = timed("overfit_check", lambda: overfit_check.run(
        cfg, 40, dev, res=hi))
    out["overfit"] = {"first5": float(np.mean(costs[:5])),
                      "last5": float(np.mean(costs[-5:]))}

    # -- the e2e recipe resumed from the asset, cut in epochs
    ecfg = train_synthetic_e2e.recipe_config(lo, cfg=cfg)

    def e2e_resumed():
        was = os.environ.get("TPUSEG_RESUME")
        os.environ["TPUSEG_RESUME"] = "1"
        try:
            return train_synthetic_e2e.run(
                ecfg, root=os.path.join(work, "e2e"), device=dev,
                resume_from=asset, **cuts["train_synthetic_e2e"])
        finally:
            if was is None:
                del os.environ["TPUSEG_RESUME"]
            else:
                os.environ["TPUSEG_RESUME"] = was

    e2e = timed("train_synthetic_e2e", e2e_resumed)
    out["e2e"] = {k: e2e[k] for k in ("sbd0", "fg0", "sbd1", "fg1",
                                       "best_sbd", "best_epoch", "steps",
                                       "steps_per_s")}
    # a checkpoint written by write_msgpack and read back by load_model:
    # the in-memory model's f32 outputs, bit for bit
    path = os.path.join(work, "e2e_final.msgpack")
    write_msgpack(path, to_flax(e2e["model"]))
    lcfg, loaded = load_model(ecfg, path)
    if lcfg != ecfg:
        raise AssertionError("load_model changed the e2e configuration")
    rng = np.random.default_rng(5)
    imgs = np.stack([make_scene(rng, lo, lo)[0] for _ in range(16)])
    got = []
    for m, c in ((copy.deepcopy(e2e["model"]), ecfg), (loaded, lcfg)):
        p = Predictor(c, m, batch_size=16, device=dev, dtype=torch.float32)
        got.append([t.cpu() for t in p.predict_batch_arrays(imgs)[1:]])
    for a, b, what in zip(*got, ("fg", "idmap", "counts")):
        if not torch.equal(a, b):
            raise AssertionError(f"re-loaded checkpoint: {what} differs")
    out["e2e"]["reload_counts"] = got[1][2].tolist()
    log(f"  e2e: written + re-loaded checkpoint gives the in-memory "
        f"model's f32 fg, id maps and counts bit for bit "
        f"(counts {got[1][2].tolist()})")

    # -- density head on the frozen asset; nothing else may move
    dout = os.path.join(work, "density.msgpack")
    dens = timed("train_density", lambda: train_density.run(
        train_density.recipe_config(hi, cfg=cfg), asset, dout, device=dev,
        cache_dir=os.path.join(work, "pool"), **cuts["train_density"]))
    before = flatten(read_msgpack(asset), "/")
    n_same = 0
    for key, a in flatten(read_msgpack(dout), "/").items():
        if key.startswith("params/density_head/"):
            continue
        if not same_leaf(a, before[key]):
            raise AssertionError(f"train_density moved {key}")
        n_same += 1
    out["density"] = {k: dens[k] for k in ("best_mae", "a", "b",
                                            "calibrated_mae", "steps")}
    out["density"]["leaves_bitwise"] = n_same
    log(f"  train_density: {n_same} leaves outside density_head bitwise "
        f"the asset's")

    # -- the stopping-rule sweep at the JAX defaults (f32), and the
    # installed rule's row beside what stop_params.json records
    def calibrate():
        p = calibrate_stopping.calibration_predictor(cfg, asset, hi, 16,
                                                     False, dev)
        scenes = calibrate_stopping.hard_scenes(
            max(calib_n, STOP_RECORD["n"]), hi, STOP_RECORD["seed"])
        preps = calibrate_stopping.prep_batches(p, scenes[0])
        # the first calib_n scenes are the JAX default's (the same draws)
        assert calib_n % p.batch_size == 0
        rows = calibrate_stopping.sweep(
            p, preps[:calib_n // p.batch_size], scenes[1][:calib_n],
            scenes[2][:calib_n], *calibrate_stopping.DEFAULT_GRID)
        stop = load_stop_params()
        row = calibrate_stopping.sweep_point(
            p, preps, scenes[1], scenes[2],
            calibrate_stopping.stop_tuple(*stop))
        return rows, stop, row

    rows, stop, row = timed("calibrate_stopping", calibrate)
    with open(os.path.join(assets, "stop_params.json")) as f:
        record = json.load(f)
    out["calibration"] = {"best": rows[0], "rows": rows,
                          "installed": {"stop_params": list(map(float, stop)),
                                        **row},
                          "record": {k: record[k] for k in (
                              "sbd", "abs_dic", "calibrated_on")}}
    log(f"  calibration (hard{calib_n}@{hi} seed{STOP_RECORD['seed']}, "
        f"default grid, f32): best {rows[0]}")
    log(f"  installed rule {stop} on hard{STOP_RECORD['n']}@{hi} seed"
        f"{STOP_RECORD['seed']}: SBD {row['sbd']:.4f} |DiC| "
        f"{row['abs_dic']:.4f} (stop_params.json records SBD "
        f"{record['sbd']} |DiC| {record['abs_dic']}, the JAX package's "
        f"TPU run), rounds to done {row['rounds_to_done']:.2f}")

    # -- the count diagnosis under the installed rule (JAX defaults)
    diag = timed("count_diagnosis", lambda: count_diagnosis.diagnose(
        cfg, asset, res=hi, device=dev))
    out["count_diagnosis"] = {
        "abs_dic": float(np.abs(diag["extracted"] - diag["gt"]).mean()),
        "head_abs_dic": float(np.abs(diag["budget"] - diag["gt"]).mean()),
        "sbd": float(diag["sbd"].mean()),
        "oracle_gt_abs_dic": float(np.abs(diag["oracle_extracted"]
                                          - diag["gt"]).mean()),
        "oracle_gt_sbd": float(diag["oracle_sbd"].mean())}

    # -- hard fine-tune with the counting heads and BN statistics pinned
    hard = timed("train_hard_r3", lambda: train_hard_r3.run(
        train_hard_r3.recipe_config(lo, cfg=cfg), root=os.path.join(
            work, "r3"), out=os.path.join(work, "hard.msgpack"), device=dev,
        resume_from=asset, freeze_bn=True,
        freeze_subtrees="count_head,density_head", **cuts["train_hard_r3"]))
    final = flatten(to_flax(hard["state"].model), "/")
    stored = flatten(read_msgpack(asset), "/")
    n_pinned = 0
    for key, a in final.items():
        col, sub = key.split("/")[:2]
        if not (col == "batch_stats" or col == "params" and sub in (
                "count_head", "density_head")):
            continue
        if not same_leaf(a, stored[key]):
            raise AssertionError(f"train_hard_r3 moved pinned {key}")
        n_pinned += 1
    out["hard_r3"] = {"start": hard["start"], "best": hard["best"],
                      "best_epoch": hard["best_epoch"],
                      "saved": hard["saved"], "swa_n": hard["swa_n"],
                      "pinned_leaves_bitwise": n_pinned}
    log(f"  train_hard_r3: {n_pinned} pinned leaves (count_head, "
        f"density_head, every batch statistic) bitwise the asset's")

    out["launches"] = {"ir_chain": ir_chain.launches,
                       "masked_softmax_forward":
                           masked_softmax.forward_launches,
                       "masked_softmax_backward":
                           masked_softmax.backward_launches}
    if _asset_hashes(assets) != hashes:
        raise AssertionError("the recipes changed a file under assets/")
    out["seconds"]["total"] = time.perf_counter() - t_phase
    log(f"  recipes: launches over the phase {out['launches']}; assets/ "
        f"unchanged; {out['seconds']['total']:.1f} s; card: {smi}")
    return out


# phase 27: the native-res report's canvas, 512x512 (its bucket is its own
# size); square, so its decode is windowed, the window scaled to 384 /
# stride 128
NATIVE_SIZES = {"native512": (512, 512)}


def phase_reports(cfg, model, dev, smi, work, cli_eval):
    """The report tools of ``tpuseg_torch/tools`` on the card.  ir_chain
    against its plain version at every level shape of the 512x512 bucket's
    windowed decode (phase 14's function and gates); ``native_res_report``
    at its defaults (24 hard scenes at 512x512, seed 7, f32, batch 8; the
    256 resize and ``--bucketed``) held to the JAX package's CPU result
    (``assets/native_res512_jax_f32.json``) by phase 11's rule: counts
    equal on every scene, SBD within an eighth of one scene's weight in
    the mean, FG dice within 1e-4; ``quality_report`` at its defaults
    (eval_hard64, bf16, batch 16, ab_infer's 128 scenes): SBD >= phase
    11's f32 - 0.01, |DiC| <= f32 + 0.1.  The CLIs run as subprocesses,
    each reporting its own ir_chain launches and rounds (20 a round, none
    may be 0).  The root REPORT.md and assets/ must hash the same after."""
    import hashlib

    from tpuseg_torch.tools import native_res_report, quality_report

    here = os.path.dirname(os.path.abspath(__file__))
    assets = os.path.join(here, "assets")

    def protected():
        with open(os.path.join(here, "REPORT.md"), "rb") as f:
            return (_asset_hashes(assets), hashlib.sha256(f.read()).hexdigest())

    before = protected()
    t0 = time.perf_counter()
    chain_rows = phase_bucket_chains(cfg, copy.deepcopy(model).to(dev).eval(),
                                     dev, smi, sizes=NATIVE_SIZES)
    out = {"seconds": {"chains": time.perf_counter() - t0}}

    with open(os.path.join(assets, "native_res512_jax_f32.json")) as f:
        ref = json.load(f)
    report = os.path.join(work, "REPORT.md")
    t0 = time.perf_counter()
    native = native_res_report.main(["--report", report,
                                     "--work", os.path.join(work, "native")])
    out["seconds"]["native_res_report"] = time.perf_counter() - t0
    with open(native["lst"]) as f:
        names = [os.path.splitext(os.path.basename(p))[0]
                 for p in f.read().splitlines() if p]
    n = len(names)
    if n != ref["n_images"]:
        raise AssertionError(f"native_res_report made {n} scenes, the JAX "
                             f"file holds {ref['n_images']}")
    for tag, want in ref["paths"].items():
        got = native[tag]
        per = _per_image(got["pred_dir"], names)
        counts = sum(per[r["name"]][0] == r["count"] for r in want["images"])
        idmaps = sum(per[r["name"]][1] == r["ins_mask_sha256"]
                     for r in want["images"])
        launches, rounds = got["ir_chain_launches"], got["rounds"]
        out[tag] = {"sbd": got["sbd"], "abs_dic": got["dic"],
                    "fg_dice": got["fg"], "counts_equal_jax_f32": counts,
                    "idmaps_equal_jax_f32": idmaps,
                    "ir_chain_launches": launches, "rounds": rounds,
                    "jax_cpu": {k: want[k] for k in (
                        "mean_sbd", "mean_abs_dic", "mean_fg_dice")}}
        log(f"  native_res {tag}: SBD {got['sbd']:.6f} |DiC| "
            f"{got['dic']:.4f} FG dice {got['fg']:.6f}; JAX package f32 on "
            f"the CPU SBD {want['mean_sbd']:.6f} |DiC| "
            f"{want['mean_abs_dic']:.4f} FG dice {want['mean_fg_dice']:.6f};"
            f" counts equal on {counts}/{n}, id maps (sha256) on {idmaps}/"
            f"{n}; {launches} ir_chain launches over {rounds} rounds [{smi}]")
        if launches == 0 or launches != 20 * rounds:
            raise AssertionError(
                f"native_res {tag}: ir_chain launches {launches} != 5 levels "
                f"x 4 blocks x {rounds} rounds")
        if counts != n:
            raise AssertionError(
                f"native_res {tag}: counts equal the JAX reference on only "
                f"{counts}/{n} scenes")
        if not (abs(got["sbd"] - want["mean_sbd"]) <= 1 / (8 * n)
                and abs(got["fg"] - want["mean_fg_dice"]) <= 1e-4):
            raise AssertionError(
                f"native_res {tag}: SBD {got['sbd']} / FG {got['fg']} against"
                f" the JAX package's {want['mean_sbd']} / "
                f"{want['mean_fg_dice']} ({1 / (8 * n):.2e} / 1e-4)")
    log(f"  JAX package on a TPU v5e (REPORT.md, NATIVE_RES): resize256 SBD "
        f"{REPORT_TPU_NATIVE['resize256'][0]} |DiC| "
        f"{REPORT_TPU_NATIVE['resize256'][1]}; native --bucketed SBD "
        f"{REPORT_TPU_NATIVE['native_bucketed'][0]} |DiC| "
        f"{REPORT_TPU_NATIVE['native_bucketed'][1]}")

    t0 = time.perf_counter()
    quality = quality_report.main(["--report", report])
    out["seconds"]["quality_report"] = time.perf_counter() - t0
    f32 = cli_eval["f32"]
    out["quality"] = {k: quality[k] for k in (
        "sbd", "dic", "fg", "cold_s", "warm_s", "ab_infer", "card",
        "ir_chain_launches", "rounds")}
    log(f"  quality_report bf16 on eval_hard64: SBD {quality['sbd']:.6f} "
        f"|DiC| {quality['dic']:.4f} FG dice {quality['fg']:.6f} (phase 11 "
        f"f32: {f32['sbd']:.6f} / {f32['abs_dic']:.4f}); pred_list wall "
        f"cold {quality['cold_s']:.2f} s, warm {quality['warm_s']:.2f} s; "
        f"ir_chain launches {quality['ir_chain_launches']} over rounds "
        f"{quality['rounds']}; ab_infer: {quality['ab_infer']} "
        f"[{quality['card']}]")
    for launches, rounds in zip(quality["ir_chain_launches"],
                                quality["rounds"]):
        if launches == 0 or launches != 20 * rounds:
            raise AssertionError(
                f"quality_report: ir_chain launches {launches} != 5 levels x "
                f"4 blocks x {rounds} rounds")
    if not (quality["sbd"] >= f32["sbd"] - 0.01
            and quality["dic"] <= f32["abs_dic"] + 0.1):
        raise AssertionError(
            f"quality_report bf16 SBD {quality['sbd']} |DiC| "
            f"{quality['dic']} against phase 11's f32 {f32['sbd']} / "
            f"{f32['abs_dic']} (-0.01 / +0.1)")
    with open(report) as f:
        text = f.read()
    if not (text.startswith("# tpuseg_torch report")
            and native["section"] in text):
        raise AssertionError("quality_report's rewrite lost the NATIVE_RES "
                             "section")
    if protected() != before:
        raise AssertionError("the report tools changed the root REPORT.md "
                             "or a file under assets/")
    out["chain_rows"] = chain_rows
    out["ir_chain_launches"] = (
        sum(out[t]["ir_chain_launches"] for t in ref["paths"])
        + sum(quality["ir_chain_launches"]))
    log(f"  reports: {out['ir_chain_launches']} ir_chain launches over the "
        f"four pred_list runs; REPORT.md and assets/ unchanged; seconds "
        f"{out['seconds']}")
    return out


SHARE_MAX = 105.0  # a share over this reads a count or a time wrong


def _tool_output(main, argv) -> str:
    """Run a tool's ``main(argv)`` in this process; what it printed."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    if rc != 0:
        raise AssertionError(f"{main.__module__} {argv} exited {rc}:\n"
                             f"{buf.getvalue()[-2000:]}")
    return buf.getvalue()


def _last_json(text: str):
    """The JSON object a tool printed last (one line, or indented from a
    line that starts with its brace)."""
    return json.loads(text[text.rfind("\n{") + 1:])


def check_trace(tr, chain, want_chain):
    """A summarised inference trace: device time, an idle share in [0, 1)
    and ``want_chain`` ``ir_chain`` launches."""
    if not tr["busy_ms"] > 0:
        raise AssertionError(f"trace_summary: no device time: {tr}")
    if not 0.0 <= tr["idle_share"] < 1.0:
        raise AssertionError(f"idle share {tr['idle_share']} not in [0, 1)")
    if chain != want_chain:
        raise AssertionError(
            f"the trace holds {chain} ir_chain launches, the batch made "
            f"{want_chain}")


def phase_measure(trace, smi):
    """The measurement tools of ``tpuseg_torch/tools`` on the card:
    ``trace_summary`` of phase 22's trace (busy time, idle share, buckets,
    the gaps), ``roofline`` at B=32 bf16, ``profile_stages --ks 1,32
    --trace``, ``profile_components``, ``profile_decode_scaling`` at B 32
    and 128 and ``warmup``.  Raises when a trace has no device time, its
    idle share lies outside [0, 1), its ``ir_chain`` launches differ from
    the batch's (phase 22's counter; 20 a round of ``profile_stages``'
    batch), the counted ``ir_chain`` operations are not the launches'
    rounds times a round's formula, a share reads over ``SHARE_MAX`` %, or
    ``warmup`` built anything (phase 1 built every library)."""
    from tpuseg_torch.tools import (
        profile_components, profile_decode_scaling, profile_stages,
        roofline, trace_summary, warmup,
    )
    from tpuseg_torch.tools.profile_stages import INFER_BUCKETS

    out = {}
    t0 = time.perf_counter()
    argv = [trace["trace_dir"], "--json", "--window", "predict_batch",
            "--gaps", "5", "--top", "12"]
    for b in INFER_BUCKETS:
        argv += ["--bucket", b]
    tr = _last_json(_tool_output(trace_summary.main, argv))
    chain = sum(n for name, n in tr["launches"].items() if "ir_block" in name)
    log(f"  trace_summary of phase 22's batch: window {tr['window_ms']:.2f} "
        f"ms, device busy {tr['busy_ms']:.2f} ms (kernel sum "
        f"{tr['device_ms']:.2f}), idle share {tr['idle_share']:.4f}; "
        f"buckets (ms) " + ", ".join(f"{k} {v:.2f}"
                                     for k, v in tr["buckets"].items())
        + f"; ir_chain launches traced {chain}, counted {trace['ir_chain_launches']}"
        f"; {tr['ops']} device events [{smi}]")
    log(f"    idle over {tr['n_gaps']} gaps; idle ms by the host event at a "
        f"gap's start: " + ", ".join(
            f"{k} {v:.2f}" for k, v in list(tr["idle_by_host"].items())[:8]))
    for g in tr["gaps"]:
        log(f"    gap {g['ms']:.3f} ms at +{g['start_us'] / 1e3:.2f} ms, "
            f"host: {g['host']}")
    log("    top: " + "; ".join(f"{t['name'][:60]} x{t['count']} "
                                f"{t['ms']:.2f} ms" for t in tr["top"][:8]))
    check_trace(tr, chain, trace["ir_chain_launches"])
    out["trace"] = {k: tr[k] for k in ("window_ms", "busy_ms", "device_ms",
                                       "idle_share", "buckets", "gaps",
                                       "n_gaps", "idle_by_host", "ops")}
    out["trace"]["ir_chain_launches"] = chain
    out["trace_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    rows_path = os.path.join(os.path.dirname(trace["trace_dir"]),
                             "roofline.json")
    text = _tool_output(roofline.main, ["--batch", "32", "--iters", "3",
                                        "--out", rows_path])
    with open(rows_path) as f:
        rows = json.load(f)
    for line in text.splitlines():
        if line.startswith("card:") or line.startswith("|"):
            log("    " + line)
    infer = rows[-1]
    calls = infer["kernels"]["ir_chain"]["calls"]
    launches = infer["launches"]["ir_chain"]
    per_round = sum(chain_ops(N_DECODE, h, w, c) for _, h, w, c in MAIN_SHAPES)
    want = launches // 20 * per_round
    log(f"  roofline: infer {infer['rounds']} rounds, ir_chain {calls} calls "
        f"/ {launches} launches, counted {infer['kernels']['ir_chain']['flops']}"
        f" FLOP against {want} (launches / 20 x a round's five calls)")
    if (launches != 4 * calls or launches != 20 * infer["rounds"]
            or infer["kernels"]["ir_chain"]["flops"] != want):
        raise AssertionError(f"roofline's ir_chain count: {infer}")
    for r in rows:
        for key in ("pct_mxu_peak", "pct_hbm_peak", "pct_roofline"):
            if not (r[key] is not None and 0 <= r[key] <= SHARE_MAX):
                raise AssertionError(f"roofline {r['stage']}: {key} "
                                     f"{r[key]}")
    out["roofline"] = [{k: r[k] for k in (
        "stage", "gflop", "gb", "ai_flop_per_byte", "ms", "tflops",
        "pct_mxu_peak", "hbm_gbs", "pct_hbm_peak", "bound_ms", "bound_by",
        "pct_roofline")} for r in rows]
    out["roofline_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    st = _last_json(_tool_output(profile_stages.main, [
        "--ks", "1,32", "--iters", "2", "--trace",
        os.path.join(os.path.dirname(trace["trace_dir"]), "stages_trace")]))
    log("  profile_stages (ms a batch): " + ", ".join(
        f"{k} {v:.2f}" for k, v in st["stages_ms_per_batch"].items())
        + f"; rounds {st['rounds']}")
    st_tr, st_rounds = st["trace"], st["rounds"]["infer_k32"]
    st_chain = sum(n for name, n in st_tr["launches"].items()
                   if "ir_block" in name)
    check_trace(st_tr, st_chain, 20 * st_rounds)
    for name, t, rounds in (
            ("phase 22's batch (phase 4's scenes)", tr,
             trace["ir_chain_launches"] // 20),
            ("profile_stages' batch (the tools' scenes)", st_tr, st_rounds)):
        idle = t["window_ms"] - t["busy_ms"]
        log(f"    {name}: {rounds} rounds, window {t['window_ms']:.2f} ms, "
            f"busy {t['busy_ms']:.2f}, idle {idle:.2f} ms = share "
            f"{t['idle_share']:.4f}; idle {idle / rounds:.2f} ms a round, "
            f"{1e3 * idle / t['ops']:.2f} us and busy "
            f"{1e3 * t['busy_ms'] / t['ops']:.2f} us a device event "
            f"({t['ops']})")
    out["stages_trace"] = {k: st_tr[k] for k in (
        "window_ms", "busy_ms", "idle_share", "buckets", "n_gaps", "ops")}
    out["stages_trace"]["rounds"] = st_rounds
    comp = _last_json(_tool_output(profile_components.main, ["--iters", "2"]))
    log("  profile_components (ms a batch): " + ", ".join(
        f"{k} {v:.2f}" for k, v in comp["ms_per_batch"].items()))
    dec = _last_json(_tool_output(profile_decode_scaling.main,
                                  ["--batches", "32,128", "--iters", "2"]))
    log("  profile_decode_scaling (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in dec.items() if k != "device"))
    out["stages"] = st["stages_ms_per_batch"]
    out["components"] = comp["ms_per_batch"]
    out["decode_scaling"] = {k: v for k, v in dec.items() if k != "device"}
    out["profile_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    wu = _last_json(_tool_output(warmup.main, []))
    built = [k for k, v in wu["libraries"].items() if not v["reused"]]
    log(f"  warmup: libraries {sorted(wu['libraries'])}, built anew "
        f"{built}; batches (s) {wu['batch_seconds']}")
    if built or set(wu["libraries"]) != {"ir_chain", "masked_softmax",
                                         "sru_scan", "native"}:
        raise AssertionError(f"warmup: {wu}")
    out["warmup"] = wu["batch_seconds"]
    out["warmup_s"] = time.perf_counter() - t0
    return out


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
    _, _, _, r1 = pred.model.decoder.extract_rounds(
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

        # -- phase 13: the staged dispatch vs the monolithic one, phase 4's
        # images, bf16 and f32
        t0 = time.perf_counter()
        staged = phase_staged(cfg, model, dev, stop, batches, smi)
        log(f"phase staged: {time.perf_counter() - t0:.1f} s")

        # -- phase 14: ir_chain at the CVPPP buckets' level shapes
        t0 = time.perf_counter()
        bucket_rows = phase_bucket_chains(
            cfg, copy.deepcopy(model).to(dev).eval(), dev, smi)
        log(f"phase bucket-chains: {time.perf_counter() - t0:.1f} s")

        # -- phase 15: bucketed inference end to end at the CVPPP sizes
        t0 = time.perf_counter()
        bucketed = phase_bucketed(cfg, model, dev, stop,
                                  os.path.join(work, "cvppp"), smi)
        log(f"phase bucketed: {time.perf_counter() - t0:.1f} s")

        # -- phase 16: the pred CLI, pred_list --staged / --bucketed
        t0 = time.perf_counter()
        pred_cli = phase_pred_cli(cfg, model, work, eval_lst, smi)
        log(f"phase pred-cli: {time.perf_counter() - t0:.1f} s")

        # -- phase 17: predict_cluster on the card
        t0 = time.perf_counter()
        cluster = phase_cluster(cfg, model, dev, eval_lst, smi)
        log(f"phase cluster: {time.perf_counter() - t0:.1f} s")

        # -- phase 18: the debug mode, card vs CPU; fit's debug dumps
        t0 = time.perf_counter()
        debug = phase_debug(cfg, model, dev, os.path.join(work, "debug"), smi)
        log(f"phase debug: {time.perf_counter() - t0:.1f} s")

        # -- phase 19: data-parallel fit over 2 ranks on the card vs one
        # process, 1 NCCL rank, the timed data-parallel steps
        t0 = time.perf_counter()
        spatial = spatial_calls(cfg, model, stop)
        dp_fit, spatial_ranks = phase_dp_fit(cfg, model, dev, train, smi,
                                             more=spatial)
        log(f"phase dp-fit: {time.perf_counter() - t0:.1f} s")

        # -- phase 20: the mesh predictor on phase 4's images
        t0 = time.perf_counter()
        mesh_pred = phase_mesh_predict(cfg, model, dev, stop, batches, smi)
        log(f"phase mesh-predict: {time.perf_counter() - t0:.1f} s")

        # -- phase 21: train --ndevices 2, pred_list --ndevices 2, evaluate
        t0 = time.perf_counter()
        dp_cli = phase_dp_cli(work, eval_lst, smi)
        log(f"phase dp-cli: {time.perf_counter() - t0:.1f} s")

        # -- phase 22: one inference batch under the tracing utilities
        t0 = time.perf_counter()
        trace = phase_trace(cfg, model, dev, stop, batches[0],
                            os.path.join(work, "trace"), smi)
        log(f"phase trace: {time.perf_counter() - t0:.1f} s")

        # -- phase 23: the split-row masked_softmax entry points vs plain
        t0 = time.perf_counter()
        split_rows, split_p_err, split_de_rel = phase_split_softmax(dev, smi)
        log(f"phase split-softmax: {time.perf_counter() - t0:.1f} s")

        # -- phase 24: spatial inference and training over 2 ranks
        t0 = time.perf_counter()
        spatial_run = phase_spatial(dev, smi, spatial, spatial_ranks)
        log(f"phase spatial: {time.perf_counter() - t0:.1f} s")

        # -- phase 25: the capability modules, card vs CPU
        t0 = time.perf_counter()
        capability = phase_capability(dev, smi)
        log(f"phase capability: {time.perf_counter() - t0:.1f} s")

        # -- phase 26: the model-production recipes (tpuseg_torch/tools)
        t0 = time.perf_counter()
        recipes = phase_recipes(dev, smi, os.path.join(work, "recipes"))
        log(f"phase recipes: {time.perf_counter() - t0:.1f} s")

        # -- phase 27: the report tools (tpuseg_torch/tools)
        t0 = time.perf_counter()
        reports = phase_reports(cfg, model, dev, smi,
                                os.path.join(work, "reports"), cli_eval)
        log(f"phase reports: {time.perf_counter() - t0:.1f} s")

        # -- phase 28: the measurement tools (tpuseg_torch/tools)
        t0 = time.perf_counter()
        measure = phase_measure(trace, smi)
        log(f"phase measure: {time.perf_counter() - t0:.1f} s")
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
        "staged": staged, "bucketed": bucketed, "pred_cli": pred_cli,
        "cluster": cluster, "debug": debug, "dp_fit": dp_fit,
        "mesh_predict": mesh_pred, "dp_cli": dp_cli, "trace": trace,
        "spatial": spatial_run, "capability": capability,
        "recipes": {k: v for k, v in recipes.items()
                    if k != "calibration"},
        "reports": {k: v for k, v in reports.items() if k != "chain_rows"},
        "measure": measure,
        "seconds": time.perf_counter() - t_all,
    }
    log("summary " + json.dumps(summary))
    log("ir_chain rows " + json.dumps(rows))
    log("masked_softmax rows " + json.dumps(sm_rows))
    log("sru_scan rows " + json.dumps(sru_rows))
    log("ir_chain bucket rows " + json.dumps(bucket_rows))
    log("masked_softmax split rows " + json.dumps(split_rows))
    log("recipes calibration " + json.dumps(recipes["calibration"]))
    log("ir_chain native512 rows " + json.dumps(reports["chain_rows"]))
    # the training path's scan: uni, k = 3, identity, dropout mask, 35 steps
    sru_main = [r for r in sru_rows if r["length"] == SRU_LM["length"]
                and not r["bidirectional"] and r["activation"] == 0
                and r["mask_c"] and not r["mask_pad"]][0]
    sru_note = ("no PyTorch call computes the SRU recurrence: the plain "
                "version is a loop of elementwise calls over time")
    sm8 = [r for r in sm_rows if r["shape"][0] == 8][0]
    split8 = [r for r in split_rows if r["shape"][0] == 8][0]
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
        # phases 13-18: one staged pass of the 256 images, one bucketed
        # pass of the CVPPP-size scenes, the debug forward and fit's run
        # with the dumps (2 debug decodes + the validation decode)
        "launches_staged": {d: staged[d]["counts"]["staged"][
            "ir_chain_launches"] for d in ("bfloat16", "float32")},
        "launches_bucketed": {d: bucketed[d]["ir_chain_launches"]
                              for d in ("bfloat16", "float32")},
        "launches_debug": {
            "forward": debug["debug_forward_launches"]["ir_chain"],
            "fit_with_dumps": debug["fit_launches"]["ir_chain"]},
        # phases 20-21: the mesh predictor's pass over the 256 images and
        # pred_list --ndevices 2 on eval_hard64 (both f32, 2 replicas; the
        # rounds of each replica, 20 launches a round), and the validation
        # decodes of train --ndevices 2 (each rank's)
        "launches_mesh_predict": mesh_pred["ir_chain_launches"],
        "mesh_predict_rounds_per_replica": mesh_pred["rounds_per_replica"],
        # pred_list --ndevices 2: each rank process's launches and rounds
        "launches_pred_list_ndevices2":
            dp_cli["pred_list_ir_chain_launches_per_rank"],
        "pred_list_ndevices2_rounds_per_rank":
            dp_cli["pred_list_rounds_per_rank"],
        # phase 24: spatial inference over 2 ranks (each rank's launches on
        # its rows plus halos, windows cut at the ranks' rows)
        "launches_spatial_infer": spatial_run["ir_chain_launches_per_rank"],
        "launches_train_ndevices2_validation": [
            r["ir_chain"] for r in dp_cli["rank_launches"]],
        # per bucket level shape: ms a call (events), device ms a launch
        # (profiler) and the bound of a call, f32 and bf16
        "bucket_shapes": [{k: r[k] for k in (
            "level", "shape", "dtype", "skip", "ms", "device_ms_per_launch",
            "bound_ms", "bound_by")} for r in bucket_rows],
        # phase 27: the report tools' four pred_list processes (each its
        # own count: native_res_report's resize256 and --bucketed, f32;
        # quality_report's cold and warm runs, bf16), and the 512x512
        # bucket's windowed level shapes
        "launches_reports": {
            "native_resize256": reports["resize256"]["ir_chain_launches"],
            "native_bucketed":
                reports["native_bucketed"]["ir_chain_launches"],
            "quality_cold_warm": reports["quality"]["ir_chain_launches"]},
        "native512_shapes": [{k: r[k] for k in (
            "level", "shape", "dtype", "skip", "ms", "device_ms_per_launch",
            "bound_ms", "bound_by", "max_abs_err")}
            for r in reports["chain_rows"]],
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
        # phase 18: the debug forward, and fit's 2 steps with the dumps
        # (forward + backward)
        "launches_debug": {
            "forward": debug["debug_forward_launches"]["masked_softmax"],
            "fit_with_dumps": debug["fit_launches"]["forward"]
            + debug["fit_launches"]["backward"]},
        # phases 19 and 21, each rank's forward + backward launches: the
        # timed data-parallel steps (2 gloo ranks, 4 steps) and
        # train --ndevices 2 (2 epochs + validation)
        "launches_dp_fit": [r["masked_softmax_forward"]
                            + r["masked_softmax_backward"]
                            for r in dp_fit["launches_bf16"]],
        "launches_train_ndevices2": [r["masked_softmax_forward"]
                                     + r["masked_softmax_backward"]
                                     for r in dp_cli["rank_launches"]],
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
        # phase 24: spatial training's split entry points, each rank
        "launches_spatial_train_split": spatial_run["split_launches_per_rank"],
    }, {
        "name": "masked_softmax_split",
        "route": "cuda",
        "source": "tpuseg_torch/kernels/csrc/masked_softmax.cu",
        "replaces": "tpuseg/kernels/masked_softmax.py:38",
        # phase 24: 2 SGD steps of spatial training, each rank's stats +
        # apply (forward) and row dots + tiles (backward) launches
        "launches": sum(d["forward"] + d["backward"]
                        for d in spatial_run["split_launches_per_rank"]),
        "launches_per_rank": spatial_run["split_launches_per_rank"],
        "checked": True,
        "max_abs_err": split_p_err,
        "max_rel_err_backward": split_de_rel,
        # one rank's half of the (8, 32, 65536) training shape: forward +
        # backward (training path's g), device time where traced
        "ms": (split8["forward_device_ms"] or split8["forward_ms"])
        + (split8["backward_device_ms"] or split8["backward_ms"]),
        "event_ms": split8["forward_ms"] + split8["backward_ms"],
        "plain_ms": split8["plain_forward_ms"] + split8["plain_backward_ms"],
        "bound_ms": split8["bound_forward_ms"] + split8["bound_backward_ms"],
        "bound_by": "bytes",
        "library_ms": split8["library_ms"],
        "library_call": "torch.softmax on the half's masked logits + "
                        "torch._softmax_backward_data (no collective)",
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
