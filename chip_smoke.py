#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpuseg_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``tpuseg_torch/kernels/csrc`` with
``nvcc`` (sm_90a), then:

1. holds the ``ir_chain`` kernel against its plain PyTorch version at the
   five main-path shapes (decode batch 128 = 32 images x 4 glimpses), in
   float32 and bfloat16, with and without the mid-chain skip, and times
   both;
2. runs the batched-inference path end to end in float32 on 4 synthetic
   256x256 images on the card (kernel) and on the CPU (plain version), with
   the committed checkpoint and stopping rule: counts must be equal and
   >= 99.9% of id-map pixels;
3. drives the main path (``Predictor.predict_batch_packed``, the full-width
   CVPPP model, B=32, bfloat16) over 256 synthetic images, timed, with the
   kernel launch counter reset just before and read just after: the chain
   must have run 5 levels x 4 blocks x the rounds run; prints img/s and
   SBD / |DiC| / FG dice against the synthetic ground truth, bf16-vs-f32
   count agreement, and the same pass without the per-round done-sync.

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

# H100 SXM, dense: matrix products at the type's rate (tensor cores for
# bf16), everything else at the float32 rate of the CUDA cores
PEAK_MATMUL = {"float32": 67e12, "bfloat16": 989e12}
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
N_DECODE = 128  # B * G on the main path
# (level, H, W, C) of the main path's ir_chain calls at 256^2 with the 192
# window: three full-canvas levels, then the two windowed ones
MAIN_SHAPES = [(0, 16, 16, 256), (1, 32, 32, 128), (2, 64, 64, 64),
               (3, 96, 96, 32), (4, 192, 192, 32)]


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


def chain_bound(n, h, w, c, dtype_name, with_skip):
    """(bytes ms, operations ms): the least time for one chain call is the
    larger — inputs read once and the output written once at the memory
    rate, operations at the card's peak for their type.  Per pixel and
    block: the two pointwise products (8 C^2 FLOPs) at the matrix rate;
    the depthwise taps (36 C), the two bias + relu6 passes (12 C) and the
    residual + b3 (2 C), accumulated in float32, at the CUDA cores' float32
    rate.  In bf16 the two kinds run on different units, so the larger
    time bounds; in float32 both share the CUDA cores and add."""
    es = 4 if dtype_name == "float32" else 2
    act = n * h * w * c * es
    weights = 4 * (2 * c * 2 * c * es + (2 * c * 2 + 2 * c * 9 + c) * 4)
    nbytes = act * (3 if with_skip else 2) + weights
    px = n * h * w * 4
    mm_s = px * 8 * c * c / PEAK_MATMUL[dtype_name]
    other_s = px * 50 * c / PEAK_F32
    ops_s = mm_s + other_s if dtype_name == "float32" else max(mm_s, other_s)
    return 1e3 * nbytes / PEAK_BYTES, 1e3 * ops_s


def phase_kernel_vs_plain(model, dev):
    """ir_chain kernel vs plain at the main-path shapes."""
    import torch

    from tpuseg_torch.kernels.ir_chain import (
        ir_chain, ir_chain_plain, stack_chain_params,
    )

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
                b_ms, o_ms = chain_bound(N_DECODE, h, w, c, name,
                                         skip is not None)
                rows.append({
                    "level": lvl, "shape": [N_DECODE, h, w, c], "dtype": name,
                    "skip": skip is not None, "ms": k_ms, "plain_ms": p_ms,
                    "bound_ms": max(b_ms, o_ms), "bytes_ms": b_ms,
                    "ops_ms": o_ms,
                    "bound_by": "bytes" if b_ms >= o_ms else "operations",
                    "max_abs_err": err, "max_abs_y": scale,
                })
                r = rows[-1]
                log(f"  ir_chain L{lvl} {r['shape']} {name} skip={r['skip']}: "
                    f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound "
                    f"{r['bound_ms']:.4f} ms, max|err| {err:.3e} "
                    f"(max|y| {scale:.3e})")
        del x32, s32
    torch.cuda.empty_cache()
    return rows, max_abs_f32, max_rel_bf16


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
    _, fg_c, id_c, n_c = p_cpu.predict_batch_arrays(small)
    p_f32 = Predictor(cfg, copy.deepcopy(model), batch_size=32, device=dev,
                      dtype=torch.float32, stop_params=stop)
    _, fg_g, id_g, n_g = p_f32.predict_batch_arrays(small)
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
    outs32, dt_f32 = run(p_f32, "f32")
    counts_f32 = np.concatenate([o[1] for o in outs32])
    log(f"bf16-vs-f32 count agreement {np.mean(counts_f32 == counts_bf16):.4f}"
        f" (mean |diff| {np.abs(counts_f32 - counts_bf16).mean():.4f}); f32 "
        f"rounds {p_f32.rounds_run}")
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

    summary = {
        "img_per_s_bf16": len(imgs) / dt_main,
        "ms_per_batch_bf16": 1e3 * dt_main / len(batches),
        "img_per_s_f32": len(imgs) / dt_f32,
        "img_per_s_bf16_nosync": len(imgs) / dt_nosync,
        "sbd": sbd, "abs_dic": float(dic), "fg_dice": fgd,
        "rounds": rounds, "batches": len(batches),
        "ir_chain_launches_per_batch": launches / len(batches),
        "count_agreement_bf16_f32": float(np.mean(counts_f32 == counts_bf16)),
        "e2e_f32_idmap_agreement": agree,
        "seconds": time.perf_counter() - t_all,
    }
    log("summary " + json.dumps(summary))
    log("ir_chain rows " + json.dumps(rows))
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
    }]}
    print(json.dumps(kernels), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
