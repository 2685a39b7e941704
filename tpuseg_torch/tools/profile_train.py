"""Trace a few full-width train steps on the card with ``torch.profiler``.

    python tpuseg_torch/tools/profile_train.py [steps] [batch]

The timed training configuration of ``chip_smoke.py`` (CVPPP model at full
width, 256x256, bfloat16 autocast, sampling and dropout on, committed
checkpoint, synthetic batches).  After 2 warm-up steps it traces ``steps``
steps and prints the wall time of the window, the device's busy time (the
sum of kernel and memcpy durations; kernels of one stream do not overlap)
and idle share, the number of device kernels per step, and the kernels
that take the most device time.  Exits non-zero without CUDA or when the
trace holds no device activity.
"""

import os
import sys
import time


def main(argv) -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_train: CUDA is not available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, root)
    from torch.profiler import ProfilerActivity, profile

    from tpuseg_torch.cli.common import load_model
    from tpuseg_torch.data.synthetic import make_batch
    from tpuseg_torch.runtime.state import create_train_state
    from tpuseg_torch.runtime.train import make_train_step
    from tpuseg_torch.settings import get_config

    n_steps = int(argv[1]) if len(argv) > 1 else 3
    batch_size = int(argv[2]) if len(argv) > 2 else 8
    cfg, model = load_model(
        get_config("CVPPP"),
        os.path.join(root, "assets", "synthetic_ckpt.msgpack"))
    state = create_train_state(cfg, model, device="cuda")
    step = make_train_step(cfg, model, dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(cfg.train.seed)
    rng = np.random.default_rng(13)
    batches = [make_batch(rng, batch_size, 256, 256, cfg.data.max_n_objects,
                          hard=True) for _ in range(2 + n_steps)]
    for b in batches[:2]:
        step(state, b, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for b in batches[2:]:
            step(state, b, gen)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    # device-side events only; "name#..." entries are the optimizer's
    # profiler annotations mirrored onto the device timeline, not kernels
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and "#" not in e.name]
    busy_ms = sum(e.device_time for e in events) / 1e3
    if not events or busy_ms <= 0:
        print("profile_train: the trace holds no device activity",
              file=sys.stderr)
        return 1
    by_name = {}
    for e in events:
        n, t_us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t_us + e.device_time)
    print(f"card: {torch.cuda.get_device_name(0)}; {n_steps} steps at "
          f"B={batch_size}: wall {wall_ms / n_steps:.1f} ms/step (profiler "
          f"on), device busy {busy_ms / n_steps:.1f} ms/step, idle share "
          f"{1 - busy_ms / wall_ms:.3f}, {len(events) / n_steps:.0f} device "
          f"kernels and copies per step")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    for name, (n, t_us) in top:
        print(f"  {t_us / 1e3 / n_steps:8.2f} ms/step {n / n_steps:7.0f} "
              f"calls/step  {name[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
