"""Build the port's native code and run one inference batch of each size
(counterpart of ``tools/warmup.py``).

    python -m tpuseg_torch.tools.warmup [--batchsizes 16,32] [--res 256]
        [--f32] [--device cpu]

The JAX tool filled XLA's persistent compilation cache.  The port has no
such cache: what a first call pays for is building its libraries and the
first calls' set-up (cuDNN plans, the caching allocator).  This tool

1. builds every CUDA kernel library (``kernels/build.py::build``: one
   ``nvcc`` a source, all at once) and the C++ host library
   (``build_host``), each only where its library for the current source is
   missing, and says for each whether the build was reused;
2. runs one ``Predictor`` batch of synthetic scenes (``tools/stages.py``)
   for each of ``--batchsizes`` at ``--res``, the committed checkpoint,
   bf16 (float32 with ``--f32``), and prints the seconds of each step.

Raises when CUDA or ``nvcc`` is missing, unless given ``--device cpu``
(then only the host library is built and the batches run on the CPU).
Prints the results as one JSON object last.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from typing import List, Optional

import torch

from tpuseg_torch import resolve_device
from tpuseg_torch.kernels import build
from tpuseg_torch.runtime.predict import Predictor
from tpuseg_torch.tools import stages
from tpuseg_torch.utils.checkpoint_io import load_stop_params


def build_all(dev: torch.device) -> dict:
    """Build what is missing; {library: {"reused", "path"}} and the
    seconds the builds took."""
    builds = {}
    t = time.perf_counter()
    if dev.type == "cuda":
        build.nvcc()  # raises when the toolkit is absent, built or not
        for name in build.KERNELS:
            builds[name] = {"reused": build.library_path(name).exists()}
        for name, path in build.build().items():
            builds[name]["path"] = str(path)
    builds["native"] = {"reused": build.host_library_path().exists(),
                        "path": str(build.build_host())}
    return {"libraries": builds, "seconds": time.perf_counter() - t}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batchsizes", default="16,32")
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    built = build_all(dev)
    for name, b in built["libraries"].items():
        print(f"{name}: {'reused' if b['reused'] else 'built'} {b['path']}",
              flush=True)
    print(f"builds: {built['seconds']:.1f} s", flush=True)

    _, cfg, model = stages.load(args)
    dtype = torch.float32 if args.f32 else torch.bfloat16
    batches = {}
    for bs in (int(b) for b in args.batchsizes.split(",")):
        t = time.perf_counter()
        pred = Predictor(cfg, copy.deepcopy(model), batch_size=bs,
                         device=dev, dtype=dtype,
                         stop_params=load_stop_params())
        x = stages.synthetic_images(bs, args.res, args.res)
        _, fg, idmap, counts = pred.predict_batch_arrays(x, with_probs=False)
        fg.cpu(), idmap.cpu(), counts.cpu()
        batches[bs] = time.perf_counter() - t
        print(f"batch {bs} @ {args.res}^2 ({'f32' if args.f32 else 'bf16'}):"
              f" set up and ran in {batches[bs]:.1f} s, {pred.rounds_run} "
              f"rounds", flush=True)
    print(json.dumps({"device": stages.device_name(dev), **built,
                      "batch_seconds": batches}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
