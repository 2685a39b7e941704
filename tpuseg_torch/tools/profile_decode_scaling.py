"""How does one pyramid decode's time scale with the (folded) batch size?
(port of ``tools/profile_decode_scaling.py``)

    python -m tpuseg_torch.tools.profile_decode_scaling [--batches
        32,64,128,256] [--iters 6] [--res 256] [--device cpu]

If decode(B * G) is well under G x decode(B), folding G glimpses of an
extraction round into the batch wins.  Times one ``AttenDecoder.decode``
(5 levels, the chains through ``ir_chain``) from transformed skips at each
batch size, in bfloat16 and in float32 (TF32 off), the median of 3 runs of
``--iters`` calls timed with CUDA events after a warm-up.  Prints a line a
case and the results as one JSON object (``decode_{bf16,f32}_b{B}``: ms).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import sys
from typing import List, Optional

import torch

from tpuseg_torch import resolve_device
from tpuseg_torch.runtime.predict import tf32_off
from tpuseg_torch.tools import stages
from tpuseg_torch.tools.profile_components import pyramid_inputs, timer


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batches", default="32,64,128,256")
    ap.add_argument("--iters", type=int, default=6)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    _, cfg, model = stages.load(args)
    h, w, f = cfg.data.image_height, cfg.data.image_width, cfg.model.n_filters
    results = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        bone = copy.deepcopy(model).to(dev).to_inference(dtype).decoder.bone
        for b in (int(x) for x in args.batches.split(",")):
            feats, sem, point = pyramid_inputs(b, h, w, f, dtype, dev)
            with torch.no_grad(), (tf32_off() if dtype == torch.float32
                                   else contextlib.nullcontext()):
                skips_t = bone.transform_skips(feats)
                ms = timer(lambda: bone.decode(point, skips_t, sem), dev,
                           args.iters)
            results[f"decode_{name}_b{b}"] = ms
            print(f"decode {name} b={b}: {ms:.3f} ms ({ms / b:.4f} "
                  f"ms/sample)", flush=True)
            del feats, skips_t, sem
        del bone
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps({"device": stages.device_name(dev), **results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
