"""Direct component timing of the inference path on the card, on
synthesized inputs (port of ``tools/profile_components.py``).

    python -m tpuseg_torch.tools.profile_components [--batch 32] [--f32]
        [--iters 8] [--device cpu]

Times each component in isolation by calling the model's own submodules
with the checkpoint's weights, cast for inference (no subtraction games):
  stem            : ``ReSeg.ins_stem`` on a UNet-output-sized map
  s_sp            : the decoder's ``SpatialAttention`` (d_model channels)
  attend          : the decoder's ``HardAttention`` (``nn/attention.py``)
                    with one instance, which runs the ``masked_softmax``
                    kernel on the card
  transform_skips : the 5 glimpse-independent skip transforms
                    (``decoder/pyramid.py::AttenDecoder.transform_skips``)
  decode1         : one pyramid decode (5 levels) from transformed skips
                    (``AttenDecoder.decode``; its chains run ``ir_chain``)
  full_infer      : the whole batch through the ``Predictor``
                    (``tools/stages.py::batch``) on synthetic images
Each is the median of 3 runs of ``--iters`` calls timed with CUDA events
after a warm-up (the host clock with ``--device cpu``).  Prints the report
as JSON, with the JAX tool's keys.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from typing import List, Optional

import torch

from tpuseg_torch import resolve_device
from tpuseg_torch.tools import stages

_CL = torch.channels_last


def timer(fn, dev, iters: int) -> float:
    fn()  # warm-up
    return statistics.median(stages.time_ms(fn, dev, iters, warmup=0)
                             for _ in range(3))


def pyramid_inputs(b: int, h: int, w: int, f: int, dtype, dev, seed: int = 0):
    """UNet-skip-shaped inputs (fine -> coarse: f x 1, 2, 4, 8, 16
    channels at 1, 1/2 .. 1/16 size), a random semantic mask (B, 1, H, W)
    and one glimpse point per sample at the centre."""
    g = torch.Generator(device=dev).manual_seed(seed)
    feats = [torch.randn((b, f * s, h // s, w // s), generator=g, device=dev,
                         dtype=dtype).contiguous(memory_format=_CL)
             for s in (1, 2, 4, 8, 16)]
    sem = (torch.rand((b, 1, h, w), generator=g, device=dev) > 0.5).to(dtype)
    point = torch.full((b,), (h // 2) * w + w // 2, dtype=torch.long,
                       device=dev)
    return feats, sem, point


@torch.no_grad()
def components(s: stages.Setup, iters: int) -> dict:
    cfg, model, dev, dt = s.cfg, s.model, s.dev, s.dtype
    b, h, w = s.batch, cfg.data.image_height, cfg.data.image_width
    dec = model.decoder
    feats, sem, point = pyramid_inputs(b, h, w, cfg.model.n_filters, dt, dev)
    x_dec = feats[0]
    ms = {}
    with s.pred._compute():
        ms["stem"] = timer(lambda: model.ins_stem(x_dec), dev, iters)
        encode = model.ins_stem(x_dec)
        ms["s_sp"] = timer(lambda: dec.s_sp(encode, sem), dev, iters)
        s_out = dec.s_sp(encode, sem)
        ms["attend"] = timer(lambda: dec.attend(s_out, sem, sem), dev, iters)
        bone = dec.bone
        ms["transform_skips"] = timer(lambda: bone.transform_skips(feats), dev,
                                      iters)
        skips_t = bone.transform_skips(feats)
        ms["decode1"] = timer(lambda: bone.decode(point, skips_t, sem), dev,
                              iters)
    ms["full_infer"] = timer(lambda: stages.batch(s.pred, s.x), dev,
                             max(iters // 2, 3))
    return ms


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    stages.add_model_args(ap)
    ap.add_argument("--iters", type=int, default=8)
    args = ap.parse_args(argv)
    resolve_device(args.device)
    s = stages.setup(args)
    ms = components(s, args.iters)
    print(json.dumps({
        "batch": s.batch,
        "dtype": s.dtype_name,
        "device": stages.device_name(s.dev),
        "ms_per_batch": ms,
        "ms_per_image": {k: v / s.batch for k, v in ms.items()},
    }, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
