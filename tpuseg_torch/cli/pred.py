"""Single-image inference CLI (port of ``tpuseg/cli/pred.py``).

    python -m tpuseg_torch.cli.pred --image <png> --model <msgpack or
        checkpoint> --output <dir> [--instances]

Same flags and output files as the JAX CLI.  By default the semantic path:
``<image>-fg_mask.png`` (foreground probability > 0.5, palette PNG).  With
``--instances`` the batched instance path for one image: ``<image>.png``,
``-fg_mask.png``, ``-ins_mask.png``, ``-ins_mask_color.png`` and
``-n_objects.npy``.

The JAX CLI builds its model in float32, so this one runs float32 with
TF32 off (``runtime/predict.py::tf32_off``), not bfloat16.  It runs on the
card (``--device cuda``, the default) and raises without CUDA unless given
``--device cpu``.  Reading and writing PNGs needs Pillow.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from tpuseg_torch import resolve_device
from tpuseg_torch.cli.common import colorize_instances, load_model
from tpuseg_torch.runtime.predict import Predictor
from tpuseg_torch.settings import get_config


def _parser():
    p = argparse.ArgumentParser()
    p.add_argument("--image", required=True, help="Path of the image")
    p.add_argument("--model", default="", help="Path of the model")
    p.add_argument("--usegpu", action="store_true", default=True,
                   help="kept for CLI parity; the card is the default device")
    p.add_argument("--output", default="outputs/pred",
                   help="Path of the output directory")
    p.add_argument("--dataset", type=str, default="CVPPP")
    p.add_argument("--instances", action="store_true",
                   help="run the full instance path")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    return p


def main(argv=None) -> str:
    """Writes the prediction files; returns the output directory."""
    opt = _parser().parse_args(argv)
    device = resolve_device(opt.device)
    if opt.dataset != "CVPPP":
        raise ValueError(f"unknown dataset {opt.dataset}")
    from PIL import Image

    os.makedirs(opt.output, exist_ok=True)
    cfg, model = load_model(get_config(opt.dataset), opt.model)
    predictor = Predictor(cfg, model, batch_size=1, device=device,
                          dtype=torch.float32)
    name = os.path.splitext(os.path.basename(opt.image))[0]
    out = lambda suffix: os.path.join(opt.output, name + suffix)  # noqa: E731

    if opt.instances:
        res = predictor.predict_attend(opt.image)
        fg = (res["fg_mask"] * 255).astype(np.uint8)
        ins = res["ins_mask"].astype(np.uint8)
        Image.fromarray(res["image"]).save(out(".png"))
        Image.fromarray(fg).convert("P").save(out("-fg_mask.png"))
        Image.fromarray(ins).save(out("-ins_mask.png"))
        Image.fromarray(colorize_instances(ins)).save(out("-ins_mask_color.png"))
        np.save(out("-n_objects.npy"), np.asarray(res["n_objects"]))
    else:
        res = predictor.predict_semantic(opt.image)
        fg = ((res["fg_prob"] > 0.5) * 255).astype(np.uint8)
        Image.fromarray(fg).convert("P").save(out("-fg_mask.png"))
    print(f"wrote predictions for {name} to {opt.output}")
    return opt.output


if __name__ == "__main__":
    main()
