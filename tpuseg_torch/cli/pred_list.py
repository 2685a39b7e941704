"""Batch inference CLI (port of ``tpuseg/cli/pred_list.py``).

    python -m tpuseg_torch.cli.pred_list --lst <image list> \
        --model assets/synthetic_ckpt.msgpack --dataset CVPPP

Same flags and output layout as the JAX CLI:
``outputs/<dataset>/<modeldir>-<model>/<subset>/<image>/`` holding
``<image>.png``, ``-fg_mask.png``, ``-ins_mask.png``,
``-ins_mask_color.png`` and ``-n_objects.npy``.  Runs on the card
(``--device cuda``, the default; bf16 unless ``--f32``, which runs the
model in float32 with TF32 off: ``runtime/predict.py::tf32_off``).
``--model`` takes a flax ``.msgpack`` or a checkpoint the train CLI
wrote (``cli/common.py::load_model``).  Reading and writing PNGs needs
Pillow.

``--staged`` runs the staged extraction dispatch (windows of 8 batches,
the same outputs; off by default, as in the JAX CLI); ``--bucketed`` runs
each image near its native size on a shape-bucket canvas and writes masks
pixel-aligned with it.  ``--window`` / ``--window_stride`` default to the
environment variables ``TPUSEG_EXTRACT_WINDOW`` /
``TPUSEG_EXTRACT_WINDOW_STRIDE`` (-1 when unset: the config's values).
``--ndevices N`` (0: every card) splits each batch over N replicas of
the model (``Predictor(use_mesh=True)``; the batch size rounds to a
multiple of N).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

from tpuseg_torch import resolve_device
from tpuseg_torch.cli.common import colorize_instances, load_model
from tpuseg_torch.runtime.predict import Predictor
from tpuseg_torch.settings import get_config
from tpuseg_torch.utils.checkpoint_io import load_stop_params


def _parser():
    p = argparse.ArgumentParser()
    p.add_argument("--lst", required=True,
                   help="Text file that contains image paths")
    p.add_argument("--model", required=True, help="Path of the model")
    p.add_argument("--usegpu", action="store_true",
                   help="kept for CLI parity; the card is the default device")
    p.add_argument("--dataset", type=str, required=True,
                   help='Name of the dataset which is "CVPPP"')
    p.add_argument("--batchsize", type=int, default=8)
    p.add_argument("--output", default="", help="override the output directory")
    p.add_argument("--f32", action="store_true",
                   help="disable the bfloat16 inference compute path")
    p.add_argument("--ndevices", type=int, default=1,
                   help="data-parallel devices for batched inference "
                        "(0 = all available)")
    p.add_argument("--bucketed", action="store_true",
                   help="mixed-resolution bucketed inference: no fixed "
                        "resize; images run at native resolution rounded up "
                        "to shape buckets")
    p.add_argument("--staged", action="store_true", default=None,
                   help="staged extraction dispatch: the rounds the budget "
                        "asks for, then 2-round chunks; identical outputs")
    p.add_argument("--no-staged", dest="staged", action="store_false",
                   help="force the monolithic dispatch (the default)")
    p.add_argument("--window", type=int,
                   default=int(os.environ.get("TPUSEG_EXTRACT_WINDOW", "-1")),
                   help="windowed finest-level decode size in pixels; -1 "
                        "keeps the config default, 0 disables")
    p.add_argument("--window_stride", type=int,
                   default=int(os.environ.get("TPUSEG_EXTRACT_WINDOW_STRIDE",
                                              "-1")),
                   help="origin-grid stride of the windowed decode; -1 keeps "
                        "the config default")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    return p


def main(argv=None):
    t_start = time.perf_counter()
    opt = _parser().parse_args(argv)
    device = resolve_device(opt.device)
    n_dev = opt.ndevices or (torch.cuda.device_count()
                             if device.type == "cuda" else 1)
    if opt.dataset != "CVPPP":
        raise ValueError(f"unknown dataset {opt.dataset}")
    from PIL import Image

    images_list = np.loadtxt(opt.lst, dtype="str", delimiter=",", ndmin=1)
    subset = os.path.basename(opt.lst).split("_")[0]
    model_name = os.path.splitext(os.path.basename(opt.model))[0]
    model_dir = os.path.basename(os.path.dirname(opt.model))
    if opt.output:
        output_path = os.path.abspath(opt.output)
    else:
        output_path = os.path.abspath(os.path.join(
            os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir,
            "outputs", opt.dataset, model_dir + "-" + model_name, subset,
        ))
    os.makedirs(output_path, exist_ok=True)

    cfg = get_config(opt.dataset)
    dec = cfg.decoder
    if opt.window >= 0:
        dec = dataclasses.replace(dec, extract_window=opt.window)
    if opt.window_stride >= 0:
        dec = dataclasses.replace(dec, extract_window_stride=opt.window_stride)
    cfg = dataclasses.replace(cfg, decoder=dec)
    cfg, model = load_model(cfg, opt.model)
    predictor = Predictor(
        cfg, model, batch_size=opt.batchsize, stop_params=load_stop_params(),
        device=device, dtype=torch.float32 if opt.f32 else None,
        staged=bool(opt.staged), use_mesh=n_dev > 1,
        n_devices=n_dev if n_dev > 1 else None,
    )
    t_ready = time.perf_counter()

    names = [os.path.splitext(os.path.basename(p))[0] for p in images_list]
    predict = (predictor.predict_paths_bucketed if opt.bucketed
               else predictor.predict_paths)
    for name, res in zip(names, predict([str(p) for p in images_list])):
        out_dir = os.path.join(output_path, name)
        os.makedirs(out_dir, exist_ok=True)
        fg = (res["fg_mask"] * 255).astype(np.uint8)
        ins = res["ins_mask"].astype(np.uint8)
        Image.fromarray(res["image"]).save(os.path.join(out_dir, name + ".png"))
        Image.fromarray(fg).save(os.path.join(out_dir, name + "-fg_mask.png"))
        Image.fromarray(ins).save(os.path.join(out_dir, name + "-ins_mask.png"))
        Image.fromarray(colorize_instances(ins)).save(
            os.path.join(out_dir, name + "-ins_mask_color.png"))
        np.save(os.path.join(out_dir, name + "-n_objects.npy"),
                np.asarray(res["n_objects"]))
    t_done = time.perf_counter()
    print(
        f"timing: setup+weights {t_ready - t_start:.1f}s, inference+artifacts "
        f"{t_done - t_ready:.1f}s ({len(names) / max(t_done - t_ready, 1e-9):.1f}"
        f" img/s incl. host PNG writes) on {device}",
        file=sys.stderr,
    )
    print(f"wrote {len(names)} predictions to {output_path}")
    return output_path


if __name__ == "__main__":
    main()
