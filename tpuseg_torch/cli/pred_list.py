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
``--ndevices N`` (0: every card) runs N rank processes
(``parallel/mesh.py::run_ranks``, rank r on ``cuda:(r % cards)``, all on
the CPU with ``--device cpu``): the batch size rounds to a multiple of N,
as in the JAX CLI, the image list is cut into batches of that size, and
each rank takes a contiguous run of whole batches (the first ranks one
more where they do not divide), predicts them with its own ``Predictor``
and writes its own images' files.  The ranks make no collective.
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
from tpuseg_torch.kernels.ir_chain import ir_chain
from tpuseg_torch.parallel.mesh import Mesh, run_ranks
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


def write_artifacts(output_path: str, res) -> None:
    """One image's five files under ``<output_path>/<image name>/``."""
    from PIL import Image

    name = os.path.splitext(os.path.basename(res["path"]))[0]
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


def list_shard(n_images: int, batch_size: int, mesh: Mesh) -> slice:
    """Rank ``mesh.rank``'s images: a contiguous run of the whole batches
    of ``batch_size`` that one process would form, the first ranks taking
    one batch more where the batches do not divide over the ranks (a rank
    may get none)."""
    n_batches = -(-n_images // batch_size)
    per, extra = divmod(n_batches, mesh.size)
    first = mesh.rank * per + min(mesh.rank, extra)
    last = first + per + (mesh.rank < extra)
    return slice(first * batch_size, min(last * batch_size, n_images))


def predict_and_write(predictor: Predictor, paths, output_path: str,
                      bucketed: bool = False) -> int:
    """Predict ``paths`` in order and write each image's files; returns
    the number written."""
    predict = (predictor.predict_paths_bucketed if bucketed
               else predictor.predict_paths)
    n = 0
    for res in predict([str(p) for p in paths]):
        write_artifacts(output_path, res)
        n += 1
    return n


# the ranks' results of the last ``--ndevices N`` run of ``main`` (N > 1):
# per rank, its images, extraction rounds and kernel launches
last_ranks: list = []


def main(argv=None):
    t_start = time.perf_counter()
    opt = _parser().parse_args(argv)
    device = resolve_device(opt.device)
    n_dev = opt.ndevices or (torch.cuda.device_count()
                             if device.type == "cuda" else 1)
    if opt.dataset != "CVPPP":
        raise ValueError(f"unknown dataset {opt.dataset}")

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
    paths = [str(p) for p in images_list]
    pred_kw = dict(stop_params=load_stop_params(),
                   dtype=torch.float32 if opt.f32 else None,
                   staged=bool(opt.staged))
    if n_dev > 1:
        from tpuseg_torch.parallel import tasks

        # the JAX CLI's rounding of the batch size to the devices
        batch_size = max(opt.batchsize // n_dev, 1) * n_dev
        state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        t_ready = time.perf_counter()
        last_ranks[:] = run_ranks(
            tasks.pred_list_rank, n_dev, device=device.type,
            args=(cfg, state, paths, batch_size, output_path, pred_kw,
                  bool(opt.bucketed)))
        n_written = sum(r["images"] for r in last_ranks)
        rounds = sum(r["rounds"] for r in last_ranks)
        launches = sum(r["launches"]["ir_chain"] for r in last_ranks)
    else:
        predictor = Predictor(cfg, model, batch_size=opt.batchsize,
                              device=device, **pred_kw)
        t_ready = time.perf_counter()
        before = ir_chain.launches
        n_written = predict_and_write(predictor, paths, output_path,
                                      bool(opt.bucketed))
        rounds, launches = predictor.rounds_run, ir_chain.launches - before
    t_done = time.perf_counter()
    print(
        f"timing: setup+weights {t_ready - t_start:.1f}s, inference+artifacts "
        f"{t_done - t_ready:.1f}s ({n_written / max(t_done - t_ready, 1e-9):.1f}"
        f" img/s incl. host PNG writes) on {device}"
        + (f" ({n_dev} ranks)" if n_dev > 1 else ""),
        file=sys.stderr,
    )
    print(f"wrote {n_written} predictions to {output_path}")
    # kernel launches (0 on the CPU, where the plain version runs)
    print(f"ir_chain launches {launches} over {rounds} extraction rounds")
    return output_path


if __name__ == "__main__":
    main()
