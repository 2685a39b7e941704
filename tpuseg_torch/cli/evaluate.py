"""Scoring CLI (port of ``tpuseg/cli/evaluate.py``).

    python -m tpuseg_torch.cli.evaluate --pred_dir <pred_list output> \
        --dataset CVPPP [--metadata <dir>] [--img_dir <ground-truth dir>]

Same flags, metrics and three print lines as the JAX CLI: mean SBD,
mean |DiC| and mean foreground Dice over the images of
``validation_image_paths.txt`` that have a prediction.  The metadata
directory is probed as the JAX CLI probes it.  Images are scored in one
batch per image shape with ``evalm/metrics.py`` on ``--device`` (the card
by default), ``max_ids`` rounded up to a multiple of 16.  Reading PNGs
needs Pillow.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from tpuseg_torch import resolve_device
from tpuseg_torch.evalm.metrics import fg_dice_batch, symmetric_best_dice_batch


def _find_metadata(root_hint: str, dataset: str) -> str:
    cands = [
        os.path.join(root_hint, "data", "metadata", dataset),
        os.path.join(root_hint, "data", "metadata"),
        os.path.join("data", "metadata", dataset),
        os.path.join("data", "metadata"),
    ]
    for c in cands:
        if os.path.isfile(os.path.join(c, "validation_image_paths.txt")):
            return c
    raise FileNotFoundError(
        f"no metadata dir with validation_image_paths.txt among {cands}")


def _parser():
    p = argparse.ArgumentParser()
    p.add_argument("--pred_dir", required=True, help="Prediction directory")
    p.add_argument("--dataset", type=str, required=True,
                   help='Name of the dataset which is "CVPPP"')
    p.add_argument("--metadata", default="", help="metadata directory")
    p.add_argument("--img_dir", default="", help="ground-truth image dir")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' scores on the CPU")
    return p


def _load_records(pred_dir: str, meta: str, img_dir: str):
    from PIL import Image

    names = np.loadtxt(os.path.join(meta, "validation_image_paths.txt"),
                       dtype="str", delimiter=",", ndmin=1)
    names = [os.path.splitext(os.path.basename(n))[0] for n in names]
    n_objects_gts = np.loadtxt(os.path.join(meta, "number_of_instances.txt"),
                               dtype="str", delimiter=",", ndmin=2)

    def png(path):
        return np.array(Image.open(path))

    records = []
    for name in names:
        base = f"{pred_dir}/{name}/{name}"
        if not os.path.isfile(base + "-n_objects.npy"):
            continue
        key = name.replace("_rgb", "")
        records.append({
            "ins_gt": png(os.path.join(img_dir, key + "_label.png")).astype(
                np.int32),
            "ins_pred": png(base + "-ins_mask.png").astype(np.int32),
            "fg_gt": png(os.path.join(img_dir, key + "_fg.png")) == 1,
            "fg_pred": png(base + "-fg_mask.png") == 255,
            "n_gt": int(n_objects_gts[n_objects_gts[:, 0] == key][0][1]),
            "n_pred": int(np.load(base + "-n_objects.npy")),
        })
    return records


def main(argv=None):
    opt = _parser().parse_args(argv)
    device = resolve_device(opt.device)
    if opt.dataset != "CVPPP":
        raise ValueError(f"unknown dataset {opt.dataset}")
    meta = opt.metadata or _find_metadata(".", opt.dataset)
    img_dir = opt.img_dir or os.path.join(
        "data", "raw", opt.dataset, "CVPPP2017_LSC_training", "training", "A1")
    records = _load_records(opt.pred_dir, meta, img_dir)

    def stack(group, key):
        return torch.from_numpy(np.stack([r[key] for r in group])).to(device)

    dics, sbds, fg_dices = [], [], []
    buckets = {}
    for r in records:
        buckets.setdefault(r["ins_gt"].shape, []).append(r)
    for group in buckets.values():
        max_ids = max(int(max(r["ins_gt"].max(), r["ins_pred"].max(), 1))
                      for r in group)
        max_ids = int(np.ceil(max_ids / 16) * 16)
        sbds.extend(symmetric_best_dice_batch(
            stack(group, "ins_gt"), stack(group, "ins_pred"),
            max_ids=max_ids).cpu().tolist())
        fg_dices.extend(fg_dice_batch(
            stack(group, "fg_gt"), stack(group, "fg_pred")).cpu().tolist())
        dics.extend(abs(r["n_gt"] - r["n_pred"]) for r in group)

    def mean(xs):
        return float(np.mean(xs)) if xs else None

    print("MEAN SBD     : ", np.mean(sbds) if sbds else float("nan"))
    print("MEAN |DIC|   : ", np.mean(dics) if dics else float("nan"))
    print("MEAN FG DICE : ", np.mean(fg_dices) if fg_dices else float("nan"))
    return mean(sbds), mean(dics), mean(fg_dices)


if __name__ == "__main__":
    main()
