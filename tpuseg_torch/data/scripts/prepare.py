"""Dataset preparation (own copy of ``tpuseg/data/scripts/prepare.py``): the
reference's seven-step ``data/scripts/CVPPP/prepare.sh`` as one CLI.

  1. per-image semantic and instance masks from ``*_label.png`` and
     ``*_fg.png`` (1-create_annotations.py)
  2. alpha channels stripped (1-remove_alpha.sh; PIL here)
  3. a random 80/20 training/validation split: ``.lst`` files and
     ``*_image_paths.txt`` (2-get_image_paths.py)
  4. ``image_shapes.txt`` (2-get_image_shapes.py)
  5. per-channel mean and std (2-get_image_means-stds.py)
  6. ``number_of_instances.txt`` (2-get_number_of_instances.py)
  7. the record datasets (3-create_dataset.py): packed records, the
     reference's LMDB layout (needs the ``lmdb`` package), or both

Every output is byte for byte the JAX script's for the same raw tree and
seed.

    python -m tpuseg_torch.data.scripts.prepare --data_dir data [--dataset CVPPP]
"""

from __future__ import annotations

import argparse
import glob
import os
import random

import numpy as np

from tpuseg_torch.data.records import LmdbWriter, RecordWriter


def _open(path):
    from PIL import Image

    return Image.open(path)


def _rgb_paths(img_dir: str):
    return sorted(glob.glob(os.path.join(img_dir, "*_rgb.png")))


def create_annotations(img_dir: str, out_dir: str) -> int:
    """Step 1 (reference 1-create_annotations.py:28-67): ``.npy`` semantic
    and instance masks per labelled image; returns their count."""
    sem_dir = os.path.join(out_dir, "semantic-annotations")
    ins_dir = os.path.join(out_dir, "instance-annotations")
    os.makedirs(sem_dir, exist_ok=True)
    os.makedirs(ins_dir, exist_ok=True)
    n = 0
    for image_path in _rgb_paths(img_dir):
        name = os.path.basename(image_path).split("_rgb")[0]
        label_path = os.path.join(img_dir, name + "_label.png")
        if not os.path.isfile(label_path):
            continue
        annotation = np.array(_open(label_path))
        sem = np.array(_open(os.path.join(img_dir, name + "_fg.png")))
        ids = sorted(set(np.unique(annotation)) - {0})
        if not ids:
            continue
        h, w = annotation.shape
        ins = np.zeros((h, w, len(ids)), np.uint8)
        for i, v in enumerate(ids):
            ins[annotation == v, i] = 1
        np.save(os.path.join(ins_dir, name + ".npy"), ins)
        np.save(os.path.join(sem_dir, name + ".npy"), sem)
        n += 1
    return n


def remove_alpha(img_dir: str) -> None:
    """Step 2 (reference 1-remove_alpha.sh): RGBA images saved as RGB."""
    for p in _rgb_paths(img_dir):
        img = _open(p)
        if img.mode != "RGB":
            img.convert("RGB").save(p)


def split_paths(img_dir: str, meta_dir: str, seed: int = 0):
    """Step 3 (reference 2-get_image_paths.py): a shuffled 80/20 split into
    ``training.lst`` / ``validation.lst`` and the full-path lists."""
    os.makedirs(meta_dir, exist_ok=True)
    names = sorted(os.path.basename(p).split("_rgb")[0]
                   for p in _rgb_paths(img_dir))
    random.Random(seed).shuffle(names)
    cut = int(0.8 * len(names))
    splits = {"training": names[:cut], "validation": names[cut:]}
    for subset, subset_names in splits.items():
        with open(os.path.join(meta_dir, subset + ".lst"), "w") as f:
            f.write("\n".join(subset_names) + "\n")
        with open(os.path.join(meta_dir, f"{subset}_image_paths.txt"), "w") as f:
            f.write("\n".join(os.path.join(img_dir, n + "_rgb.png")
                              for n in subset_names) + "\n")
    return splits


def image_shapes(img_dir: str, meta_dir: str) -> None:
    """Step 4 (reference 2-get_image_shapes.py): ``name,H,W`` per line."""
    with open(os.path.join(meta_dir, "image_shapes.txt"), "w") as f:
        for p in _rgb_paths(img_dir):
            w, h = _open(p).size
            f.write(f"{os.path.basename(p)},{h},{w}\n")


def means_stds(img_dir: str, meta_dir: str):
    """Step 5 (reference 2-get_image_means-stds.py): the channel mean and
    std of the whole image set, written to ``means_stds.txt`` and
    returned."""
    acc = np.zeros(3)
    acc2 = np.zeros(3)
    count = 0
    for p in _rgb_paths(img_dir):
        arr = np.array(_open(p).convert("RGB"), np.float64) / 255.0
        acc += arr.reshape(-1, 3).sum(0)
        acc2 += (arr.reshape(-1, 3) ** 2).sum(0)
        count += arr.shape[0] * arr.shape[1]
    mean = acc / max(count, 1)
    std = np.sqrt(np.maximum(acc2 / max(count, 1) - mean ** 2, 0))
    with open(os.path.join(meta_dir, "means_stds.txt"), "w") as f:
        f.write(",".join(f"{m:.6f}" for m in mean) + "\n")
        f.write(",".join(f"{s:.6f}" for s in std) + "\n")
    return mean, std


def number_of_instances(img_dir: str, meta_dir: str) -> None:
    """Step 6 (reference 2-get_number_of_instances.py): ``name,count``."""
    with open(os.path.join(meta_dir, "number_of_instances.txt"), "w") as f:
        for p in sorted(glob.glob(os.path.join(img_dir, "*_label.png"))):
            name = os.path.basename(p).split("_label")[0]
            ids = set(np.unique(np.array(_open(p)))) - {0}
            f.write(f"{name},{len(ids)}\n")


def create_records(img_dir: str, ann_dir: str, meta_dir: str, out_dir: str,
                   fmt: str = "records"):
    """Step 7 (reference 3-create_dataset.py, utils.py:14-62): one dataset
    per subset.  ``fmt``: 'records' (packed ``.tsidx``/``.tsbin``),
    'lmdb' (the reference's layout) or 'both'.  Returns the sample count
    per subset."""
    os.makedirs(out_dir, exist_ok=True)
    counts = {}
    for subset in ("training", "validation"):
        lst = os.path.join(meta_dir, subset + ".lst")
        if not os.path.isfile(lst):
            continue
        with open(lst) as f:
            names = [line.strip() for line in f if line.strip()]
        writers = []
        if fmt in ("records", "both"):
            writers.append(RecordWriter(os.path.join(out_dir, subset)))
        if fmt in ("lmdb", "both"):
            writers.append(LmdbWriter(os.path.join(out_dir, subset + "_lmdb")))
        n = 0
        for name in names:
            img_path = os.path.join(img_dir, name + "_rgb.png")
            ins_path = os.path.join(ann_dir, "instance-annotations",
                                    name + ".npy")
            sem_path = os.path.join(ann_dir, "semantic-annotations",
                                    name + ".npy")
            if not (os.path.isfile(img_path) and os.path.isfile(ins_path)):
                continue
            with open(img_path, "rb") as f:
                png = f.read()
            ins = np.load(ins_path)
            sem = np.load(sem_path)
            for writer in writers:
                writer.add(png, sem.astype(np.uint8), ins.astype(np.uint8),
                           ins.shape[-1])
            n += 1
        for writer in writers:
            writer.close()
        counts[subset] = n
    return counts


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", default="data")
    parser.add_argument("--dataset", default="CVPPP")
    parser.add_argument("--img_dir", default="",
                        help="raw image dir (default <data_dir>/raw/...A1)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--format", default="records",
                        choices=("records", "lmdb", "both"),
                        help="packed records (default), the reference's "
                             "LMDB layout, or both")
    opt = parser.parse_args(argv)

    img_dir = opt.img_dir or os.path.join(
        opt.data_dir, "raw", opt.dataset, "CVPPP2017_LSC_training",
        "training", "A1")
    processed = os.path.join(opt.data_dir, "processed", opt.dataset)
    meta = os.path.join(opt.data_dir, "metadata", opt.dataset)
    os.makedirs(meta, exist_ok=True)

    print("1. Creating semantic and instance masks")
    print(f"   {create_annotations(img_dir, processed)} annotated images")
    print("2. Removing alpha channels from images")
    remove_alpha(img_dir)
    print("3. Saving image paths")
    splits = split_paths(img_dir, meta, seed=opt.seed)
    print(f"   {len(splits['training'])} train / "
          f"{len(splits['validation'])} val")
    print("4. Calculating image shapes")
    image_shapes(img_dir, meta)
    print("5. Calculating means and standard deviations per channel")
    mean, std = means_stds(img_dir, meta)
    print(f"   mean={mean.round(4)} std={std.round(4)}")
    print("6. Calculating number of instances in images")
    number_of_instances(img_dir, meta)
    print("7. Creating record datasets")
    counts = create_records(img_dir, processed, meta,
                            os.path.join(processed, "records"), fmt=opt.format)
    print(f"   {counts}")


if __name__ == "__main__":
    main()
