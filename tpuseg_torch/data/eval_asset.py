"""The frozen evaluation asset (own copy of ``tpuseg/data/eval_asset.py``).

``assets/eval_hard64.{tsbin,tsidx}`` hold 64 hard synthetic scenes, made
once and pinned by the sha256 sums in ``assets/eval_hard64.sha256``, so
every quality number is taken on the same images.  Per sample the blob
file holds the RGB image and the instance label map, each as PNG bytes,
and the index their offsets and the instance count.

``materialize_eval_tree`` writes the ground-truth tree ``cli/evaluate.py``
reads: the two PNGs copied verbatim, ``_fg.png`` derived as ``label > 0``,
and the metadata lists.  The tree is a function of the asset's bytes
alone, byte for byte the JAX package's.  Pillow is imported when called.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
from typing import Dict, List

import numpy as np

EVAL_MAGIC = b"TSEV0001"


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _png_bytes(arr: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def freeze_eval_records(prefix: str, n_samples: int = 64, seed: int = 99,
                        height: int = 256, width: int = 256,
                        hard: bool = True, max_leaves: int = 14,
                        min_leaves: int = 3) -> dict:
    """Make the eval scenes and write them as an asset with its
    ``.sha256`` sidecar; returns the hashes.  The defaults are those the
    committed ``eval_hard64`` was made with."""
    from tpuseg_torch.data.synthetic import label_map, make_scene

    rng = np.random.default_rng(seed)
    index: List[Dict] = []
    with open(prefix + ".tsbin", "wb") as binf:
        binf.write(EVAL_MAGIC)
        offset = len(EVAL_MAGIC)

        def blob(data: bytes):
            nonlocal offset
            binf.write(data)
            ref = [offset, len(data)]
            offset += len(data)
            return ref

        for _ in range(n_samples):
            rgb, _, ins, n = make_scene(rng, height, width,
                                        min_leaves=min_leaves,
                                        max_leaves=max_leaves, hard=hard)
            index.append({
                "image": blob(_png_bytes(rgb)),
                "label": blob(_png_bytes(label_map(ins))),
                "n_objects": int(n),
            })
    with open(prefix + ".tsidx", "w") as f:
        json.dump({
            "format": "eval_tree_v1",
            "num_samples": len(index),
            "generator": {
                "seed": seed, "hard": hard, "height": height,
                "width": width, "min_leaves": min_leaves,
                "max_leaves": max_leaves,
            },
            "samples": index,
        }, f)
    hashes = {
        os.path.basename(prefix) + ".tsbin": _sha256(prefix + ".tsbin"),
        os.path.basename(prefix) + ".tsidx": _sha256(prefix + ".tsidx"),
    }
    with open(prefix + ".sha256", "w") as f:
        for name, digest in sorted(hashes.items()):
            f.write(f"{digest}  {name}\n")
    return hashes


def verify_eval_records(prefix: str) -> None:
    """Raise ``ValueError`` if the asset's bytes differ from the pinned
    hashes."""
    with open(prefix + ".sha256") as f:
        pinned = dict(
            reversed(line.split()) for line in f.read().splitlines() if line)
    base = os.path.dirname(os.path.abspath(prefix))
    for name, digest in pinned.items():
        actual = _sha256(os.path.join(base, name))
        if actual != digest:
            raise ValueError(
                f"frozen eval asset {name} hash mismatch: "
                f"pinned {digest}, on disk {actual}")


def materialize_eval_tree(records_prefix: str, root: str,
                          verify: bool = True) -> str:
    """Write the ground-truth tree under ``root`` (the layout of
    ``write_synthetic_eval_tree``), after checking the pinned hashes when
    the sidecar exists; returns the list file's path."""
    from PIL import Image

    if verify and os.path.isfile(records_prefix + ".sha256"):
        verify_eval_records(records_prefix)
    with open(records_prefix + ".tsidx") as f:
        idx = json.load(f)
    img_dir = os.path.join(root, "data", "raw", "CVPPP",
                           "CVPPP2017_LSC_training", "training", "A1")
    meta = os.path.join(root, "data", "metadata", "CVPPP")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(meta, exist_ok=True)
    paths, counts = [], []
    with open(records_prefix + ".tsbin", "rb") as binf:
        if binf.read(len(EVAL_MAGIC)) != EVAL_MAGIC:
            raise ValueError(f"{records_prefix}.tsbin is not an eval asset")

        def blob(ref) -> bytes:
            binf.seek(ref[0])
            return binf.read(ref[1])

        for i, rec in enumerate(idx["samples"]):
            name = f"plant{i:04d}"
            with open(os.path.join(img_dir, name + "_rgb.png"), "wb") as f:
                f.write(blob(rec["image"]))
            label_png = blob(rec["label"])
            with open(os.path.join(img_dir, name + "_label.png"), "wb") as f:
                f.write(label_png)
            label = np.asarray(Image.open(io.BytesIO(label_png)))
            Image.fromarray((label > 0).astype(np.uint8)).save(
                os.path.join(img_dir, name + "_fg.png"))
            paths.append(os.path.join(img_dir, name + "_rgb.png"))
            counts.append((name, rec["n_objects"]))
    lst = os.path.join(meta, "validation_image_paths.txt")
    with open(lst, "w") as f:
        f.write("\n".join(paths) + "\n")
    with open(os.path.join(meta, "number_of_instances.txt"), "w") as f:
        f.write("\n".join(f"{n},{c}" for n, c in counts) + "\n")
    return lst


def default_asset_prefix() -> str:
    """``<repo>/assets/eval_hard64``."""
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "assets", "eval_hard64")
