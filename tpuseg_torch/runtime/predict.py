"""Batched inference (port of ``tpuseg/runtime/predict.py``, the monolithic
predictor).

One batch runs: 21-channel expansion -> ``ReSeg.infer_prep`` (backbone,
semantic head, density budget, attention score, conv1 partials) ->
``InstanceDecoder.extract_rounds`` (G glimpses per round through the
pyramid decode and its ``ir_chain`` kernel) -> fg mask, id map and counts.

The predictor runs on the card by default and raises when CUDA is absent
unless ``device="cpu"`` is asked for.  ``dtype`` defaults to bfloat16 on
the card (as the JAX ``pred_list`` does) and float32 on the CPU.  The
staged, mesh, bucketed, cluster and attend predictors of the JAX package
are later slices of the port.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from tpuseg_torch import resolve_device
from tpuseg_torch.configs import Config
from tpuseg_torch.data.colorspace import image_ex_standardize


def pack_masks(fg: torch.Tensor, idmap: torch.Tensor) -> torch.Tensor:
    """One uint8 plane ``idmap | fg << 7`` (ids < 128): one host copy per
    batch instead of two."""
    return idmap.to(torch.uint8) | (fg.to(torch.uint8) << 7)


def unpack_masks(packed) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side inverse of :func:`pack_masks` -> (fg, idmap) uint8."""
    packed = np.asarray(packed)
    return (packed >> 7).astype(np.uint8), (packed & 0x7F).astype(np.uint8)


class Predictor:
    def __init__(
        self,
        cfg: Config,
        model,
        batch_size: int = 8,
        max_instances: Optional[int] = None,
        stop_params: Optional[Tuple] = None,
        device="cuda",
        dtype: Optional[torch.dtype] = None,
        sync_rounds: bool = True,
    ):
        """``model``: a ``ReSeg`` with its weights loaded (float32).
        ``sync_rounds``: end extraction after the first round that leaves
        every sample done (one host sync per round) instead of always
        running ceil(max_instances / extract_group) rounds."""
        self.device = resolve_device(device)
        if dtype is None:
            dtype = torch.bfloat16 if self.device.type == "cuda" else torch.float32
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"unsupported inference dtype {dtype}")
        self.cfg = cfg
        self.dtype = dtype
        self.batch_size = batch_size
        self.max_instances = max_instances
        self.stop_params = stop_params
        self.sync_rounds = sync_rounds
        self.model = model.to(self.device).to_inference(dtype)
        G = max(int(cfg.decoder.extract_group), 1)
        k_static = max_instances or cfg.data.max_n_objects
        self.max_rounds = -(-k_static // G)
        self.rounds_run = 0  # extraction rounds over this predictor's life

    @torch.no_grad()
    def _infer_full(self, images_u8: torch.Tensor):
        x = image_ex_standardize(images_u8).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        sem_probs, sem_mask, budget, score, partials = self.model.infer_prep(
            x, max_instances=self.max_instances
        )
        idmap, counts, rounds = self.model.decoder.extract_rounds(
            sem_mask, score, partials, max_instances=self.max_instances,
            count_budget=budget, n_rounds=self.max_rounds,
            stop_params=self.stop_params, sync_rounds=self.sync_rounds,
        )
        self.rounds_run += rounds
        return sem_probs, idmap, counts

    def _to_device(self, images_u8) -> torch.Tensor:
        x = images_u8 if torch.is_tensor(images_u8) else torch.from_numpy(
            np.ascontiguousarray(images_u8))
        if x.dtype != torch.uint8 or x.dim() != 4 or x.shape[-1] != 3:
            raise ValueError("images must be (B, H, W, 3) uint8")
        return x.to(self.device, non_blocking=True)

    def predict_batch_arrays(self, images_u8, with_probs: bool = False):
        """images_u8 (B, H, W, 3) uint8 -> (sem_probs or None, fg (B, H, W)
        uint8, idmap (B, H, W) uint8, counts (B,) int32) on the device;
        sem_probs is (B, H, W, 2) float when asked for."""
        sem_probs, idmap, counts = self._infer_full(self._to_device(images_u8))
        fg = sem_probs.argmax(dim=1).to(torch.uint8)
        probs = sem_probs.permute(0, 2, 3, 1) if with_probs else None
        return probs, fg, idmap.to(torch.uint8), counts.to(torch.int32)

    def predict_batch_packed(self, images_u8):
        """(packed (B, H, W) uint8, counts (B,) int32) on the device — one
        mask plane per batch (:func:`pack_masks`)."""
        sem_probs, idmap, counts = self._infer_full(self._to_device(images_u8))
        return pack_masks(sem_probs.argmax(dim=1), idmap), counts.to(torch.int32)

    # ------------------------------------------------------------------
    def _load(self, path: str):
        """(raw image, resized (H, W, 3) uint8, native (h, w)); bilinear
        resize as the JAX package's loader does."""
        from PIL import Image

        img = Image.open(path).convert("RGB")
        w, h = img.size
        resized = img.resize(
            (self.cfg.data.image_width, self.cfg.data.image_height),
            Image.BILINEAR,
        )
        return np.array(img), np.asarray(resized, np.uint8), (h, w)

    @staticmethod
    def _upsample_nearest(arr: np.ndarray, hw) -> np.ndarray:
        from PIL import Image

        return np.array(Image.fromarray(arr).resize((hw[1], hw[0]),
                                                    Image.NEAREST))

    def predict_paths(self, paths: Sequence[str]) -> Iterator[Dict]:
        """Yields per image: dict(path, image, fg_mask (native res, {0,1}
        uint8), ins_mask (native res ids, uint8), n_objects)."""
        bs = self.batch_size
        for start in range(0, len(paths), bs):
            chunk = list(paths[start:start + bs])
            n_valid = len(chunk)
            chunk += [chunk[-1]] * (bs - n_valid)
            raws, resized, sizes = zip(*[self._load(p) for p in chunk])
            packed, counts = self.predict_batch_packed(np.stack(resized))
            fg, idmap = unpack_masks(packed.cpu().numpy())
            counts = counts.cpu().numpy()
            for i in range(n_valid):
                yield {
                    "path": chunk[i],
                    "image": raws[i],
                    "fg_mask": self._upsample_nearest(fg[i], sizes[i]),
                    "ins_mask": self._upsample_nearest(
                        idmap[i].astype(np.int32), sizes[i]
                    ).astype(np.uint8),
                    "n_objects": int(counts[i]),
                }
