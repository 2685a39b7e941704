"""Batched inference (port of ``tpuseg/runtime/predict.py``).

One batch runs: 21-channel expansion -> ``ReSeg.infer_prep`` (backbone,
semantic head, density budget, attention score, conv1 partials) ->
``InstanceDecoder.extract_rounds`` (G glimpses per round through the
pyramid decode and its ``ir_chain`` kernel) -> fg mask, id map and counts.

Two dispatches of the extraction rounds give the same outputs:

* monolithic (the default): one call per batch whose round loop reads the
  ``done`` flags after every round (one host sync a round) and stops when
  every sample is done;
* staged (``staged=True``): the budget vector is read once, the first
  chunk runs the rounds it asks for (plus ``staged_margin``) without a
  sync, then 2-round chunks continue from the carry until every sample is
  done.  ``predict_batches_staged`` does this for a window of batches with
  one budget readback and one ``done`` readback per chunk for the whole
  window.

Besides the batched paths: ``predict_paths_bucketed`` (each image near its
native size on a zero-padded bucket canvas), ``predict_semantic``,
``predict_attend`` and ``predict_cluster`` (embeddings -> on-device KMeans,
``runtime/cluster.py``).

The predictor runs on the card by default and raises when CUDA is absent
unless ``device="cpu"`` is asked for.  ``dtype`` defaults to bfloat16 on
the card (as the JAX ``pred_list`` does) and float32 on the CPU; float32
runs every call with TF32 off (:func:`tf32_off`).

``use_mesh`` is the JAX package's data-parallel predictor: one replica of
the model per device (replica i on ``cuda:(i % device_count)``, every one
on the CPU when the predictor is), the batch size rounded to a multiple of
them, each batch split on its leading axis and the outputs gathered in
order.  Inference reduces nothing over the batch, so this is one process.
The replicas run one after another from the calling thread, so they do
not overlap on several cards.  A thread a replica measured slower, not
faster: the round loops are paced by the host, whose dispatch the threads
contend for (PERF.md, PR 10); serving several cards at once wants a
process a card.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpuseg_torch import resolve_device
from tpuseg_torch.configs import Config
from tpuseg_torch.data.colorspace import image_ex_standardize
from tpuseg_torch.parallel.mesh import rank_device


@contextlib.contextmanager
def tf32_off():
    """cuDNN convolutions and CUDA matmuls in full float32 inside the block
    (PyTorch lets cuDNN use TF32 by default); the previous settings are
    restored after it."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    before = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = before


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
        staged: bool = False,
        staged_margin: int = 1,
        use_mesh: bool = False,
        n_devices: Optional[int] = None,
    ):
        """``model``: a ``ReSeg`` with its weights loaded (float32).
        ``dtype=torch.float32`` runs every call with TF32 off
        (:func:`tf32_off`).  ``sync_rounds`` (monolithic dispatch): end
        extraction after the first round that leaves every sample done (one
        host sync per round) instead of always running ceil(max_instances /
        extract_group) rounds.  ``staged``: the staged dispatch for
        ``predict_batch_arrays(with_probs=False)``, ``predict_batch_packed``
        and ``predict_paths``; ``staged_margin`` extra rounds in its first
        chunk.  ``use_mesh``: replicas on ``n_devices`` devices (all cards
        when None; see the module docstring); ``replicas`` lists them,
        this predictor first."""
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
        self.staged = staged
        self.staged_margin = staged_margin
        self.replicas = [self]
        if use_mesh:
            n = n_devices or (torch.cuda.device_count()
                              if self.device.type == "cuda" else 1)
            self.batch_size = max(batch_size // n, 1) * n
            self.replicas += [Predictor(
                cfg, copy.deepcopy(model), batch_size=self.batch_size // n,
                max_instances=max_instances, stop_params=stop_params,
                device=rank_device(i, self.device), dtype=dtype,
                sync_rounds=sync_rounds, staged=staged,
                staged_margin=staged_margin) for i in range(1, n)]
        self.model = model.to(self.device).to_inference(dtype)
        self.group = max(int(cfg.decoder.extract_group), 1)
        k_static = max_instances or cfg.data.max_n_objects
        self.max_rounds = -(-k_static // self.group)
        # over this predictor's life: extraction rounds run, host syncs of
        # the round dispatch (done / budget readbacks), and each distinct
        # round count a staged chunk was asked for
        self.rounds_run = 0
        self.host_syncs = 0
        self.round_chunks = set()

    def _compute(self):
        """The numerics of the predictor's dtype around a model call."""
        return tf32_off() if self.dtype == torch.float32 else contextlib.nullcontext()

    @staticmethod
    def _standardize(images_u8: torch.Tensor) -> torch.Tensor:
        x = image_ex_standardize(images_u8).permute(0, 3, 1, 2)
        return x.contiguous(memory_format=torch.channels_last)

    @torch.no_grad()
    def _infer_full(self, images_u8: torch.Tensor):
        """Monolithic dispatch: (sem_probs, idmap, counts)."""
        with self._compute():
            sem_probs, sem_mask, budget, score, partials = (
                self.model.infer_prep(self._standardize(images_u8),
                                      max_instances=self.max_instances))
            idmap, counts, _, rounds = self.model.decoder.extract_rounds(
                sem_mask, score, partials, max_instances=self.max_instances,
                count_budget=budget, n_rounds=self.max_rounds,
                stop_params=self.stop_params, sync_rounds=self.sync_rounds,
            )
        self.rounds_run += rounds
        if self.sync_rounds:
            # one done readback before each round; none after the last
            # round of the budget
            self.host_syncs += min(rounds + 1, self.max_rounds)
        return sem_probs, idmap, counts

    # ---------------------- staged extraction -------------------------

    @torch.no_grad()
    def _infer_prep(self, images_u8: torch.Tensor):
        """Stage A of the staged dispatch: (fg (B, H, W) uint8, sem_mask,
        budget (B,) int32, score, conv1 partials); the budget is the one
        value the host reads before the rounds."""
        with self._compute():
            sem_probs, sem_mask, budget, score, partials = (
                self.model.infer_prep(self._standardize(images_u8),
                                      max_instances=self.max_instances))
        fg = sem_probs.argmax(dim=1).to(torch.uint8)
        return fg, sem_mask, budget, score, partials

    @torch.no_grad()
    def _rounds(self, n_rounds: int, prep, carry):
        """Stage B: exactly ``n_rounds`` extraction rounds from ``carry``
        (None: the start), no host sync.  -> (idmap uint8, counts int32,
        carry)."""
        self.round_chunks.add(n_rounds)
        _, sem_mask, budget, score, partials = prep
        with self._compute():
            idmap, counts, carry, rounds = self.model.decoder.extract_rounds(
                sem_mask, score, partials, max_instances=self.max_instances,
                count_budget=budget, n_rounds=n_rounds,
                stop_params=self.stop_params, sync_rounds=False,
                carry_in=carry,
            )
        self.rounds_run += rounds
        return idmap.to(torch.uint8), counts.to(torch.int32), carry

    def _extract_staged(self, preps, margin: int):
        """Stage B over a window of prepped batches: one readback of all
        the budgets; each batch's first chunk runs the rounds its budget
        asks for plus ``margin``; then 2-round chunks for the batches that
        still have a live sample, with one readback of their all-done flags
        per chunk, until every sample is done or the static round budget is
        spent.  The outputs are the monolithic dispatch's.
        -> [(fg, idmap, counts)] per batch."""
        budgets = torch.stack([pr[2] for pr in preps]).cpu()  # one readback
        self.host_syncs += 1
        states = [{
            "prep": pr, "carry": None, "used": 0, "out": None,
            "n": min(max(-(-int(bud.max()) // self.group) + margin, 1),
                     self.max_rounds),
        } for pr, bud in zip(preps, budgets)]
        live = list(range(len(states)))
        while live:
            for i in live:
                st = states[i]
                step_n = min(st["n"], self.max_rounds - st["used"])
                idmap, counts, st["carry"] = self._rounds(step_n, st["prep"],
                                                          st["carry"])
                st["out"] = (st["prep"][0], idmap, counts)
                st["used"] += step_n
                st["n"] = 2
            still = [i for i in live if states[i]["used"] < self.max_rounds]
            if not still:
                break
            dones = torch.stack([states[i]["carry"]["done"].all()
                                 for i in still]).cpu()  # one readback
            self.host_syncs += 1
            live = [i for i, d in zip(still, dones.tolist()) if not d]
        return [st["out"] for st in states]

    def _infer_staged(self, images_u8: torch.Tensor):
        """One batch through the staged dispatch -> (fg, idmap, counts)."""
        return self._extract_staged([self._infer_prep(images_u8)], 0)[0]

    def predict_batches_staged(self, xs: Sequence, packed: bool = False):
        """The staged dispatch over a window of batches (each (B, H, W, 3)
        uint8): every batch's prep, then :meth:`_extract_staged` with
        ``staged_margin`` extra rounds in each first chunk (cheaper than a
        continuation's readback when a glimpse or two miss).  Outputs equal
        the monolithic dispatch's.

        Returns a list of (fg, idmap, counts) device tensors; with
        ``packed`` a list of (packed uint8, counts) pairs."""
        outs = self._extract_staged(
            [self._infer_prep(self._to_device(x)) for x in xs],
            int(self.staged_margin))
        if packed:
            return [(pack_masks(fg, idmap), counts) for fg, idmap, counts in outs]
        return outs

    # ------------------------------------------------------------------
    def _to_device(self, images_u8) -> torch.Tensor:
        x = images_u8 if torch.is_tensor(images_u8) else torch.from_numpy(
            np.ascontiguousarray(images_u8))
        if x.dtype != torch.uint8 or x.dim() != 4 or x.shape[-1] != 3:
            raise ValueError("images must be (B, H, W, 3) uint8")
        return x.to(self.device, non_blocking=True)

    def _over_replicas(self, local, images_u8):
        """``local(replica, shard)`` for each replica on its contiguous
        shard of the batch, one after another; the outputs (tuples of
        tensors or None) concatenated in order on this predictor's
        device."""
        n = len(self.replicas)
        if n == 1:
            return local(self, images_u8)
        b = images_u8.shape[0]
        if b % n:
            raise ValueError(f"batch of {b} does not divide over {n} replicas")
        per, outs = b // n, []
        with self._compute():
            for i, rep in enumerate(self.replicas):
                on = (torch.cuda.device(rep.device)
                      if rep.device.type == "cuda" else contextlib.nullcontext())
                with on:
                    outs.append(local(rep, images_u8[i * per:(i + 1) * per]))
        return tuple(None if parts[0] is None else
                     torch.cat([t.to(self.device) for t in parts])
                     for parts in zip(*outs))

    def predict_batch_arrays(self, images_u8, with_probs: bool = True):
        """images_u8 (B, H, W, 3) uint8 -> (sem_probs, fg, idmap, counts) on
        the device, as the JAX package's predictor returns them: with
        ``with_probs`` sem_probs (B, H, W, 2) float32, fg (B, H, W) uint8,
        idmap (B, H, W) int32 and counts (B,) int32 (always the monolithic
        dispatch); without, (None, fg uint8, idmap uint8, counts int32),
        staged when the predictor is.  Split over the replicas under a
        mesh."""
        return self._over_replicas(
            lambda rep, x: rep._batch_arrays(x, with_probs), images_u8)

    def _batch_arrays(self, images_u8, with_probs: bool):
        x = self._to_device(images_u8)
        if not with_probs and self.staged:
            fg, idmap, counts = self._infer_staged(x)
            return None, fg, idmap, counts
        sem_probs, idmap, counts = self._infer_full(x)
        fg = sem_probs.argmax(dim=1).to(torch.uint8)
        counts = counts.to(torch.int32)
        if with_probs:
            probs = sem_probs.permute(0, 2, 3, 1).to(torch.float32)
            return probs, fg, idmap.to(torch.int32), counts
        return None, fg, idmap.to(torch.uint8), counts

    def predict_batch_packed(self, images_u8):
        """(packed (B, H, W) uint8, counts (B,) int32) on the device — one
        mask plane per batch (:func:`pack_masks`); staged when the
        predictor is; split over the replicas under a mesh."""
        return self._over_replicas(lambda rep, x: rep._batch_packed(x),
                                   images_u8)

    def _batch_packed(self, images_u8):
        x = self._to_device(images_u8)
        if self.staged:
            fg, idmap, counts = self._infer_staged(x)
            return pack_masks(fg, idmap), counts
        sem_probs, idmap, counts = self._infer_full(x)
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
        return np.array(img), np.array(resized, np.uint8), (h, w)

    @staticmethod
    def _upsample_nearest(arr: np.ndarray, hw) -> np.ndarray:
        from PIL import Image

        return np.array(Image.fromarray(arr).resize((hw[1], hw[0]),
                                                    Image.NEAREST))

    def _results(self, chunk, raws, sizes, n_valid, packed, counts):
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

    def predict_paths(self, paths: Sequence[str], window: int = 8
                      ) -> Iterator[Dict]:
        """Yields per image: dict(path, image, fg_mask (native res, {0,1}
        uint8), ins_mask (native res ids, uint8), n_objects).

        A staged predictor dispatches ``window`` batches at a time
        (:meth:`predict_batches_staged`), unless it has a mesh; the
        monolithic one a batch at a time."""
        bs = self.batch_size
        starts = list(range(0, len(paths), bs))
        win = window if self.staged and len(self.replicas) == 1 else 1
        for ws in range(0, len(starts), win):
            metas, xs = [], []
            for start in starts[ws:ws + win]:
                chunk = list(paths[start:start + bs])
                n_valid = len(chunk)
                chunk += [chunk[-1]] * (bs - n_valid)
                raws, resized, sizes = zip(*[self._load(p) for p in chunk])
                metas.append((chunk, raws, sizes, n_valid))
                xs.append(np.stack(resized))
            if win > 1:
                outs = self.predict_batches_staged(xs, packed=True)
            else:
                outs = [self.predict_batch_packed(x) for x in xs]
            for meta, (packed, counts) in zip(metas, outs):
                yield from self._results(*meta, packed, counts)

    # ---------------- mixed-resolution bucketed inference ----------------

    @staticmethod
    def _bucket_shape(h: int, w: int, multiple: int = 64,
                      cap: int = 1024) -> Tuple[int, int]:
        """A native size rounded up to the bucket grid: multiples of
        ``multiple`` (the UNet downsamples 16x), capped at ``cap``."""
        bh = min(int(-(-h // multiple)) * multiple, cap)
        bw = min(int(-(-w // multiple)) * multiple, cap)
        return max(bh, multiple), max(bw, multiple)

    def predict_paths_bucketed(self, paths: Sequence[str], multiple: int = 64,
                               cap: int = 1024) -> Iterator[Dict]:
        """Mixed-resolution inference without the fixed-size resize: each
        image is zero-padded onto the canvas of its shape bucket (native
        size rounded up to ``multiple``, at most ``cap``; a larger image is
        downscaled onto it, bilinear), each bucket runs in batches of
        ``batch_size`` through :meth:`predict_batch_packed` (so staged when
        the predictor is), and the masks are cropped back to the native
        size (nearest-upsampled for a downscaled image): pixel-aligned with
        the input.  Yields the results in the order of ``paths``."""
        from PIL import Image

        items = []
        for i, p in enumerate(paths):
            img = np.array(Image.open(p).convert("RGB"))
            h, w = img.shape[:2]
            items.append((i, p, img, (h, w),
                          self._bucket_shape(h, w, multiple, cap)))
        buckets: Dict[Tuple[int, int], List] = {}
        for it in items:
            buckets.setdefault(it[4], []).append(it)

        results: List[Optional[Dict]] = [None] * len(items)
        bs = self.batch_size
        for (bh, bw), group in buckets.items():
            for start in range(0, len(group), bs):
                chunk = group[start:start + bs]
                canvas = np.zeros((bs, bh, bw, 3), np.uint8)
                for j, (_, _, img, (h, w), _) in enumerate(chunk):
                    sh, sw = min(h, bh), min(w, bw)
                    if h > bh or w > bw:
                        # downscale, never crop: a crop would predict on a
                        # corner and stretch its masks over the image
                        img = np.array(Image.fromarray(img).resize(
                            (sw, sh), Image.BILINEAR))
                    canvas[j, :sh, :sw] = img[:sh, :sw]
                packed, counts = self.predict_batch_packed(canvas)
                fg, idmap = unpack_masks(packed.cpu().numpy())
                counts = counts.cpu().numpy()
                for j, (i, p, img, (h, w), _) in enumerate(chunk):
                    fg_j = fg[j, :min(h, bh), :min(w, bw)]
                    id_j = idmap[j, :min(h, bh), :min(w, bw)]
                    if fg_j.shape != (h, w):  # capped bucket: upsample back
                        fg_j = self._upsample_nearest(fg_j, (h, w))
                        id_j = self._upsample_nearest(
                            id_j.astype(np.int32), (h, w)).astype(np.uint8)
                    results[i] = {"path": p, "image": img, "fg_mask": fg_j,
                                  "ins_mask": id_j,
                                  "n_objects": int(counts[j])}
        yield from results

    # ---------------- single-image paths ----------------

    def predict_attend(self, path: str) -> Dict:
        """The attention decoder's own masks for one image (the batched
        path's result, as :meth:`predict_paths` yields it)."""
        return next(iter(self.predict_paths([path])))

    @torch.no_grad()
    def predict_cluster(self, path: str, seed: int = 0) -> Dict:
        """The clustering path: the instance embeddings of the predicted
        foreground pixels (with coordinate planes under
        ``cfg.model.use_coordinates``) KMeans'd on the device
        (``runtime/cluster.py``) into the model's count estimate of
        clusters (``ReSeg.embed``), clipped to 1..max_n_objects; the seeds
        drawn from a generator seeded with ``seed``.  -> dict(path, image,
        fg_mask, ins_mask, n_objects) at native resolution."""
        from tpuseg_torch.nn.coord_conv import add_coordinates
        from tpuseg_torch.runtime.cluster import kmeans_cluster

        raw, resized, size = self._load(path)
        max_n = self.cfg.data.max_n_objects
        with self._compute():
            sem_probs, emb, n_est = self.model.embed(
                self._standardize(self._to_device(resized[None])))
            fg = sem_probs[0].argmax(dim=0)
            emb0 = emb[:1].float()
            if self.cfg.model.use_coordinates:
                emb0 = add_coordinates(emb0, with_r=True)
            n = n_est[0].clamp(1, max_n)
            gen = torch.Generator(device=self.device).manual_seed(seed)
            ids, _ = kmeans_cluster(emb0[0].permute(1, 2, 0), fg, n, gen,
                                    max_clusters=max_n)
        return {
            "path": path,
            "image": raw,
            "fg_mask": self._upsample_nearest(
                fg.cpu().numpy().astype(np.uint8), size),
            "ins_mask": self._upsample_nearest(
                ids.cpu().numpy().astype(np.int32), size).astype(np.uint8),
            "n_objects": int(n),
        }

    @torch.no_grad()
    def predict_semantic(self, path: str) -> Dict:
        """Semantic-only single-image path: dict(image, fg_prob (native
        res float32, nearest-upsampled))."""
        raw, resized, size = self._load(path)
        with self._compute():
            probs = self.model.semantic(
                self._standardize(self._to_device(resized[None])))
        fg_prob = probs[0, 1].float().cpu().numpy()
        return {"image": raw, "fg_prob": self._upsample_nearest(fg_prob, size)}
