"""Entry ``infer``: batched inference as ``pred_list`` runs it.

``Predictor.predict_batch_packed`` with the monolithic dispatch, the
calibrated stopping rule and the default ``sync_rounds``, in the
configuration's dtype, in a closed loop of one stream: each batch is
uploaded from host ``uint8`` and its packed masks and counts are read
back to the host before the next is sent.

Cell parameters: ``batch`` (images a batch), ``distinct_batches`` (the
batches the seed draws; the window cycles through them), ``check_batches``
(how many of them the reference checks), ``trace_batches`` (batches in
the traced window).
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from segbench import compare, program, traffic
from segbench.trace import WINDOW, summarize, traced


class Run:
    def __init__(self, cell: Dict, seed: int, device: torch.device):
        from tpuseg_torch.runtime.predict import Predictor
        from tpuseg_torch.utils.checkpoint_io import load_stop_params

        p = cell["params"]
        conf = cell["configuration"]
        self.cell, self.seed, self.device = cell, seed, device
        self.batch = int(p["batch"])
        mix = cell["mix"]
        if mix.get("canvas", [mix["scene"]["height"],
                              mix["scene"]["width"]]) != conf["canvas"]:
            raise ValueError("the mix's canvas is not the configuration's")
        self.batches = traffic.make_batches(mix, seed, self.batch,
                                            int(p["distinct_batches"]))
        self.cfg, model = program.load(conf, device)
        self.predictor = Predictor(
            self.cfg, model, batch_size=self.batch, device=device,
            dtype=program.DTYPES[conf["dtype"]],
            stop_params=load_stop_params(program.path(conf["stop_params"])))
        self.outputs: Dict[int, tuple] = {}
        self.refs: Dict[str, object] = {}

    def _call(self, i: int):
        packed, counts = self.predictor.predict_batch_packed(
            self.batches[i]["images"])
        packed, counts = packed.cpu().numpy(), counts.cpu().numpy()
        self.outputs[i] = (packed, counts)

    def warm(self) -> None:
        """Every shape the window uses: two batches."""
        for i in range(min(2, len(self.batches))):
            self._call(i)
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def window(self, seconds: float) -> Dict[str, float]:
        """The closed loop for ``seconds``; the last batch ends it."""
        lat: List[float] = []
        n = len(self.batches)
        t0 = time.perf_counter()
        k = 0
        while time.perf_counter() - t0 < seconds:
            t = time.perf_counter()
            self._call(k % n)
            lat.append(time.perf_counter() - t)
            k += 1
        elapsed = time.perf_counter() - t0
        return {"infer_img_per_s": k * self.batch / elapsed,
                "infer_batch_p95_ms": 1e3 * float(
                    np.quantile(lat, 0.95, method="higher")),
                "batches": k}

    def traced_window(self) -> Dict:
        """The traced window: ``trace_batches`` batches under the
        profiler, with the program's counters read around it."""
        from tpuseg_torch.kernels import ir_chain

        n = int(self.cell["params"]["trace_batches"])
        rounds0, launches0 = self.predictor.rounds_run, ir_chain.ir_chain.launches
        with traced() as tr:
            with torch.profiler.record_function(WINDOW):
                for k in range(n):
                    self._call(k % len(self.batches))
        summary = summarize(tr["events"])
        return {"summary": summary, "batches": n, "images": n * self.batch,
                "rounds": self.predictor.rounds_run - rounds0,
                "ir_chain_launches": ir_chain.ir_chain.launches - launches0,
                "dtype": self.cell["configuration"]["dtype"]}

    def release(self) -> None:
        """Frees the program's state before the reference runs."""
        self.predictor = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check_sample(self) -> List[int]:
        """The batches the check compares: every batch of the seeded pool
        that the window ran, then others drawn from the seed, up to
        ``check_batches``."""
        rng = np.random.default_rng([int(self.seed), 2])
        n = min(int(self.cell["params"]["check_batches"]), len(self.outputs))
        ran = sorted(self.outputs)
        first = [i for i in ran if self.batches[i]["seeded"].all()][:n]
        rest = [i for i in ran if i not in first]
        more = rng.choice(rest, n - len(first), replace=False).tolist()
        return sorted(first + [int(i) for i in more])

    def _reference(self, dtype: str = "float32"):
        """The reference in ``dtype``, built once a run."""
        from segbench.reference.plain import Inference

        if dtype not in self.refs:
            conf = self.cell["configuration"]
            self.refs[dtype] = Inference(
                conf["config"], program.path(conf["checkpoint"]),
                program.path(conf["stop_params"]), self.device,
                dtype=program.DTYPES[dtype])
        return self.refs[dtype]

    def reference_outputs(self, sample: List[int], dtype: str = "float32",
                          control: bool = False) -> List[tuple]:
        """The reference's (fg, idmap, counts) of each sampled batch, in
        ``dtype``; with ``control``, with float8 products."""
        ref = self._reference(dtype)
        out = []
        for i in sample:
            images = self.batches[i]["images"]
            if control:
                with compare.fp8_products():
                    out.append(ref(images))
            else:
                out.append(ref(images))
        return out

    def program_outputs(self, sample: List[int]) -> List[tuple]:
        """The program's last (fg, idmap, counts) of each sampled batch."""
        from tpuseg_torch.runtime.predict import unpack_masks

        out = []
        for i in sample:
            packed, counts = self.outputs[i]
            fg, idmap = unpack_masks(packed)
            out.append((fg, idmap, counts))
        return out

    def check(self, control: bool = False) -> Dict[str, float]:
        """The program's last outputs of the sampled batches against the
        reference's (with ``control``: the reference with float8 products
        in the program's place)."""
        sample = self.check_sample()
        plain = self.reference_outputs(sample)
        side = (self.reference_outputs(sample, control=True) if control
                else self.program_outputs(sample))
        return compare.infer_numbers(side, plain)

    def work(self, traced: Dict) -> Dict:
        """The operations of the traced window from the frozen count, and
        the ``ir_chain`` calls' least time."""
        from segbench.count import flops, peaks

        ref = self._reference()
        w = flops.infer_work(ref, self.batches[0]["images"][0])
        b, rounds = self.batch, traced["rounds"]
        chain_s = sum(peaks.chain_bound_s(n * b, h, wd, c, traced["dtype"],
                                          skip)
                      for n, h, wd, c, skip in w["round_chains"]) * rounds
        return {"flops": traced["batches"] * b * w["prep_flops"]
                + rounds * b * w["round_flops"],
                "chain_bound_s": chain_s,
                "chain_calls": rounds * len(w["round_chains"])}
