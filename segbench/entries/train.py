"""Entry ``train``: the training step users run.

``make_train_step(cfg, model, dtype)`` on the checkpoint's weights, with
its Adadelta state, in the configuration's dtype (autocast; parameters
and optimizer in float32), keeping the sampling, dropout and remat of the
configuration.  One object is built, driven from the seed through its
first ``check_steps`` steps (the steps the reference follows, on rows
that all differ) and then timed: every step uploads a host batch and ends
with its metrics on the host.

Cell parameters: ``batch``, ``distinct_batches`` (the batches the seed
draws; the window cycles through them after the checked steps),
``check_steps``, ``trace_steps``.  The reference computes the checked
steps in the configuration's precision (bfloat16 autocast, parameters and
optimizer in float32), as the program does.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from segbench import compare, program, traffic
from segbench.trace import WINDOW, summarize, traced


class Run:
    def __init__(self, cell: Dict, seed: int, device: torch.device):
        from tpuseg_torch.runtime.state import create_train_state
        from tpuseg_torch.runtime.train import make_train_step

        p = cell["params"]
        conf = cell["configuration"]
        self.cell, self.seed, self.device = cell, seed, device
        self.batch = int(p["batch"])
        self.check_steps = int(p["check_steps"])
        self.cfg, model = program.load(conf, device, kernels=("masked_softmax",))
        self.batches = traffic.make_batches(
            cell["mix"], seed, self.batch, int(p["distinct_batches"]),
            max_n_objects=self.cfg.data.max_n_objects)
        self.state = create_train_state(self.cfg, model, device=device)
        self.step = make_train_step(self.cfg, model,
                                    train_cnn=self.cfg.train.train_cnn,
                                    dtype=program.DTYPES[conf["dtype"]])
        self.generator = torch.Generator(device=device).manual_seed(int(seed))
        self.params = list(model.parameters())
        self.k = 0
        self.first: Dict = {}

    def _step_batch(self, batch: Dict) -> Dict:
        return batch

    def _call(self) -> Dict[str, float]:
        batch = self._step_batch(self.batches[self.k % len(self.batches)])
        self.k += 1
        _, metrics = self.step(self.state, batch, self.generator)
        names = list(metrics)
        values = torch.stack([metrics[n].float() for n in names]).cpu()
        return dict(zip(names, values.tolist()))

    def warm(self) -> None:
        """The checked steps: their losses and loss terms, step 1's
        gradients as the optimizer got them, and each parameter's change
        over the steps."""
        from segbench.reference.plain import optimizer_grad_norms

        start = [p.detach().clone() for p in self.params]
        terms: List[Dict[str, float]] = []
        for i in range(self.check_steps):
            terms.append(self._call())
            if i == 0:
                grads = optimizer_grad_norms(self.state.optimizer,
                                             self.params)
        change = [float((p.detach() - s).norm())
                  for p, s in zip(self.params, start)]
        self.first = {"loss": [m["cost"] for m in terms], "terms": terms,
                      "grad_norms": grads, "change": change}
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def window(self, seconds: float) -> Dict[str, float]:
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < seconds:
            self._call()
            n += 1
        elapsed = time.perf_counter() - t0
        out = {"train_img_per_s": n * self.batch / elapsed, "steps": n}
        if self.device.type == "cuda":
            out["train_peak_mem_gib"] = (
                torch.cuda.max_memory_allocated(self.device) / 2 ** 30)
        return out

    def traced_window(self) -> Dict:
        n = int(self.cell["params"]["trace_steps"])
        with traced() as tr:
            with torch.profiler.record_function(WINDOW):
                for _ in range(n):
                    self._call()
        return {"summary": summarize(tr["events"]), "steps": n,
                "images": n * self.batch}

    def release(self) -> None:
        self.state = self.step = None
        self.params = []
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _checked_batches(self):
        return [self.batches[i] for i in range(self.check_steps)]

    def reference(self, dtype: str = "", control: bool = False) -> Dict:
        """The reference's checked steps from the same weights over the
        same batches and random draws, in ``dtype`` (default: the
        configuration's, as the program runs it); with ``control``, with
        float8 products."""
        from segbench.reference.plain import train_steps

        conf = self.cell["configuration"]
        dtype = dtype or conf["dtype"]
        args = (conf["config"], program.path(conf["checkpoint"]),
                self._checked_batches(), self.seed, self.device,
                program.DTYPES[dtype])
        if not control:
            return train_steps(*args)
        with compare.fp8_products():
            return train_steps(*args)

    def check(self, control: bool = False) -> Dict[str, float]:
        """The checked steps against the reference's (with ``control``:
        the reference with float8 products in the program's place)."""
        ref = self.reference()
        side = self.reference(control=True) if control else self.first
        return compare.train_numbers(side, ref)

    def work(self, traced: Dict) -> Dict:
        from segbench.count import flops

        conf = self.cell["configuration"]
        one = {k: v[:1] for k, v in self.batches[0].items()}
        f = flops.train_work(conf["config"], program.path(conf["checkpoint"]),
                             one, self.seed, self.device)
        return {"flops": traced["steps"] * self.batch * f}
