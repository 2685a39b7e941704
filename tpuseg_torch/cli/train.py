"""Training CLI (port of ``tpuseg/cli/train.py``).

    python -m tpuseg_torch.cli.train --dataset CVPPP --train_data <records> \
        --val_data <records> [--batchsize 2] [--nepochs 600] [--bf16]

Same flags as the JAX CLI.  Makes a run directory
``<runs_dir>/<dataset>/<run id>`` holding ``config.json`` (the effective
config), ``training.log``, ``validation.log``, ``metrics.jsonl`` and the
best-validation checkpoints; seeds Python, numpy and torch from the
config's seed; reads packed records (or an LMDB) through ``AlignCollate``
and a ``PrefetchLoader``; and runs ``fit`` on the card (``--device cuda``,
the default).  ``--model`` resumes a train state that ``fit`` saved, step
count and schedule included.  ``--bf16`` runs the model under bfloat16
autocast.  ``--device_aug`` moves the flips, rot90 and photometric
transforms into the step, on the card, and keeps only the transforms whose
output shape depends on the draw in the host collate.

After each epoch's train loop the CLI prints the loop's steps/s with the
loader included, and the share of that wall time the loop spent waiting
for the ``PrefetchLoader``.

``--debug`` prints the cost every 10 steps and writes the debug images of
a single-glimpse forward every 40 train steps under ``<run_dir>/debug``.
``--live`` prints sparklines of every metric after each epoch;
``--tensorboard`` writes the metrics under ``<run_dir>/tb``.

``--ndevices N`` (0: every card) trains data-parallel over N ranks
(``parallel.run_ranks``): the run directory is made here, before the
ranks start; each rank reads the same loader order from the same seed and
takes its slice of every global batch of ``--batchsize``; ``--model``
resumes on rank 0, which ``fit`` broadcasts; rank 0 logs and saves.  NCCL
when every rank has its own card, else gloo (ranks sharing a card, or
``--device cpu``).  The run has no deadline: a rank that dies ends it at
once, and a rank whose collective waits ``CLI_COLLECTIVE_TIMEOUT_S`` for a
peer fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import getpass
import json
import os
import random
import time

import numpy as np
import torch

from tpuseg_torch import resolve_device
from tpuseg_torch.data.dataset import AlignCollate
from tpuseg_torch.data.loader import PrefetchLoader
from tpuseg_torch.data.records import open_dataset
from tpuseg_torch.models import ReSeg
from tpuseg_torch.parallel.mesh import run_ranks
from tpuseg_torch.parallel.tasks import kernel_launches
from tpuseg_torch.runtime.checkpoint import restore_checkpoint
from tpuseg_torch.runtime.loop import fit
from tpuseg_torch.runtime.state import create_train_state
from tpuseg_torch.settings import default_data_paths, get_config


# the longest the other ranks wait at a collective for a peer: rank 0
# alone writes the logs, the checkpoints and the debug dumps while they
# wait at the epoch's barrier
CLI_COLLECTIVE_TIMEOUT_S = 1800.0


def generate_run_id() -> str:
    """Reference train.py:46-56 format: date_time_user_random."""
    username = getpass.getuser()
    now = datetime.datetime.now()
    date = f"{now.year}-{now.month}-{now.day}"
    clock = now.time().replace(microsecond=0).isoformat().replace(":", "-")
    return f"{date}_{clock[:5]}_{username}_{clock[3:]}-{random.randint(0, 10000)}"


def _parser():
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="",
                   help="checkpoint of a previous run to resume from")
    p.add_argument("--usegpu", action="store_true",
                   help="kept for CLI parity; the card is the default device")
    p.add_argument("--nepochs", type=int, default=600)
    p.add_argument("--batchsize", type=int, default=2)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--nworkers", type=int, default=2)
    p.add_argument("--dataset", type=str, required=True)
    p.add_argument("--train_data", default="",
                   help="packed-record prefix (or LMDB dir) for training")
    p.add_argument("--val_data", default="")
    p.add_argument("--runs_dir", default="models")
    p.add_argument("--ndevices", type=int, default=1,
                   help="data-parallel ranks (0 = every card); the global "
                        "batch is split over them")
    p.add_argument("--live", action="store_true",
                   help="terminal sparkline plots per metric")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 autocast for the train step (parameters "
                        "and optimizer stay float32)")
    p.add_argument("--tensorboard", action="store_true",
                   help="TensorBoard scalars under <run_dir>/tb")
    p.add_argument("--device_aug", action="store_true",
                   help="flips, rot90 and the photometric transforms on "
                        "the device inside the train step; the host collate "
                        "keeps the rest")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the plain PyTorch path")
    return p


class _LoaderClock:
    """Wraps an epoch's batch iterator: the time ``fit`` waits in
    ``next()`` (the first batch's wait apart: nothing runs while it is
    built) and the loop's wall time from the first request to the end of
    the last step (the device synchronised there)."""

    def __init__(self, device: torch.device, verbose: bool = True):
        self.device = device
        self.verbose = verbose
        self.epochs = []

    def __call__(self, batches):
        waits, t0 = [], time.perf_counter()
        it = iter(batches)
        while True:
            t = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                break
            waits.append(time.perf_counter() - t)
            yield batch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        n, wait = len(waits), sum(waits)
        first = waits[0] if waits else 0.0
        self.epochs.append({"steps": n, "wall_s": wall, "loader_wait_s": wait,
                            "first_batch_wait_s": first})
        if not self.verbose:
            return
        print(f"  train loop: {n} steps in {wall:.2f} s, "
              f"{n / max(wall, 1e-9):.3f} steps/s with the loader; waited "
              f"{wait:.2f} s ({100 * wait / max(wall, 1e-9):.1f}%) for the "
              f"PrefetchLoader, {first:.2f} s of it for the first batch")


def main(argv=None) -> dict:
    """Returns ``run_dir``, the final ``step``, per epoch the train loop's
    ``steps``, ``wall_s``, ``loader_wait_s`` and ``first_batch_wait_s``,
    and the kernel ``launches`` of the run (rank 0's under ``--ndevices``,
    with every rank's in ``rank_launches``)."""
    opt = _parser().parse_args(argv)
    device = resolve_device(opt.device)
    n_dev = opt.ndevices or (torch.cuda.device_count()
                             if device.type == "cuda" else 1)

    cfg = get_config(opt.dataset)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=opt.batchsize, n_epochs=opt.nepochs))
    run_dir = os.path.join(opt.runs_dir, opt.dataset, generate_run_id())
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)
    print(f"run dir: {run_dir}")
    if n_dev == 1:
        return _train(None, opt, cfg, run_dir, device)
    if device.type == "cuda":
        # one build before the ranks start: they would race on _build/
        from tpuseg_torch.kernels import build

        build.build()
    # no deadline for the run; a rank that dies ends it at once
    ranks = run_ranks(_train, n_dev, (opt, cfg, run_dir, device.type),
                      device=device.type, timeout=None,
                      collective_timeout=CLI_COLLECTIVE_TIMEOUT_S)
    return dict(ranks[0], rank_launches=[r["launches"] for r in ranks])


def _train(mesh, opt, cfg, run_dir: str, device) -> dict:
    """The run after its directory exists: one process, or rank
    ``mesh.rank`` of a data-parallel run."""
    lead = mesh is None or mesh.rank == 0
    if mesh is not None:
        device = mesh.device
    seed = cfg.train.seed
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)

    train_path, val_path = default_data_paths(cfg, opt.dataset)
    train_ds = open_dataset(opt.train_data or train_path)
    val_ds = open_dataset(opt.val_data or val_path)
    if lead:
        print(f"train: {len(train_ds)} samples, val: {len(val_ds)} samples")

    bs = cfg.train.batch_size
    if opt.device_aug:
        d = cfg.data
        host_kept = [n for n, on in (("resolution", d.resolution),
                                     ("rotation", d.rotation),
                                     ("center_cut", d.center_cut)) if on]
        train_collate = AlignCollate("training_host_only", cfg.data, bs)
        if lead:
            print("--device_aug: D4 + photometric run on device; host "
                  f"collate keeps {host_kept or 'no'} dynamic-shape "
                  "transform(s)")
    else:
        train_collate = AlignCollate("training", cfg.data, bs)
    train_loader = PrefetchLoader(train_ds, train_collate, bs, shuffle=True,
                                  seed=seed, n_workers=opt.nworkers)
    val_loader = PrefetchLoader(val_ds, AlignCollate("test", cfg.data, bs),
                                bs, shuffle=False, seed=seed,
                                n_workers=opt.nworkers)

    state = create_train_state(cfg, ReSeg(cfg), device=device)
    if opt.model and lead:
        state = restore_checkpoint(opt.model, state)
        print(f"resumed from {opt.model} at step {state.step}")

    before = kernel_launches()
    clock = _LoaderClock(device, verbose=lead)
    state = fit(
        cfg, state.model, state,
        lambda epoch: clock(train_loader.epoch(epoch)),
        val_loader.epoch, run_dir, n_epochs=opt.nepochs,
        log_every=10 if opt.debug else 0, mesh=mesh,
        live=opt.live, tensorboard=opt.tensorboard,
        debug_dir=os.path.join(run_dir, "debug") if opt.debug else None,
        device_aug=opt.device_aug,
        dtype=torch.bfloat16 if opt.bf16 else None,
    )
    return {"run_dir": run_dir, "step": state.step, "epochs": clock.epochs,
            "launches": {k: v - before[k]
                         for k, v in kernel_launches().items()}}


if __name__ == "__main__":
    main()
