"""The port stands alone: importing every ``tpuseg_torch`` module pulls in
no JAX, flax, msgpack, PIL or ``tpuseg`` module, and its entry points run
on the card unless asked for the CPU."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, pkgutil, sys
import tpuseg_torch
names = [m.name for m in pkgutil.walk_packages(tpuseg_torch.__path__,
                                                "tpuseg_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack",
                           "PIL", "tpuseg")
)
print(json.dumps({"imported": names, "bad": bad}))
"""


def test_port_imports_nothing_of_jax_or_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
        text=True, timeout=120, check=True,
    )
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "tpuseg_torch.runtime.predict" in res["imported"]
    assert "tpuseg_torch.cli.pred_list" in res["imported"]
    # the training slice's modules are walked too
    for name in ("kernels.masked_softmax", "losses.dice", "losses.focal",
                 "runtime.train", "runtime.state", "runtime.loop",
                 "runtime.checkpoint", "runtime.metrics_log"):
        assert f"tpuseg_torch.{name}" in res["imported"], name
    # and the SRU slice's
    for name in ("nn.sru", "kernels.sru_scan"):
        assert f"tpuseg_torch.{name}" in res["imported"], name
    # and the root-CLI slice's: records, the data pipeline, the CLIs
    for name in ("data.records", "data.eval_asset", "data.dataset",
                 "data.loader", "data.augment", "data.device_aug",
                 "data.scripts.prepare", "cli.evaluate", "cli.train",
                 "settings"):
        assert f"tpuseg_torch.{name}" in res["imported"], name
    assert res["bad"] == []


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable here")
    from tpuseg_torch.configs import cvppp_config
    from tpuseg_torch.runtime.predict import Predictor

    class _Unused:
        def to(self, *a, **k):  # never reached: the device check comes first
            raise AssertionError("model touched before the device check")

    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(cvppp_config(), _Unused())
    from tpuseg_torch.cli.pred_list import main

    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--lst", "unused.txt", "--model", "unused.msgpack",
              "--dataset", "CVPPP"])
    # the training entry point: the state is where the device is chosen
    from tpuseg_torch.runtime.state import create_train_state

    with pytest.raises(RuntimeError, match="CUDA"):
        create_train_state(cvppp_config(), _Unused())
    # the root CLIs of the slice that reads records and scores predictions
    from tpuseg_torch.cli import evaluate, train

    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate.main(["--pred_dir", "unused", "--dataset", "CVPPP"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--dataset", "CVPPP"])


def test_kernel_wrappers_do_not_fall_back_off_the_cpu():
    """A wrapper takes its plain version only for a CPU tensor; any other
    device launches the kernel or raises (here: a ``meta`` tensor)."""
    from tpuseg_torch.kernels.masked_softmax import masked_softmax

    with pytest.raises(ValueError, match="unsupported device"):
        masked_softmax(torch.zeros(1, 8, device="meta"),
                       torch.zeros(1, 2, 8, device="meta"))


def test_sru_takes_the_plain_path_only_for_cpu_tensors():
    """Without CUDA, ``SRU`` on CPU tensors runs the plain loop (no launch
    counted, the same numbers as ``sru_recurrence`` layer by layer); the
    kernel wrapper raises on a tensor that is not on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: CUDA tensors take the kernels here")
    from tpuseg_torch.kernels.sru_scan import sru_scan
    from tpuseg_torch.nn import SRU, sru_recurrence

    stack = SRU(4, 3, num_layers=2, bidirectional=True,
                generator=torch.Generator().manual_seed(0))
    x = torch.randn(5, 2, 4, generator=torch.Generator().manual_seed(1))
    before = sru_scan.launches
    h, c = stack(x)
    assert sru_scan.launches == before
    want = x
    for cell in (stack.cell0, stack.cell1):
        u = (want.reshape(-1, cell.n_in) @ cell.weight).reshape(5, 2, -1)
        want, _ = sru_recurrence(u, want, cell.weight_c, cell.bias, d=3,
                                 bidirectional=True, scale_x=cell.scale_x)
    assert torch.equal(h, want) and c.shape == (2, 2, 6)
    meta = {"device": "meta"}
    with pytest.raises(ValueError, match="unsupported device"):
        sru_scan(torch.zeros(5, 2, 24, **meta), torch.zeros(5, 2, 4, **meta),
                 torch.zeros(12, **meta), torch.zeros(12, **meta), d=3,
                 bidirectional=True)
