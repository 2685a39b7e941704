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
    if m.split(".")[0] in ("jax", "jaxlib", "flax", "msgpack", "PIL", "tpuseg")
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
