"""The port stands alone: importing every ``tpuseg_torch`` module pulls in
no JAX, flax, msgpack, PIL or ``tpuseg`` module, and its entry points run
on the card unless asked for the CPU."""

import ast
import importlib
import json
import subprocess
import sys
import types
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
    # and the inference entry points' slice: pred, clustering, debug dumps
    for name in ("cli.pred", "runtime.cluster", "nn.coord_conv",
                 "utils.debug_images"):
        assert f"tpuseg_torch.{name}" in res["imported"], name
    # and the data-parallel slice's: the mesh layer, its rank tasks,
    # tracing, validation and the losses off the training path
    for name in ("parallel", "parallel.mesh", "parallel.tasks",
                 "utils.tracing", "utils.validation", "losses.lovasz"):
        assert f"tpuseg_torch.{name}" in res["imported"], name
    # and the spatial slice's
    assert "tpuseg_torch.parallel.spatial" in res["imported"]
    # and the capability modules'
    for name in ("nn.native", "nn.aspp", "nn.transformer", "nn.embedding",
                 "nn.conv_gru", "nn.hourglass", "nn.vgg16", "nn.dqn",
                 "nn.dcgan_decoder", "models.attenet_legacy", "losses.mmd",
                 "losses.discriminative", "decoder.pn_losses",
                 "runtime.wae"):
        assert f"tpuseg_torch.{name}" in res["imported"], name
    assert res["bad"] == []


def _all_of(path: Path):
    """The names in a module's ``__all__``, read as text (no import)."""
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"{path} has no __all__")


def test_the_port_has_every_module_and_export_of_the_jax_package():
    """Every module file of ``tpuseg/`` has its counterpart in
    ``tpuseg_torch/``, and the port's ``nn`` and ``losses`` export every
    name of the JAX package's (the JAX lists read as text)."""
    jax_files = {p.relative_to(REPO / "tpuseg")
                 for p in (REPO / "tpuseg").rglob("*.py")}
    port_files = {p.relative_to(REPO / "tpuseg_torch")
                  for p in (REPO / "tpuseg_torch").rglob("*.py")}
    assert sorted(map(str, jax_files - port_files)) == []
    for pkg in ("nn", "losses"):
        want = _all_of(REPO / "tpuseg" / pkg / "__init__.py")
        mod = importlib.import_module(f"tpuseg_torch.{pkg}")
        assert set(want) <= set(mod.__all__), set(want) - set(mod.__all__)
        for name in want:
            assert getattr(mod, name) is not None, name
    from tpuseg_torch.decoder.pyramid import window_origin_fg  # noqa: F401
    from tpuseg_torch.evalm.metrics import calc_bd  # noqa: F401
    from tpuseg_torch.nn import ChannelAttention, MobileV1ASPP  # noqa: F401


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


def test_other_inference_entry_points_default_to_cuda(tmp_path):
    """``pred`` (both modes) and ``pred_list --staged`` / ``--bucketed``
    raise without CUDA before they read or write anything; the staged
    predictor, and with it ``predict_cluster``, raise at construction."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable here")
    from tpuseg_torch.cli import pred, pred_list
    from tpuseg_torch.configs import cvppp_config
    from tpuseg_torch.runtime.predict import Predictor

    for extra in ([], ["--instances"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            pred.main(["--image", "unused.png", "--output",
                       str(tmp_path / "pred")] + extra)
    for flag in ("--staged", "--bucketed"):
        with pytest.raises(RuntimeError, match="CUDA"):
            pred_list.main(["--lst", "unused.txt", "--model",
                            "unused.msgpack", "--dataset", "CVPPP",
                            "--output", str(tmp_path / "pl"), flag])
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(cvppp_config(), None, staged=True)
    assert not any(tmp_path.iterdir())


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


def _stand_in_tensorflow():
    # the launcher tells TensorFlow's own JAX from the port's by this name
    sys.modules.setdefault("tensorflow", types.ModuleType("tensorflow"))


def _imports_jax_itself(mesh):
    _stand_in_tensorflow()
    import jax  # noqa: F401


def _tensorflow_loads_jax(mesh):
    _stand_in_tensorflow()
    importlib.import_module("jax")


@pytest.mark.parametrize("task", [_imports_jax_itself, _tensorflow_loads_jax])
def test_a_rank_that_imports_jax_fails_even_beside_tensorflow(task):
    """A rank whose own code imports JAX fails, TensorFlow loaded or not;
    JAX that TensorFlow (TensorBoard's backend) loads is not the port's."""
    from tpuseg_torch.parallel import run_ranks

    if task is _tensorflow_loads_jax:
        assert run_ranks(task, 1, device="cpu", timeout=120) == [None]
        return
    with pytest.raises(RuntimeError, match=r"imported \['jax \(by test_"):
        run_ranks(task, 1, device="cpu", timeout=120)
