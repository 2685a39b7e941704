"""The port's root CLIs against the JAX package's.

* ``evaluate``: both CLIs score one prediction directory; the three means
  agree to 1e-6.
* ``pred_list --f32 --device cpu`` -> ``evaluate`` over the first images
  of the frozen ``assets/eval_hard64`` at full width with the committed
  checkpoint: counts and id-map hashes equal the JAX package's, as
  recorded in ``assets/eval_hard64_jax_f32.json``.
* ``train`` at a small configuration: a run directory with
  ``config.json``, the logs and a checkpoint; ``--model`` resumes from it
  and ``pred_list --model`` loads it.
* The ``slow`` test makes ``assets/eval_hard64_jax_f32.json`` again from
  the JAX package (all 64 images, f32, on the CPU: about 5 minutes) and
  compares it with the committed file.  ``python tests/test_torch_cli.py
  --write`` writes the file through the same function.
"""

import dataclasses
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
REFERENCE = REPO / "assets" / "eval_hard64_jax_f32.json"
CKPT = str(REPO / "assets" / "synthetic_ckpt.msgpack")
BATCH = 16
A1 = ("data", "raw", "CVPPP", "CVPPP2017_LSC_training", "training", "A1")


def _lst_head(lst: str, n: int, out: str) -> str:
    """A copy of the list file holding its first ``n`` paths (same base
    name, so the CLIs name the subset alike)."""
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, os.path.basename(lst))
    with open(lst) as f:
        paths = f.read().splitlines()[:n]
    with open(path, "w") as f:
        f.write("\n".join(paths) + "\n")
    return path


def _per_image(pred_dir: str, lst: str):
    """name, count and the sha256 of the ``-ins_mask.png`` pixel array of
    each image a ``pred_list`` run wrote."""
    from PIL import Image

    out = []
    with open(lst) as f:
        names = [os.path.splitext(os.path.basename(p))[0]
                 for p in f.read().splitlines() if p]
    for name in names:
        base = os.path.join(pred_dir, name, name)
        ins = np.ascontiguousarray(np.asarray(Image.open(base + "-ins_mask.png")))
        out.append({
            "name": name,
            "count": int(np.load(base + "-n_objects.npy")),
            "ins_mask_sha256": hashlib.sha256(ins.tobytes()).hexdigest(),
        })
    return out


def jax_f32_reference(root: str, n_images: int = 64) -> dict:
    """The JAX package's ``pred_list --f32 --batchsize 16`` -> ``evaluate``
    over the first ``n_images`` of the frozen eval asset, with the
    committed checkpoint, on the CPU."""
    from tpuseg.cli import evaluate as jeval
    from tpuseg.cli import pred_list as jpred
    from tpuseg.data.eval_asset import default_asset_prefix, materialize_eval_tree

    tree = os.path.join(root, "tree")
    lst = materialize_eval_tree(default_asset_prefix(), tree)
    meta = os.path.dirname(lst)
    if n_images < 64:
        lst = _lst_head(lst, n_images, os.path.join(root, "meta"))
    pred_dir = os.path.join(root, "pred")
    jpred.main(["--lst", lst, "--model", CKPT, "--dataset", "CVPPP",
                "--batchsize", str(BATCH), "--f32", "--output", pred_dir])
    sbd, dic, fg = jeval.main(["--pred_dir", pred_dir, "--dataset", "CVPPP",
                               "--metadata", meta,
                               "--img_dir", os.path.join(tree, *A1)])
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO,
                            capture_output=True, text=True).stdout.strip()
    return {
        "made_by": "tests/test_torch_cli.py::jax_f32_reference",
        "command": f"pred_list.py --f32 --batchsize {BATCH} --model "
                   "assets/synthetic_ckpt.msgpack -> evaluate.py, JAX on "
                   "the CPU",
        "asset": "assets/eval_hard64",
        "commit": commit or None,
        "n_images": n_images,
        "mean_sbd": sbd,
        "mean_abs_dic": dic,
        "mean_fg_dice": fg,
        "images": _per_image(pred_dir, lst),
    }


def _fake_predictions(root, pred_dir):
    """Prediction files for a ground-truth tree: each label map with some
    pixels relabelled, a perturbed fg mask and count; the last image has
    none (the CLIs skip it)."""
    from PIL import Image

    rng = np.random.default_rng(1)
    with open(os.path.join(root, "data", "metadata", "CVPPP",
                           "validation_image_paths.txt")) as f:
        paths = f.read().splitlines()
    for path in paths[:-1]:
        name = os.path.splitext(os.path.basename(path))[0]
        label = np.asarray(Image.open(path.replace("_rgb", "_label")))
        pred = np.where(rng.random(label.shape) < 0.9, label,
                        rng.integers(0, 9, label.shape)).astype(np.uint8)
        fg = ((pred > 0) * 255).astype(np.uint8)
        out = os.path.join(pred_dir, name)
        os.makedirs(out)
        Image.fromarray(pred).save(os.path.join(out, name + "-ins_mask.png"))
        Image.fromarray(fg).save(os.path.join(out, name + "-fg_mask.png"))
        np.save(os.path.join(out, name + "-n_objects.npy"),
                np.asarray(int(rng.integers(0, 12))))


def test_evaluate_equals_the_jax_cli(tmp_path):
    """One prediction directory over two image shapes (two buckets)."""
    from tpuseg.cli import evaluate as jeval
    from tpuseg_torch.cli import evaluate as teval
    from tpuseg_torch.data.synthetic import write_synthetic_eval_tree

    root = str(tmp_path / "gt")
    write_synthetic_eval_tree(root, 3, seed=4, height=40, width=36, hard=True)
    other = str(tmp_path / "gt2")
    write_synthetic_eval_tree(other, 2, seed=5, height=28, width=30)
    meta = os.path.join(root, "data", "metadata", "CVPPP")
    for name in sorted(os.listdir(os.path.join(other, *A1))):
        os.replace(os.path.join(other, *A1, name),
                   os.path.join(root, *A1, name.replace("plant", "leaf")))
    with open(os.path.join(other, "data", "metadata", "CVPPP",
                           "number_of_instances.txt")) as f:
        extra = f.read().replace("plant", "leaf")
    with open(os.path.join(meta, "number_of_instances.txt"), "a") as f:
        f.write(extra)
    lst = os.path.join(meta, "validation_image_paths.txt")
    with open(lst) as f:
        paths = f.read().splitlines()
    paths[1:1] = [os.path.join(root, *A1, f"leaf{i:04d}_rgb.png")
                  for i in range(2)]
    with open(lst, "w") as f:
        f.write("\n".join(paths) + "\n")
    pred_dir = str(tmp_path / "pred")
    _fake_predictions(root, pred_dir)
    argv = ["--pred_dir", pred_dir, "--dataset", "CVPPP", "--metadata", meta,
            "--img_dir", os.path.join(root, *A1)]
    want = jeval.main(argv)
    got = teval.main(argv + ["--device", "cpu"])
    assert len(os.listdir(pred_dir)) == 4
    assert np.allclose(got, want, rtol=0, atol=1e-6), (got, want)
    assert all(0 < v for v in got)


def test_evaluate_finds_the_metadata_dir_as_the_jax_cli_does(tmp_path,
                                                              monkeypatch):
    from tpuseg.cli.evaluate import _find_metadata as jax_find
    from tpuseg_torch.cli.evaluate import _find_metadata

    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError):
        _find_metadata("hint", "CVPPP")
    for d in ("data/metadata", "hint/data/metadata",
              "hint/data/metadata/CVPPP"):
        os.makedirs(d, exist_ok=True)
        open(os.path.join(d, "validation_image_paths.txt"), "w").close()
        assert _find_metadata("hint", "CVPPP") == jax_find("hint", "CVPPP")


def test_pred_list_f32_cpu_matches_the_jax_reference(tmp_path):
    """The first 4 images of eval_hard64 at full width, committed
    checkpoint: counts and id maps equal the JAX package's f32 result; the
    TF32 switches the CLI turns off come back as they were."""
    from tpuseg_torch.cli import evaluate as teval
    from tpuseg_torch.cli import pred_list
    from tpuseg_torch.data.eval_asset import default_asset_prefix, materialize_eval_tree

    torch.set_num_threads(4)
    n = 4
    lst = materialize_eval_tree(default_asset_prefix(), str(tmp_path / "tree"))
    meta = os.path.dirname(lst)
    lst = _lst_head(lst, n, str(tmp_path / "meta"))
    pred_dir = str(tmp_path / "pred")
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    before = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32 = matmul.allow_tf32 = True
    try:
        pred_list.main(["--lst", lst, "--model", CKPT, "--dataset", "CVPPP",
                        "--batchsize", str(n), "--f32", "--device", "cpu",
                        "--output", pred_dir])
        assert cudnn.allow_tf32 and matmul.allow_tf32
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = before
    want = json.loads(REFERENCE.read_text())["images"][:n]
    assert _per_image(pred_dir, lst) == want
    sbd, dic, fg = teval.main(["--pred_dir", pred_dir, "--dataset", "CVPPP",
                               "--metadata", meta, "--device", "cpu",
                               "--img_dir", str(tmp_path / "tree" / Path(*A1))])
    assert np.isfinite([sbd, dic, fg]).all() and sbd > 0.5 and fg > 0.99


def _tiny(cfg):
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, image_height=32, image_width=32,
                                 max_n_objects=4),
        model=dataclasses.replace(cfg.model, n_filters=8),
    )


def test_predictor_f32_turns_tf32_off_inside_the_forward_only():
    """``Predictor(dtype=float32)``: cuDNN's and matmul's TF32 switches are
    off while the model runs and as they were after; bf16 leaves them."""
    from tpuseg_torch.configs import cvppp_config
    from tpuseg_torch.models import ReSeg
    from tpuseg_torch.runtime.predict import Predictor

    cfg = _tiny(cvppp_config())
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    before = (cudnn.allow_tf32, matmul.allow_tf32)
    images = np.random.default_rng(0).integers(0, 256, (2, 32, 32, 3),
                                               dtype=np.uint8)
    try:
        for dtype, want_inside in ((torch.float32, False),
                                   (torch.bfloat16, True)):
            torch.manual_seed(0)
            p = Predictor(cfg, ReSeg(cfg), batch_size=2, device="cpu",
                          dtype=dtype)
            seen = []
            for m in (p.model.base, p.model.decoder):
                m.register_forward_pre_hook(lambda *a: seen.append(
                    (cudnn.allow_tf32, matmul.allow_tf32)))
            cudnn.allow_tf32 = matmul.allow_tf32 = True
            p.predict_batch_arrays(images)
            assert seen and set(seen) == {(want_inside, want_inside)}, dtype
            assert cudnn.allow_tf32 and matmul.allow_tf32
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = before


def test_load_model_paths(tmp_path):
    """A missing path: the seeded random init; a file that is neither a
    ``.msgpack`` nor a port checkpoint (or a directory): ValueError."""
    from tpuseg_torch.cli.common import load_model
    from tpuseg_torch.configs import cvppp_config

    cfg = _tiny(cvppp_config())
    _, a = load_model(cfg, str(tmp_path / "absent"))
    _, b = load_model(cfg, "")
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(v, w), k
    (tmp_path / "notes.txt").write_text("not a checkpoint")
    torch.save({"model": {}}, tmp_path / "other.pt")
    for bad in ("notes.txt", "other.pt", ""):
        with pytest.raises(ValueError, match="not a checkpoint"):
            load_model(cfg, str(tmp_path / bad))


def _train_argv(tmp_path, *extra):
    return ["--dataset", "CVPPP", "--batchsize", "2", "--nepochs", "1",
            "--train_data", str(tmp_path / "train"),
            "--val_data", str(tmp_path / "val"),
            "--runs_dir", str(tmp_path / "runs"), "--device", "cpu", *extra]


def _records(tmp_path, n_train=4):
    from tpuseg_torch.data.synthetic import write_synthetic_records

    write_synthetic_records(str(tmp_path / "train"), n_train, seed=1,
                            height=45, width=39)
    write_synthetic_records(str(tmp_path / "val"), 2, seed=2, height=45,
                            width=39)


def _tb_scalars(run_dir: str) -> set:
    """The scalar tags of the TensorBoard event files under the run."""
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    acc = EventAccumulator(os.path.join(run_dir, "tb"))
    acc.Reload()
    return set(acc.Tags()["scalars"])


@pytest.mark.parametrize("flag", ["--live", "--tensorboard"])
def test_train_cli_live_view_and_tensorboard(tmp_path, monkeypatch, capfd,
                                             flag):
    """``--live`` prints a sparkline row per metric after each epoch;
    ``--tensorboard`` writes every metric under ``<run_dir>/tb``."""
    from tpuseg_torch.cli import train
    from tpuseg_torch.settings import get_config

    torch.set_num_threads(2)
    monkeypatch.setattr(train, "get_config", lambda ds: _tiny(get_config(ds)))
    _records(tmp_path)
    out = train.main(_train_argv(tmp_path, flag))
    text = capfd.readouterr().out
    live = "live metrics:" in text and "train/cost" in text
    assert live == (flag == "--live")
    assert os.path.isdir(os.path.join(out["run_dir"], "tb")) == (
        flag == "--tensorboard")
    if flag == "--tensorboard":
        assert {"train/cost", "val/cost", "train/grad_norm"} <= _tb_scalars(
            out["run_dir"])


def test_train_cli_over_two_ranks(tmp_path, monkeypatch, capfd):
    """``--ndevices 2 --live --tensorboard`` on the CPU (two gloo ranks):
    one run directory, rank 0's logs (finite costs, the live rows once per
    epoch, TensorBoard events) and checkpoints, the global batch of 2 split
    one sample a rank; rank 0's result comes back."""
    from tpuseg_torch.cli import train
    from tpuseg_torch.settings import get_config

    torch.set_num_threads(2)
    monkeypatch.setattr(train, "get_config", lambda ds: _tiny(get_config(ds)))
    _records(tmp_path)
    out = train.main(_train_argv(tmp_path, "--ndevices", "2", "--live",
                                 "--tensorboard", "--nepochs", "2"))
    text = capfd.readouterr().out
    assert "data-parallel: 2 ranks on the CPU, backend gloo" in text
    assert text.count("live metrics:") == 4  # train + val, 2 epochs
    assert text.count("Epoch [") == 2
    runs = os.listdir(tmp_path / "runs" / "CVPPP")
    assert [os.path.join(str(tmp_path / "runs"), "CVPPP", r)
            for r in runs] == [out["run_dir"]]
    assert out["step"] == 4 and [e["steps"] for e in out["epochs"]] == [2, 2]
    files = set(os.listdir(out["run_dir"]))
    assert {"config.json", "training.log", "validation.log",
            "metrics.jsonl", "tb"} <= files
    assert any(f.startswith("model_0_") for f in files)
    with open(os.path.join(out["run_dir"], "training.log")) as f:
        costs = [float(line.split(",")[1]) for line in f.read().split()[1:]]
    assert len(costs) == 2 and np.isfinite(costs).all()
    assert {"train/cost", "val/ins_dice_loss"} <= _tb_scalars(out["run_dir"])


def test_train_cli_ranks_run_without_a_deadline(tmp_path, monkeypatch):
    """``train --ndevices N`` starts its ranks with no deadline for the
    run (a real run lasts hours) and a collective timeout long enough for
    rank 0's logging and checkpoints at the epoch's barrier."""
    from tpuseg_torch.cli import train

    calls = []

    def fake_run_ranks(task, n, args, **kw):
        calls.append((n, kw))
        return [{"run_dir": args[2], "launches": {}}] * n

    monkeypatch.setattr(train, "run_ranks", fake_run_ranks)
    out = train.main(_train_argv(tmp_path, "--ndevices", "2",
                                 "--nepochs", "600"))
    (n, kw), = calls
    assert n == 2 and kw["device"] == "cpu"
    assert kw["timeout"] is None
    assert kw["collective_timeout"] == train.CLI_COLLECTIVE_TIMEOUT_S >= 600
    assert out["rank_launches"] == [{}, {}]


def test_pred_list_over_two_devices_equals_one(tmp_path):
    """``pred_list --ndevices 2 --device cpu`` (two rank processes; one
    batch of 4, so rank 0 predicts it) on the first 4 images of eval_hard64 at full width writes the
    files ``--ndevices 1`` writes, byte for byte, and those hold the JAX
    package's counts and id maps."""
    from tpuseg_torch.cli import pred_list
    from tpuseg_torch.data.eval_asset import default_asset_prefix, materialize_eval_tree

    torch.set_num_threads(4)
    n = 4
    lst = materialize_eval_tree(default_asset_prefix(), str(tmp_path / "tree"))
    lst = _lst_head(lst, n, str(tmp_path / "meta"))
    dirs = []
    for n_dev in ("1", "2"):
        dirs.append(tmp_path / f"pred{n_dev}")
        pred_list.main(["--lst", lst, "--model", CKPT, "--dataset", "CVPPP",
                        "--batchsize", str(n), "--f32", "--device", "cpu",
                        "--ndevices", n_dev, "--output", str(dirs[-1])])
    files = sorted(p.relative_to(dirs[0]) for p in dirs[0].rglob("*")
                   if p.is_file())
    assert len(files) == 5 * n
    for rel in files:
        assert (dirs[0] / rel).read_bytes() == (dirs[1] / rel).read_bytes()
    want = json.loads(REFERENCE.read_text())["images"][:n]
    assert _per_image(str(dirs[1]), lst) == want


def test_pred_list_ranks_take_whole_batches_of_an_uneven_list(
        tmp_path, monkeypatch):
    """``pred_list --ndevices 2 --device cpu`` on 5 images at batch size 2
    (3 batches, the last one short): rank 0 takes the first two batches
    and rank 1 the third; every image's 5 files come out, byte for byte
    those of ``--ndevices 1`` (tiny configuration, seeded random init)."""
    from tpuseg_torch.cli import pred_list
    from tpuseg_torch.data.eval_asset import default_asset_prefix, materialize_eval_tree
    from tpuseg_torch.settings import get_config

    monkeypatch.setattr(pred_list, "get_config",
                        lambda ds: _tiny(get_config(ds)))
    n = 5
    lst = materialize_eval_tree(default_asset_prefix(), str(tmp_path / "tree"))
    lst = _lst_head(lst, n, str(tmp_path / "meta"))
    dirs = []
    for n_dev in ("1", "2"):
        dirs.append(tmp_path / f"pred{n_dev}")
        pred_list.main(["--lst", lst, "--model", str(tmp_path / "none.ckpt"),
                        "--dataset", "CVPPP", "--batchsize", "2", "--f32",
                        "--device", "cpu", "--ndevices", n_dev,
                        "--output", str(dirs[-1])])
    assert [r["images"] for r in pred_list.last_ranks] == [4, 1]
    with open(lst) as f:
        names = [os.path.splitext(os.path.basename(q))[0]
                 for q in f.read().split()]
    files = sorted(p.relative_to(dirs[0]) for p in dirs[0].rglob("*")
                   if p.is_file())
    assert sorted({f.parts[0] for f in files}) == sorted(names)
    assert len(files) == 5 * n
    for rel in files:
        assert (dirs[0] / rel).read_bytes() == (dirs[1] / rel).read_bytes()


def test_train_cli_runs_resumes_and_serves(tmp_path, monkeypatch):
    """The train CLI at a tiny configuration on tiny records: a run
    directory with config.json, the logs and a checkpoint; ``--model``
    resumes it (the step count continues); ``pred_list --model`` serves
    it with the checkpoint's weights, and ``evaluate`` scores that."""
    from tpuseg_torch.cli import evaluate as teval
    from tpuseg_torch.cli import pred_list, train
    from tpuseg_torch.cli.common import load_model
    from tpuseg_torch.data.synthetic import (
        write_synthetic_eval_tree, write_synthetic_records,
    )
    from tpuseg_torch.runtime.checkpoint import read_model_state
    from tpuseg_torch.settings import get_config

    torch.set_num_threads(2)
    monkeypatch.setattr(train, "get_config", lambda ds: _tiny(get_config(ds)))
    monkeypatch.setattr(pred_list, "get_config",
                        lambda ds: _tiny(get_config(ds)))
    write_synthetic_records(str(tmp_path / "train"), 4, seed=1, height=45,
                            width=39)
    write_synthetic_records(str(tmp_path / "val"), 2, seed=2, height=45,
                            width=39)

    first = train.main(_train_argv(tmp_path))
    run = first["run_dir"]
    files = set(os.listdir(run))
    assert {"config.json", "training.log", "validation.log",
            "metrics.jsonl"} <= files
    ckpts = sorted(f for f in files if f.startswith("model_0_"))
    assert len(ckpts) == 1 and first["step"] == 2
    with open(os.path.join(run, "config.json")) as f:
        saved = json.load(f)
    assert saved["data"]["image_height"] == 32
    assert saved["model"]["n_filters"] == 8
    assert saved["train"]["batch_size"] == 2
    assert first["epochs"][0]["steps"] == 2
    ckpt = os.path.join(run, ckpts[0])

    resumed = train.main(_train_argv(tmp_path, "--model", ckpt,
                                     "--device_aug"))
    assert resumed["step"] == 4 and resumed["run_dir"] != run

    loaded = []

    def spy(cfg, path):
        out = load_model(cfg, path)
        loaded.append({k: v.detach().clone()
                       for k, v in out[1].state_dict().items()})
        return out

    monkeypatch.setattr(pred_list, "load_model", spy)
    tree = str(tmp_path / "tree")
    lst = write_synthetic_eval_tree(tree, 3, seed=3, height=40, width=44)
    pred_dir = str(tmp_path / "pred")
    pred_list.main(["--lst", lst, "--model", ckpt, "--dataset", "CVPPP",
                    "--batchsize", "2", "--f32", "--device", "cpu",
                    "--output", pred_dir])
    state = read_model_state(ckpt)
    got = loaded[0]
    assert got.keys() == state.keys()
    for k, v in state.items():
        assert torch.equal(got[k], v), k
    scores = teval.main(["--pred_dir", pred_dir, "--dataset", "CVPPP",
                         "--metadata", os.path.dirname(lst), "--device", "cpu",
                         "--img_dir", os.path.join(tree, *A1)])
    assert np.isfinite(scores).all()


@pytest.mark.slow
def test_jax_reference_file_is_what_the_jax_package_gives(tmp_path):
    want = json.loads(REFERENCE.read_text())
    got = jax_f32_reference(str(tmp_path))
    for key in ("n_images", "images"):
        assert got[key] == want[key], key
    for key in ("mean_sbd", "mean_abs_dic", "mean_fg_dice"):
        assert got[key] == pytest.approx(want[key], abs=1e-9), key


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_cli.py --write")
    import tempfile

    sys.path.insert(0, str(REPO))
    import jax

    jax.config.update("jax_platforms", "cpu")
    with tempfile.TemporaryDirectory() as tmp:
        ref = jax_f32_reference(tmp)
    REFERENCE.write_text(json.dumps(ref, indent=1) + "\n")
    print(f"wrote {REFERENCE}: SBD {ref['mean_sbd']} |DiC| "
          f"{ref['mean_abs_dic']} FG {ref['mean_fg_dice']}")
