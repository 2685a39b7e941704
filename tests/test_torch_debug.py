"""The port's debug path against the JAX package's, at the tiny training
configuration on the CPU (``test_torch_train.tiny``: 32x32, n_filters 8,
max_n_objects 4, deterministic glimpses), float32.

* ``ReSeg.debug`` through ``make_debug_step`` vs the JAX ``mode="debug"``
  on one drawn weight tree (``test_torch_train.draw_variables``):
  glimpse points, pooled targets and the semantic mask equal; attention
  maps within 1e-5; per-level logits within 1e-4 (relative and absolute:
  five levels of eval-mode convolutions in float32).
* ``dump_pyramid_debug`` writes byte-equal files to the JAX writer's from
  the same arrays.
* ``fit(debug_dir=, debug_every=)`` and the train CLI's ``--debug`` write
  the dumps under ``ep<epoch:03d>_it<step:05d>``.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
from test_torch_train import draw_variables, make_batch, tiny

from tpuseg.cli.common import build_model
from tpuseg.configs import cvppp_config as jax_cvppp_config
from tpuseg.runtime.train import prepare_images
from tpuseg_torch.configs import cvppp_config
from tpuseg_torch.models import ReSeg
from tpuseg_torch.runtime.loop import fit
from tpuseg_torch.runtime.state import create_train_state
from tpuseg_torch.runtime.train import make_debug_step
from tpuseg_torch.weights import load_flax

torch.set_num_threads(2)

DUMP_FILES = sorted([f"{kind}_{lvl}.jpg" for kind in ("p", "pred", "target")
                     for lvl in range(5)] + ["proall.jpg", "pro.jpg",
                                             "mas.jpg"])


@pytest.fixture(scope="module")
def variables():
    return draw_variables()


def _port(variables):
    cfg = tiny(cvppp_config())
    model = load_flax(ReSeg(cfg), variables)
    return cfg, model, create_train_state(cfg, model, device="cpu")


def test_debug_mode_matches_jax(variables):
    batch = make_batch()
    jcfg = tiny(jax_cvppp_config())
    jmodel = build_model(jcfg)
    want = jax.jit(lambda v, b: jmodel.apply(
        v, prepare_images(b["images"]), b["sem_onehot"], b["ins_masks"],
        b["n_objects"], train=False, mode="debug"))(variables, batch)
    cfg, model, state = _port(variables)
    got = make_debug_step(cfg, model)(state, batch)
    assert not model.training
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["point"].numpy(),
                                  np.asarray(want["point"]))
    np.testing.assert_array_equal(got["sem_mask"].numpy(),
                                  np.asarray(want["sem_mask"]))
    assert len(got["preds"]) == len(got["targets"]) == 5
    for g, w in zip(got["targets"], want["targets"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(got["preds"], want["preds"]):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4)
    for k in ("alpha", "pro"):
        w = np.asarray(want[k])
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_dump_files_are_the_jax_writers(tmp_path):
    from tpuseg.utils.debug_images import dump_pyramid_debug as jax_dump
    from tpuseg_torch.utils.debug_images import (
        dump_pyramid_debug, write_pn_jpg,
    )
    from tpuseg.utils.debug_images import write_pn_jpg as jax_pn

    rng = np.random.RandomState(2)
    preds = [rng.randn(2, 2 ** (2 + i), 2 ** (2 + i), 2).astype(np.float32)
             for i in range(5)]
    targets = [(rng.rand(2, 2 ** (2 + i), 2 ** (2 + i), 1) < 0.5).astype(
        np.float32) for i in range(5)]
    pro = rng.rand(2, 64, 64, 1).astype(np.float32)
    mask = (rng.rand(2, 64, 64, 1) < 0.5).astype(np.float32)
    alpha = rng.rand(2, 64 * 64).astype(np.float32)
    for sample in (0, 1):
        dirs = [tmp_path / f"{who}{sample}" for who in ("jax", "port")]
        for fn, d in zip((jax_dump, dump_pyramid_debug), dirs):
            fn(str(d), preds, targets, pro, mask, alpha=alpha,
               sample_idx=sample, point=77)
        names = sorted(os.listdir(dirs[0]))
        assert names == sorted(os.listdir(dirs[1])) == DUMP_FILES
        for n in names:
            assert (dirs[0] / n).read_bytes() == (dirs[1] / n).read_bytes(), n
    jax_pn(alpha[0], mask[0], str(tmp_path / "pn_jax.jpg"))
    write_pn_jpg(alpha[0], mask[0], str(tmp_path / "pn_port.jpg"))
    assert ((tmp_path / "pn_jax.jpg").read_bytes()
            == (tmp_path / "pn_port.jpg").read_bytes())


def test_fit_writes_debug_dumps(variables, tmp_path):
    cfg, model, state = _port(variables)
    batches = [make_batch(seed=s) for s in range(3)]
    debug_dir = tmp_path / "debug"
    fit(cfg, model, state, lambda e: batches, lambda e: batches[:1],
        str(tmp_path / "run"), n_epochs=2, debug_dir=str(debug_dir),
        debug_every=2)
    want = [f"ep{e:03d}_it{it:05d}" for e in (0, 1) for it in (1, 3)]
    assert sorted(os.listdir(debug_dir)) == want
    for d in want:
        assert sorted(os.listdir(debug_dir / d)) == DUMP_FILES
    assert state.step == 6


def test_train_cli_debug_writes_dumps(tmp_path, monkeypatch, capsys):
    from tpuseg_torch.cli import train
    from tpuseg_torch.data.synthetic import write_synthetic_records
    from tpuseg_torch.settings import get_config

    small = lambda ds: dataclasses.replace(  # noqa: E731
        get_config(ds),
        data=dataclasses.replace(get_config(ds).data, image_height=32,
                                 image_width=32, max_n_objects=4),
        model=dataclasses.replace(get_config(ds).model, n_filters=8))
    monkeypatch.setattr(train, "get_config", small)
    write_synthetic_records(str(tmp_path / "train"), 4, seed=1, height=45,
                            width=39)
    write_synthetic_records(str(tmp_path / "val"), 2, seed=2, height=45,
                            width=39)
    res = train.main(["--dataset", "CVPPP", "--batchsize", "2", "--nepochs",
                      "1", "--train_data", str(tmp_path / "train"),
                      "--val_data", str(tmp_path / "val"), "--runs_dir",
                      str(tmp_path / "runs"), "--device", "cpu", "--debug"])
    debug = os.path.join(res["run_dir"], "debug")
    assert os.listdir(debug) == ["ep000_it00001"]
    assert sorted(os.listdir(os.path.join(debug, "ep000_it00001"))) == DUMP_FILES
    assert res["step"] == 2
