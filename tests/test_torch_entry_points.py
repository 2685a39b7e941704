"""The port's other inference entry points against the JAX package's, at
``tests/test_staged_extraction.py``'s small model (64x64, n_filters=8,
max_n_objects=8), float32 on the CPU, one weight tree on both sides
(``test_torch_predict._draw``; the CLIs read it from a ``.msgpack`` file).

Tolerances, per check:

* ``predict_semantic``: fg_prob within 1e-5;
* ``ReSeg.embed``: probabilities within 1e-5, embeddings within 1e-4
  (relative and absolute), count estimates equal; ``ReSeg.density``
  within 1e-5 relative;
* ``add_coordinates``: within 1e-6;
* ``_lloyd`` from equal initial centres: assignments equal, inertia within
  1e-5 relative;
* ``pred`` and ``pred_list --staged`` / ``--bucketed``: every file
  byte-equal to the JAX CLI's (masks, counts and images exact);
* ``predict_cluster``: the contract (ids 1..n on the foreground, 0
  elsewhere) and the JAX package's fg mask and cluster count; the cluster
  ids themselves come from each package's own random seeding.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_predict import _draw

from tpuseg.cli.common import build_model, init_variables
from tpuseg.configs import cvppp_config as jax_cvppp_config
from tpuseg.data.synthetic import make_scene
from tpuseg.runtime.predict import Predictor as JaxPredictor
from tpuseg_torch.configs import cvppp_config
from tpuseg_torch.models import ReSeg
from tpuseg_torch.runtime.predict import Predictor
from tpuseg_torch.weights import load_flax

torch.set_num_threads(2)


def _small(cfg, **model_kw):
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, image_height=64, image_width=64,
                                 max_n_objects=8),
        model=dataclasses.replace(cfg.model, n_filters=8, **model_kw),
    )


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(weights, checkpoint path, image paths of native sizes 70x90, 60x60,
    50x64 and 70x120)."""
    import flax.serialization
    from PIL import Image

    cfg = _small(jax_cvppp_config())
    shapes = jax.eval_shape(lambda: init_variables(cfg, build_model(cfg), 0))
    variables = _draw(shapes, seed=0)
    root = tmp_path_factory.mktemp("entry")
    ckpt = str(root / "small.msgpack")
    with open(ckpt, "wb") as f:
        f.write(flax.serialization.to_bytes(variables))
    rng = np.random.default_rng(21)
    paths = []
    for i, (h, w) in enumerate([(70, 90), (60, 60), (50, 64), (70, 120)]):
        p = str(root / f"plant{i:03d}_rgb.png")
        Image.fromarray(make_scene(rng, h, w, hard=True)[0].astype(
            np.uint8)).save(p)
        paths.append(p)
    return variables, ckpt, paths


def _predictors(variables, batch_size=1, **model_kw):
    jcfg = _small(jax_cvppp_config(), **model_kw)
    jp = JaxPredictor(jcfg, build_model(jcfg), variables,
                      batch_size=batch_size)
    tcfg = _small(cvppp_config(), **model_kw)
    tp = Predictor(tcfg, load_flax(ReSeg(tcfg), variables),
                   batch_size=batch_size, device="cpu")
    return jp, tp


def _inputs(paths):
    """(JAX standardised NHWC, the port's NCHW) of the resized images."""
    from PIL import Image

    from tpuseg.data.colorspace import image_ex_standardize as jstd
    from tpuseg_torch.data.colorspace import image_ex_standardize as tstd

    imgs = np.stack([np.asarray(Image.open(p).convert("RGB").resize(
        (64, 64), Image.BILINEAR)) for p in paths]).astype(np.uint8)
    return (jstd(jnp.asarray(imgs)),
            tstd(torch.from_numpy(imgs)).permute(0, 3, 1, 2).contiguous())


def test_predict_semantic_matches_jax(setup):
    variables, _, paths = setup
    jp, tp = _predictors(variables)
    for p in paths[:2]:
        want, got = jp.predict_semantic(p), tp.predict_semantic(p)
        np.testing.assert_array_equal(got["image"], want["image"])
        assert got["fg_prob"].shape == want["fg_prob"].shape
        assert got["fg_prob"].dtype == np.float32
        np.testing.assert_allclose(got["fg_prob"], want["fg_prob"],
                                   rtol=0, atol=1e-5)


def test_embed_and_density_modes_match_jax(setup):
    variables, _, paths = setup
    jcfg = _small(jax_cvppp_config())
    jmodel = build_model(jcfg)
    xj, xt = _inputs(paths)
    tcfg = _small(cvppp_config())
    m = load_flax(ReSeg(tcfg), variables).to_inference(torch.float32)

    probs, emb, n_est = jmodel.apply(variables, xj, mode="embed")
    tprobs, temb, tn = m.embed(xt)
    np.testing.assert_allclose(tprobs.permute(0, 2, 3, 1).numpy(),
                               np.asarray(probs), rtol=0, atol=1e-5)
    np.testing.assert_allclose(temb.permute(0, 2, 3, 1).numpy(),
                               np.asarray(emb), rtol=1e-4, atol=1e-4)
    assert tn.dtype == torch.int32
    np.testing.assert_array_equal(tn.numpy(), np.asarray(n_est))

    dens = np.asarray(jmodel.apply(variables, xj, mode="density"))
    tdens = m.density(xt).permute(0, 2, 3, 1).numpy()
    assert tdens.shape == dens.shape
    np.testing.assert_allclose(tdens, dens, rtol=1e-5,
                               atol=1e-5 * np.abs(dens).max())

    # without the density head the count head's argmax, without both 16
    for kw in (dict(use_density_head=False),
               dict(use_density_head=False, use_count_head=False)):
        jm = build_model(_small(jax_cvppp_config(), **kw))
        drop = {"density_head"} | ({"count_head"} if len(kw) == 2 else set())
        tree = {c: {k: v for k, v in t.items() if k not in drop}
                for c, t in variables.items()}
        tc = _small(cvppp_config(), **kw)
        tm = load_flax(ReSeg(tc), tree).to_inference(torch.float32)
        want = np.asarray(jm.apply(tree, xj, mode="embed")[2])
        np.testing.assert_array_equal(tm.embed(xt)[2].numpy(), want)
        if len(kw) == 2:
            assert (want == 16).all()
        with pytest.raises(ValueError, match="density head"):
            tm.density(xt)


def test_add_coordinates_matches_jax():
    from tpuseg.nn.coord_conv import add_coordinates as jax_add
    from tpuseg_torch.nn.coord_conv import add_coordinates

    x = np.random.default_rng(3).normal(size=(2, 5, 7, 3)).astype(np.float32)
    for with_r in (False, True):
        want = np.asarray(jax_add(jnp.asarray(x), with_r=with_r))
        got = add_coordinates(torch.from_numpy(x).permute(0, 3, 1, 2),
                              with_r=with_r).permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_lloyd_matches_jax_from_equal_centres():
    from tpuseg.runtime.cluster import _lloyd as jax_lloyd
    from tpuseg_torch.runtime.cluster import _lloyd

    rng = np.random.default_rng(4)
    emb = rng.normal(size=(200, 6)).astype(np.float32)
    emb[:100] += 3.0
    wts = (rng.random(200) < 0.7).astype(np.float32)
    centers = rng.normal(size=(3, 8, 6)).astype(np.float32)
    for k_valid in (3, 8):
        j_assign, j_inertia = jax.vmap(
            lambda c: jax_lloyd(jnp.asarray(emb), jnp.asarray(wts), c,
                                jnp.asarray(k_valid), 10)
        )(jnp.asarray(centers))
        # the restarts as one batched program
        assign, inertia = _lloyd(torch.from_numpy(emb), torch.from_numpy(wts),
                                 torch.from_numpy(centers), k_valid, 10)
        np.testing.assert_array_equal(assign.numpy(), np.asarray(j_assign))
        np.testing.assert_allclose(inertia.numpy(), np.asarray(j_inertia),
                                   rtol=1e-5)
        assert assign.max() < k_valid


def test_kmeans_cluster_contract():
    """Two blobs: two clusters; ids 1..n on the foreground, 0 elsewhere;
    the result is the restart of least inertia (checked against each
    restart run on its own from the same seeds)."""
    from tpuseg_torch.runtime.cluster import (
        _BIG, _lloyd, kmeans_cluster, kmeans_cluster_batch,
    )

    rng = np.random.default_rng(0)
    h = w = 16
    emb = np.zeros((h, w, 2), np.float32)
    emb[8:] = 10.0
    emb += rng.normal(size=(h, w, 2)).astype(np.float32) * 0.1
    fg = np.ones((h, w), np.float32)
    fg[:, :3] = 0
    e, m = torch.from_numpy(emb), torch.from_numpy(fg)
    ids, inertia = kmeans_cluster(e, m, 2, torch.Generator().manual_seed(0),
                                  max_clusters=4, n_init=4)
    assert ids.dtype == torch.int32 and ids.shape == (h, w)
    assert (ids[m == 0] == 0).all() and (ids[m > 0] >= 1).all()
    assert ids.max() <= 2
    assert len(set(ids[:8, 3:].flatten().tolist())) == 1
    assert len(set(ids[8:, 3:].flatten().tolist())) == 1
    assert ids[0, 5] != ids[15, 15]
    assert float(inertia) < 20.0

    # the same seeds, each restart alone
    gen = torch.Generator().manual_seed(0)
    u = torch.rand((1, 4, h * w), generator=gen)
    g = -torch.log(-torch.log(u.clamp(min=1e-20)))
    flat = e.reshape(-1, 2)
    score = torch.where(m.reshape(-1) > 0, g, torch.full_like(g, -_BIG))
    solo = [_lloyd(flat, m.reshape(-1), flat[idx], 2, 50)
            for idx in score[0].topk(4, dim=-1).indices]
    best = int(np.argmin([float(s[1]) for s in solo]))
    assert float(inertia) == float(solo[best][1])
    want = (solo[best][0] + 1).to(torch.int32) * (m.reshape(-1) > 0)
    assert torch.equal(ids.reshape(-1), want.to(torch.int32))

    bids, binertia = kmeans_cluster_batch(
        torch.stack([e, e.flip(0)]), torch.stack([m, m]),
        torch.tensor([2, 3]), torch.Generator().manual_seed(1),
        max_clusters=4, n_init=4)
    assert bids.shape == (2, h, w) and binertia.shape == (2,)
    assert (bids[:, m == 0] == 0).all()
    assert bids[0].max() <= 2 and bids[1].max() <= 3


@pytest.mark.parametrize("coords", [False, True])
def test_predict_cluster(setup, coords):
    variables, _, paths = setup
    jp, tp = _predictors(variables, use_coordinates=coords)
    want = jp.predict_cluster(paths[0], seed=0)
    got = tp.predict_cluster(paths[0], seed=0)
    assert got["ins_mask"].shape == got["fg_mask"].shape == (70, 90)
    np.testing.assert_array_equal(got["image"], want["image"])
    np.testing.assert_array_equal(got["fg_mask"], want["fg_mask"])
    assert got["n_objects"] == want["n_objects"]
    assert 1 <= got["n_objects"] <= 8
    ins = got["ins_mask"]
    assert (ins[got["fg_mask"] == 0] == 0).all()
    assert set(np.unique(ins[got["fg_mask"] > 0])) <= set(
        range(1, got["n_objects"] + 1))
    # the seed fixes the result
    again = tp.predict_cluster(paths[0], seed=0)
    np.testing.assert_array_equal(again["ins_mask"], ins)


def test_predict_attend_matches_jax(setup):
    variables, _, paths = setup
    jp, tp = _predictors(variables)
    want, got = jp.predict_attend(paths[0]), tp.predict_attend(paths[0])
    assert got["path"] == want["path"] == paths[0]
    for k in ("image", "fg_mask", "ins_mask"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got["n_objects"] == want["n_objects"]


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                out[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return out


def _small_get_config(module, monkeypatch):
    real = module.get_config
    monkeypatch.setattr(module, "get_config", lambda ds: _small(real(ds)))


@pytest.mark.parametrize("instances", [False, True])
def test_pred_cli_matches_the_jax_cli(setup, tmp_path, monkeypatch,
                                      instances):
    from tpuseg.cli import pred as jpred
    from tpuseg_torch.cli import pred

    _, ckpt, paths = setup
    _small_get_config(jpred, monkeypatch)
    _small_get_config(pred, monkeypatch)
    flags = ["--instances"] if instances else []
    common = ["--image", paths[0], "--model", ckpt, "--dataset", "CVPPP"]
    jpred.main(common + ["--output", str(tmp_path / "jax")] + flags)
    pred.main(common + ["--output", str(tmp_path / "port"), "--device",
                        "cpu"] + flags)
    want, got = _files(tmp_path / "jax"), _files(tmp_path / "port")
    n = 5 if instances else 1
    assert len(want) == n and got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k


def _lst(paths, root):
    lst = os.path.join(root, "validation_image_paths.txt")
    os.makedirs(root, exist_ok=True)
    with open(lst, "w") as f:
        f.write("\n".join(paths) + "\n")
    return lst


@pytest.mark.parametrize("flag", ["--staged", "--bucketed"])
def test_pred_list_modes_match_the_jax_cli(setup, tmp_path, monkeypatch,
                                           flag):
    """Batches of 2 over 4 images (two batches in one staged window; two
    buckets, 64x64 and 128x128 on the 64 grid)."""
    from tpuseg.cli import pred_list as jpl
    from tpuseg_torch.cli import pred_list

    _, ckpt, paths = setup
    _small_get_config(jpl, monkeypatch)
    _small_get_config(pred_list, monkeypatch)
    made = []

    class Recording(Predictor):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    monkeypatch.setattr(pred_list, "Predictor", Recording)
    lst = _lst(paths, str(tmp_path / "meta"))
    common = ["--lst", lst, "--model", ckpt, "--dataset", "CVPPP",
              "--batchsize", "2", "--f32", flag]
    jpl.main(common + ["--output", str(tmp_path / "jax")])
    pred_list.main(common + ["--output", str(tmp_path / "port"), "--device",
                             "cpu"])
    want, got = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert len(want) == 5 * len(paths) and got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k
    assert made[-1].staged == (flag == "--staged")


def test_pred_list_window_defaults_follow_the_environment(setup, tmp_path,
                                                          monkeypatch):
    """``TPUSEG_EXTRACT_WINDOW`` / ``..._STRIDE`` set the defaults of
    ``--window`` / ``--window_stride`` in both CLIs alike."""
    from tpuseg.cli import pred_list as jpl
    from tpuseg_torch.cli import pred_list

    _, ckpt, paths = setup
    lst = _lst(paths, str(tmp_path / "meta"))
    seen = {}

    class Stop(Exception):
        pass

    def jax_build(cfg, dtype=None):
        seen["jax"] = cfg
        raise Stop

    def port_load(cfg, path):
        seen["port"] = cfg
        raise Stop

    monkeypatch.setattr(jpl, "build_model", jax_build)
    monkeypatch.setattr(pred_list, "load_model", port_load)
    argv = ["--lst", lst, "--model", ckpt, "--dataset", "CVPPP",
            "--output", str(tmp_path / "out")]
    for window, stride in (("128", "32"), ("0", None), (None, None)):
        for name, value in (("TPUSEG_EXTRACT_WINDOW", window),
                            ("TPUSEG_EXTRACT_WINDOW_STRIDE", stride)):
            if value is None:
                monkeypatch.delenv(name, raising=False)
            else:
                monkeypatch.setenv(name, value)
        with pytest.raises(Stop):
            jpl.main(argv)
        with pytest.raises(Stop):
            pred_list.main(argv + ["--device", "cpu"])
        jd, td = seen["jax"].decoder, seen["port"].decoder
        assert dataclasses.asdict(td) == dataclasses.asdict(jd)
        want_w = 192 if window is None else int(window)
        assert td.extract_window == want_w
        assert td.extract_window_stride == (64 if stride is None
                                            else int(stride))
