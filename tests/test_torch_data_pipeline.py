"""The port's host data pipeline against the JAX package's, bit for bit:
every ``augment`` function under one ``numpy.random.Generator`` state,
``AlignCollate`` in its three modes (odd sizes, short batches, every
transform on and the CVPPP defaults), the ``batches`` iterator and
``PrefetchLoader`` for two (seed, epoch) pairs at 1 and 3 workers,
``otsu_threshold`` / ``TransferDataset``, and ``prepare.py`` on a raw tree
the test writes itself."""

import dataclasses
import os
import shutil
import sys

import numpy as np
import pytest
from PIL import Image

from tpuseg.configs import cvppp_config as jax_cvppp_config
from tpuseg.data import augment as JA
from tpuseg.data import dataset as jds
from tpuseg.data import loader as jld
from tpuseg.data.scripts import prepare as jprep
from tpuseg.data.synthetic import write_synthetic_eval_tree, write_synthetic_records
from tpuseg_torch.configs import cvppp_config
from tpuseg_torch.data import augment as TA
from tpuseg_torch.data import dataset as tds
from tpuseg_torch.data import loader as tld
from tpuseg_torch.data import records as trec
from tpuseg_torch.data.scripts import prepare as tprep


def _arr(x):
    return np.asarray(x[0] if isinstance(x, tuple) else x)


def _image(seed, h=23, w=31):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


def _mask(seed, h=23, w=31):
    return (np.random.default_rng(seed).random((h, w)) > 0.6).astype(np.uint8)


# (name, call(module, rng)) for every function of augment.py, on numpy and
# PIL inputs; the PIL resampling constants come from each module itself
AUGMENT_CASES = [
    ("to_pil", lambda A, r: A.to_pil(_image(0))),
    ("hflip_np", lambda A, r: A.hflip(_image(1))),
    ("hflip_pil", lambda A, r: A.hflip(Image.fromarray(_image(1)))),
    ("vflip_mask", lambda A, r: A.vflip(_mask(2))),
    ("transpose_np", lambda A, r: A.transpose(_image(3))),
    ("transpose_pil", lambda A, r: A.transpose(Image.fromarray(_mask(3)))),
    ("rotate_bilinear", lambda A, r: A.rotate(_image(4), 7, A.BILINEAR, True)),
    ("rotate_nearest", lambda A, r: A.rotate(_mask(4), -90, A.NEAREST, True)),
    ("rotate_no_expand", lambda A, r: A.rotate(_image(5), 33, A.BILINEAR,
                                               False)),
    *[(f"rotate_bg_{s}", lambda A, r, s=s: A.rotate_with_random_bg(
        _image(6 + s), 9 - 4 * s, r, A.BILINEAR, True)) for s in range(6)],
    ("center_cut_mid", lambda A, r: A.center_cut(_image(7, 40, 44), (20, 22),
                                                 8, 9)),
    ("center_cut_edges", lambda A, r: A.center_cut(_mask(8, 40, 44), (2, 43),
                                                   8, 9)),
    ("center_cut_pil", lambda A, r: A.center_cut(
        Image.fromarray(_image(9, 12, 10)), (30, 1), 8, 9)),
    ("swap_channels", lambda A, r: A.swap_channels(_image(10), r)),
    ("adjust_gamma", lambda A, r: A.adjust_gamma(_image(11), 0.83)),
    ("adjust_gamma_gain", lambda A, r: A.adjust_gamma(_image(11), 1.21, 0.9)),
    ("degrade_resolution", lambda A, r: A.degrade_resolution(_image(12), 0.75)),
    ("color_jitter", lambda A, r: A.color_jitter(_image(13), r)),
    ("color_jitter_brightness", lambda A, r: A.color_jitter(
        _image(13), r, contrast=0, saturation=0, hue=0)),
    ("color_jitter_no_hue", lambda A, r: A.color_jitter(_image(14), r, hue=0)),
    ("grayscale_always", lambda A, r: A.grayscale(_image(15), r, p=1.0)),
    ("grayscale", lambda A, r: A.grayscale(_image(15), r)),
    ("resize_bilinear", lambda A, r: A.resize(_image(16), 17, 29)),
    ("resize_nearest", lambda A, r: A.resize(_mask(16), 41, 13, A.NEAREST)),
    ("random_resized_crop_params", lambda A, r: np.asarray(
        A.random_resized_crop_params((31, 23), r))),
    ("random_resized_crop_params_thin", lambda A, r: np.asarray(
        A.random_resized_crop_params((200, 3), r))),
    ("random_resized_crop", lambda A, r: A.random_resized_crop(
        _image(17), 19, 21, r)),
    ("random_resized_crop_params_given", lambda A, r: A.random_resized_crop(
        _mask(18), 19, 21, r, A.NEAREST, params=(2, 3, 10, 12))),
]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name,call", AUGMENT_CASES,
                         ids=[c[0] for c in AUGMENT_CASES])
def test_augment_functions_bit_equal(name, call, seed):
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    want, got = call(JA, rj), call(TA, rt)
    assert type(got) is type(want)
    if isinstance(want, tuple):  # center_cut's flag, the crop's params
        assert got[1:] == want[1:]
    w, g = _arr(want), _arr(got)
    assert g.dtype == w.dtype and g.shape == w.shape
    np.testing.assert_array_equal(g, w)
    # the same number of draws: the generators end in one state
    assert rt.bit_generator.state == rj.bit_generator.state


def test_resampling_constants_are_pillows():
    assert (TA.NEAREST, TA.LANCZOS, TA.BILINEAR) == (
        JA.NEAREST, JA.LANCZOS, JA.BILINEAR)


def _data_cfgs(h, w, max_n, every):
    """The same DataConfig in both packages: the CVPPP defaults, or every
    transform on."""
    kw = dict(image_height=h, image_width=w, max_n_objects=max_n)
    if every:
        kw.update(color_jitter=True, grayscale=True, channel_swap=True,
                  gamma=True, resolution=True)
    return (dataclasses.replace(jax_cvppp_config().data, **kw),
            dataclasses.replace(cvppp_config().data, **kw))


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """7 hard scenes at 53x47 (odd, non-square), read by the port's
    reader; both pipelines get the same samples."""
    prefix = str(tmp_path_factory.mktemp("pipe") / "train")
    write_synthetic_records(prefix, 7, seed=3, height=53, width=47, hard=True)
    return prefix


def _equal_batches(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("mode", ["training", "test", "training_host_only"])
@pytest.mark.parametrize("shape", [(32, 32, 8, True), (29, 35, 3, False),
                                   (24, 24, 4, False)])
def test_align_collate_bit_equal(records, mode, shape):
    h, w, max_n, every = shape
    jcfg, tcfg = _data_cfgs(h, w, max_n, every)
    ds = trec.SegRecordDataset(records)
    for seed in (0, 1, 2):
        for n in (4, 2):  # a full batch and a short one (padded by sample 0)
            samples = [ds[(seed + i) % len(ds)] for i in range(n)]
            rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
            want = jds.AlignCollate(mode, jcfg, 4)(samples, rng=rj).asdict()
            got = tds.AlignCollate(mode, tcfg, 4)(samples, rng=rt).asdict()
            _equal_batches(got, want)
            assert rt.bit_generator.state == rj.bit_generator.state
            assert got["images"].shape == (4, h, w, 3)
            assert got["ins_masks"].shape == (4, h, w, max_n)


def test_align_collate_rejects_an_unknown_mode():
    with pytest.raises(ValueError, match="unknown AlignCollate mode"):
        tds.AlignCollate("train", cvppp_config().data, 2)


def test_batches_iterator_bit_equal(records):
    jcfg, tcfg = _data_cfgs(24, 28, 5, True)
    ds = trec.SegRecordDataset(records)
    for drop_last in (False, True):
        want = list(jds.batches(ds, jds.AlignCollate("training", jcfg, 3), 3,
                                True, seed=4, epoch=1, drop_last=drop_last))
        got = list(tds.batches(ds, tds.AlignCollate("training", tcfg, 3), 3,
                               True, seed=4, epoch=1, drop_last=drop_last))
        assert len(got) == len(want) == (2 if drop_last else 3)
        for g, w in zip(got, want):
            _equal_batches(g, w)


@pytest.mark.parametrize("n_workers", [1, 3])
def test_prefetch_loader_bit_equal(records, n_workers):
    jcfg, tcfg = _data_cfgs(24, 24, 6, False)
    ds = trec.SegRecordDataset(records)
    for seed, epoch in ((23, 0), (5, 3)):
        jl = jld.PrefetchLoader(ds, jds.AlignCollate("training", jcfg, 3), 3,
                                shuffle=True, seed=seed, n_workers=n_workers)
        tl = tld.PrefetchLoader(ds, tds.AlignCollate("training", tcfg, 3), 3,
                                shuffle=True, seed=seed, n_workers=n_workers)
        assert len(tl) == len(jl) == 3
        want, got = list(jl.epoch(epoch)), list(tl.epoch(epoch))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            _equal_batches(g, w)
    tl = tld.PrefetchLoader(ds, tds.AlignCollate("test", tcfg, 3), 3,
                            shuffle=False, seed=0, n_workers=n_workers,
                            drop_last=True)
    assert len(tl) == 2 and len(list(tl.epoch(0))) == 2


def test_otsu_and_transfer_dataset_equal(tmp_path):
    gray = np.random.default_rng(0).beta(2, 5, (40, 50)).astype(np.float32)
    assert tds.otsu_threshold(gray) == jds.otsu_threshold(gray)
    (tmp_path / "sub").mkdir()
    for i, size in enumerate(((20, 30), (16, 16))):
        Image.fromarray(_image(i, *size)).save(tmp_path / "sub" / f"im{i}.png")
    jt, tt = jds.TransferDataset(str(tmp_path)), tds.TransferDataset(str(tmp_path))
    assert tt.samples == jt.samples and len(tt) == 2
    for i in range(2):
        for g, w in zip(tt[i], jt[i]):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _raw_tree(root):
    """A CVPPP-layout raw tree: 6 hard scenes of two sizes, one RGBA."""
    write_synthetic_eval_tree(str(root), 4, seed=2, height=37, width=41,
                              hard=True)
    img_dir = os.path.join(str(root), "data", "raw", "CVPPP",
                           "CVPPP2017_LSC_training", "training", "A1")
    extra = root / "extra"
    write_synthetic_eval_tree(str(extra), 2, seed=3, height=30, width=26)
    src = os.path.join(str(extra), "data", "raw", "CVPPP",
                       "CVPPP2017_LSC_training", "training", "A1")
    for name in os.listdir(src):
        shutil.copy(os.path.join(src, name),
                    os.path.join(img_dir, name.replace("plant", "leaf")))
    shutil.rmtree(extra)
    shutil.rmtree(os.path.join(str(root), "data", "metadata"))
    rgba = os.path.join(img_dir, "leaf0001_rgb.png")
    Image.open(rgba).convert("RGBA").save(rgba)


def _files(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read().replace(
                    str(root).encode(), b"<root>")
    return out


@pytest.mark.parametrize("fmt", ["records", "both"])
def test_prepare_outputs_equal_the_jax_scripts(tmp_path, monkeypatch, fmt):
    if fmt == "both":  # the in-memory lmdb stub of test_torch_records.py
        from test_torch_records import _FakeEnv, _fake_lmdb_module

        monkeypatch.setitem(sys.modules, "lmdb", _fake_lmdb_module())
    for pkg in ("j", "t"):
        _raw_tree(tmp_path / pkg)
    for pkg, mod in (("j", jprep), ("t", tprep)):
        mod.main(["--data_dir", str(tmp_path / pkg / "data"), "--seed", "3",
                  "--format", fmt])
    got, want = _files(tmp_path / "t"), _files(tmp_path / "j")
    assert got == want
    assert "data/processed/CVPPP/records/training.tsidx" in got
    assert len([k for k in got if k.endswith(".npy")]) == 12
    ds = trec.open_dataset(str(tmp_path / "t" / "data" / "processed" / "CVPPP"
                               / "records" / "training"))
    assert len(ds) == 4
    if fmt == "both":
        stores = {k.replace(str(tmp_path / "t"), "<root>"): v
                  for k, v in _FakeEnv._stores.items()
                  if k.startswith(str(tmp_path / "t"))}
        assert stores and stores == {
            k.replace(str(tmp_path / "j"), "<root>"): v
            for k, v in _FakeEnv._stores.items()
            if k.startswith(str(tmp_path / "j"))}
