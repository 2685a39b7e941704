"""The port's on-device augmentation (``tpuseg_torch/data/device_aug.py``)
against ``tpuseg/data/device_aug.py::device_augment``.

The test draws what the JAX function draws from one key (the same split
and calls as ``device_aug.py:85-126``), feeds those draws to the port's
``apply_augment`` and compares the outputs per transform and with every
transform on: masks exactly, images within 1 on uint8 (float ``**`` and
the mean's summation order may round one way or the other; at most 1% of
the values where gamma or the colour jitter runs, none elsewhere).
Measured here: no image value differs in any case (8 x 20 x 20 x 3 and
8 x 20 x 26 x 3 values per case).

Then ``make_train_step(device_aug=True)`` against a plain step on the
batch augmented beforehand with the same draws: equal metrics and
parameters (tiny configuration, CPU).
"""

import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from tpuseg.configs import cvppp_config as jax_cvppp_config
from tpuseg.data.device_aug import device_augment as jax_device_augment
from tpuseg_torch.configs import cvppp_config
from tpuseg_torch.data.device_aug import apply_augment, device_augment, draw_augment
from tpuseg_torch.models import ReSeg
from tpuseg_torch.runtime.state import create_train_state
from tpuseg_torch.runtime.train import make_train_step, upload

FLAGS = ("hflip", "vflip", "transpose", "rot90", "color_jitter", "gamma",
         "channel_swap", "grayscale")


def _cfgs(on):
    kw = {f: f in on for f in FLAGS}
    return (dataclasses.replace(jax_cvppp_config().data, **kw),
            dataclasses.replace(cvppp_config().data, **kw))


def _batch(b=8, h=20, w=20, n=3, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "images": rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8),
        "sem_onehot": np.eye(2, dtype=np.float32)[rng.integers(0, 2, (b, h, w))],
        "ins_masks": (rng.random((b, h, w, n)) > 0.7).astype(np.float32),
        "n_objects": np.full((b,), n, np.int32),
    }


def jax_draws(key, b, square, cfg):
    """``device_aug.py:85-126``'s draws, as the port's named tensors."""
    (k_hf, k_vf, k_tr, k_rot, k_bri, k_con, k_sat, k_gam, k_swp, k_swpi,
     k_gry) = jax.random.split(key, 11)
    r = jax.random
    col = (b, 1, 1, 1)
    d = dict.fromkeys(("hf", "vf", "tr", "rotk", "fb", "fc", "fs", "g", "swp",
                       "swpi", "gry"))
    if cfg.hflip:
        d["hf"] = r.bernoulli(k_hf, 0.5, (b,))
    if cfg.vflip:
        d["vf"] = r.bernoulli(k_vf, 0.5, (b,))
    if cfg.transpose and square:
        d["tr"] = r.bernoulli(k_tr, 0.5, (b,))
    if cfg.rot90 and square:
        d["rotk"] = r.randint(k_rot, (b,), 0, 4)
    if cfg.color_jitter:
        for name, k in (("fb", k_bri), ("fc", k_con), ("fs", k_sat)):
            d[name] = 1.0 + r.uniform(k, col, minval=-0.4, maxval=0.4)
    if cfg.gamma:
        d["g"] = r.uniform(k_gam, col) * 0.6 + 0.7
    if cfg.channel_swap:
        d["swp"] = r.bernoulli(k_swp, 0.5, (b,))
        d["swpi"] = r.randint(k_swpi, (b, 3), 0, 3)
    if cfg.grayscale:
        d["gry"] = r.bernoulli(k_gry, 0.3, (b,))
    return {k: None if v is None else torch.from_numpy(np.asarray(v).copy())
            for k, v in d.items()}


CASES = [(f,) for f in FLAGS] + [FLAGS]


@pytest.mark.parametrize("square", [True, False])
@pytest.mark.parametrize("on", CASES, ids=["+".join(c) for c in CASES])
def test_apply_augment_matches_jax_under_shared_draws(on, square):
    jcfg, tcfg = _cfgs(on)
    batch = _batch(w=20 if square else 26, seed=len(on))
    key = jax.random.PRNGKey(7 + len(on[0]))
    want = jax_device_augment({k: jax.numpy.asarray(v) for k, v in batch.items()},
                              key, jcfg)
    draws = jax_draws(key, 8, square, jcfg)
    got = apply_augment(upload(batch, "cpu"), draws, tcfg)
    for k in ("sem_onehot", "ins_masks", "n_objects"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    gi, wi = got["images"].numpy(), np.asarray(want["images"])
    assert gi.dtype == wi.dtype == np.uint8 and gi.shape == wi.shape
    diff = np.abs(gi.astype(int) - wi.astype(int))
    assert diff.max() <= 1
    photometric = {"color_jitter", "gamma"} & set(on)
    assert (diff > 0).sum() <= (0.01 * diff.size if photometric else 0)


def test_draws_follow_the_config_and_the_shape():
    _, cfg = _cfgs(FLAGS)
    gen = torch.Generator().manual_seed(0)
    d = draw_augment(5, True, cfg, gen)
    assert all(v is not None for v in d.values())
    assert d["hf"].dtype == torch.bool and d["rotk"].shape == (5,)
    assert d["swpi"].shape == (5, 3) and int(d["swpi"].max()) < 3
    assert float(d["fb"].min()) >= 0.6 and float(d["g"].max()) < 1.3
    d = draw_augment(5, False, cfg, gen)
    assert d["tr"] is None and d["rotk"] is None and d["hf"] is not None
    _, off = _cfgs(())
    assert all(v is None for v in draw_augment(5, True, off, gen).values())


def test_device_augment_is_draw_then_apply():
    _, cfg = _cfgs(FLAGS)
    batch = upload(_batch(seed=3), "cpu")
    got = device_augment(batch, torch.Generator().manual_seed(4), cfg)
    draws = draw_augment(8, True, cfg, torch.Generator().manual_seed(4))
    want = apply_augment(batch, draws, cfg)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _tiny():
    cfg = cvppp_config()
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, image_height=32, image_width=32,
                                 max_n_objects=4, color_jitter=True,
                                 gamma=True, channel_swap=True, grayscale=True),
        model=dataclasses.replace(cfg.model, n_filters=8),
    )


def test_train_step_with_device_aug_equals_a_step_on_the_augmented_batch():
    torch.set_num_threads(2)
    cfg = _tiny()
    torch.manual_seed(0)
    model_a = ReSeg(cfg)
    model_b = copy.deepcopy(model_a)
    state_a = create_train_state(cfg, model_a, device="cpu")
    state_b = create_train_state(cfg, model_b, device="cpu")
    batch = _batch(b=2, h=32, w=32, n=4, seed=5)

    gen_a = torch.Generator().manual_seed(11)
    _, m_a = make_train_step(cfg, model_a, device_aug=True)(state_a, batch,
                                                            gen_a)

    gen_b = torch.Generator().manual_seed(11)
    draws = draw_augment(2, True, cfg.data, gen_b)
    augmented = apply_augment(upload(batch, "cpu"), draws, cfg.data)
    assert not torch.equal(augmented["images"], upload(batch, "cpu")["images"])
    _, m_b = make_train_step(cfg, model_b)(state_b, augmented, gen_b)

    assert m_a.keys() == m_b.keys()
    for k in m_a:
        assert torch.equal(m_a[k], m_b[k]), k
    for (name, p), q in zip(model_a.state_dict().items(),
                            model_b.state_dict().values()):
        assert torch.equal(p, q), name
    assert state_a.step == state_b.step == 1
