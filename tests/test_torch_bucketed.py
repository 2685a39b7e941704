"""The port's bucketed (mixed-resolution) predictor against the JAX
package's, float32 on the CPU, at ``tests/test_staged_extraction.py``'s
small model (n_filters=8, max_n_objects=8, base size 64x64) with buckets
on a 32 grid and a cap of 128:

* 50x120 -> bucket 64x128: not square, so the decode is not windowed;
* 110x100 -> 128x128: square above the base size, the 192 / 64 window
  scales to 96 / 32;
* 140x170 -> capped at 128x128: downscaled onto the canvas, the masks
  upsampled back;
* 40x40 -> 64x64: the window scales to 48 / 16.

Tolerance: every mask pixel and count equal to the JAX package's.
"""

import dataclasses

import jax
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

SIZES = [(50, 120), (110, 100), (140, 170), (40, 40)]
BUCKETS = [(64, 128), (128, 128), (128, 128), (64, 64)]
MULTIPLE, CAP = 32, 128


def _small(cfg):
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, image_height=64, image_width=64,
                                 max_n_objects=8),
        model=dataclasses.replace(cfg.model, n_filters=8),
    )


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    cfg = _small(jax_cvppp_config())
    shapes = jax.eval_shape(lambda: init_variables(cfg, build_model(cfg), 0))
    variables = _draw(shapes, seed=0)
    from PIL import Image

    root = tmp_path_factory.mktemp("bucketed")
    rng = np.random.default_rng(5)
    paths = []
    for i, (h, w) in enumerate(SIZES):
        p = str(root / f"img_{i}.png")
        Image.fromarray(make_scene(rng, h, w, hard=True)[0].astype(
            np.uint8)).save(p)
        paths.append(p)
    return variables, paths


def _port(variables, staged=False):
    tcfg = _small(cvppp_config())
    return Predictor(tcfg, load_flax(ReSeg(tcfg), variables), batch_size=2,
                     device="cpu", staged=staged)


def test_bucket_shape_matches_jax():
    cases = [((250, 500, 64), {}), ((64, 64, 64), {}), ((1, 1, 64), {}),
             ((5000, 100, 64), {"cap": 1024})]
    want = [(256, 512), (64, 64), (64, 64), (1024, 128)]
    for (args, kw), w in zip(cases, want):
        assert Predictor._bucket_shape(*args, **kw) == w
        assert JaxPredictor._bucket_shape(*args, **kw) == w
    for (h, w), b in zip(SIZES, BUCKETS):
        assert Predictor._bucket_shape(h, w, MULTIPLE, CAP) == b


def test_window_plan_at_the_buckets():
    """The windowed decode's rule (``tpuseg/decoder/pyramid.py``
    ``decode_split``: square canvases only, the 256-calibrated window and
    stride scaled with the canvas, tiling on the stride grid) at this
    file's buckets and at the CVPPP 2017 buckets of ``chip_smoke.py``."""
    from tpuseg_torch.decoder.pyramid import window_plan

    want = {(64, 128): None, (128, 128): (96, 32), (64, 64): (48, 16),
            (256, 256): (192, 64), (576, 512): None, (576, 576): (432, 144),
            (448, 448): (336, 112), (1024, 1024): (768, 256),
            (320, 320): (240, 80)}
    for (h, w), plan in want.items():
        assert window_plan(h, w, 192, 64) == plan, (h, w)
    assert window_plan(256, 256, 0, 64) is None
    assert window_plan(200, 200, 192, 64) is None  # 150 is not a multiple of 4


def test_bucketed_matches_jax(setup):
    variables, paths = setup
    jcfg = _small(jax_cvppp_config())
    jp = JaxPredictor(jcfg, build_model(jcfg), variables, batch_size=2)
    want = list(jp.predict_paths_bucketed(paths, multiple=MULTIPLE, cap=CAP))
    got = list(_port(variables).predict_paths_bucketed(
        paths, multiple=MULTIPLE, cap=CAP))
    assert [r["path"] for r in got] == [r["path"] for r in want] == paths
    for g, w, (h, wd) in zip(got, want, SIZES):
        assert g["fg_mask"].shape == g["ins_mask"].shape == (h, wd)
        for k in ("image", "fg_mask", "ins_mask"):
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert g["n_objects"] == w["n_objects"]
    assert sum(r["n_objects"] for r in got) > 0


def test_bucketed_order_and_solo_runs(setup):
    """Results come in the order of the paths whatever the buckets; an
    image run alone gives what it gave in the joint run; the staged
    predictor gives the same."""
    _, paths = setup
    variables = setup[0]
    p = _port(variables)
    order = [3, 0, 2, 1]
    joint = list(p.predict_paths_bucketed([paths[i] for i in order],
                                          multiple=MULTIPLE, cap=CAP))
    assert [r["path"] for r in joint] == [paths[i] for i in order]
    for r, i in zip(joint, order):
        solo = next(iter(p.predict_paths_bucketed([paths[i]],
                                                  multiple=MULTIPLE, cap=CAP)))
        np.testing.assert_array_equal(solo["fg_mask"], r["fg_mask"])
        np.testing.assert_array_equal(solo["ins_mask"], r["ins_mask"])
        assert solo["n_objects"] == r["n_objects"]
    staged = list(_port(variables, staged=True).predict_paths_bucketed(
        [paths[i] for i in order], multiple=MULTIPLE, cap=CAP))
    for a, b in zip(staged, joint):
        np.testing.assert_array_equal(a["ins_mask"], b["ins_mask"])
        assert a["n_objects"] == b["n_objects"]
