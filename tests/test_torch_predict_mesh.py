"""The port's mesh ``Predictor`` (``use_mesh=True, n_devices=2``: two
replicas, each batch split on its leading axis) on the CPU, float32, at
``tests/test_torch_predict.py``'s small configuration.

* Against the JAX package's meshed ``Predictor`` on the faked CPU devices:
  the rounded batch size equal (5 -> 4 over 2 devices), the semantic
  probabilities within rtol 2e-4 / atol 2e-5 (``tests/test_predictor_mesh
  .py``'s), fg, id maps and counts equal.
* Against the port's predictor without a mesh: ``predict_batch_arrays``
  without the probabilities, ``predict_batch_packed`` (monolithic and
  staged), ``predict_paths`` and ``predict_paths_bucketed`` give equal
  outputs, and every replica ran extraction rounds.
"""

import copy

import numpy as np
import pytest
import torch

from test_torch_predict import _draw, _small
from tpuseg.cli.common import build_model, init_variables
from tpuseg.configs import cvppp_config as jax_cvppp_config
from tpuseg.data.synthetic import make_scene
from tpuseg.runtime.predict import Predictor as JaxPredictor
from tpuseg_torch.configs import cvppp_config
from tpuseg_torch.models import ReSeg
from tpuseg_torch.runtime.predict import Predictor
from tpuseg_torch.weights import load_flax


@pytest.fixture(scope="module")
def setup():
    import jax

    cfg = _small(jax_cvppp_config())
    model = build_model(cfg)
    shapes = jax.eval_shape(lambda: init_variables(cfg, model, 0))
    variables = _draw(shapes, seed=0)
    rng = np.random.default_rng(0)
    imgs = np.stack([make_scene(rng, 64, 64, hard=True)[0]
                     for _ in range(4)]).astype(np.uint8)
    model = load_flax(ReSeg(_small(cvppp_config())), variables)
    return variables, imgs, model


def _pair(model, **kw):
    tcfg = _small(cvppp_config())
    one = Predictor(tcfg, copy.deepcopy(model), batch_size=4, device="cpu",
                    **kw)
    two = Predictor(tcfg, copy.deepcopy(model), batch_size=5, device="cpu",
                    use_mesh=True, n_devices=2, **kw)
    return one, two


def test_mesh_predictor_matches_the_jax_mesh_predictor(setup):
    variables, imgs, model = setup
    jcfg = _small(jax_cvppp_config())
    jp = JaxPredictor(jcfg, build_model(jcfg), variables, batch_size=5,
                      use_mesh=True, n_devices=2)
    tp = _pair(model)[1]
    assert tp.batch_size == jp.batch_size == 4
    assert len(tp.replicas) == 2
    assert all(r.device == torch.device("cpu") for r in tp.replicas)
    want = [np.asarray(w) for w in jp.predict_batch_arrays(imgs)]
    got = [g.numpy() for g in tp.predict_batch_arrays(imgs)]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
    np.testing.assert_allclose(got[0], want[0], rtol=2e-4, atol=2e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)
    assert int(got[3].sum()) > 0
    assert all(r.rounds_run >= 1 for r in tp.replicas)


@pytest.mark.parametrize("staged", [False, True])
def test_mesh_predictor_equals_one_device(setup, tmp_path, staged):
    from PIL import Image

    _, imgs, model = setup
    one, two = _pair(model, staged=staged)
    a = one.predict_batch_arrays(imgs, with_probs=False)
    b = two.predict_batch_arrays(imgs, with_probs=False)
    assert a[0] is None and b[0] is None
    for x, y in zip(a[1:], b[1:]):
        assert x.dtype == y.dtype and torch.equal(x, y)
    for x, y in zip(one.predict_batch_packed(imgs),
                    two.predict_batch_packed(imgs)):
        assert torch.equal(x, y)
    paths = []
    for i, img in enumerate(imgs[:3]):  # a short last batch: padded
        paths.append(str(tmp_path / f"plant{i:04d}_rgb.png"))
        Image.fromarray(img[: 48 + 4 * i]).save(paths[-1])
    for run in ("predict_paths", "predict_paths_bucketed"):
        for x, y in zip(getattr(one, run)(paths), getattr(two, run)(paths)):
            assert x["path"] == y["path"] and x["n_objects"] == y["n_objects"]
            for key in ("image", "fg_mask", "ins_mask"):
                np.testing.assert_array_equal(x[key], y[key])
    assert all(r.rounds_run >= 1 for r in two.replicas)
