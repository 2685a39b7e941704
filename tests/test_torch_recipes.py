"""The port's model-production recipes (``tpuseg_torch/tools/``) against
the JAX package's own tools on the CPU, at small widths (n_filters 8,
32x32), both sides on one numpy-drawn weight tree
(``test_torch_predict._draw``), float32:

* the stopping-rule sweep (``calibrate_stopping.py``): a 2 x 1 x 2 grid on
  4 hard scenes gives the JAX ``Predictor(staged=True)`` loop's rows (the
  tool's loop: prep once, then one round a call with the four stop scalars
  as float32 / int32 / float32 / float32 until all are done): SBD, |DiC|,
  score and rounds-to-done equal as the JAX tool rounds them;
* the learning-evidence evaluation (``train_synthetic_e2e.py``): the
  port's ``evaluate`` equals ``tools/train_synthetic_e2e.py::evaluate``
  on the same records and weights (SBD and FG dice within 1e-6, counts
  equal).

JAX compiles: the staged predictor's prep and one-round programs, and the
JAX tool's infer.
"""

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_predict import _draw
from test_torch_train import tiny

from tpuseg.cli.common import build_model, init_variables
from tpuseg.configs import cvppp_config as jax_cvppp_config
from tpuseg.data.records import SegRecordDataset as JaxRecordDataset
from tpuseg.evalm.metrics import symmetric_best_dice_batch as jax_sbd
from tpuseg.runtime.predict import Predictor as JaxPredictor
from tpuseg_torch.configs import cvppp_config
from tpuseg_torch.data.records import SegRecordDataset
from tpuseg_torch.data.synthetic import write_synthetic_records
from tpuseg_torch.models import ReSeg
from tpuseg_torch.runtime.predict import Predictor
from tpuseg_torch.tools import calibrate_stopping, train_synthetic_e2e
from tpuseg_torch.weights import load_flax

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID = ([0.006, 0.024], [2], [0.0, 0.9], [-1.0])


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _weights(cfg):
    shapes = jax.eval_shape(
        lambda: init_variables(cfg, build_model(cfg), 0))
    return _draw(shapes, seed=3)


def _jax_sweep(jp, imgs, gt_ids, gt_ns, dic_weight=0.05):
    """``tools/calibrate_stopping.py``'s loop over the grid, on a JAX
    staged predictor (one batch)."""
    import itertools

    G = max(int(jp.cfg.decoder.extract_group), 1)
    max_rounds = -(-jp.cfg.data.max_n_objects // G)
    dec_vars = jp._decoder_variables()
    prep = jp._infer_prep(jp.variables, jnp.asarray(imgs))
    rounds1 = jp._rounds_fn(1)
    rows = []
    for min_frac, max_misses, sup, stop_frac in itertools.product(*GRID):
        sp = (jnp.asarray(min_frac, jnp.float32),
              jnp.asarray(max_misses, jnp.int32),
              jnp.asarray(sup, jnp.float32),
              jnp.asarray(stop_frac, jnp.float32))
        fg, sem_mask, budget, score, skips_t = prep
        carry, used = None, 0
        while used < max_rounds:
            idmap, counts, carry = rounds1(dec_vars, sem_mask, score,
                                           skips_t, budget, carry, sp)
            used += 1
            if bool(np.asarray(carry["done"]).all()):
                break
        pred_ids = np.asarray(idmap).astype(np.int32)
        sbd = float(np.mean(np.asarray(jax_sbd(gt_ids, pred_ids))))
        dic = float(np.mean(np.abs(gt_ns - np.asarray(counts))))
        rows.append({
            "min_frac": min_frac, "max_misses": max_misses,
            "suppress": sup, "stop_frac": stop_frac,
            "sbd": round(sbd, 4), "abs_dic": round(dic, 4),
            "score": round(sbd - dic_weight * dic, 4),
            "rounds_to_done": round(float(used), 2),
        })
    rows.sort(key=lambda r: -r["score"])
    return rows


def _slots16(cfg):
    """Up to 16 instances, 4 rounds of 4 glimpses, and no counting head:
    the stopping rule alone ends extraction (a random head would cap it)."""
    return dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, max_n_objects=16),
        model=dataclasses.replace(cfg.model, use_count_head=False,
                                  use_density_head=False))


def test_calibration_sweep_matches_the_jax_tools_loop():
    jcfg = _slots16(tiny(jax_cvppp_config()))
    tcfg = _slots16(tiny(cvppp_config()))
    variables = _weights(jcfg)
    imgs, gt_ids, gt_ns = calibrate_stopping.hard_scenes(4, 32, seed=77)
    jp = JaxPredictor(jcfg, build_model(jcfg), variables, batch_size=4,
                      staged=True)
    want = _jax_sweep(jp, imgs, gt_ids, gt_ns)

    p = Predictor(tcfg, load_flax(ReSeg(tcfg), variables), batch_size=4,
                  staged=True, device="cpu", dtype=torch.float32)
    preps = calibrate_stopping.prep_batches(p, imgs)
    got = calibrate_stopping.sweep(p, preps, gt_ids, gt_ns, *GRID)
    for r in got:
        del r["secs"]
    assert got == want
    assert len({(r["sbd"], r["abs_dic"]) for r in got}) > 1  # the knobs bite
    # the sweep leaves the predictor on the last point's tuple, typed as
    # the JAX tool passes it
    assert [type(v) for v in p.stop_params] == [
        np.float32, np.int32, np.float32, np.float32]
    report = calibrate_stopping.report(got, 4, 32, "ckpt", 0.05)
    assert report.count("\n| ") == len(got) + 1


def test_e2e_evaluate_matches_the_jax_tool(tmp_path):
    jcfg = train_synthetic_e2e.recipe_config(32, cfg=tiny(jax_cvppp_config()))
    tcfg = train_synthetic_e2e.recipe_config(32, cfg=tiny(cvppp_config()))
    variables = _weights(jcfg)
    prefix = str(tmp_path / "val")
    write_synthetic_records(prefix, 8, seed=2, height=32, width=32,
                            min_leaves=3, max_leaves=8)
    jax_e2e = _jax_tool("train_synthetic_e2e")
    sbd_j, fg_j, c_j = jax_e2e.evaluate(jcfg, build_model(jcfg), variables,
                                        JaxRecordDataset(prefix), 8)
    model = load_flax(ReSeg(tcfg), variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    sbd_t, fg_t, c_t = train_synthetic_e2e.evaluate(
        tcfg, model, SegRecordDataset(prefix), 8)
    np.testing.assert_array_equal(c_t, np.asarray(c_j))
    assert abs(sbd_t - sbd_j) <= 1e-6 and abs(fg_t - fg_j) <= 1e-6
    assert int(np.sum(c_t)) > 0
    # the evaluation runs on a copy: the trained model is left as it was
    assert model.training and all(torch.equal(v, before[k])
                                  for k, v in model.state_dict().items())


def run_jax_e2e(seed: int, epochs: int, root: str, n_filters: int = 0,
                res: int = 128) -> None:
    """The JAX package's ``tools/train_synthetic_e2e.py`` as it is, except
    for its records / output root (``root`` for ``/tmp/tpuseg_e2e``), the
    training seed (``cfg.train.seed``) and optionally the width: the
    learning-evidence reference for the port's recipe (PERF.md §6)."""
    src = open(os.path.join(REPO, "tools", "train_synthetic_e2e.py")).read()
    src = src.replace('"/tmp/tpuseg_e2e/trained_ckpt.msgpack"',
                      repr(os.path.join(root, "trained_ckpt.msgpack")))
    src = src.replace('"/tmp/tpuseg_e2e"', repr(root))
    model_kw = f", model=dataclasses.replace(cfg.model, n_filters={n_filters})"
    src = src.replace(
        "    cfg = cvppp_config()\n",
        "    cfg = cvppp_config()\n    cfg = dataclasses.replace(cfg, train="
        f"dataclasses.replace(cfg.train, seed={seed})"
        f"{model_kw if n_filters else ''})\n", 1)
    assert "/tmp/tpuseg_e2e" not in src and f"seed={seed}" in src
    ns = {"__name__": "jax_train_synthetic_e2e",
          "__file__": os.path.join(REPO, "tools", "train_synthetic_e2e.py")}
    exec(compile(src, "tools/train_synthetic_e2e.py", "exec"), ns)
    ns["main"](epochs=epochs, res=res)


if __name__ == "__main__":
    import argparse

    jax.config.update("jax_platforms", "cpu")
    ap = argparse.ArgumentParser(
        description="the JAX e2e recipe on the CPU, the port's reference")
    ap.add_argument("--seed", type=int, default=23)
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--n_filters", type=int, default=0,
                    help="0: the configuration's width")
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--root", required=True)
    a = ap.parse_args()
    run_jax_e2e(a.seed, a.epochs, a.root, a.n_filters, a.res)
