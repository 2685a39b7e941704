"""The decoder's loss path against the JAX package where the comparison can
be tight: the eval-mode loss forward of the whole model, and the train-mode
gradients of the pyramid decoder under the pyramid loss, evaluated on its
own (``tests/test_torch_train.py`` says why the whole compiled step allows
less).  Tiny configuration, float32, CPU; the helpers and the numpy-drawn
variables are that file's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import (
    cheap_jit,
    draw_variables,
    make_batch,
    tiny,
)
from tpuseg.cli.common import build_model
from tpuseg.configs import cvppp_config as jax_cvppp_config
from tpuseg.decoder import instance as jins
from tpuseg.decoder import pyramid as jpy
from tpuseg.runtime.train import total_cost as jax_total_cost
from tpuseg_torch.configs import cvppp_config
from tpuseg_torch.decoder import instance as tins
from tpuseg_torch.models import ReSeg
from tpuseg_torch.runtime.train import model_inputs, total_cost
from tpuseg_torch.weights import grads_to_flax, load_flax, to_flax


@pytest.fixture(scope="module")
def setup():
    variables, batch = draw_variables(), make_batch()
    images, sem, ins, n_obj = model_inputs(batch, "cpu")
    return variables, batch, (images, sem, ins, n_obj)


def test_loss_mode_eval_forward_matches_jax(setup):
    """Every key of ``total_cost``'s metrics in eval mode, rtol 1e-4; the
    glimpse loop runs max(min(n_ins), 1) = 1 iteration and moves no
    statistics."""
    variables, batch, (images, sem, ins, n_obj) = setup
    jcfg, tcfg = tiny(jax_cvppp_config()), tiny(cvppp_config())
    jmodel = build_model(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jax_eval(variables):
        sem_logits, _, dec = jmodel.apply(
            variables, jb["images"], jb["sem_onehot"], jb["ins_masks"],
            jb["n_objects"], train=False, mode="loss",
            rngs={"glimpse": jax.random.PRNGKey(0)})
        return jax_total_cost(jcfg, sem_logits, jb["sem_onehot"], dec,
                              train=False, n_objects=jb["n_objects"])[1]

    want = cheap_jit(jax_eval, variables)(variables)
    model = load_flax(ReSeg(tcfg), variables).eval()
    with torch.no_grad():
        sem_logits, _, dec = model.loss(images, sem, ins, n_obj)
        _, got = total_cost(tcfg, sem_logits, sem, dec, False, n_obj)
    assert set(got) == set(want) and len(want) == 11
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert len(model.decoder.last_points) == 1
    after = to_flax(model)
    for col in ("batch_stats", "decoder_state"):
        for a, b in zip(jax.tree_util.tree_leaves(after[col]),
                        jax.tree_util.tree_leaves(variables[col])):
            np.testing.assert_array_equal(a, b)


def test_pyramid_decoder_train_gradients_match_jax(setup):
    """``AttenDecoder`` in train mode on the model's own skip features, one
    glimpse per sample, under ``pred_loss`` against the pooled gold masks:
    the per-level logits (1e-4 of max|logit|), the gradient of every
    parameter, and the gradient with respect to the five skip features
    (what flows on into the backbone).  Per leaf the relative L2 error is
    <= 2e-2 with a median <= 1e-3 (float32 noise through train-mode
    BatchNorm and ReLU6 kinks; measured median 2e-4, largest 5e-3); a
    parameter whose gradient is zero by construction is held to 1e-5 of
    the largest."""
    variables, batch, (images, sem, ins, n_obj) = setup
    jcfg, tcfg = tiny(jax_cvppp_config()), tiny(cvppp_config())
    model = load_flax(ReSeg(tcfg), variables).train()
    with torch.no_grad():
        _, skips, _ = model._backbone(images)
    sem_mask = sem.argmax(dim=1, keepdim=True).float()
    points = torch.tensor([15 * 32 + 8, 9 * 32 + 9])  # inside instance 0
    gold = ins[:, 0:1]

    nhwc = lambda t: jnp.asarray(t.permute(0, 2, 3, 1).numpy())  # noqa: E731
    bone_vars = {
        col: variables[col]["decoder"]["glimpse"]["bone"]
        for col in ("params", "batch_stats")
    }
    jdec = jpy.AttenDecoder(cfg=jcfg.decoder, n_filters=8)

    def jax_loss(params, feats):
        (targets, preds), _ = jdec.apply(
            dict(bone_vars, params=params), jnp.asarray(points.numpy()),
            feats, nhwc(sem_mask), nhwc(gold), None, True,
            mutable=["batch_stats"])
        return jins.pred_loss(jcfg.decoder, preds, targets)[0].sum(), preds

    (_, want_preds), (want, want_feats) = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True))(
            bone_vars["params"], [nhwc(s) for s in skips])

    bone = model.decoder.bone
    skips = [s.clone().requires_grad_() for s in skips]
    targets, preds = bone(points, skips, sem_mask, gold)
    tins.pred_loss(tcfg.decoder, preds, targets)[0].sum().backward()
    for s, w in zip(skips, want_feats):
        w = np.asarray(w, np.float64)
        g = s.grad.permute(0, 2, 3, 1).numpy().astype(np.float64)
        assert np.linalg.norm(g - w) <= 2e-2 * np.linalg.norm(w) > 0
    for g, w in zip(preds, want_preds):
        w = np.asarray(w)
        np.testing.assert_allclose(
            g.detach().permute(0, 2, 3, 1).numpy(), w, rtol=0,
            atol=1e-4 * np.abs(w).max())

    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = dict(jax.tree_util.tree_leaves_with_path(grads_to_flax(bone)))
    assert len(flat_w) == len(flat_g)
    top = max(float(np.abs(np.asarray(w)).max()) for _, w in flat_w)
    rels = []
    for path, w in flat_w:
        name = jax.tree_util.keystr(path)
        w, g = np.asarray(w, np.float64), np.asarray(flat_g[path], np.float64)
        if np.abs(w).max() < 1e-5 * top:
            assert np.abs(g).max() < 1e-5 * top, name
            continue
        rels.append(np.linalg.norm(g - w) / np.linalg.norm(w))
        assert rels[-1] <= 2e-2, (name, rels[-1])
    assert len(rels) > 250 and np.median(rels) <= 1e-3


def test_remat_changes_neither_gradients_nor_statistics(setup):
    """``cfg.remat`` checkpoints the pyramid decode: the recomputed forward
    sees the same dropout multipliers and leaves the BatchNorm statistics
    alone, so gradients and running statistics equal the run without it,
    bit for bit, with dropout and sampling on."""
    variables, batch, (images, sem, ins, n_obj) = setup
    results = []
    for remat in (True, False):
        cfg = tiny(cvppp_config(), remat=remat, drop_rate=0.5,
                   deterministic_glimpse=False)
        model = load_flax(ReSeg(cfg), variables).train()
        gen = torch.Generator().manual_seed(5)
        sem_logits, _, dec = model.loss(images, sem, ins, n_obj, generator=gen)
        cost, _ = total_cost(cfg, sem_logits, sem, dec, True, n_obj)
        cost.backward()
        results.append((float(cost.detach()), grads_to_flax(model),
                        to_flax(model)))
    (c1, g1, s1), (c2, g2, s2) = results
    assert c1 == c2 and np.isfinite(c1)
    for a, b in zip(jax.tree_util.tree_leaves(g1),
                    jax.tree_util.tree_leaves(g2)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree_util.tree_leaves(s1),
                    jax.tree_util.tree_leaves(s2)):
        np.testing.assert_array_equal(a, b)
