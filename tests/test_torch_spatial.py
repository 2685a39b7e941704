"""The port's spatial (H-sharded) path (``tpuseg_torch/parallel/spatial.py``)
on the CPU: gloo ranks through ``run_ranks(device="cpu")`` against one
process and against the JAX package, mirroring
``tests/test_spatial_sharding.py``.

One spawn of 4 ranks runs every sharded case in turn
(``parallel/tasks.py::in_turn``); the one-process references run here.

* Semantic at H=128, W=64 (32 rows a rank), ``n_filters`` 8: the ranks'
  probabilities within rtol 2e-4 / atol 2e-5 of one process and of the
  JAX package's single-device ``apply(mode="semantic")`` on the same
  seeded weights (``weights.to_flax``); the ranks move halos and
  reductions only (the JAX test: collective-permutes, no all-gather).
* Instance inference at 128x128 (the windowed decode: 96 / 32),
  ``max_instances`` 4: id maps and counts exactly one process's; no
  gathered tensor has a dim >= H or more than 1/8 of the 21-channel input
  activation, and the halos are at most 4 rows.
* Training: two SGD steps under ``deterministic_glimpse`` at H=64, W=32,
  B=2: parameters within rtol 5e-3 / atol 1.6e-2 of one process (the JAX
  test's bound), the ranks bit-identical, the gathers under 4 input
  activations, each under one, none a full-resolution map of more than
  2 channels.
* H=32 over 4 ranks (8 rows a rank: the UNet's 1/16 level and the decode's
  1/4 and coarser gather): semantic and inference equal one process.
* H not dividing over the ranks raises ``ValueError``.
* The two kinds of reduction: a train-mode ``MaskedBatchNorm`` with its
  rows over 4 ranks, and with its samples over 4 ranks (data parallel),
  each equal to one process (atol 1e-5).
* ``masked_softmax`` over split rows: the plain pieces over 2 emulated
  ranks equal the whole-row plain version (forward and backward, 1e-6),
  and ``spatial.masked_softmax`` over the 4 ranks equals it (1e-6).
* ``decode_split(fg_mask=)``'s foreground-seeking window origins at H=64
  (windows of 32 on a 16 grid, across the ranks' rows, tied masses): the
  4 ranks give one process's and the JAX package's origins, moving only
  the (B, n_r, n_c) window masses.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.cli.common import build_model
from tpuseg.configs import cvppp_config as jax_cvppp_config
from tpuseg.data.colorspace import image_ex_standardize as jax_standardize
from tpuseg_torch.configs import cvppp_config
from tpuseg_torch.kernels import masked_softmax as ms
from tpuseg_torch.models import ReSeg
from tpuseg_torch.parallel import make_mesh, run_ranks, spatial, tasks
from tpuseg_torch.runtime.predict import Predictor
from tpuseg_torch.weights import to_flax

LIMIT = 400  # seconds the spawn may take
N_RANKS = 4


def _sized(cfg, h, w, **model_kw):
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, image_height=h, image_width=w,
                                 max_n_objects=4),
        model=dataclasses.replace(cfg.model, n_filters=8, **model_kw),
    )


def _train_cfg(cfg, h, w):
    cfg = _sized(cfg, h, w)
    return dataclasses.replace(
        cfg,
        train=dataclasses.replace(cfg.train, batch_size=2, optimizer="SGD",
                                  learning_rate=0.01),
        decoder=dataclasses.replace(cfg.decoder, deterministic_glimpse=True),
    )


def _images(b, h, w, seed=0):
    return (np.random.RandomState(seed).rand(b, h, w, 3) * 255).astype(
        np.uint8)


def _infer_model(cfg, images):
    """Seeded weights whose semantic head marks about half the pixels
    foreground and whose finest pyramid head leans to foreground, so the
    extraction emits instances (no count heads: the budget is 4)."""
    torch.manual_seed(0)
    model = ReSeg(cfg).eval()
    with torch.no_grad():
        x = Predictor._standardize(torch.from_numpy(images))
        logits = model._backbone(x)[2]
        model.sem_seg_output.bias[1] -= (logits[:, 1] - logits[:, 0]).median()
        model.decoder.bone.pred4.Conv_1.bias[1] += 0.5
    return {k: v.clone() for k, v in model.state_dict().items()}


def _train_batch(h, w):
    """``tests/test_spatial_sharding.py``'s training batch."""
    rng = np.random.RandomState(0)
    labels = np.zeros((2, h, w), np.int32)
    labels[:, 16:48, 8:24] = 1
    ins = np.zeros((2, h, w, 4), np.float32)
    ins[:, 16:32, 8:24, 0] = 1
    ins[:, 32:48, 8:24, 1] = 1
    return {
        "images": rng.randint(0, 255, (2, h, w, 3)).astype(np.uint8),
        "sem_onehot": np.eye(2, dtype=np.float32)[labels],
        "ins_masks": ins,
        "n_objects": np.full((2,), 2, np.int32),
    }


def _softmax_inputs(seed, b=2, n=3, h=16, w=8):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(b, 1, h, w)).astype(np.float32)
    mask = (rng.random((b, n, h, w)) < 0.3).astype(np.float32)
    mask[0, 1] = 0.0  # an instance with no pixel
    mask[1, 2] = 0.0
    mask[1, 2, 13, 5] = 1.0  # an instance on one rank's rows only
    g = rng.normal(size=(b, n, h, w)).astype(np.float32)
    g[:, 0] = 0.0  # a row with no cotangent
    return e, mask, g


def _fg_window_inputs():
    """A remaining-foreground mask at 64x64 whose window masses tie (two
    equal blocks, mirrored), and glimpses at and between them."""
    fg = np.zeros((2, 1, 64, 64), np.float32)
    fg[0, 0, 8:24, 8:24] = 1.0
    fg[0, 0, 40:56, 8:24] = 1.0
    fg[1, 0, 20:44, 30:34] = 1.0
    pts = np.array([32 * 64 + 16, 16 * 64 + 16, 31 * 64 + 31, 44 * 64 + 33],
                   np.int64)
    return fg, pts


def _bn_inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(4, 3, 16, 8)).astype(np.float32)
    mask = (rng.random((4, 1, 16, 8)) < 0.5).astype(np.float32)
    gy = rng.normal(size=x.shape).astype(np.float32)
    return x, mask, gy


class _Case:
    """The configurations, weights and inputs of every sharded case."""

    def __init__(self):
        self.jax_model = build_model(_sized(jax_cvppp_config(), 128, 64))
        self.sem_cfg = _sized(cvppp_config(), 128, 64)
        torch.manual_seed(0)
        sem_model = ReSeg(self.sem_cfg)
        self.jax_vars = to_flax(sem_model)  # the same weights for JAX
        self.sem_state = {k: v.clone()
                          for k, v in sem_model.state_dict().items()}
        self.sem_images = _images(2, 128, 64)
        off = dict(use_density_head=False, use_count_head=False)
        self.inf_cfg = _sized(cvppp_config(), 128, 128, **off)
        self.inf_images = _images(2, 128, 128, seed=1)
        self.inf_state = _infer_model(self.inf_cfg, self.inf_images)
        self.small_cfg = _sized(cvppp_config(), 32, 32, **off)
        self.small_images = _images(2, 32, 32, seed=2)
        self.small_state = _infer_model(self.small_cfg, self.small_images)
        self.train_cfg = _train_cfg(cvppp_config(), 64, 32)
        torch.manual_seed(0)
        self.train_state = ReSeg(self.train_cfg).state_dict()
        self.train_batch = _train_batch(64, 32)
        self.bn = _bn_inputs(3)
        self.softmax = _softmax_inputs(4)
        self.fg_window = _fg_window_inputs()

    def calls(self):
        f32 = torch.float32
        return [
            (tasks.spatial_semantic, (self.sem_cfg, self.sem_state,
                                      self.sem_images, None, True)),
            (tasks.spatial_infer, (self.inf_cfg, self.inf_state,
                                   [self.inf_images], 4, None, None, True)),
            (tasks.spatial_train, (self.train_cfg, self.train_state,
                                   [self.train_batch] * 2, f32, True)),
            (tasks.spatial_semantic, (self.small_cfg, self.small_state,
                                      self.small_images, None, True)),
            (tasks.spatial_infer, (self.small_cfg, self.small_state,
                                   [self.small_images], 4, None, None, True)),
            (tasks.masked_batch_norm_grads, (*self.bn, True)),
            (tasks.masked_batch_norm_grads, (*self.bn, False)),
            (tasks.split_masked_softmax, self.softmax),
            (tasks.spatial_window_origin_fg, (*self.fg_window, 32, 16, 2)),
        ]


@pytest.fixture(scope="module")
def case():
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    c = _Case()
    c.ranks = run_ranks(tasks.in_turn, N_RANKS, args=(c.calls(),),
                        device="cpu", timeout=LIMIT)
    one = make_mesh(1, "cpu")
    c.one = [task(one, *args) for task, args in c.calls()[:5]]
    torch.set_num_threads(before)
    return c


def _rows(case, i, get, dim):
    return torch.cat([get(r[i]) for r in case.ranks], dim=dim)


def _gathers(comms, ops=("gather",)):
    return [c for c in comms if c["op"] in ops]


def test_semantic_matches_one_process_and_the_jax_package(case):
    got = _rows(case, 0, lambda r: r["probs"], 2)
    np.testing.assert_allclose(got.numpy(), case.one[0]["probs"].numpy(),
                               rtol=2e-4, atol=2e-5)
    ref = jax.jit(lambda v, x: case.jax_model.apply(
        v, jax_standardize(x), mode="semantic"))(
        case.jax_vars, jnp.asarray(case.sem_images))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), rtol=2e-4, atol=2e-5)
    # each rank holds its 32 rows
    assert [r[0]["probs"].shape[2] for r in case.ranks] == [32] * N_RANKS


def test_semantic_moves_halos_not_maps(case):
    """The JAX test: collective-permutes and no all-gather."""
    for r in case.ranks:
        ops = {c["op"] for c in r[0]["comms"]}
        assert "halo" in ops and not _gathers(r[0]["comms"]), ops
        assert all(c["shape"][2] <= 2 for c in r[0]["comms"]
                   if c["op"] == "halo")


def test_infer_matches_one_process_exactly(case):
    one = case.one[1]["outs"][0]
    idmap = _rows(case, 1, lambda r: r["outs"][0]["idmap"], 1)
    np.testing.assert_array_equal(idmap.numpy(), one["idmap"].numpy())
    for r in case.ranks:
        np.testing.assert_array_equal(r[1]["outs"][0]["counts"].numpy(),
                                      one["counts"].numpy())
        assert r[1]["rounds"] == case.one[1]["rounds"]
    assert one["counts"].sum() > 0
    sem = _rows(case, 1, lambda r: r["outs"][0]["sem"], 2)
    np.testing.assert_allclose(sem.numpy(), one["sem"].numpy(), rtol=2e-4,
                               atol=2e-5)


def test_infer_gathers_only_small_coarse_maps(case):
    """No gathered tensor has a dim >= H, each is at most 1/8 of the
    21-channel input activation; the halos are at most 4 rows."""
    h = 128
    act = 2 * h * 128 * 21
    for r in case.ranks:
        comms = r[1]["comms"]
        assert any(c["op"] == "halo" for c in comms)
        for c in _gathers(comms):
            assert max(c["shape"]) < h, c
            assert int(np.prod(c["shape"])) * 8 <= act, c
        assert all(c["shape"][2] <= 8 for c in comms if c["op"] == "halo")


def test_train_matches_one_process(case):
    one = case.one[2]
    for r in case.ranks:
        for k, v in one["model"].items():
            np.testing.assert_allclose(r[2]["model"][k].numpy(), v.numpy(),
                                       rtol=5e-3, atol=1.6e-2, err_msg=k)
        assert r[2]["step"] == one["step"] == 2
    for k in case.ranks[0][2]["model"]:
        assert all(torch.equal(r[2]["model"][k], case.ranks[0][2]["model"][k])
                   for r in case.ranks), k
    cost = case.ranks[0][2]["metrics"][0]["cost"]
    assert abs(cost - one["metrics"][0]["cost"]) < 2e-2 * max(1.0, abs(cost))


def test_train_gathers_stay_under_the_input_activation(case):
    act = 2 * 64 * 32 * 21
    for r in case.ranks:
        comms = r[2]["comms"]
        assert any(c["op"] == "halo_grad" for c in comms)
        # the gathers and, in the backward, their all-reduced gradients
        moved = _gathers(comms, ("gather", "gather_grad", "take_grad"))
        sizes = [int(np.prod(c["shape"])) for c in moved]
        assert all(s <= act for s in sizes)
        # no rank holds all rows of a full-resolution map of > 2 channels
        assert not [c for c in moved if c["shape"][2] >= 64
                    and c["shape"][1] > 2]
        assert sum(sizes) <= 4 * act, sum(sizes)


def test_h32_gathers_coarse_levels_and_matches(case):
    sem = _rows(case, 3, lambda r: r["probs"], 2)
    np.testing.assert_allclose(sem.numpy(), case.one[3]["probs"].numpy(),
                               rtol=2e-4, atol=2e-5)
    # the UNet's 1/16 level (2 rows) does not divide over 4 ranks
    assert _gathers(case.ranks[0][3]["comms"])
    one = case.one[4]["outs"][0]
    idmap = _rows(case, 4, lambda r: r["outs"][0]["idmap"], 1)
    np.testing.assert_array_equal(idmap.numpy(), one["idmap"].numpy())
    np.testing.assert_array_equal(
        case.ranks[0][4]["outs"][0]["counts"].numpy(), one["counts"].numpy())
    for c in _gathers(case.ranks[0][4]["comms"]):
        assert c["shape"][2] <= 8, c  # levels at 1/4 or coarser


def test_rows_that_do_not_divide_raise():
    mesh = spatial.Mesh(4, 1, torch.device("cpu"))
    with pytest.raises(ValueError, match="does not divide"):
        spatial.shard_spatial(np.zeros((1, 30, 8, 3), np.uint8), mesh)
    with pytest.raises(ValueError, match="does not divide"):
        spatial.shard_train_batch({"images": np.zeros((1, 30, 8, 3)),
                                   "n_objects": np.ones(1)}, mesh)
    with pytest.raises(ValueError, match="fewer than"):
        spatial.shard_spatial(np.zeros((1, 8, 8, 3), np.uint8), mesh)
    got = spatial.shard_spatial(np.arange(32 * 2).reshape(1, 32, 2, 1), mesh)
    assert got.shape == (1, 8, 2, 1) and int(got[0, 0, 0, 0]) == 16


@pytest.mark.parametrize("kind,index", [("rows", 5), ("samples", 6)])
def test_masked_batch_norm_both_reductions(case, kind, index):
    """Rows of the same samples over the ranks (spatial) and samples over
    the ranks (data parallel) each give one process's MaskedBatchNorm."""
    from tpuseg_torch.nn.attention import MaskedBatchNorm

    x, mask, gy = case.bn
    bn = MaskedBatchNorm(3).train()
    xt = torch.from_numpy(x).requires_grad_()
    y = bn(xt, torch.from_numpy(mask))
    y.backward(torch.from_numpy(gy))
    dim = 2 if kind == "rows" else 0
    res = [r[index] for r in case.ranks]
    close = dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(torch.cat([r["y"] for r in res], dim), y.detach(),
                               **close)
    torch.testing.assert_close(torch.cat([r["dx"] for r in res], dim), xt.grad,
                               **close)
    torch.testing.assert_close(sum(r["dscale"] for r in res), bn.scale.grad,
                               **close)
    torch.testing.assert_close(sum(r["dbias"] for r in res), bn.bias.grad,
                               **close)
    for r in res:
        torch.testing.assert_close(r["mean"], bn.mean, **close)
        torch.testing.assert_close(r["var"], bn.var, **close)


def _whole_row(e, mask, g):
    b, n, h, w = mask.shape
    et = torch.from_numpy(e).reshape(b, h * w).requires_grad_()
    p = ms.masked_softmax_plain(et, torch.from_numpy(mask).reshape(b, n, -1))
    p.backward(torch.from_numpy(g).reshape(b, n, -1))
    return p.detach().reshape(b, n, h, w), et.grad.reshape(b, 1, h, w)


def test_split_plain_pieces_over_two_rows_equal_the_whole_row():
    e, mask, g = _softmax_inputs(5)
    want_p, want_de = _whole_row(e, mask, g)
    b, n, h, w = mask.shape
    halves = [slice(0, h // 2), slice(h // 2, h)]
    flat = lambda a, s: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a[:, :, s])).reshape(a.shape[0], a.shape[1], -1)
    es = [flat(e, s)[:, 0] for s in halves]
    masks = [flat(mask, s) for s in halves]
    gs = [flat(g, s) for s in halves]
    stats = spatial._combine_stats([ms.masked_softmax_stats_plain(ei, mi)
                                    for ei, mi in zip(es, masks)])
    ps = [ms.masked_softmax_apply_plain(ei, mi, stats)
          for ei, mi in zip(es, masks)]
    dots = sum(ms.masked_softmax_row_dots_plain(pi, gi)
               for pi, gi in zip(ps, gs))
    des = [ms.masked_softmax_tiles_plain(pi, gi, dots)
           for pi, gi in zip(ps, gs)]
    got_p = torch.cat([pi.reshape(b, n, h // 2, w) for pi in ps], dim=2)
    got_de = torch.cat([d.reshape(b, 1, h // 2, w) for d in des], dim=2)
    torch.testing.assert_close(got_p, want_p, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got_de, want_de, rtol=1e-6, atol=1e-6)
    assert float(got_p[0, 1].abs().sum()) == 0.0  # the empty instance


def test_split_masked_softmax_over_the_ranks(case):
    want_p, want_de = _whole_row(*case.softmax)
    got_p = _rows(case, 7, lambda r: r["p"], 2)
    got_de = _rows(case, 7, lambda r: r["de"], 2)
    torch.testing.assert_close(got_p, want_p, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got_de, want_de, rtol=1e-6, atol=1e-6)


def test_fg_window_origins_over_the_ranks(case):
    """``decode_split(fg_mask=)`` picks its windows from the summed row
    partials of the window masses: the ranks agree with one process and
    with the JAX package, ties (equal masses) included."""
    from tpuseg.decoder import pyramid as jpy

    fg, pts = case.fg_window
    one = tasks.spatial_window_origin_fg(make_mesh(1, "cpu"), fg, pts, 32,
                                         16, 2)
    want = jpy.window_origin_fg(jnp.asarray(pts, jnp.int32), (64, 64), 32,
                                16, jnp.asarray(np.moveaxis(fg, 1, -1)), 2)
    for r in case.ranks:
        got = r[8]
        for k, j in (("ir", 0), ("ic", 1)):
            np.testing.assert_array_equal(got[k].numpy(), one[k].numpy())
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[j]))
        assert [c["op"] for c in got["comms"]] == ["reduce"]
        assert tuple(got["comms"][0]["shape"]) == (2, 3, 3)
