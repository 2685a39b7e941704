"""The port's binding of the repo's C++ host library
(``tpuseg_torch/nn/native.py``), built at first use with the host compiler
from ``native/*.cpp`` into the git-ignored build directory: the SRU
forward against the port's plain loop (``sru_states``, 1e-5), the blob
gather against numpy slicing (exact), the size checks before any pointer
is passed, and a failed build raising with the compiler's message.  Also
``window_origin_fg`` (tied window masses) and ``calc_bd`` against the JAX
package, and ``decode_split(fg_mask=)`` taking those windows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.decoder import pyramid as jpy
from tpuseg.evalm import metrics as jmetrics
from tpuseg_torch.decoder import pyramid as tpy
from tpuseg_torch.evalm import metrics as tmetrics
from tpuseg_torch.kernels import build
from tpuseg_torch.nn import native
from tpuseg_torch.nn.sru import sru_states


def _sru_inputs(rng, length, batch, d, k, bidir, n_in=None):
    nb = 2 if bidir else 1
    f32 = np.float32
    return dict(
        u=rng.standard_normal((length, batch, nb * d * k)).astype(f32),
        x=rng.standard_normal((length, batch, n_in or nb * d)).astype(f32),
        weight_c=rng.standard_normal(2 * nb * d).astype(f32),
        bias=rng.standard_normal(2 * nb * d).astype(f32),
        c0=rng.standard_normal((batch, nb * d)).astype(f32),
        mask_pad=(rng.random((length, batch)) < 0.25).astype(f32),
    )


@pytest.mark.parametrize("bidir,k,activation,skip,c0,pad", [
    (False, 3, 0, True, False, False),
    (False, 4, 1, True, True, True),
    (True, 3, 2, True, True, True),
    (True, 4, 0, False, False, True),
    (False, 3, 3, False, True, False),
])
def test_sru_forward_cpu_matches_the_plain_loop(bidir, k, activation, skip,
                                               c0, pad):
    """uni / bi, k = 3 / 4, identity / tanh / relu, with and without the
    skip term, c0 and mask_pad; selu (3) has no plain counterpart: its
    cell states (which no activation touches) are held, its h is finite."""
    rng = np.random.default_rng(k + 10 * activation)
    a = _sru_inputs(rng, 7, 3, 5, k, bidir)
    kw = dict(d=5, bidirectional=bidir, has_skip_term=skip, scale_x=0.7)
    c0_ = a["c0"] if c0 else None
    mp = a["mask_pad"] if pad else None
    h, c = native.sru_forward_cpu(a["u"], a["x"], a["weight_c"], a["bias"],
                                  c0_, activation=activation, mask_pad=mp,
                                  **kw)
    t = lambda v: None if v is None else torch.from_numpy(v)  # noqa: E731
    act = 0 if activation == 3 else activation
    wh, wc, _ = sru_states(t(a["u"]), t(a["x"]), t(a["weight_c"]),
                           t(a["bias"]), t(c0_), activation=act,
                           mask_pad=t(mp), **kw)
    np.testing.assert_allclose(c, wc.numpy(), rtol=1e-5, atol=1e-5)
    if activation == 3:
        assert np.isfinite(h).all() and h.shape == wh.shape
        return
    np.testing.assert_allclose(h, wh.numpy(), rtol=1e-5, atol=1e-5)


def test_native_library_is_built_in_the_build_dir():
    path = build.build_host()
    assert path.parent == build.BUILD_DIR and path.exists()
    assert path == build.host_library_path()
    assert native.load() is native.load()


def test_a_failed_build_raises_with_the_compilers_message(tmp_path,
                                                         monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(build, "HOST_SOURCES", (bad,))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="native library build failed"
                       ) as err:
        build.build_host()
    assert "bad.cpp" in str(err.value)
    assert not list((tmp_path / "_build").glob("*.so"))


def test_sru_forward_cpu_checks_sizes_before_the_call():
    rng = np.random.default_rng(0)
    a = _sru_inputs(rng, 4, 2, 3, 3, False)
    args = (a["u"], a["x"], a["weight_c"], a["bias"])
    with pytest.raises(ValueError, match="x"):
        native.sru_forward_cpu(a["u"], a["x"][:, :1], *args[2:], None, d=3)
    with pytest.raises(ValueError, match="weight_c"):
        native.sru_forward_cpu(*args[:2], a["weight_c"][:4], a["bias"],
                               None, d=3)
    with pytest.raises(ValueError, match="c0"):
        native.sru_forward_cpu(*args, a["c0"][:1], d=3)
    with pytest.raises(ValueError, match="k = 2"):
        native.sru_forward_cpu(a["u"][..., :6], *args[1:], None, d=3)


def test_gather_blobs_equals_slicing():
    rng = np.random.default_rng(1)
    base = rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()
    offsets = rng.integers(0, 4000, 40)
    lengths = rng.integers(0, 900, 40)
    lengths[3] = 0
    want = np.concatenate([np.frombuffer(base, np.uint8)[o:o + n]
                           for o, n in zip(offsets, lengths)])
    for threads in (1, 4):
        got = native.gather_blobs(base, offsets, lengths, n_threads=threads)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="outside"):
        native.gather_blobs(base, [4990], [20])


def _fg_tied():
    """Masks whose candidate windows tie in mass: mirrored equal blocks,
    an empty sample, and a glimpse near the border (only the nearest
    window allowed by the margin)."""
    fg = np.zeros((3, 64, 64), np.float32)
    fg[0, 8:24, 8:24] = 1.0
    fg[0, 40:56, 8:24] = 1.0
    fg[1, 20:44, 30:34] = 1.0
    pts = np.array([32 * 64 + 16, 16 * 64 + 16, 31 * 64 + 31, 44 * 64 + 33,
                    0, 63 * 64 + 63], np.int64)
    return fg, pts


def test_window_origin_fg_ties():
    fg, pts = _fg_tied()
    want = jpy.window_origin_fg(jnp.asarray(pts, jnp.int32), (64, 64), 32,
                                16, jnp.asarray(fg[..., None]), 2)
    got = tpy.window_origin_fg(torch.from_numpy(pts), (64, 64), 32, 16,
                               torch.from_numpy(fg[:, None]), 2)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[3:] == want[3:]
    mass = tpy.window_mass(torch.from_numpy(fg[:, None]), 32, 16, 3)
    assert float(mass[0, 0, 0]) == float(mass[0, 2, 0]) == 256.0  # a tie


def test_decode_split_takes_the_fg_windows():
    """With ``fg_mask`` the windowed decode crops and pastes at
    ``window_origin_fg``'s origins: the finest logits are background
    (1, -1) outside exactly those windows."""
    from tpuseg_torch.configs import cvppp_config

    torch.manual_seed(0)
    dec = tpy.AttenDecoder(cvppp_config().decoder, 8).eval()
    rng = np.random.default_rng(2)
    feats = [torch.from_numpy(rng.standard_normal(
        (2, c, 64 // f, 64 // f)).astype(np.float32))
        for f, c in zip((1, 2, 4, 8, 16), (8, 16, 32, 64, 128))]
    fg, pts = _fg_tied()
    fg_t = torch.from_numpy(fg[:2, None])
    with torch.no_grad():
        parts = dec.conv1_partials(dec.transform_skips(feats), fg_t)
        preds = dec.decode_split(torch.from_numpy(pts[:4]), parts, 2,
                                 window=128, window_stride=64, fg_mask=fg_t)
    ir, ic, _, _, _ = tpy.window_origin_fg(torch.from_numpy(pts[:4]),
                                           (64, 64), 32, 16, fg_t, 2)
    out = preds[-1]
    for n in range(4):
        r0, c0 = int(ir[n]) * 16, int(ic[n]) * 16
        inside = torch.zeros(64, 64, dtype=torch.bool)
        inside[r0:r0 + 32, c0:c0 + 32] = True
        assert (out[n, 0][~inside] == 1.0).all()
        assert (out[n, 1][~inside] == -1.0).all()
        assert not (out[n, 0][inside] == 1.0).all()


def test_calc_bd():
    rng = np.random.default_rng(3)
    gt = rng.integers(0, 4, (24, 24)).astype(np.int32)
    pred = np.where(rng.random((24, 24)) < 0.8, gt, 5).astype(np.int32)
    np.testing.assert_allclose(
        float(tmetrics.calc_bd(gt, pred, max_ids=8)),
        float(jmetrics.calc_bd(gt, pred, max_ids=8)), rtol=1e-6)
    assert float(tmetrics.calc_bd(gt, np.zeros_like(gt))) == 0.0
