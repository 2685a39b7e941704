"""The port's capability modules against the JAX package on the CPU: the
CoordConv family (the flax ConvTranspose SAME crop at (k, s) = (3, 2),
(5, 2), (5, 1)), the ConvGRU cell and the hourglasses, VGG16 with its npz
loader and the CoordConv retrofit, ``ChannelAttention``, ``MobileV1ASPP``,
the ASPP modules, the transformer stack (``ScalePDAttention`` at B=2,
nh=2 with a ``nomask``, the JAX package's mask tiling kept), the
distance-map embedding, the discriminative loss and the PN losses.

Each module runs on the same seeded numpy inputs in both packages, the
weights carried by ``tpuseg_torch.weights`` (and written back equal);
forward f32 within atol 1e-5 / rtol 1e-4.  The port's maps are NCHW, the
JAX package's NHWC.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.decoder import pn_losses as jpn
from tpuseg.losses import discriminative as jdisc
from tpuseg.nn import aspp as jaspp
from tpuseg.nn import attention as jatt
from tpuseg.nn import blocks as jblocks
from tpuseg.nn import conv_gru as jgru
from tpuseg.nn import coord_conv as jcc
from tpuseg.nn import embedding as jemb
from tpuseg.nn import hourglass as jhg
from tpuseg.nn import transformer as jtr
from tpuseg.nn import vgg16 as jvgg
from tpuseg_torch.decoder import pn_losses as tpn
from tpuseg_torch.losses import discriminative as tdisc
from tpuseg_torch.nn import aspp as taspp
from tpuseg_torch.nn import attention as tatt
from tpuseg_torch.nn import blocks as tblocks
from tpuseg_torch.nn import conv_gru as tgru
from tpuseg_torch.nn import coord_conv as tcc
from tpuseg_torch.nn import embedding as temb
from tpuseg_torch.nn import hourglass as thg
from tpuseg_torch.nn import transformer as ttr
from tpuseg_torch.nn import vgg16 as tvgg
from tpuseg_torch.weights import load_flax, to_flax

KEY = jax.random.PRNGKey(0)
CLOSE = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    torch.manual_seed(0)  # the port modules' initial weights
    yield
    torch.set_num_threads(before)


def _np_tree(tree, leaf=np.asarray):
    if hasattr(tree, "items"):
        return {k: _np_tree(v, leaf) for k, v in tree.items()}
    return leaf(tree)


_NORMS = (torch.nn.BatchNorm2d, torch.nn.GroupNorm, torch.nn.LayerNorm)


def _weights(jax_module, module, *args, seed=0, **kw):
    """Seeded weights for both packages: the port module's initial weights
    (convolutions and Dense from torch's init, the norms' affines and
    statistics drawn here) written as a flax tree by ``to_flax``, checked
    against the JAX module's own tree (structure and shapes, from
    ``eval_shape`` of its init), loaded back by ``load_flax`` (strict) and
    written out again equal.  Returns (variables, the module in eval)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, _NORMS) and getattr(m, "weight", None) is not None:
                m.weight.copy_(1 + 0.1 * torch.randn(m.weight.shape,
                                                     generator=g))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape,
                                                       generator=g))
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape,
                                                     generator=g))
    variables = to_flax(module)
    want = jax.eval_shape(functools.partial(jax_module.init, **kw), KEY, *args)
    spec = lambda a: (tuple(a.shape), str(a.dtype))  # noqa: E731
    assert _np_tree(variables, spec) == _np_tree(want, spec)
    load_flax(module, variables)
    back = to_flax(module)
    jax.tree.map(np.testing.assert_array_equal, back, variables)
    return variables, module.eval()


def _apply(jax_module, variables, *args, **kw):
    """The JAX module's output, one jit per call site."""
    return jax.jit(functools.partial(jax_module.apply, **kw))(variables,
                                                              *args)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(a), -1, 1)))


def _nhwc(a):
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return (a.permute(0, 2, 3, 1) if a.ndim == 4 else a).numpy()
    return np.asarray(a)


def _close(got, want, **tol):
    """``got`` (a port tensor, NCHW maps) against ``want``."""
    np.testing.assert_allclose(_nhwc(got), _nhwc(want), **(tol or CLOSE))


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# ------------------------------ CoordConv ------------------------------

class _JaxCT(fnn.Module):
    features: int
    k: int
    s: int

    @fnn.compact
    def __call__(self, x):
        return fnn.ConvTranspose(self.features, (self.k, self.k),
                                 strides=(self.s, self.s))(x)


class _TorchCT(torch.nn.Module):
    def __init__(self, cin, features, k, s):
        super().__init__()
        self.ConvTranspose_0 = torch.nn.ConvTranspose2d(cin, features, k,
                                                        stride=s)

    def forward(self, x):
        return tcc.conv_transpose_same(x, self.ConvTranspose_0)


@pytest.mark.parametrize("k,s", [(3, 2), (5, 2), (5, 1)])
def test_conv_transpose_same_crop(k, s):
    """flax's SAME transposed convolution: the full one, then the crop of
    ``lax.conv_transpose``'s rule (rows and cols [0, 2H) at k=3 s=2, [1,
    2H+1) at k=5 s=2, padding 2 at k=5 s=1); a non-square input."""
    rng = np.random.default_rng(k * 10 + s)
    x = _rand(rng, 2, 5, 7, 4)
    jm = _JaxCT(3, k, s)
    v, m = _weights(jm, _TorchCT(4, 3, k, s), x)
    got = m(_nchw(x))
    assert got.shape == (2, 3, 5 * s, 7 * s)
    _close(got, _apply(jm, v, x))


@pytest.mark.parametrize("with_r", [False, True])
def test_coord_conv_and_transpose(with_r):
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 8, 6, 4)
    jm = jcc.CoordConv(5, 3, stride=2, padding=1, with_r=with_r)
    v, m = _weights(jm, tcc.CoordConv(4, 5, 3, stride=2, padding=1,
                                      with_r=with_r), x)
    _close(m(_nchw(x)), _apply(jm, v, x))
    jt = jcc.CoordConvTranspose(3, with_r=with_r)
    v, m = _weights(jt, tcc.CoordConvTranspose(4, 3, with_r=with_r), x)
    _close(m(_nchw(x)), _apply(jt, v, x))


def test_retrofit_and_coordconvnet():
    """The weight surgery on a state_dict gives the JAX surgery's tree; the
    retrofitted CoordConvNet equals the JAX one layer for layer and the
    plain VGG16 it came from."""
    rng = np.random.default_rng(2)
    x = _rand(rng, 1, 8, 8, 3)
    plain = jvgg.VGG16(n_layers=6)
    v, tplain = _weights(plain, tvgg.VGG16(3, n_layers=6), x)
    jretro = _np_tree(jcc.retrofit_coordconv_params(v["params"], with_r=True))
    sd = tcc.retrofit_coordconv_params(tplain.state_dict(), with_r=True)
    net = tcc.CoordConvNet(3, n_layers=6, with_r=True).eval()
    net.load_state_dict(sd)
    jax.tree.map(np.testing.assert_array_equal, to_flax(net)["params"],
                 jretro)
    jouts = _apply(jcc.CoordConvNet(n_layers=6), {"params": jretro}, x)
    touts = net(_nchw(x))
    assert len(touts) == len(jouts) == 6
    for got, want in zip(touts, jouts):
        _close(got, want)
    _close(touts[-1], tplain(_nchw(x)))


# ------------------------- ConvGRU, hourglasses -------------------------

@pytest.mark.parametrize("coords", [False, True])
def test_conv_gru_cell(coords):
    rng = np.random.default_rng(3)
    x, h = _rand(rng, 2, 8, 8, 3), _rand(rng, 2, 8, 8, 5)
    jm = jgru.ConvGRUCell(5, 3, use_coordinates=coords)
    v, m = _weights(jm, tgru.ConvGRUCell(3, 5, 3, use_coordinates=coords),
                    x, h)
    _close(m(_nchw(x), _nchw(h)), _apply(jm, v, x, h))
    _close(m(_nchw(x)), _apply(jm, v, x))


def test_stacked_recurrent_hourglass():
    """Two stacks of three levels, the ConvGRU cell shared by the levels
    (one ``convgru_cell`` per hourglass), CoordConvs on."""
    rng = np.random.default_rng(4)
    x = _rand(rng, 2, 12, 12, 3)
    jm = jhg.StackedRecurrentHourglass(n_stacks=2, hidden_n_filters=6,
                                       n_levels=3, embedding_size=4,
                                       use_coordinates=True)
    v, m = _weights(jm, thg.StackedRecurrentHourglass(
        3, n_stacks=2, hidden_n_filters=6, n_levels=3, embedding_size=4,
        use_coordinates=True), x)
    for got, want in zip(m(_nchw(x)), _apply(jm, v, x)):
        _close(got, want)


def test_recurrent_hourglass_one_level():
    rng = np.random.default_rng(5)
    x = _rand(rng, 1, 8, 8, 2)
    jm = jhg.RecurrentHourglass(4, 3, 1, 6)
    v, m = _weights(jm, thg.RecurrentHourglass(2, 4, 3, 1, 6), x)
    _close(m(_nchw(x)), _apply(jm, v, x))


# -------------------------------- VGG16 ---------------------------------

def test_vgg16_npz_and_skip(tmp_path):
    """An npz of seeded random weights in torchvision's layout (both key
    forms) loads into both packages; SkipVGG16's three taps agree, and so
    does a truncated CoordConv VGG16."""
    rng = np.random.default_rng(6)
    arrays, cin = {}, 3
    for i, t in enumerate(jvgg._layer_types()):
        if t.startswith("conv"):
            c = int(t[4:])
            key = f"features.{i}" if i < 16 else str(i)
            arrays[f"{key}.weight"] = _rand(rng, c, cin, 3, 3,
                                            scale=(9 * cin) ** -0.5)
            arrays[f"{key}.bias"] = _rand(rng, c, scale=0.1)
            cin = c
    path = tmp_path / "vgg.npz"
    np.savez(path, **arrays)
    x = _rand(rng, 1, 16, 16, 3)
    skip = tvgg.SkipVGG16(3).eval()
    sd = tvgg.load_npz(str(path), skip_prefix=True)
    assert len(sd) == 26 and sd["features.conv12.weight"].shape == (
        512, 512, 3, 3)
    skip.load_state_dict({k: sd[k] for k in skip.state_dict()})
    jtree = _np_tree(jvgg.load_npz(str(path), skip_prefix=True))
    jtree["params"]["features"] = {
        k: v for k, v in jtree["params"]["features"].items()
        if int(k[4:]) < 7}
    jax.tree.map(np.testing.assert_array_equal, to_flax(skip), jtree)
    jouts = _apply(jvgg.SkipVGG16(), jtree, x)
    touts = skip(_nchw(x))
    assert len(touts) == 3
    for got, want in zip(touts, jouts):
        _close(got, want)
    jc = jvgg.VGG16(n_layers=5, use_coordinates=True)
    v, m = _weights(jc, tvgg.VGG16(3, n_layers=5, use_coordinates=True), x)
    _close(m(_nchw(x), return_intermediate=[1])[0],
           _apply(jc, v, x, return_intermediate=[1])[0])


# ---------------------- attention, blocks, the ASPP ----------------------

@pytest.mark.parametrize("with_h,multiply,train", [
    (False, True, False), (True, True, True), (True, False, False)])
def test_channel_attention(with_h, multiply, train):
    """Without and with ``h_t`` (the last Dense is ``Dense_1`` / ``Dense_2``),
    eval and train mode (the BatchNorm's running statistics)."""
    rng = np.random.default_rng(7)
    base = _rand(rng, 2, 6, 6, 8)
    y = (rng.random((2, 6, 6, 1)) > 0.4).astype(np.float32)
    h_t = _rand(rng, 2, 5) if with_h else None
    jm = jatt.ChannelAttention(8, multiply=multiply)
    v, m = _weights(jm, tatt.ChannelAttention(
        8, 8, multiply=multiply, h_dim=5 if with_h else 0), base, y, h_t)
    m.train(train)
    got = m(_nchw(base), _nchw(y), None if h_t is None else
            torch.from_numpy(h_t))
    if train:
        want, upd = _apply(jm, v, base, y, h_t, train=True,
                           mutable=["batch_stats"])
        stats = upd["batch_stats"]["BatchNorm_0"]
        _close(m.BatchNorm_0.running_mean, stats["mean"])
        _close(m.BatchNorm_0.running_var, stats["var"])
    else:
        want = _apply(jm, v, base, y, h_t)
    _close(got, want)


@pytest.mark.parametrize("stride,dilation,with_relu", [
    (1, 1, False), (1, 2, True), (2, 1, False)])
def test_mobile_v1_aspp(stride, dilation, with_relu):
    rng = np.random.default_rng(8)
    x = _rand(rng, 2, 8, 8, 4)
    jm = jblocks.MobileV1ASPP(4, stride=stride, dilation=dilation,
                              with_relu=with_relu)
    v, m = _weights(jm, tblocks.MobileV1ASPP(
        4, 4, stride=stride, dilation=dilation, with_relu=with_relu), x)
    _close(m(_nchw(x)), _apply(jm, v, x))


def test_dense_aspp_block_and_masked_encoder():
    """eps 1e-6 instance norms (flax GroupNorm), eval-mode dropout; the
    encoder with a mask that zeroes a band; train-mode channel dropout is
    one draw per sample and channel."""
    rng = np.random.default_rng(9)
    x = _rand(rng, 2, 10, 10, 6, scale=3.0)
    jb = jaspp.DenseAsppBlock(num1=8, num2=4, dilation_rate=2)
    v, m = _weights(jb, taspp.DenseAsppBlock(6, 8, 4, 2), x)
    _close(m(_nchw(x)), _apply(jb, v, x))
    mask = np.ones((2, 10, 10, 1), np.float32)
    mask[:, :3] = 0.0
    je = jaspp.MaskedAsppEncoder(d_model=6, aspp_rates=(1, 3))
    v, m = _weights(je, taspp.MaskedAsppEncoder(6, 6, (1, 3)), x, mask)
    _close(m(_nchw(x), _nchw(mask)), _apply(je, v, x, mask))
    g = torch.Generator().manual_seed(0)
    y = taspp.channel_dropout(torch.ones(2, 5, 3, 3), 0.5, True, g)
    assert set(torch.unique(y).tolist()) <= {0.0, 2.0}
    assert torch.equal(y, y[:, :, :1, :1].expand_as(y))


def test_dilated_mobilenet_and_dense_aspp():
    """The 17 inverted-residual blocks with their strides and dilations,
    four taps; DenseASPP wraps the net as ``features``."""
    rng = np.random.default_rng(10)
    x = _rand(rng, 1, 16, 16, 3)
    jm = jaspp.DenseASPP(output_stride=1)
    v, m = _weights(jm, taspp.DenseASPP(3, output_stride=1), x)
    outs = m(_nchw(x))
    assert [o.shape[1] for o in outs] == [24, 64, 160, 256]
    for got, want in zip(outs, _apply(jm, v, x)):
        _close(got, want)


# ------------------------- the transformer stack -------------------------

def test_position_encoding():
    got = ttr.make_position_encoding(2, 7, 6)
    np.testing.assert_allclose(got.numpy(),
                               jtr.make_position_encoding(2, 7, 6),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("last", [False, True])
def test_transformer_decoder_layer(last):
    """Self and encoder attention with a key mask, the feed-forward; the
    ``last`` variant's one-head sigmoid correlation (no output
    projection)."""
    rng = np.random.default_rng(11)
    dec, enc = _rand(rng, 2, 3, 8), _rand(rng, 2, 5, 8)
    mask = np.ones((2, 5), np.float32)
    mask[1, 3:] = 0.0
    jm = jtr.TransformerDecoderLayer(8, 12, 2, 4, 4, last=last)
    v, m = _weights(jm, ttr.TransformerDecoderLayer(8, 12, 2, 4, 4,
                                                    last=last),
                    dec, enc, mask)
    got = m(*map(torch.from_numpy, (dec, enc, mask)))
    for g, w in zip(got, _apply(jm, v, dec, enc, mask)):
        if w is None:
            assert g is None
        else:
            _close(g, w)


def test_scale_pd_attention_keeps_the_mask_tiling():
    """B=2, nh=2 with a nomask that differs between the samples: the port
    folds heads sample-major and tiles the mask head-major as the JAX
    package does, so both read the same (crossed) masks."""
    rng = np.random.default_rng(12)
    qk, v_in = _rand(rng, 2, 6, 6, 8), _rand(rng, 2, 6, 6, 6)
    nomask = np.zeros((2, 6, 6, 1), np.float32)
    nomask[0, :3] = 1.0
    nomask[1, :, 4:] = 1.0
    jm = jtr.ScalePDAttention(d_k=4, d_v=3, d_model=8, dilation=2, n_head=2)
    v, m = _weights(jm, ttr.ScalePDAttention(8, 4, 3, 8, 2, n_head=2, c_v=6),
                    qk, v_in, nomask)
    got = m(_nchw(qk), _nchw(v_in), _nchw(nomask))
    _close(got, _apply(jm, v, qk, v_in, nomask))
    _close(m(_nchw(qk), _nchw(v_in)), _apply(jm, v, qk, v_in))
    # the masks differ per sample, so which sample's mask a head reads
    # shows in the output
    swapped = m(_nchw(qk), _nchw(v_in), _nchw(nomask[::-1].copy()))
    assert not torch.allclose(swapped, got)


@pytest.mark.parametrize("mode", ["Dot", "Embedded Gaussian",
                                  "Concatenation"])
def test_non_local_layer(mode):
    rng = np.random.default_rng(13)
    fmap, x = _rand(rng, 2, 5, 5, 6, scale=0.3), _rand(rng, 2, 4, scale=0.3)
    jm = jtr.NonLocalLayer(in_ch=3, out_ch=6, mode=mode)
    v, m = _weights(jm, ttr.NonLocalLayer(6, 4, 3, 6, mode=mode), fmap, x)
    _close(m(_nchw(fmap), torch.from_numpy(x)), _apply(jm, v, fmap, x))


def test_embedding():
    rng = np.random.default_rng(14)
    o_map, h = _rand(rng, 2, 6, 7, 8), _rand(rng, 2, 5)
    points = np.array([[1, 2], [5, 0]], np.int32)
    jm = jemb.Embedding(8)
    v, m = _weights(jm, temb.Embedding(5, 8), o_map, points, h)
    _close(m(_nchw(o_map), torch.from_numpy(points), torch.from_numpy(h)),
           _apply(jm, v, o_map, points, h))
    _close(temb.cal_position((6, 7), torch.from_numpy(points)),
           jemb.cal_position((6, 7), jnp.asarray(points)))


# ------------------------------- losses --------------------------------

def _instances(rng, b, h, w, n):
    ids = rng.integers(0, n + 1, size=(b, h, w))
    return (ids[..., None] == np.arange(1, n + 1)).astype(np.float32)


@pytest.mark.parametrize("norm", [1, 2])
def test_discriminative_loss_and_terms(norm):
    """Every term and the loss; sample 1 has fewer objects than slots."""
    rng = np.random.default_rng(15 + norm)
    b, h, w, f, n = 2, 6, 6, 4, 3
    emb = _rand(rng, b, h, w, f)
    tgt = _instances(rng, b, h, w, n)
    n_obj = np.array([3, 2], np.int32)
    jl, jmeans = jdisc.discriminative_loss(emb, tgt, n_obj, norm=norm)
    tl, tmeans = tdisc.discriminative_loss(_nchw(emb), _nchw(tgt),
                                           torch.from_numpy(n_obj), norm=norm)
    _close(tl, jl)
    _close(tmeans, jmeans)
    pred = emb.reshape(b, -1, f)
    gt = tgt.reshape(b, -1, n)
    tp, tg, tn = map(torch.from_numpy, (pred, gt, n_obj))
    jm = jdisc.calculate_means(pred, gt, n_obj, normalize=False)
    tm = tdisc.calculate_means(tp, tg, tn, normalize=False)
    _close(tm, jm)
    _close(tdisc.calculate_variance_term(tp, tg, tm, tn, 0.5, norm),
           jdisc.calculate_variance_term(pred, gt, jm, n_obj, 0.5, norm))
    _close(tdisc.calculate_distance_term(tm, tn, 1.5, norm),
           jdisc.calculate_distance_term(jm, n_obj, 1.5, norm))
    _close(tdisc.calculate_regularization_term(tm, tn, norm),
           jdisc.calculate_regularization_term(jm, n_obj, norm))
    _close(tdisc.calculate_q_regularization_term(tp, tg),
           jdisc.calculate_q_regularization_term(pred, gt))


@pytest.mark.parametrize("focal_weight", [0.0, 0.3])
def test_pn_losses(focal_weight):
    """The three PN losses, values and (pn_loss) the gradient of pred."""
    rng = np.random.default_rng(17)
    b, h, w = 2, 5, 6
    pred = rng.random((b, h * w)).astype(np.float32)
    adv = _rand(rng, b, h * w)
    alpha = rng.random((b, h * w)).astype(np.float32)
    evaline = np.full((b, 1), 0.5, np.float32)
    gold = (rng.random((b, h * w)) > 0.5).astype(np.float32)
    want, jgrad = jax.value_and_grad(lambda p: jpn.pn_loss(
        p, adv, alpha, evaline, gold, focal_weight=focal_weight).sum())(
        jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_()
    got = tpn.pn_loss(tp, *map(torch.from_numpy, (adv, alpha, evaline, gold)),
                      focal_weight=focal_weight).sum()
    got.backward()
    _close(got, want)
    _close(tp.grad, jgrad)
    maps = [rng.random((b, h, w, 1)).astype(np.float32) for _ in range(5)]
    g4 = (maps[4] > 0.4).astype(np.float32)
    _close(tpn.pn_loss2(*[_nchw(a) for a in maps[:4]], _nchw(g4)),
           jpn.pn_loss2(*maps[:4], g4))
    onehot = np.zeros((b, h, w, 1), np.float32)
    onehot[:, 2, 3] = 1.0
    pro = _rand(rng, b, h, w, 1)
    ev = np.array([0.3, 0.6], np.float32)
    _close(tpn.pn_loss3(_nchw(onehot), _nchw(pro), _nchw(maps[0]),
                        torch.from_numpy(ev), _nchw(g4)),
           jpn.pn_loss3(onehot, pro, maps[0], ev, g4))
