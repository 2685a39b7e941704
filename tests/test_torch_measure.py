"""The port's measurement tools (``tpuseg_torch/tools/{trace_summary,
roofline,profile_stages,profile_components,profile_decode_scaling,
warmup}.py``) and its operation count (``tpuseg_torch/utils/roofline.py``)
against the JAX package, on the CPU at small sizes.

- The port's counted operations of the semantic forward, the skip
  transforms and one pyramid decode equal a count over ``jax.make_jaxpr``
  of the JAX package's counterparts (no JAX compile), exactly.
- Each hand kernel's formula equals ``FlopCounterMode`` of its plain
  version (operations) and the bytes of the call's tensors, each input read
  once and each output written once; a decode counts the same whether the
  ``ir_chain`` dispatch runs the kernel (a stub here) or the plain version.
- ``trace_summary`` gives the JAX tool's bucket and top-op tables on one
  synthetic trace, and busy time, idle share and gaps computed by hand.
- Each tool prints its report with the JAX tool's keys at a small size.
"""

import dataclasses
import gzip
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.extend
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from tpuseg.cli.common import build_model, init_variables
from tpuseg.configs import cvppp_config as jax_cvppp_config
from tpuseg.decoder import pyramid as jpy
from tpuseg_torch.cli.common import load_model
from tpuseg_torch.configs import cvppp_config
from tpuseg_torch.decoder import pyramid as tpy
from tpuseg_torch.kernels.ir_chain import ir_chain_plain
from tpuseg_torch.kernels.masked_softmax import (
    masked_softmax_backward_plain, masked_softmax_plain,
)
from tpuseg_torch.kernels.sru_scan import sru_scan_backward_plain
from tpuseg_torch.models import ReSeg
from tpuseg_torch.nn import SRU
from tpuseg_torch.nn.sru import sru_states
from tpuseg_torch.tools import ab_infer, stages, trace_summary
from tpuseg_torch.utils import roofline as rl
from tpuseg_torch.utils.tracing import trace_context
from tpuseg_torch.weights import load_flax

REPO = Path(__file__).resolve().parents[1]
SIDE, BATCH, WIDTH = 64, 2, 8


def _small(cfg):
    return dataclasses.replace(
        cfg,
        data=dataclasses.replace(cfg.data, image_height=SIDE,
                                 image_width=SIDE, max_n_objects=8),
        model=dataclasses.replace(cfg.model, n_filters=WIDTH),
    )


# ------------------------ the JAX package's count ------------------------

def _resampling(eqn) -> bool:
    tb = eqn.source_info.traceback
    return tb is not None and any(
        "image/scale.py" in f.file_name for f in tb.frames)


def _taps(n_in, n_out, k, stride, rhs_dil, lhs_dil, lo):
    """Taps of one axis of an lhs-dilated convolution that land on a real
    input pixel (not a dilation zero, not padding)."""
    return sum(1 for o in range(n_out) for j in range(k)
               if 0 <= o * stride + j * rhs_dil - lo <= (n_in - 1) * lhs_dil
               and (o * stride + j * rhs_dil - lo) % lhs_dil == 0)


def jaxpr_flops(jaxpr) -> int:
    """2 x output elements x contracted size / feature groups of every
    ``conv_general_dilated`` and ``dot_general`` in ``jaxpr`` and its
    sub-jaxprs."""
    total = 0
    for eqn in jaxpr.eqns:
        prim = eqn.primitive.name
        if prim == "conv_general_dilated":
            p = eqn.params
            lhs, rhs = (v.aval.shape for v in eqn.invars[:2])
            out = eqn.outvars[0].aval.shape
            dn = p["dimension_numbers"]
            cin = lhs[dn.lhs_spec[1]] // p["feature_group_count"]
            ksp = [rhs[d] for d in dn.rhs_spec[2:]]
            assert p["batch_group_count"] == 1
            if all(d == 1 for d in p["lhs_dilation"]):
                total += 2 * math.prod(out) * cin * math.prod(ksp)
            else:
                # a transposed convolution: lhs dilation puts zeros between
                # the input pixels, which the port's transposed convolution
                # never multiplies.  Both sides count the products on real
                # input pixels only.
                taps = math.prod(
                    _taps(lhs[dn.lhs_spec[2 + i]], out[dn.out_spec[2 + i]],
                          k, p["window_strides"][i], p["rhs_dilation"][i],
                          p["lhs_dilation"][i], p["padding"][i][0])
                    for i, k in enumerate(ksp))
                total += (2 * out[dn.out_spec[0]] * out[dn.out_spec[1]]
                          * cin * taps)
        elif prim == "dot_general" and not _resampling(eqn):
            # jax.image.resize contracts with an interpolation matrix; the
            # port's bilinear upsample is no product: neither side counts
            # resampling
            (lc, _), _ = eqn.params["dimension_numbers"]
            lhs = eqn.invars[0].aval.shape
            total += (2 * math.prod(eqn.outvars[0].aval.shape)
                      * math.prod(lhs[d] for d in lc))
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                if isinstance(sub, jax.extend.core.ClosedJaxpr):
                    total += jaxpr_flops(sub.jaxpr)
                elif isinstance(sub, jax.extend.core.Jaxpr):
                    total += jaxpr_flops(sub)
    return total


@pytest.fixture(scope="module")
def pair():
    """One seed's JAX variables (shapes from ``init_variables``, values
    from numpy) and the port's model loaded from them through the bridge,
    with inputs for the three counted functions."""
    cfg = _small(jax_cvppp_config())
    model = build_model(cfg)
    shapes = jax.eval_shape(lambda: init_variables(cfg, model, 0))
    rng = np.random.default_rng(0)

    def leaf(path, v):
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, v.shape).astype(v.dtype)
        return (0.1 * rng.normal(size=v.shape)).astype(v.dtype)

    variables = jax.tree_util.tree_map_with_path(leaf, shapes)
    port = load_flax(ReSeg(_small(cvppp_config())), variables).eval()
    x = rng.normal(size=(BATCH, SIDE, SIDE, 21)).astype(np.float32)
    feats = [rng.normal(size=(BATCH, SIDE // f, SIDE // f, WIDTH * f))
             .astype(np.float32) for f in (1, 2, 4, 8, 16)]
    sem = (rng.random((BATCH, SIDE, SIDE, 1)) > 0.5).astype(np.float32)
    pts = np.array([5 * SIDE + 7, 40 * SIDE + 50], np.int32)
    bone = jpy.AttenDecoder(cfg=cfg.decoder, n_filters=WIDTH)
    bone_vars = {c: variables[c]["decoder"]["glimpse"]["bone"]
                 for c in ("params", "batch_stats")}
    return dict(model=model, variables=variables, port=port, x=x,
                feats=feats, sem=sem, pts=pts, bone=bone,
                bone_vars=bone_vars)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _jax_count(p, name):
    bone, bv = p["bone"], p["bone_vars"]
    if name == "semantic":
        fn = lambda v, x: p["model"].apply(v, x, mode="semantic")  # noqa
        return jaxpr_flops(jax.make_jaxpr(fn)(p["variables"], p["x"]).jaxpr)
    skips = lambda v, f: bone.apply(  # noqa: E731
        v, f, False, method=jpy.AttenDecoder.transform_skips)
    if name == "transform_skips":
        return jaxpr_flops(jax.make_jaxpr(skips)(bv, p["feats"]).jaxpr)
    skips_t = jax.eval_shape(skips, bv, p["feats"])

    def decode(v, pts, s, m):
        return bone.apply(v, pts, list(s), m, None, None, False,
                          method=jpy.AttenDecoder.decode)

    return jaxpr_flops(
        jax.make_jaxpr(decode)(bv, p["pts"], skips_t, p["sem"]).jaxpr)


@torch.no_grad()
def _port_count(p, name) -> rl.Count:
    port = p["port"]
    bone = port.decoder.bone
    if name == "semantic":
        with rl.count() as c:
            port.semantic(_nchw(p["x"]))
        return c
    feats = [_nchw(f) for f in p["feats"]]
    if name == "transform_skips":
        with rl.count() as c:
            bone.transform_skips(feats)
        return c
    skips_t = bone.transform_skips(feats)
    with rl.count() as c:
        bone.decode(torch.from_numpy(p["pts"]).long(), skips_t,
                    _nchw(p["sem"]))
    return c


@pytest.mark.parametrize("name", ["semantic", "transform_skips", "decode"])
def test_operation_counts_equal_the_jax_package(pair, name):
    """The port's counted operations (its eval decode runs the chains
    through ``ir_chain``, counted by its formula) equal the JAX package's
    convolutions and products, read from ``make_jaxpr``."""
    got = _port_count(pair, name)
    assert got.flops > 0
    assert got.flops == _jax_count(pair, name)
    if name == "decode":
        assert got.kernels["ir_chain"]["calls"] == 5


# --------------------------- kernel formulas -----------------------------

def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _flop_counter(fn, *args):
    fc = FlopCounterMode(display=False)
    with fc:
        out = fn(*args)
    return fc.get_total_flops(), out


def _chain_inputs(n, h, w, c, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, h, w, c, generator=g).to(dtype)
    x1u = torch.randn(n, h, w, c, generator=g).to(dtype)
    ws = [torch.randn(4, c, 2 * c, generator=g).to(dtype),
          torch.randn(4, 2 * c, generator=g),
          torch.randn(4, 3, 3, 2 * c, generator=g),
          torch.randn(4, 2 * c, generator=g),
          torch.randn(4, 2 * c, c, generator=g).to(dtype),
          torch.randn(4, c, generator=g)]
    return x, x1u, ws


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("skip", [False, True])
def test_ir_chain_formula(dtype, skip):
    x, x1u, ws = _chain_inputs(3, 5, 7, 16, dtype, 1)
    x1u = x1u if skip else None
    flops, y = _flop_counter(ir_chain_plain, x, x1u, *ws)
    with rl.count() as c:
        tpy.ir_chain(x, x1u, *ws)
    k = c.kernels["ir_chain"]
    assert k["calls"] == 1 and c.ops == 0  # the plain ops are hidden
    assert k["flops"] == flops == rl.chain_ops(3, 5, 7, 16)
    assert k["bytes"] == _nbytes(x, x1u, *ws, y)
    # the same count as the bound's bytes (chip_smoke.py)
    name = "float32" if dtype == torch.float32 else "bfloat16"
    b_ms, _ = rl.chain_bound(3, 5, 7, 16, name, skip)
    assert b_ms == pytest.approx(1e3 * k["bytes"] / rl.PEAK_BYTES, rel=1e-12)


def test_masked_softmax_formulas_and_gradient():
    """Forward and backward of the per-instance softmax, through the
    attention module's call site under autograd: the formulas, the rows of
    the cotangent that are not zero, and the gradient unchanged by the
    count."""
    from tpuseg_torch.nn import attention

    g = torch.Generator().manual_seed(2)
    b, n, hw = 2, 5, 48
    e = torch.randn(b, hw, generator=g, requires_grad=True)
    mask = (torch.rand(b, n, hw, generator=g) > 0.5).float()
    mask[1, 3] = 0.0
    cot = torch.randn(b, n, hw, generator=g)
    cot[:, 1:3] = 0.0  # 3 of the 5 rows a sample carry a cotangent
    flops, p_ref = _flop_counter(masked_softmax_plain, e.detach(), mask)
    bflops, de_ref = _flop_counter(masked_softmax_backward_plain,
                                   p_ref, cot)
    assert flops == bflops == 0
    with rl.count() as c:
        p = attention.masked_softmax(e, mask)
        (de,) = torch.autograd.grad(p, e, cot)
    torch.testing.assert_close(p, p_ref, rtol=0, atol=0)
    torch.testing.assert_close(de, de_ref, rtol=1e-6, atol=1e-6)
    fwd, bwd = c.kernels["masked_softmax"], c.kernels["masked_softmax_backward"]
    assert fwd == {"calls": 1, "flops": 0, "bytes": _nbytes(e, mask, p)}
    active = 3 * b
    assert bwd == {"calls": 1, "flops": 0,
                   "bytes": _nbytes(cot, p[:, :3], de)}
    assert bwd["bytes"] == rl.softmax_bytes(b, n, hw, active)[1]
    # without the count the call site is the wrapper again
    assert attention.masked_softmax.__module__.endswith("masked_softmax")


@pytest.mark.parametrize("bidir,masks", [(False, False), (True, True)])
def test_sru_scan_formulas_and_gradient(bidir, masks):
    """An SRU stack's layers through ``nn/sru.py``'s call site: one forward
    and one backward count a layer, the bytes of each call's tensors, no
    operations (as ``FlopCounterMode`` counts the plain loop), and the
    gradients of the stack unchanged by the count.  The first layer takes
    6 features into 3 a direction: k = 4 one way, k = 3 both ways."""
    stack = SRU(6, 3, num_layers=2, bidirectional=bidir,
                generator=torch.Generator().manual_seed(3))
    x = torch.randn(7, 2, 6, generator=torch.Generator().manual_seed(4),
                    requires_grad=True)
    pad = torch.zeros(7, 2)
    pad[5:, 1] = 1.0
    kw = {"mask_pad": pad} if masks else {}

    def loss():
        h, c = stack(x, **kw)
        return h.square().sum() + c.sum()

    want = torch.autograd.grad(loss(), [x, *stack.parameters()])
    with rl.count() as c:
        got = torch.autograd.grad(loss(), [x, *stack.parameters()])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert c.kernels["sru_scan"]["calls"] == 2
    assert c.kernels["sru_scan_backward"]["calls"] == 2
    assert c.kernels["sru_scan"]["flops"] == 0
    # one layer's call: the formula against the tensors of the plain loop
    cell = stack.cell0
    u = (x.detach().reshape(-1, 6) @ cell.weight.detach()).reshape(7, 2, -1)
    args = (u, x.detach(), cell.weight_c.detach(), cell.bias.detach())
    opts = dict(d=3, bidirectional=bidir, scale_x=cell.scale_x,
                mask_pad=pad if masks else None)
    flops, (h, c_final, c_all) = _flop_counter(
        lambda: sru_states(*args, **opts))
    assert flops == 0
    kk = u.shape[-1] // c_final.shape[-1]
    x_read = x if kk == 3 else None
    pad_read = pad if masks else None
    fwd = rl.sru_bytes(7, 2, c_final.shape[-1], kk, 6, False, False, masks,
                       backward=False)
    assert fwd == _nbytes(u, x_read, args[2], args[3], pad_read, h, c_all,
                          c_final)
    gh, gc = torch.ones_like(h), torch.ones_like(c_final)
    bflops, grads = _flop_counter(
        sru_scan_backward_plain, u, x.detach(), args[2], args[3], None, None,
        pad_read, c_all, gh, gc, 3, 0, bidir, True, cell.scale_x)
    assert bflops == 0
    bwd = rl.sru_bytes(7, 2, c_final.shape[-1], kk, 6, False, False, masks,
                       backward=True)
    assert bwd == _nbytes(u, x_read, args[2], args[3], pad_read, c_all, gh,
                          gc, *grads)


def test_decode_counts_the_same_on_either_route(pair):
    """The pyramid decode counted with the ``ir_chain`` dispatch replaced by
    a stub that returns the plain result (what the kernel route gives the
    count) and through the wrapper's plain route: the same totals; and
    with the call site left alone the plain chain's own convolutions add up
    to the same operations."""
    bone = pair["port"].decoder.bone
    with torch.no_grad():
        skips_t = bone.transform_skips([_nchw(f) for f in pair["feats"]])
    pts, sem = torch.from_numpy(pair["pts"]).long(), _nchw(pair["sem"])

    def counted(kernels=True):
        with torch.no_grad(), rl.count(kernels) as c:
            preds = bone.decode(pts, skips_t, sem)[1]
        return c, preds

    plain, want = counted()
    real = tpy.ir_chain
    calls = []

    def stub(*args):
        calls.append(1)
        return ir_chain_plain(*args)

    tpy.ir_chain = stub
    try:
        kernel, got = counted()
    finally:
        tpy.ir_chain = real
    assert len(calls) == 5
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert (kernel.flops, kernel.bytes, kernel.ops, kernel.kernels) == (
        plain.flops, plain.bytes, plain.ops, plain.kernels)
    unwrapped, _ = counted(kernels=False)
    assert unwrapped.kernels == {}
    assert unwrapped.flops == plain.flops


def test_ops_seconds_rates_the_chain_at_its_route():
    """The ``ir_chain`` kernel's operations at its route's matrix rate
    (bf16 tensor cores; float32 as 3xTF32), the rest at the stage's."""
    peaks = rl.card_peaks("NVIDIA H100 80GB HBM3")
    c = rl.Count()
    c.add_kernel("ir_chain", 600, 0)
    c.flops += 400
    assert rl.ops_seconds(c, "bfloat16", peaks) == pytest.approx(1000 / 989e12)
    assert rl.ops_seconds(c, "float32", peaks) == pytest.approx(
        600 / (494.7e12 / 3) + 400 / 67e12)
    assert rl.ops_seconds(rl.Count(flops=400), "float32",
                          peaks) == pytest.approx(400 / 67e12)


def test_card_peaks_by_name():
    assert rl.card_peaks("NVIDIA H100 80GB HBM3") == {
        "bfloat16": 989e12, "tf32": 494.7e12, "float32": 67e12,
        "bytes": 3.35e12}
    for name in ("NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB"):
        with pytest.raises(RuntimeError, match="no peak figures"):
            rl.card_peaks(name)


# --------------------------- trace_summary -------------------------------

# (name, category, ts us, dur us, stream): two streams overlap at 180-200
DEVICE = [
    ("ir_block_tc_kernel", "kernel", 100_000, 50_000, 7),
    ("void cudnn::conv_kernel", "kernel", 160_000, 40_000, 7),
    ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 180_000, 40_000, 8),
    ("ir_block_tc_kernel", "kernel", 300_000, 50_000, 7),
    ("void at::native::elementwise_kernel", "kernel", 420_000, 30_000, 7),
]
HOST = [
    ("predict_batch", "user_annotation", 50_000, 450_000),
    ("aten::empty", "cpu_op", 40_000, 20_000),
    ("cudaStreamSynchronize", "cuda_runtime", 215_000, 90_000),
    ("aten::outer", "cpu_op", 330_000, 100_000),
    ("aten::add", "cpu_op", 340_000, 30_000),
]
BUCKETS = ["--bucket", "ir_block=chain", "--bucket", "conv=convs"]


def _write_traces(root: Path):
    """The events as a torch Chrome trace and in the JAX tool's layout
    (device events on a ``TPU`` process, host events on another)."""
    torch_ev = [{"ph": "X", "cat": cat, "name": n, "ts": ts, "dur": d,
                 "pid": 0, "tid": s} for n, cat, ts, d, s in DEVICE]
    torch_ev += [{"ph": "X", "cat": cat, "name": n, "ts": ts, "dur": d,
                  "pid": 4242, "tid": 1} for n, cat, ts, d in HOST]
    (root / "torch").mkdir()
    with open(root / "torch" / "trace.json", "w") as f:
        json.dump({"traceEvents": torch_ev}, f)
    meta = [{"ph": "M", "name": "process_name", "pid": 1,
             "args": {"name": "/device:TPU:0"}},
            {"ph": "M", "name": "process_name", "pid": 2,
             "args": {"name": "/host:CPU"}}]
    jax_ev = meta + [{"ph": "X", "name": n, "ts": ts, "dur": d, "pid": 1,
                      "tid": s} for n, _, ts, d, s in DEVICE]
    jax_ev += [{"ph": "X", "name": n, "ts": ts, "dur": d, "pid": 2,
                "tid": 1} for n, _, ts, d in HOST]
    prof = root / "jax" / "plugins" / "profile" / "x"
    prof.mkdir(parents=True)
    with gzip.open(prof / "y.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": jax_ev}, f)
    return root / "torch", root / "jax"


def _tables(text: str):
    return [ln for ln in text.splitlines()
            if ln.startswith("|") or ln.startswith("device total")]


def test_trace_summary_gives_the_jax_tools_tables(tmp_path, capsys):
    torch_dir, jax_dir = _write_traces(tmp_path)
    want = subprocess.run(
        [sys.executable, str(REPO / "tools" / "trace_summary.py"),
         str(jax_dir), "--top", "10", *BUCKETS],
        capture_output=True, text=True, check=True, timeout=60).stdout
    assert trace_summary.main([str(torch_dir), "--top", "10", *BUCKETS]) == 0
    got = capsys.readouterr().out
    assert _tables(got) == _tables(want)
    assert len(_tables(want)) == 1 + 2 + 3 + 2 + 4  # both tables filled


def test_trace_summary_busy_idle_and_gaps(tmp_path, capsys):
    torch_dir, _ = _write_traces(tmp_path)
    assert trace_summary.main([str(torch_dir), "--window", "predict_batch",
                               "--gaps", "3", "--json"]) == 0
    r = json.loads(capsys.readouterr().out)
    # the device's union: [100, 150) [160, 220) [300, 350) [420, 450) ms,
    # 190 ms, where the durations sum to 210; the window 50-500 ms
    assert r["device_ms"] == pytest.approx(210.0)
    assert r["busy_ms"] == pytest.approx(190.0)
    assert r["window_ms"] == pytest.approx(450.0)
    assert r["idle_share"] == pytest.approx(1 - 190 / 450)
    assert r["launches"]["ir_block_tc_kernel"] == 2
    assert [(g["ms"], g["host"]) for g in r["gaps"]] == [
        (pytest.approx(80.0), "cudaStreamSynchronize"),
        (pytest.approx(70.0), "aten::add"),
        (pytest.approx(50.0), "aten::empty")]
    assert [g["start_us"] for g in r["gaps"]] == [170_000, 300_000, 0]
    # every gap's idle time by the host event at its start; 150-160 and
    # 450-500 ms begin between operations
    assert r["n_gaps"] == 5
    assert r["idle_by_host"] == {
        "cudaStreamSynchronize": pytest.approx(80.0),
        "aten::add": pytest.approx(70.0), "(none)": pytest.approx(60.0),
        "aten::empty": pytest.approx(50.0)}


def test_trace_summary_fails_without_device_events(tmp_path, capsys):
    """A trace of CPU work only (``trace_context`` without a card) holds no
    device event: the tool exits non-zero and prints no summary."""
    with trace_context(str(tmp_path)):
        torch.ones(4).add(1).sum()
    assert (tmp_path / "trace.json").is_file()
    assert trace_summary.main([str(tmp_path)]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "no device event" in out.err


# ------------------------- the tools on the CPU --------------------------

SMALL = ["--device", "cpu", "--batch", "2", "--res", "64"]


def _json_tail(text: str):
    """The JSON object a tool printed last (indented or on one line)."""
    start = text.rindex("\n{") + 1 if "\n{" in text else text.index("{")
    return json.loads(text[start:])


def test_roofline_counts_on_the_cpu(tmp_path, capsys):
    from tpuseg_torch.tools import roofline

    out = tmp_path / "roofline.json"
    assert roofline.main(SMALL + ["--iters", "1", "--out", str(out)]) == 0
    rows = json.loads(out.read_text())
    jax_keys = {"stage", "gflop", "gb", "ai_flop_per_byte", "ms", "tflops",
                "pct_mxu_peak", "hbm_gbs", "pct_hbm_peak", "note"}
    assert [r["stage"] for r in rows] == [
        "preprocess (21-ch)", "semantic (pre+UNet+head)",
        "full infer, k=32 cap"]
    for r in rows:
        assert jax_keys <= set(r), jax_keys - set(r)
        assert r["gb"] > 0 and r["pct_mxu_peak"] is None  # no share: CPU
    infer = rows[-1]
    assert infer["rounds"] > 0
    chain = infer["kernels"]["ir_chain"]
    assert chain["calls"] == 5 * infer["rounds"]
    assert rows[1]["gflop"] > 0 and infer["gflop"] > rows[1]["gflop"]
    assert "full infer" in capsys.readouterr().out


def test_profile_stages_on_the_cpu(capsys):
    from tpuseg_torch.tools import profile_stages

    assert profile_stages.main(SMALL + ["--iters", "1", "--ks", "1,32"]) == 0
    r = _json_tail(capsys.readouterr().out)
    assert {"batch", "dtype", "stages_ms_per_batch", "stages_ms_per_image",
            "imgs_per_sec_full"} <= set(r)
    assert set(r["stages_ms_per_batch"]) == {
        "preprocess", "semantic", "infer_k1", "infer_k32",
        "per_slot_extract", "attend_plus_skips", "unet_only"}
    assert r["batch"] == 2 and r["dtype"] == "bf16" and r["device"] == "cpu"


def test_profile_components_on_the_cpu(capsys):
    from tpuseg_torch.tools import profile_components

    assert profile_components.main(SMALL + ["--iters", "1"]) == 0
    r = _json_tail(capsys.readouterr().out)
    assert {"batch", "dtype", "ms_per_batch", "ms_per_image"} <= set(r)
    assert set(r["ms_per_batch"]) == {"stem", "s_sp", "attend",
                                      "transform_skips", "decode1",
                                      "full_infer"}


def test_profile_decode_scaling_on_the_cpu(capsys):
    from tpuseg_torch.tools import profile_decode_scaling

    assert profile_decode_scaling.main(
        ["--device", "cpu", "--res", "64", "--batches", "2,4", "--iters",
         "1"]) == 0
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(r) == {"device", "decode_bf16_b2", "decode_bf16_b4",
                      "decode_f32_b2", "decode_f32_b4"}


def test_warmup_on_the_cpu(capsys):
    from tpuseg_torch.tools import warmup

    assert warmup.main(["--device", "cpu", "--res", "64", "--batchsizes",
                        "2"]) == 0
    out = capsys.readouterr().out
    assert "batch 2 @ 64^2 (bf16): set up and ran in" in out
    r = json.loads(out.strip().splitlines()[-1])
    assert set(r["libraries"]) == {"native"}  # no CUDA library on the CPU
    assert os.path.isfile(r["libraries"]["native"]["path"])


def test_ab_infer_overrides():
    """``ab_infer --set group.field=value``: the pairs leave the positional
    arguments alone and change the config; values are literals only."""
    argv = ["ab_infer.py", "tree", "64", "--set", "decoder.extract_group=2",
            "3", "--set", "model.n_filters=16"]
    rest, pairs = ab_infer.split_overrides(argv)
    assert rest == ["ab_infer.py", "tree", "64", "3"]
    cfg = ab_infer.apply_overrides(cvppp_config(), pairs)
    assert cfg.decoder.extract_group == 2 and cfg.model.n_filters == 16
    assert cvppp_config().decoder.extract_group != 2
    with pytest.raises(ValueError):
        ab_infer.apply_overrides(cvppp_config(),
                                 ["decoder.extract_group=__import__('os')"])
    with pytest.raises(ValueError, match="group.field=value"):
        ab_infer.apply_overrides(cvppp_config(), ["extract_group=2"])
    # as ab_infer.main loads: the overrides applied before the checkpoint
    cfg, _ = load_model(ab_infer.apply_overrides(cvppp_config(), pairs[:1]),
                        stages.CKPT)
    assert cfg.decoder.extract_group == 2
