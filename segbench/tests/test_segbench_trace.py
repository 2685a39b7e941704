"""The trace arithmetic on a small hand-written Chrome trace."""

import pytest

from segbench import trace
from segbench.metrics import (infer_idle_share, infer_idle_us_per_op,
                              infer_ops_per_img, ir_chain_roofline)


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    _x(trace.WINDOW, "user_annotation", 0, 1000),
    _x("aten::conv2d", "cpu_op", 0, 90),
    _x("cudaLaunchKernel", "cuda_runtime", 10, 5),
    _x("cudnn_conv_kernel", "kernel", 100, 200),      # 100-300
    _x("ir_block_tc_kernel<32>", "kernel", 250, 150),  # 250-400, overlaps
    _x("aten::copy_", "cpu_op", 380, 400),
    _x("Memcpy DtoH", "gpu_memcpy", 700, 100),         # 700-800
    _x("vectorized_elementwise_kernel", "kernel", 950, 100),  # cut at 1000
    _x("late_kernel", "kernel", 1200, 10),             # outside
]


def test_busy_idle_and_gaps():
    s = trace.summarize(EVENTS)
    assert s["window_s"] == pytest.approx(1000e-6)
    # busy: [100, 400) + [700, 800) + [950, 1000) = 450 us
    assert s["busy_s"] == pytest.approx(450e-6)
    assert s["ops"] == 4
    # idle gaps: [0,100) under conv2d's op, [400,700) under copy_,
    # [800,950) under none
    gaps = dict((h, v) for h, v in s["idle_gaps"])
    assert gaps["aten::copy_"] == pytest.approx(300e-6)
    assert s["idle_by_host"]["(none)"] == pytest.approx(150e-6)
    assert s["idle_by_host"]["aten::conv2d"] == pytest.approx(100e-6)
    assert s["buckets"]["ir_chain"] == pytest.approx(150e-6)
    assert s["buckets"]["convolutions"] == pytest.approx(200e-6)
    assert s["buckets"]["copies"] == pytest.approx(100e-6)
    assert s["buckets"]["elementwise"] == pytest.approx(50e-6)
    b = trace.breakdown(s)
    assert b["device_ops"][0][0] == "convolutions"
    assert b["idle_gaps"][0] == ["aten::copy_", pytest.approx(300e-6)]


def test_readers_on_the_trace():
    s = trace.summarize(EVENTS)
    ctx = {"summary": s, "batches": 2, "images": 4, "rounds": 3,
           "ir_chain_launches": 1, "chain_calls": 1,
           "chain_bound_s": 30e-6, "device_kind": "NVIDIA H100 80GB HBM3"}
    assert infer_idle_share.read(ctx) == pytest.approx(55.0)
    assert infer_ops_per_img.read(ctx) == pytest.approx(1.0)
    assert infer_idle_us_per_op.read(ctx) == pytest.approx(550 / 4)
    assert ir_chain_roofline.read(ctx) == pytest.approx(20.0)
    # counts that disagree leave the roofline silent; so does a CPU run
    assert ir_chain_roofline.read(dict(ctx, chain_calls=2)) is None
    assert ir_chain_roofline.read(dict(ctx, ir_chain_launches=4)) is None
    assert ir_chain_roofline.read(dict(ctx, device_kind="cpu")) is None
    # an inference reader finds nothing in a training window
    assert infer_idle_share.read({"summary": s, "steps": 1}) is None


def test_no_device_event_raises():
    with pytest.raises(ValueError):
        trace.summarize([_x(trace.WINDOW, "user_annotation", 0, 10)])
