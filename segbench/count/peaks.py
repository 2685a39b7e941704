"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W; a card set below that runs slower than they say), and the
least time of one ``ir_chain`` call.  Frozen copies of the program's
``utils/roofline.py`` figures and formulas."""

from __future__ import annotations

PEAK_F32 = 67e12           # float32 on the CUDA cores
PEAK_TF32 = 494.7e12
PEAK_3XTF32 = PEAK_TF32 / 3
PEAK_BF16 = 989e12         # bf16 on the tensor cores
PEAK_MATMUL = {"float32": PEAK_3XTF32, "bfloat16": PEAK_BF16}
PEAK_BYTES = 3.35e12       # HBM3

H100_SXM = ("H100 80GB HBM3", "H100 SXM")


def check_card(name: str) -> None:
    """Raises for a card whose peaks these are not."""
    if not any(part in name for part in H100_SXM):
        raise RuntimeError(f"no peak figures for {name!r}: only the H100 "
                           f"SXM ({', '.join(H100_SXM)}) is known")


def chain_ops(n: int, h: int, w: int, c: int) -> int:
    """2 x the multiply-adds of one ``ir_chain`` call: per pixel and block
    the two pointwise products (2 x 2 C^2 MACs) and the depthwise 3x3 taps
    (18 C MACs)."""
    return 4 * n * h * w * (8 * c * c + 36 * c)


def chain_bytes(n: int, h: int, w: int, c: int, act_bytes: int,
                with_skip: bool) -> int:
    """Inputs read once and the output written once: x (and the skip),
    the four blocks' weights (pointwise in the activations' dtype, biases
    and depthwise taps in float32), y."""
    act = n * h * w * c * act_bytes
    weights = 4 * (2 * c * 2 * c * act_bytes + (2 * c * 2 + 2 * c * 9 + c) * 4)
    return act * (3 if with_skip else 2) + weights


def chain_bound_s(n: int, h: int, w: int, c: int, dtype_name: str,
                  with_skip: bool) -> float:
    """The least seconds of one call: the larger of its bytes at the
    memory rate and its operations, the pointwise products at the matrix
    rate of the dtype and the rest (depthwise taps, bias + relu6 passes,
    residual: 50 C a pixel and block) at the CUDA cores' float32 rate, the
    two kinds on different units."""
    es = 4 if dtype_name == "float32" else 2
    nbytes = chain_bytes(n, h, w, c, es, with_skip)
    px = n * h * w * 4
    ops_s = max(px * 8 * c * c / PEAK_MATMUL[dtype_name],
                px * 50 * c / PEAK_F32)
    return max(nbytes / PEAK_BYTES, ops_s)
