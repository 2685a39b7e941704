"""Helpers the readers share."""

from segbench.count.peaks import H100_SXM, PEAK_BF16


def on_h100(ctx) -> bool:
    return any(part in ctx.get("device_kind", "") for part in H100_SXM)


def idle_pct(ctx):
    s = ctx["summary"]
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def mfu_pct(ctx):
    """The window's counted operations over its seconds at the card's
    bf16 tensor-core peak (the configurations run in bf16)."""
    if not on_h100(ctx):
        return None
    return 100.0 * ctx["flops"] / (ctx["summary"]["window_s"] * PEAK_BF16)
