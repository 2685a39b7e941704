"""The training window's share of the card's bf16 peak (%): the frozen
count of a step's operations (forward, backward, update) times the steps,
over the window's seconds x 989 TFLOP/s."""

from segbench.metrics._common import mfu_pct


def read(ctx):
    return mfu_pct(ctx) if "steps" in ctx else None
