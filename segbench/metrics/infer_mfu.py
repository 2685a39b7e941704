"""The inference window's share of the card's bf16 peak (%): the frozen
count of the operations its images need (preparation a image, each
extraction round as run) over the window's seconds x 989 TFLOP/s."""

from segbench.metrics._common import mfu_pct


def read(ctx):
    return mfu_pct(ctx) if "batches" in ctx else None
