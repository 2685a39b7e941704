"""Share of the traced inference window in which no kernel, copy or
memset ran on the card (%)."""

from segbench.metrics._common import idle_pct


def read(ctx):
    return idle_pct(ctx) if "batches" in ctx else None
