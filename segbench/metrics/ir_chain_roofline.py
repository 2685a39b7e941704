"""The ``ir_chain`` kernel's share of its roofline (%): the summed least
time of the traced window's chain calls (``count.peaks.chain_bound_s`` at
the shape of each call of a round, times the rounds run) over the summed
device time of the kernel's launches in the trace.  Silent where the
launches in the trace and the program's ``ir_chain.launches`` counter
disagree, or are not a whole number of launches for each call the frozen
count makes (the chain is then not the work the bound describes)."""

from segbench.metrics._common import on_h100


def read(ctx):
    if "chain_bound_s" not in ctx or not on_h100(ctx):
        return None
    s = ctx["summary"]
    names = [n for n in s["by_name"] if "ir_block" in n]
    launches = sum(s["launches"][n] for n in names)
    calls = ctx["chain_calls"]
    if not (launches and calls and launches == ctx["ir_chain_launches"]
            and launches % calls == 0):
        return None
    return 100.0 * ctx["chain_bound_s"] / sum(s["by_name"][n] for n in names)
