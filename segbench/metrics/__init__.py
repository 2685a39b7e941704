"""One reader a per-layer metric: ``read(ctx)`` returns the metric's value
from a traced run, or None where the run has nothing to read it from.

``ctx`` holds ``summary`` (``trace.summarize`` of the traced window),
``images``, ``device_kind``, ``flops`` (the frozen count of the window's
work) and, by entry, ``batches``, ``rounds``, ``ir_chain_launches``,
``chain_calls``, ``chain_bound_s``, ``dtype`` (inference) or
``steps`` (training)."""
