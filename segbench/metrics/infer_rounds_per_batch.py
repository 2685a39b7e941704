"""Extraction rounds a batch in the traced window: the change of the
program's ``Predictor.rounds_run`` counter over its batches."""


def read(ctx):
    if "batches" not in ctx:
        return None
    return ctx["rounds"] / ctx["batches"]
