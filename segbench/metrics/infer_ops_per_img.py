"""Device events (kernels, copies, memsets) of the traced inference window
a image: the host's dispatch work that paces a batch."""


def read(ctx):
    if "batches" not in ctx:
        return None
    return ctx["summary"]["ops"] / ctx["images"]
