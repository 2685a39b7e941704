from segbench.reference.models.reseg import ReSeg  # noqa: F401
