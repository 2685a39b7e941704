from tpuseg_torch.models.reseg import ReSeg, density_count  # noqa: F401
