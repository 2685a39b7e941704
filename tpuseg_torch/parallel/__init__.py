from tpuseg_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    pad_and_shard,
    pad_to_multiple,
    replicate,
    run_ranks,
    shard_batch,
    world_size,
)
