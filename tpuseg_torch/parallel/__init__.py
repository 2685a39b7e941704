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
from tpuseg_torch.parallel.spatial import (  # noqa: F401
    make_infer_spatial,
    make_semantic_spatial,
    make_train_spatial,
    replicate_state,
    shard_spatial,
    shard_train_batch,
    spatial_context,
    spatial_sharding,
)
