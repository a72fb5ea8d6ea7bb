from multioptpy_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    ShardedTree,
    ensemble_mesh,
    shard_batch,
    sharded_optimize_batch,
    tp_energy_and_gradient,
)
