"""Several ranks over torch.distributed (parallel/sharding.py)."""

from slam_maskrcnn_tpu_torch.parallel.sharding import (
    Mesh, batch_stats_over, gather_volume_state, launch, make_mesh,
    make_sharded_fusion_step, make_sharded_render, shard_batch, shard_params,
    shard_volume_state, single_mesh)

__all__ = ["Mesh", "batch_stats_over", "gather_volume_state", "launch",
           "make_mesh", "make_sharded_fusion_step", "make_sharded_render",
           "shard_batch", "shard_params", "shard_volume_state",
           "single_mesh"]
