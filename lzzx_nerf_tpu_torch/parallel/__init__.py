"""Device meshes, shardings and process groups (port of
lzzx_nerf_tpu/parallel/): the data-parallel training step's ray shards
over a torch.distributed group, and the frame-parallel serving session's
devices."""
from .mesh import (DataSharding, Mesh, Replicated, data_sharding,
                   make_mesh, replicate, shard_batch)

__all__ = ["DataSharding", "Mesh", "Replicated", "data_sharding",
           "make_mesh", "replicate", "shard_batch"]
