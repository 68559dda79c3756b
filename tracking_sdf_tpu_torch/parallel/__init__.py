"""Multi-device runs: the grid in i-slabs over a torch.distributed process
group, one rank per device (counterpart of tracking_sdf_tpu.parallel).

The JAX package also exports ``grid_sharding`` and ``replicated_sharding``:
those are jax.sharding objects, and the port's Mesh holds each rank's slab
instead, so they have no counterpart here."""
from tracking_sdf_tpu_torch.parallel.mesh import make_mesh, shard_brick_grid, shard_grid
from tracking_sdf_tpu_torch.parallel.render import sharded_raycast
from tracking_sdf_tpu_torch.parallel.sharded import (
    make_sharded_step,
    sharded_fuse_frame,
    sharded_fuse_frame_bricked,
    sharded_fuse_frame_brickmajor,
    sharded_track_frame,
    sharded_track_frame_brickmajor,
    sharded_track_frame_masked,
)

__all__ = [
    "make_mesh",
    "shard_grid",
    "shard_brick_grid",
    "sharded_raycast",
    "sharded_fuse_frame",
    "sharded_fuse_frame_bricked",
    "sharded_fuse_frame_brickmajor",
    "sharded_track_frame",
    "sharded_track_frame_brickmajor",
    "sharded_track_frame_masked",
    "make_sharded_step",
]
