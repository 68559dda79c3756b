"""TSDF grid storage, coordinate maps and interpolation."""
from tracking_sdf_tpu_torch.grid.grid import (
    TSDFGrid,
    empty_grid,
    voxel_centers_world,
    voxel_to_world,
    world_to_voxel,
)
from tracking_sdf_tpu_torch.grid.interp import (
    interp_color,
    shepard_l1,
    trilinear,
    trilinear_with_grad,
)
