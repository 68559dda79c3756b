"""Synthetic scenes and exact depth rendering."""
from tracking_sdf_tpu_torch.data.synthetic import (
    CuboidScene,
    SphereScene,
    grid_from_scene,
    look_at,
    orbit_poses,
    render_scene_depth,
)
