"""Rendering and meshing of the grid: the raycaster (render.raycast),
marching tetrahedra with PLY export (render.marching_cubes) and PNG panels
of a render (render.image_io).

As in the JAX package, ``raycast`` and ``marching_cubes`` here are the
functions: they shadow the modules of the same name as attributes of this
package, so reach the modules with ``importlib.import_module(
"tracking_sdf_tpu_torch.render.raycast")`` or ``from
tracking_sdf_tpu_torch.render.raycast import ...``."""
from tracking_sdf_tpu_torch.render.marching_cubes import export_ply, marching_cubes
from tracking_sdf_tpu_torch.render.raycast import RenderResult, raycast
