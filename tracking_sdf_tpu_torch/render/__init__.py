"""Rendering and meshing of the grid: the raycaster (render.raycast),
marching tetrahedra with PLY export (render.marching_cubes) and PNG panels
of a render (render.image_io)."""
