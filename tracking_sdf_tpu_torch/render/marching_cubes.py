"""Isosurface meshing by marching tetrahedra, and PLY export (counterpart of
tracking_sdf_tpu.render.marching_cubes, single device).

The zero isosurface of D is extracted over every cell whose 8 corners are
observed (W > 0) and whose corner values change sign. Each cell splits into
6 tetrahedra around its main diagonal; a tetrahedron has 16 cases of at
most 2 triangles, whose vertices are interpolated linearly along the cut
edges. Winding is fixed by aligning each face normal with the cell's
central-difference SDF gradient (+gradient points outside).

Everything runs on the grid's device in three passes: the active-cell mask
(slices of D and W), the triangulation of the active cells (in row-major
cell order), and the compaction of the valid triangles (row-major over cell,
tetrahedron and triangle). The host reads two counts, then the exact-size
results: vertices (float32, or uint16 per-axis box coordinates with
``vertex_quant``) and uint8 colors.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from tracking_sdf_tpu_torch.config import GridParams
from tracking_sdf_tpu_torch.grid.grid import FIELDS, TSDFGrid, voxel_to_world, world_to_voxel
from tracking_sdf_tpu_torch.grid.interp import interp_color, shepard_color

# Cube corners in binary (x, y, z) bit order.
_CORNERS = np.array(
    [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
     [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]], dtype=np.int64)

# Six tetrahedra around the main diagonal c0 -> c7.
_TETS = np.array(
    [[0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7],
     [0, 6, 4, 7], [0, 4, 5, 7], [0, 5, 1, 7]], dtype=np.int64)

# Tetrahedron edges as pairs of local vertex indices.
_EDGES = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int64)

# case bit i set <=> tetrahedron vertex i is inside (d < 0). Each case lists
# up to 2 triangles as triples of edge ids (-1 = unused); winding is fixed
# afterwards by the gradient, so only the cut-edge sets matter here.
_TRI_TABLE = np.full((16, 2, 3), -1, dtype=np.int64)
_TRI_TABLE[1, 0] = (0, 1, 2)            # v0
_TRI_TABLE[2, 0] = (0, 3, 4)            # v1
_TRI_TABLE[3] = ((1, 3, 4), (1, 4, 2))  # v0 v1
_TRI_TABLE[4, 0] = (1, 3, 5)            # v2
_TRI_TABLE[5] = ((0, 3, 5), (0, 5, 2))  # v0 v2
_TRI_TABLE[6] = ((0, 1, 5), (0, 5, 4))  # v1 v2
_TRI_TABLE[7, 0] = (2, 4, 5)            # v0 v1 v2
_TRI_TABLE[8, 0] = (2, 4, 5)            # v3
_TRI_TABLE[9] = ((0, 1, 5), (0, 5, 4))  # v0 v3
_TRI_TABLE[10] = ((0, 3, 5), (0, 5, 2))  # v1 v3
_TRI_TABLE[11, 0] = (1, 3, 5)           # v0 v1 v3
_TRI_TABLE[12] = ((1, 3, 4), (1, 4, 2))  # v2 v3
_TRI_TABLE[13, 0] = (0, 3, 4)           # v0 v2 v3
_TRI_TABLE[14, 0] = (0, 1, 2)           # v1 v2 v3

_GREY = 0.4  # the color of a vertex with no color observation around it


class Mesh(NamedTuple):
    """Triangle soup. Winding follows a cell-constant gradient, so in a cell
    crossed by two surface sheets a sliver triangle may be wound inward;
    vertex positions are exact either way."""

    vertices: np.ndarray  # (T, 3, 3) float32 world-space triangle vertices
    colors: Optional[np.ndarray]  # (T, 3, 3) float32 in [0, 1], or None
    dropped_cells: int = 0  # surface cells past max_cells, not triangulated

    @property
    def num_triangles(self) -> int:
        return int(self.vertices.shape[0])


def _table(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(a).to(device)


def _active_cells(grid: TSDFGrid) -> torch.Tensor:
    """(s0-1, s1-1, s2-1) bool: cells whose 8 corners have W > 0 and whose
    corner values hold lo < 0 <= hi. Works on i-slabs too (the shape comes
    from D)."""
    D, W = grid.D, grid.W
    s0, s1, s2 = (s - 1 for s in D.shape)
    lo = hi = None
    valid = None
    for dx, dy, dz in _CORNERS.tolist():
        d = D[dx:dx + s0, dy:dy + s1, dz:dz + s2]
        w = W[dx:dx + s0, dy:dy + s1, dz:dz + s2] > 0
        lo = d if lo is None else torch.minimum(lo, d)
        hi = d if hi is None else torch.maximum(hi, d)
        valid = w if valid is None else valid & w
    return valid & (lo < 0.0) & (hi >= 0.0)


def _active_cell_indices(active: torch.Tensor, n_cells: int) -> torch.Tensor:
    """(n_cells, 3) indices of the first ``n_cells`` active cells in
    row-major order (np.argwhere's order)."""
    n1, n2 = active.shape[1:]
    flat = torch.nonzero(active.reshape(-1)).reshape(-1)[:n_cells]
    return torch.stack([flat // (n1 * n2), (flat // n2) % n1, flat % n2], dim=-1)


def _triangulate_cells(grid: TSDFGrid, cells: torch.Tensor, *, params: GridParams,
                       i_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """cells (A, 3) -> (vertices (A*6, 2, 3, 3), valid (A*6, 2)). ``cells``
    index the grid's tensors (maybe an i-slab); ``i_offset`` is the slab's
    first global i, so world positions stay global."""
    dev = cells.device
    corners = cells[:, None, :] + _table(_CORNERS, dev)[None]  # (A, 8, 3)
    d = grid.D[corners[..., 0], corners[..., 1], corners[..., 2]]  # (A, 8)
    goff = torch.tensor([i_offset, 0, 0], dtype=corners.dtype, device=dev)
    pos = voxel_to_world(params, (corners + goff).to(grid.D.dtype))  # (A, 8, 3)

    tets = _table(_TETS, dev)
    A = d.shape[0]
    d_t = d[:, tets].reshape(A * 6, 4)
    p_t = pos[:, tets].reshape(A * 6, 4, 3)
    inside = (d_t < 0.0).to(torch.int64)
    case = inside[:, 0] + 2 * inside[:, 1] + 4 * inside[:, 2] + 8 * inside[:, 3]
    edges = _table(_TRI_TABLE, dev)[case]  # (N, 2, 3) edge ids, -1 = unused
    valid_tri = edges[:, :, 0] >= 0
    ends = _table(_EDGES, dev)[edges.clamp(min=0)]  # (N, 2, 3, 2) tet vertex ids
    rows = torch.arange(A * 6, device=dev)[:, None, None]
    da, db = d_t[rows, ends[..., 0]], d_t[rows, ends[..., 1]]
    pa, pb = p_t[rows, ends[..., 0]], p_t[rows, ends[..., 1]]
    denom = da - db
    mu = torch.where(denom.abs() > 1e-12,
                     da / torch.where(denom == 0, torch.ones_like(denom), denom),
                     torch.full_like(denom, 0.5)).clamp(0.0, 1.0)
    verts = pa + mu[..., None] * (pb - pa)  # (N, 2, 3, 3)

    # winding: the face normal along +grad(D), the gradient from the cell's
    # 8 corners (central differences: the mean of the 4 axis-edge deltas)
    sign = 2.0 * _table(_CORNERS, dev).to(d.dtype) - 1.0  # (8, 3)
    scale = torch.tensor([params.m / params.width, params.m / params.height,
                          params.m / params.depth], dtype=d.dtype, device=dev)
    g_cell = torch.stack([torch.sum(d * sign[:, a], dim=-1) / 4.0 for a in range(3)],
                         dim=-1) * scale
    g_tet = torch.repeat_interleave(g_cell, 6, dim=0)[:, None, :]
    v0, v1, v2 = verts[:, :, 0], verts[:, :, 1], verts[:, :, 2]
    face_n = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)
    flip = torch.sum(face_n * g_tet, dim=-1) < 0
    verts = torch.where(flip[:, :, None, None], torch.flip(verts, dims=(2,)), verts)
    return verts, valid_tri


def _compact_triangles(verts: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(T, 3, 3) valid triangles in row-major (cell, tet, triangle) order."""
    idx = torch.nonzero(valid.reshape(-1)).reshape(-1)
    return verts.reshape(-1, 3, 3)[idx]


def _vertex_colors(grid: TSDFGrid, tri: torch.Tensor, *, params: GridParams,
                   color_mode: str, i_offset: int = 0) -> torch.Tensor:
    """(T, 3, 3) uint8 vertex colors: interpolated from the color leaves
    (trilinear or Shepard), grey 0.4 where no corner has Wc > 0, then
    clipped to [0, 255] and truncated, as the PLY export quantizes."""
    color_fn = shepard_color if color_mode == "shepard" else interp_color
    coords = world_to_voxel(params, tri.reshape(-1, 3))
    if i_offset:
        coords = coords - torch.tensor([i_offset, 0, 0], dtype=coords.dtype,
                                       device=coords.device)
    rgb, cvalid = color_fn(grid.R, grid.G, grid.B, grid.Wc, coords)
    rgb = torch.where(cvalid[..., None], rgb, torch.full_like(rgb, _GREY))
    return (rgb * 255.0).clamp(0, 255).to(torch.uint8).reshape(tri.shape)


def _quantize_tris(tri: torch.Tensor, params: GridParams) -> torch.Tensor:
    """float32 world vertices -> uint16 per-axis box coordinates."""
    lo = torch.tensor(params.origin, dtype=torch.float32, device=tri.device)
    ext = torch.tensor(params.extent, dtype=torch.float32, device=tri.device)
    q = torch.round((tri.to(torch.float32) - lo) / ext * 65535.0)
    return q.clamp(0.0, 65535.0).to(torch.int32).to(torch.uint16)


def _dequantize(q: np.ndarray, params: GridParams) -> np.ndarray:
    lo = np.asarray(params.origin, np.float32)
    ext = np.asarray(params.extent, np.float32)
    return q.astype(np.float32) * (ext / 65535.0) + lo


def marching_cubes(grid: TSDFGrid, *, params: GridParams, with_colors: bool = False,
                   max_cells: Optional[int] = None, color_mode: str = "trilinear",
                   i_offset: int = 0, vertex_quant: bool = False) -> Mesh:
    """The zero-isosurface triangle mesh of ``grid`` (on its device).

    ``max_cells`` caps the triangulated cells (the first in row-major
    order); the rest are reported in ``dropped_cells``. ``color_mode``
    "trilinear" (smooth) or "shepard" (the reference's per-vertex
    interpolate_color). ``i_offset``: the grid is an i-slab starting at
    that global i. ``vertex_quant`` reads the vertices back as uint16
    per-axis box coordinates (error at most extent / 131070)."""
    if color_mode not in ("trilinear", "shepard"):
        raise ValueError(f"unknown color_mode: {color_mode!r}")
    active = _active_cells(grid)
    n_act = int(active.sum())
    if n_act == 0:
        empty = np.zeros((0, 3, 3), np.float32)
        return Mesh(empty, empty.copy() if with_colors else None)
    n_cells = n_act if max_cells is None else min(n_act, max_cells)
    cells = _active_cell_indices(active, n_cells)
    del active
    verts, valid = _triangulate_cells(grid, cells, params=params, i_offset=i_offset)
    tri = _compact_triangles(verts, valid)
    del verts, valid
    colors = None
    if with_colors:
        rgb8 = _vertex_colors(grid, tri, params=params, color_mode=color_mode,
                              i_offset=i_offset)
        colors = rgb8.cpu().numpy().astype(np.float32) / 255.0
    if vertex_quant:
        vertices = _dequantize(_quantize_tris(tri, params).cpu().numpy(), params)
    else:
        vertices = tri.cpu().numpy().astype(np.float32)
    return Mesh(vertices, colors, dropped_cells=n_act - n_cells)


def marching_cubes_chunked(grid: TSDFGrid, *, params: GridParams, n_chunks: int = 4,
                           with_colors: bool = False, max_cells: Optional[int] = None,
                           color_mode: str = "trilinear",
                           vertex_quant: bool = False) -> Mesh:
    """marching_cubes over ``n_chunks`` i-slabs (each with one halo plane for
    its last cell row), one after the other: bounds the peak device memory.
    Triangles come in the one-shot order (slabs ascend in i)."""
    m = params.m
    step = -(-m // n_chunks)
    parts = []
    for i0 in range(0, m, step):
        hi = min(i0 + step + 1, m)
        sub = TSDFGrid(*(getattr(grid, k)[i0:hi] for k in FIELDS))
        parts.append(marching_cubes(sub, params=params, with_colors=with_colors,
                                    max_cells=max_cells, color_mode=color_mode,
                                    i_offset=i0, vertex_quant=vertex_quant))
    tri = np.concatenate([p.vertices for p in parts], axis=0)
    colors = (np.concatenate([p.colors for p in parts], axis=0) if with_colors else None)
    return Mesh(tri, colors, dropped_cells=sum(p.dropped_cells for p in parts))


def export_ply(mesh: Mesh, path: str, binary: bool = True) -> None:
    """PLY export (with vertex colors if the mesh has them), binary little
    endian by default, or ASCII."""
    t = mesh.vertices
    n_v = t.shape[0] * 3
    n_f = t.shape[0]
    has_c = mesh.colors is not None
    verts = np.ascontiguousarray(t.reshape(-1, 3), dtype="<f4")
    if has_c:
        cols = np.clip(mesh.colors.reshape(-1, 3) * 255.0, 0, 255).astype(np.uint8)

    if binary:
        with open(path, "wb") as f:
            hdr = ["ply", "format binary_little_endian 1.0",
                   f"element vertex {n_v}",
                   "property float x", "property float y", "property float z"]
            if has_c:
                hdr += ["property uchar red", "property uchar green",
                        "property uchar blue"]
            hdr += [f"element face {n_f}",
                    "property list uchar int vertex_indices", "end_header"]
            f.write(("\n".join(hdr) + "\n").encode())
            if has_c:
                rec = np.zeros(n_v, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
                rec["xyz"] = verts
                rec["rgb"] = cols
            else:
                rec = np.zeros(n_v, dtype=[("xyz", "<f4", 3)])
                rec["xyz"] = verts
            rec.tofile(f)
            faces = np.zeros(n_f, dtype=[("n", "u1"), ("idx", "<i4", 3)])
            faces["n"] = 3
            faces["idx"] = np.arange(3 * n_f, dtype="<i4").reshape(n_f, 3)
            faces.tofile(f)
        return

    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n_v}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if has_c:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element face {n_f}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        if has_c:
            for v, c in zip(verts, cols):
                f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f} {c[0]} {c[1]} {c[2]}\n")
        else:
            for v in verts:
                f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for i in range(n_f):
            f.write(f"3 {3 * i} {3 * i + 1} {3 * i + 2}\n")


def marching_cubes_sharded(grid: TSDFGrid, mesh, *, params: GridParams,
                           with_colors: bool = False, max_cells: Optional[int] = None,
                           color_mode: str = "trilinear",
                           vertex_quant: bool = False) -> Mesh:
    """Mesh this rank's i-slab (TSDFGrid of (slab, m, m) leaves) of a grid
    split over ``mesh`` (parallel.mesh.Mesh): the cells whose base voxel the
    rank owns. The last owned plane's cells need the next rank's first
    plane, which one collective fetches (every rank calls this; the last
    rank has no next plane and meshes to m - 2). Returns this rank's
    triangles: concatenated in rank order, the ranks' meshes equal
    ``marching_cubes`` of the whole grid, triangle for triangle."""
    first = torch.stack([getattr(grid, k)[:1] for k in FIELDS])
    every = mesh.all_gather(first[None])  # (n, 6, 1, m, m)
    sub = grid
    if mesh.rank < mesh.size - 1:
        nxt = every[mesh.rank + 1]
        sub = TSDFGrid(*(torch.cat([getattr(grid, k), nxt[c]])
                         for c, k in enumerate(FIELDS)))
    return marching_cubes(sub, params=params, with_colors=with_colors,
                          max_cells=max_cells, color_mode=color_mode,
                          i_offset=mesh.i0(params.m), vertex_quant=vertex_quant)
