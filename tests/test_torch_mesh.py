"""The port's marching tetrahedra and PLY export against the JAX package's,
on the CPU, on the grids of test_torch_render.py (the JAX suite's sphere at
m=64 and the dense view of the port's fused tum256 loop at m=48), the same
float32 arrays through both.

Tolerances: equal triangle counts and dropped_cells; vertices within 1e-6
(the same float32 operations on the same corner values), and with
vertex_quant within one uint16 quantum (extent / 65535: XLA may scale by the
reciprocal where the port divides, and a coordinate within an ulp of a
half-quantum then rounds the other way); colors within one uint8 step
(1/255: both quantize by clip and truncation, and a color on a step
boundary, such as the scene's constant 0.2 = 51/255, lands on either side
after a float32 sum in another order); the PLY bytes equal.
"""
import numpy as np
import pytest
import torch

from test_torch_render import JPARAMS, PARAMS, fused_grids, sphere_grids
from tracking_sdf_tpu.render import export_ply as jexport_ply
from tracking_sdf_tpu.render import marching_cubes as jmarching_cubes
from tracking_sdf_tpu.render.marching_cubes import Mesh as JMesh
from tracking_sdf_tpu.render.marching_cubes import marching_cubes_chunked as jmarching_cubes_chunked
from tracking_sdf_tpu_torch.grid.grid import FIELDS, TSDFGrid
from tracking_sdf_tpu_torch.render.marching_cubes import (
    Mesh, export_ply, marching_cubes, marching_cubes_chunked)

torch.set_num_threads(2)

TOL_VERT, TOL_COLOR = 1e-6, 1.0 / 255.0 + 1e-6


def _assert_mesh_close(a, b, quant=False):
    assert b.num_triangles == a.num_triangles > 0
    assert b.dropped_cells == a.dropped_cells
    assert b.vertices.dtype == np.float32 and b.vertices.shape == a.vertices.shape
    tol = np.asarray(PARAMS.extent, np.float32) / 65535.0 + 1e-6 if quant else TOL_VERT
    assert (np.abs(b.vertices - a.vertices) <= tol).all()
    if a.colors is None:
        assert b.colors is None
    else:
        assert b.colors.dtype == np.float32
        np.testing.assert_allclose(b.colors, a.colors, atol=TOL_COLOR, rtol=0)


def _weight_gated():
    """The sphere with the x > 0 half unobserved."""
    jg, tg = sphere_grids()
    mask = np.zeros((PARAMS.m,) * 3, np.float32)
    mask[:PARAMS.m // 2] = 1.0
    W = np.asarray(jg.W) * mask
    return (jg._replace(W=jg.W * mask),
            TSDFGrid(**{k: getattr(tg, k) for k in FIELDS if k != "W"}, W=torch.from_numpy(W)))


MC_CASES = {
    "plain": dict(),
    "trilinear_colors": dict(with_colors=True),
    "shepard_colors": dict(with_colors=True, color_mode="shepard"),
    "vertex_quant": dict(with_colors=True, vertex_quant=True),
    "max_cells": dict(max_cells=1000),
    "weight_gate": dict(),
}


@pytest.mark.parametrize("case", list(MC_CASES))
def test_marching_cubes_matches_jax(case):
    jg, tg = _weight_gated() if case == "weight_gate" else sphere_grids()
    kw = MC_CASES[case]
    a = jmarching_cubes(jg, params=JPARAMS, **kw)
    b = marching_cubes(tg, params=PARAMS, **kw)
    _assert_mesh_close(a, b, quant=kw.get("vertex_quant", False))
    if case == "max_cells":
        assert b.dropped_cells > 0
    if case == "weight_gate":
        assert b.vertices[..., 0].max() < 0.02


@pytest.mark.parametrize("case", ["trilinear", "shepard_quant"])
def test_marching_cubes_fused_grid_matches_jax(case):
    jg, tg, params, jparams, _, _ = fused_grids()
    kw = (dict(with_colors=True) if case == "trilinear"
          else dict(with_colors=True, color_mode="shepard", vertex_quant=True))
    a = jmarching_cubes(jg, params=jparams, **kw)
    b = marching_cubes(tg, params=params, **kw)
    _assert_mesh_close(a, b, quant=case == "shepard_quant")


@pytest.mark.parametrize("n_chunks", [2, 4])
def test_marching_cubes_chunked_matches_jax_and_one_shot(n_chunks):
    """i-slabs with a halo plane: the one-shot mesh, triangles in order (4
    slabs, as the runner at 512^3, with uint16 vertices); 2 slabs with a
    per-slab max_cells against the JAX package's."""
    jg, tg = sphere_grids()
    kw = dict(with_colors=True, vertex_quant=n_chunks == 4, max_cells=2000 if n_chunks == 2 else None)
    a = jmarching_cubes_chunked(jg, params=JPARAMS, n_chunks=n_chunks, **kw)
    b = marching_cubes_chunked(tg, params=PARAMS, n_chunks=n_chunks, **kw)
    _assert_mesh_close(a, b, quant=kw["vertex_quant"])
    if kw["max_cells"] is None:
        one = marching_cubes(tg, params=PARAMS, **kw)
        np.testing.assert_array_equal(b.vertices, one.vertices)
        np.testing.assert_array_equal(b.colors, one.colors)


def test_marching_cubes_sphere_geometry_and_winding():
    """tests/test_render.py's checks on the port alone: vertices on the
    sphere, faces wound outward, and the quantized vertices within half a
    quantum (extent / 131070) of the exact ones."""
    _, tg = sphere_grids()
    mesh = marching_cubes(tg, params=PARAMS, with_colors=True)
    r = np.linalg.norm(mesh.vertices.reshape(-1, 3), axis=-1)
    assert mesh.num_triangles > 500 and np.abs(r - 0.5).max() < 0.03
    tri = mesh.vertices
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    assert (np.sum(n * tri.mean(axis=1), axis=-1) > 0).mean() > 0.99
    quant = marching_cubes(tg, params=PARAMS, with_colors=True, vertex_quant=True)
    tol = np.asarray(PARAMS.extent, np.float32) / 65535.0 * 0.5 + 1e-6
    assert (np.abs(quant.vertices - mesh.vertices) <= tol).all()
    np.testing.assert_array_equal(quant.colors, mesh.colors)


def test_marching_cubes_empty_and_bad_mode():
    _, tg = sphere_grids()
    unseen = TSDFGrid(**{k: getattr(tg, k) for k in FIELDS if k != "W"},
                      W=torch.zeros_like(tg.W))
    mesh = marching_cubes(unseen, params=PARAMS, with_colors=True)
    assert mesh.num_triangles == 0 and mesh.colors.shape == (0, 3, 3)
    with pytest.raises(ValueError):
        marching_cubes(tg, params=PARAMS, color_mode="nearest")


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "ascii"])
@pytest.mark.parametrize("colors", [True, False], ids=["colors", "geometry"])
def test_export_ply_bytes_match_jax(tmp_path, binary, colors):
    """One mesh through both exporters: the same file, byte for byte; the
    binary header and payload sizes parse."""
    _, tg = sphere_grids()
    mesh = marching_cubes(tg, params=PARAMS, with_colors=colors)
    ours, theirs = str(tmp_path / "ours.ply"), str(tmp_path / "theirs.ply")
    export_ply(mesh, ours, binary=binary)
    jexport_ply(JMesh(mesh.vertices, mesh.colors, mesh.dropped_cells), theirs, binary=binary)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        raw = f.read()
        assert raw == g.read()
    head, _, body = raw.partition(b"end_header\n")
    assert f"element face {mesh.num_triangles}".encode() in head
    if binary:
        per_vertex = 12 + (3 if colors else 0)
        assert len(body) == mesh.num_triangles * (3 * per_vertex + 13)
    assert isinstance(mesh, Mesh)
