"""K1's order of the sums: ``gn_reduce.sums_in_launch_order`` against hand-
worked sums whose value depends on the order, against the plain reduction
(``gn_reduce_reference``) and against the JAX package's ``gn_reduce_xla``.

On the card the kernel's 29 sums are ``sums_in_launch_order`` of the plain
per-query terms bit for bit (tests/test_torch_kernels_cuda.py); here, on the
CPU, the order is pinned by hand and the sums are held to the JAX suite's
tolerances (tests/test_pallas_gn.py: rtol 1e-5 / atol 1e-4 for A, atol 1e-5
for b), the valid count exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracking_sdf_tpu.config import GridParams
from tracking_sdf_tpu.core.camera import PinholeCamera, backproject
from tracking_sdf_tpu.core.lie import pose_compose as jcompose
from tracking_sdf_tpu.core.lie import se3_exp as jse3_exp
from tracking_sdf_tpu.data.synthetic import (
    CuboidScene, SphereScene, grid_from_scene, look_at, render_scene_depth)
from tracking_sdf_tpu.fusion.brickmajor import brick_grid_from_dense, brick_masked_view
from tracking_sdf_tpu.grid.interp import masked_view as jmasked_view
from tracking_sdf_tpu.tracking.pallas_gn import gather_corner_inputs, gn_reduce_xla
from tracking_sdf_tpu_torch.core.lie import pose_from_numpy
from tracking_sdf_tpu_torch.fusion.brickmajor import brick_grid_from_numpy
from tracking_sdf_tpu_torch.fusion.brickmajor import brick_masked_view as tview
from tracking_sdf_tpu_torch.tracking import gn_reduce as tgn

torch.set_num_threads(2)

PARAMS = GridParams(m=48, width=2.0, height=2.0, depth=2.0,
                    origin=(-1.0, -1.0, -1.0), delta=0.15, epsilon=0.02)
CAM = PinholeCamera(fx=60.0, fy=60.0, cx=47.5, cy=35.5, width=96, height=72)
SPHERE = SphereScene(center=(0.1, 0.05, 0.0), radius=0.45)
BOX = CuboidScene(min_corner=(-0.75, -0.4, -0.55), max_corner=(-0.35, 0.4, 0.15))
POSE = look_at((0.0, -1.5, 0.2), (0.0, 0.0, 0.0))
FORMS = ["dense", "brick_f32", "brick_bf16"]


class Scene:
    """Sphere + box: all six degrees of freedom observable."""

    def sdf(self, x):
        return jnp.minimum(SPHERE.sdf(x), BOX.sdf(x))

    def color(self, x):
        return SPHERE.color(x)

    def intersect(self, o, d):
        ta, tb = SPHERE.intersect(o, d), BOX.intersect(o, d)
        return jnp.where(jnp.isnan(ta), tb,
                         jnp.where(jnp.isnan(tb), ta, jnp.minimum(ta, tb)))


def _inputs(form):
    """(JAX view, port view, camera points (N, 3), JAX pose, port pose): the
    sphere + box grid with 10% unobserved voxels as ``form``, a NaN-speckled
    point image seen from a pose off the rendering one."""
    rng = np.random.default_rng(0)
    grid = grid_from_scene(PARAMS, Scene())
    W = np.array(grid.W)
    W[rng.random(W.shape) < 0.1] = 0.0
    grid = grid._replace(W=jnp.asarray(W))
    depth = np.array(render_scene_depth(Scene(), CAM, POSE))
    depth[rng.random(depth.shape) < 0.05] = np.nan
    pts = np.array(backproject(CAM, jnp.asarray(depth))).reshape(-1, 3)
    pose = jcompose(POSE, jse3_exp(jnp.asarray([0.02, -0.01, 0.015, 0.01, -0.02, 0.01])))
    tpose = pose_from_numpy(pose.R, pose.t, device="cpu")
    if form == "dense":
        jv = jmasked_view(grid.D, grid.W)
        return jv, torch.from_numpy(np.array(jv)), pts, pose, tpose
    bs = (8, 8, 8)
    jb = brick_grid_from_dense(grid, bs, value_dtype=jnp.bfloat16 if form == "brick_bf16"
                               else jnp.float32)
    tb = brick_grid_from_numpy(jb._asdict(), device="cpu")
    return brick_masked_view(jb, PARAMS, bs), tview(tb, PARAMS, bs), pts, pose, tpose


def _check_sums(out, A_ref, b_ref):
    A, b, _, _ = tgn.unpack(out)
    np.testing.assert_allclose(A.numpy(), np.asarray(A_ref), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(b.numpy(), np.asarray(b_ref), rtol=1e-5, atol=1e-5)


# (query, value) placements in one output column and the sum in launch order,
# worked by hand; each case gives another value in some other order
ORDER_CASES = {
    # in warp 0 the tree adds lanes 0 and 16 first: 1e8 + 1 rounds to 1e8,
    # and only then lane 1's -1e8 (exact sum 1)
    "warp_tree": ([(0, 1e8), (1, -1e8), (16, 1.0)], 0.0),
    # the block adds its warps in order: (0 + 1) + 1e8 rounds to 1e8, then
    # warp 2's -1e8 (in reverse order: 1)
    "warps_in_order": ([(0, 1.0), (32, 1e8), (64, -1e8)], 0.0),
    # lane 0 sums blocks 0, 8, ...: 3; lane 1 sums blocks 1 and 9: 1e8 - 1e8
    # = 0; so 3 (in query order: 3 + 1e8 rounds to 1e8, then 0)
    "lanes_over_blocks": ([(0, 3.0), (256, 1e8), (9 * 256, -1e8)], 3.0),
    # blocks 0, 1, 2 are lanes 0, 1, 2, added in lane order: (1e8 + 1) - 1e8
    "lanes_in_order": ([(0, 1e8), (256, 1.0), (512, -1e8)], 0.0),
}


@pytest.mark.parametrize("case", list(ORDER_CASES))
def test_sums_in_launch_order_on_order_dependent_sums(case):
    placements, want = ORDER_CASES[case]
    col = 5
    terms = torch.zeros(2400, tgn.N_OUT)
    for q, v in placements:
        terms[q, col] = v
    out = tgn.sums_in_launch_order(terms)
    assert out.dtype == torch.float32 and tuple(out.shape) == (tgn.N_OUT,)
    assert out[col].item() == want
    others = torch.cat([out[:col], out[col + 1:]])
    assert torch.equal(others, torch.zeros_like(others))


@pytest.mark.parametrize("form", FORMS)
def test_launch_order_of_plain_terms_matches_the_plain_reduction(form):
    """The plain per-query terms summed in launch order against
    ``gn_reduce_reference`` (a matmul over the same terms): the JAX suite's
    tolerances, the valid count exactly."""
    _, view, pts, _, tpose = _inputs(form)
    q = torch.from_numpy(pts)
    terms = tgn.query_terms_reference(view, tpose, q, PARAMS)
    assert tuple(terms.shape) == (q.shape[0], tgn.N_OUT)
    out = tgn.sums_in_launch_order(terms)
    ref = tgn.gn_reduce_reference(view, tpose, q, PARAMS)
    A_ref, b_ref, n_ref, s_ref = tgn.unpack(ref)
    _check_sums(out, A_ref.numpy(), b_ref.numpy())
    assert out[27].item() == n_ref.item() > 1000
    assert abs(out[28].item() - s_ref.item()) <= 1e-5 * s_ref.item()
    assert abs(float(A_ref[0, 0])) > 1.0  # a real system


@pytest.mark.parametrize("form", ["dense", "brick_bf16"])
def test_launch_order_of_plain_terms_matches_jax_xla(form):
    """Against the JAX package's ``gn_reduce_xla`` on the same numpy grid,
    pose and points, fed through ``gather_corner_inputs``."""
    jv, view, pts, pose, tpose = _inputs(form)
    A_x, b_x = gn_reduce_xla(*gather_corner_inputs(jv, pose, jnp.asarray(pts),
                                                   params=PARAMS))
    out = tgn.sums_in_launch_order(tgn.query_terms_reference(view, tpose,
                                                             torch.from_numpy(pts), PARAMS))
    _check_sums(out, A_x, b_x)


@pytest.mark.parametrize("n", [1, 255, 257, 6912, 34240])
def test_launch_order_at_launch_sizes(n):
    """Ragged and whole blocks, one block and many: the sums of n queries
    (the point image tiled with jitter from a seed) against float64 sums of
    the same terms, within the JAX suite's tolerances."""
    _, view, pts, _, tpose = _inputs("brick_bf16")
    rng = np.random.default_rng(n)
    reps = -(-n // pts.shape[0])
    q = np.tile(pts, (reps, 1))[:n]
    q = (q + rng.normal(scale=0.01, size=q.shape)).astype(np.float32)
    terms = tgn.query_terms_reference(view, tpose, torch.from_numpy(q), PARAMS)
    out = tgn.sums_in_launch_order(terms)
    exact = terms.double().sum(0)
    A, b, nv, _ = tgn.unpack(out)
    A64, b64, nv64, _ = tgn.unpack(exact)
    np.testing.assert_allclose(A.numpy(), A64.numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(b.numpy(), b64.numpy(), rtol=1e-5, atol=1e-5)
    assert nv.item() == nv64.item() <= n
    assert bool(torch.isfinite(out).all())


def test_slab_terms_partition_the_whole_grid():
    """The slab form's plain terms: two slabs' valid queries partition the
    whole grid's, and their launch-order sums add up to its sums."""
    _, view, pts, _, tpose = _inputs("dense")
    q = torch.from_numpy(pts)
    m, s = PARAMS.m, PARAMS.m // 2
    slabs = [view[:s + 1], view[s:]]  # rank 0 with the next plane, rank 1 to the end
    parts = [tgn.query_terms_reference(v, tpose, q, PARAMS, i0=r * s, slab=s)
             for r, v in enumerate(slabs)]
    whole = tgn.query_terms_reference(view, tpose, q, PARAMS)
    owned = [p[:, 27] == 1 for p in parts]
    assert not bool((owned[0] & owned[1]).any())
    assert torch.equal(owned[0] | owned[1], whole[:, 27] == 1)
    both = tgn.sums_in_launch_order(parts[0]) + tgn.sums_in_launch_order(parts[1])
    A, b, _, _ = tgn.unpack(tgn.sums_in_launch_order(whole))
    _check_sums(both, A.numpy(), b.numpy())
