"""Port vs JAX package: lie, camera, grid maps and depth preprocessing.

Inputs are made with numpy from a seed and fed to both sides. Tolerances:
atol 1e-6 for the pose/camera/grid algebra (float32 round-off of a few
operations on O(1) values), atol 1e-5 for preprocessing (exp and divisions
over 11-tap sums; the two frameworks' exp differ by an ulp).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracking_sdf_tpu.config import GridParams
from tracking_sdf_tpu.core import camera as jcam
from tracking_sdf_tpu.core import lie as jlie
from tracking_sdf_tpu.grid import grid as jgrid
from tracking_sdf_tpu.tracking import preprocess as jpre
from tracking_sdf_tpu_torch.core import camera as tcam
from tracking_sdf_tpu_torch.core import lie as tlie
from tracking_sdf_tpu_torch.grid import grid as tgrid
from tracking_sdf_tpu_torch.tracking import preprocess as tpre

torch.set_num_threads(2)

PARAMS = GridParams(m=48, width=2.0, height=2.0, depth=2.0,
                    origin=(-1.0, -1.0, -1.0), delta=0.15, epsilon=0.02)
CAM = tcam.PinholeCamera(fx=60.0, fy=60.0, cx=47.5, cy=35.5, width=96, height=72)
ATOL = 1e-6


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _twists(seed, n=16):
    rng = np.random.default_rng(seed)
    xi = rng.normal(scale=0.5, size=(n, 6)).astype(np.float32)
    xi[0] = 0.0  # theta = 0: the series branch
    xi[1, 3:] = 1e-5  # theta^2 below the series threshold
    return xi


@pytest.mark.parametrize("seed", range(3))
def test_lie_matches_jax(seed):
    xi = _twists(seed)
    pj = jlie.se3_exp(jnp.asarray(xi))
    pt = tlie.se3_exp(torch.from_numpy(xi))
    np.testing.assert_allclose(_np(pt.R), _np(pj.R), atol=ATOL)
    np.testing.assert_allclose(_np(pt.t), _np(pj.t), atol=ATOL)
    np.testing.assert_allclose(_np(tlie.so3_hat(torch.from_numpy(xi[:, 3:]))),
                               _np(jlie.so3_hat(jnp.asarray(xi[:, 3:]))), atol=ATOL)

    a, b = (jlie.Pose(pj.R[i], pj.t[i]) for i in (2, 3))
    ta, tb = (tlie.Pose(pt.R[i], pt.t[i]) for i in (2, 3))
    for fj, ft in ((jlie.pose_compose(a, b), tlie.pose_compose(ta, tb)),
                   (jlie.pose_inverse(a), tlie.pose_inverse(ta))):
        np.testing.assert_allclose(_np(ft.R), _np(fj.R), atol=ATOL)
        np.testing.assert_allclose(_np(ft.t), _np(fj.t), atol=ATOL)
    x = np.random.default_rng(seed).normal(size=(10, 3)).astype(np.float32)
    np.testing.assert_allclose(_np(tlie.pose_apply(ta, torch.from_numpy(x))),
                               _np(jlie.pose_apply(a, jnp.asarray(x))), atol=ATOL)

    q_j = jlie.quaternion_from_matrix(pj.R)
    q_t = tlie.quaternion_from_matrix(pt.R)
    np.testing.assert_allclose(_np(q_t), _np(q_j), atol=ATOL)
    np.testing.assert_allclose(_np(tlie.matrix_from_quaternion(q_t)),
                               _np(jlie.matrix_from_quaternion(q_j)), atol=ATOL)

    R_np, t_np = tlie.pose_to_numpy(ta)
    back = tlie.pose_from_numpy(R_np, t_np, device="cpu")
    assert torch.equal(back.R, ta.R) and torch.equal(back.t, ta.t)


def test_camera_matches_jax():
    rng = np.random.default_rng(1)
    depth = rng.uniform(0.5, 3.0, size=(CAM.height, CAM.width)).astype(np.float32)
    depth[rng.random(depth.shape) < 0.1] = np.nan
    depth[0, :5] = 0.0
    jc = jcam.PinholeCamera(*CAM)
    pj = jcam.backproject(jc, jnp.asarray(depth))
    pt = tcam.backproject(CAM, torch.from_numpy(depth))
    np.testing.assert_array_equal(np.isnan(_np(pt)), np.isnan(_np(pj)))
    np.testing.assert_allclose(_np(pt), _np(pj), atol=ATOL)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    pts[:, 2] = np.abs(pts[:, 2]) + 0.5
    np.testing.assert_allclose(_np(tcam.project(CAM, torch.from_numpy(pts))),
                               _np(jcam.project(jc, jnp.asarray(pts))), rtol=1e-6,
                               atol=1e-4)  # pixel units: O(100) magnitudes
    for stride in (1, 3):
        dj, xj = jcam.pixel_rays(jc, stride)
        dt, xt = tcam.pixel_rays(CAM, stride, device="cpu")
        np.testing.assert_allclose(_np(dt), _np(dj), atol=ATOL)
        np.testing.assert_allclose(_np(xt), _np(xj), atol=ATOL)
    assert tcam.ros_default_camera() == tuple(jcam.ros_default_camera())
    assert tcam.tum_fr1_camera() == tuple(jcam.tum_fr1_camera())


def test_grid_matches_jax():
    gj = jgrid.empty_grid(PARAMS)
    gt = tgrid.empty_grid(PARAMS, device="cpu")
    for k in tgrid.FIELDS:
        np.testing.assert_array_equal(_np(getattr(gt, k)), _np(getattr(gj, k)))
    rng = np.random.default_rng(2)
    x = rng.uniform(-1.2, 1.2, size=(200, 3)).astype(np.float32)
    np.testing.assert_allclose(_np(tgrid.world_to_voxel(PARAMS, torch.from_numpy(x))),
                               _np(jgrid.world_to_voxel(PARAMS, jnp.asarray(x))),
                               atol=1e-5)  # voxel units: O(50) magnitudes
    ijk = rng.uniform(-1, 49, size=(200, 3)).astype(np.float32)
    np.testing.assert_allclose(_np(tgrid.voxel_to_world(PARAMS, torch.from_numpy(ijk))),
                               _np(jgrid.voxel_to_world(PARAMS, jnp.asarray(ijk))),
                               atol=ATOL)
    arrays = {k: rng.normal(size=(4, 4, 4)).astype(np.float32) for k in tgrid.FIELDS}
    back = tgrid.grid_to_numpy(tgrid.grid_from_numpy(arrays, device="cpu"))
    for k in tgrid.FIELDS:
        np.testing.assert_array_equal(back[k], arrays[k])


def _speckled_depth(seed=3):
    """A smooth tilted surface with noise and a NaN speckle."""
    rng = np.random.default_rng(seed)
    v, u = np.mgrid[0:CAM.height, 0:CAM.width].astype(np.float32)
    depth = 1.2 + 0.004 * u + 0.002 * v + 0.2 * (u > 60)
    depth = depth + rng.normal(scale=0.005, size=depth.shape)
    depth[rng.random(depth.shape) < 0.05] = np.nan
    return depth.astype(np.float32)


def test_preprocess_matches_jax():
    depth = _speckled_depth()
    jc = jcam.PinholeCamera(*CAM)
    fj = jpre.bilateral_filter_separable(jnp.asarray(depth))
    ft = tpre.bilateral_filter_separable(torch.from_numpy(depth))
    np.testing.assert_array_equal(np.isnan(_np(ft)), np.isnan(_np(fj)))
    np.testing.assert_allclose(_np(ft), _np(fj), atol=1e-5)

    pj, nj = jpre.preprocess_frame(jnp.asarray(depth), cam=jc,
                                   bilateral_mode="separable")
    pt, nt = tpre.preprocess_frame(torch.from_numpy(depth), cam=CAM,
                                   bilateral_mode="separable")
    for a, b in ((pt, pj), (nt, nj)):
        np.testing.assert_array_equal(np.isnan(_np(a)), np.isnan(_np(b)))
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-5)
    assert np.isfinite(_np(nt)).all(-1).mean() > 0.5
    # the full 2-D kernel (the default mode): the same terms summed in
    # another order, so within the JAX loop's own float32 rounding
    pj, _ = jpre.preprocess_frame(jnp.asarray(depth), cam=jc, bilateral_mode="full")
    pt, _ = tpre.preprocess_frame(torch.from_numpy(depth), cam=CAM, bilateral_mode="full")
    np.testing.assert_array_equal(np.isnan(_np(pt)), np.isnan(_np(pj)))
    np.testing.assert_allclose(_np(pt), _np(pj), atol=1e-5)
    with pytest.raises(ValueError):
        tpre.preprocess_frame(torch.from_numpy(depth), cam=CAM, bilateral_mode="box")
