"""Port vs JAX package: the GN reduction (K1's plain version), the GN step
(K1 step's plain version) and tracking.

The same grid, pose and points (numpy) go to both sides. The reduction is
held to the JAX suite's own tolerances for A and b (tests/test_pallas_gn.py:
rtol 1e-5 / atol 1e-4 for A, atol 1e-5 for b). Tracking, and the plain step
iterated under its done flag, must run the same number of iterations and
land on the same pose to 1e-5 m / 1e-5 rad.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracking_sdf_tpu.config import GridParams, TrackingConfig
from tracking_sdf_tpu.core.camera import PinholeCamera, backproject
from tracking_sdf_tpu.core.lie import pose_compose as jcompose
from tracking_sdf_tpu.core.lie import se3_exp as jse3_exp
from tracking_sdf_tpu.data.synthetic import (
    CuboidScene, SphereScene, grid_from_scene, look_at, render_scene_depth)
from tracking_sdf_tpu.fusion.brickmajor import brick_grid_from_dense, brick_masked_view
from tracking_sdf_tpu.grid.interp import masked_view as jmasked_view
from tracking_sdf_tpu.tracking.gauss_newton import track_frame as jtrack
from tracking_sdf_tpu.tracking.pallas_gn import (
    gather_corner_inputs, gn_reduce_pallas, gn_reduce_xla)
from tracking_sdf_tpu.tracking.pyramid import track_frame_pyramid as jpyramid
from tracking_sdf_tpu_torch.core.lie import pose_from_numpy
from tracking_sdf_tpu_torch.fusion.brickmajor import brick_grid_from_numpy
from tracking_sdf_tpu_torch.fusion.brickmajor import brick_masked_view as tview
from tracking_sdf_tpu_torch.grid.grid import grid_from_numpy
from tracking_sdf_tpu_torch.grid.interp import masked_view
from tracking_sdf_tpu_torch.tracking import gn_reduce as tgn
from tracking_sdf_tpu_torch.tracking.gauss_newton import track_frame
from tracking_sdf_tpu_torch.tracking.pyramid import track_frame_pyramid

torch.set_num_threads(2)

PARAMS = GridParams(m=48, width=2.0, height=2.0, depth=2.0,
                    origin=(-1.0, -1.0, -1.0), delta=0.15, epsilon=0.02)
CAM = PinholeCamera(fx=60.0, fy=60.0, cx=47.5, cy=35.5, width=96, height=72)
SPHERE = SphereScene(center=(0.1, 0.05, 0.0), radius=0.45)
BOX = CuboidScene(min_corner=(-0.75, -0.4, -0.55), max_corner=(-0.35, 0.4, 0.15))
POSE = look_at((0.0, -1.5, 0.2), (0.0, 0.0, 0.0))
# pose and position tolerances of the tracking parity checks
TOL_T, TOL_R = 1e-5, 1e-5


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


def _grid_and_points(unobserved_frac=0.1):
    """Analytic grid with a random unobserved share (W = 0, NaN in the
    masked view) and a NaN-speckled point image of the scene."""
    rng = np.random.default_rng(0)
    grid = grid_from_scene(PARAMS, Scene())
    W = np.array(grid.W)
    W[rng.random(W.shape) < unobserved_frac] = 0.0
    grid = grid._replace(W=jnp.asarray(W))
    depth = np.array(render_scene_depth(Scene(), CAM, POSE))
    depth[rng.random(depth.shape) < 0.05] = np.nan
    pts = np.array(backproject(CAM, jnp.asarray(depth)))
    return grid, pts


def _to_port(grid, pose):
    return (grid_from_numpy(grid._asdict(), device="cpu"),
            pose_from_numpy(pose.R, pose.t, device="cpu"))


def _pose_err(pt, pj):
    t_err = np.abs(pt.t.numpy() - np.asarray(pj.t)).max()
    r_err = np.abs(pt.R.numpy() - np.asarray(pj.R)).max()
    return t_err, r_err


def test_gn_reduce_reference_matches_pallas_and_xla():
    grid, pts_img = _grid_and_points()
    pts = pts_img.reshape(-1, 3)
    pose = jcompose(POSE, jse3_exp(jnp.asarray([0.02, -0.01, 0.015, 0.01, -0.02, 0.01])))
    Dm = jmasked_view(grid.D, grid.W)
    ins = gather_corner_inputs(Dm, pose, jnp.asarray(pts), params=PARAMS)
    A_p, b_p = gn_reduce_pallas(*ins, interpret=True)
    A_x, b_x = gn_reduce_xla(*ins)

    tg, tp = _to_port(grid, pose)
    out = tgn.gn_reduce_reference(masked_view(tg.D, tg.W), tp,
                                  torch.from_numpy(pts), PARAMS)
    A, b, nvalid, _ = tgn.unpack(out)
    for A_ref, b_ref in ((A_p, b_p), (A_x, b_x)):
        np.testing.assert_allclose(A.numpy(), np.asarray(A_ref), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(b.numpy(), np.asarray(b_ref), rtol=1e-5, atol=1e-5)
    assert 0 < int(nvalid) <= int(np.asarray(ins[4]).sum())
    assert abs(float(A[0, 0])) > 1.0  # a real system, not an empty one
    # the dispatching wrapper takes the plain version for CPU tensors
    before = tgn.launches
    out2 = tgn.gn_reduce(masked_view(tg.D, tg.W), tp, torch.from_numpy(pts), PARAMS)
    assert torch.equal(out, out2) and tgn.launches == before


@pytest.mark.parametrize("value_dtype", [jnp.bfloat16, jnp.float32],
                         ids=["bfloat16", "float32"])
def test_gn_reduce_reference_on_brick_view_matches_xla(value_dtype):
    """The plain version on the brick-major view of (bf16) D rows against the
    JAX package's gn_reduce_xla fed through the view branch of
    gather_corner_inputs; tolerances of tests/test_pallas_gn.py."""
    grid, pts_img = _grid_and_points()
    pts = pts_img.reshape(-1, 3)
    pose = jcompose(POSE, jse3_exp(jnp.asarray([0.02, -0.01, 0.015, 0.01, -0.02, 0.01])))
    bs = (8, 8, 8)
    jb = brick_grid_from_dense(grid, bs, value_dtype=value_dtype)
    A_x, b_x = gn_reduce_xla(*gather_corner_inputs(
        brick_masked_view(jb, PARAMS, bs), pose, jnp.asarray(pts), params=PARAMS))
    tb = brick_grid_from_numpy(jb._asdict(), device="cpu")
    tp = pose_from_numpy(pose.R, pose.t, device="cpu")
    view = tview(tb, PARAMS, bs)
    out = tgn.gn_reduce_reference(view, tp, torch.from_numpy(pts), PARAMS)
    A, b, nvalid, _ = tgn.unpack(out)
    np.testing.assert_allclose(A.numpy(), np.asarray(A_x), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(b.numpy(), np.asarray(b_x), rtol=1e-5, atol=1e-5)
    assert int(nvalid) > 1000 and abs(float(A[0, 0])) > 1.0
    # the view holds the dense masked view's values, so the dense form agrees
    dense = tgn.gn_reduce_reference(
        masked_view(*(torch.tensor(np.asarray(x, np.float32))
                      for x in (jnp.asarray(grid.D, value_dtype), grid.W))),
        tp, torch.from_numpy(pts), PARAMS)
    torch.testing.assert_close(out, dense, rtol=1e-5, atol=1e-4)
    before = (tgn.launches, tgn.launches_brick)
    assert torch.equal(tgn.gn_reduce(view, tp, torch.from_numpy(pts), PARAMS), out)
    assert (tgn.launches, tgn.launches_brick) == before


def _perturbed():
    return jcompose(POSE, jse3_exp(jnp.asarray([0.03, -0.02, 0.025, 0.02, -0.015, 0.02])))


@pytest.mark.parametrize("cfg", [
    TrackingConfig(),
    TrackingConfig(convergence="signed", pose_update="reference",
                   damping_decay=0.5, min_iterations=3),
], ids=["default", "signed_reference_decay_floor"])
def test_track_frame_matches_jax(cfg):
    grid, pts_img = _grid_and_points()
    pts = pts_img[::2, ::2].reshape(-1, 3)
    pose0 = _perturbed()
    rj = jtrack(grid, pose0, jnp.asarray(pts), params=PARAMS, cfg=cfg)
    tg, tp = _to_port(grid, pose0)
    rt = track_frame(tg, tp, torch.from_numpy(np.ascontiguousarray(pts)),
                     params=PARAMS, cfg=cfg)
    assert rt.iterations == int(rj.iterations) > 1
    assert rt.num_valid == int(rj.num_valid)
    assert abs(rt.mean_abs_residual - float(rj.mean_abs_residual)) < 1e-6
    t_err, r_err = _pose_err(rt.pose, rj.pose)
    assert t_err < TOL_T and r_err < TOL_R, (t_err, r_err)


def test_track_frame_pyramid_matches_jax():
    grid, pts_img = _grid_and_points()
    cfg = TrackingConfig(pixel_stride=1, min_iterations=2)
    pose0 = _perturbed()
    rj, levels_j = jpyramid(grid, pose0, jnp.asarray(pts_img), params=PARAMS,
                            cfg=cfg, levels=(2, 1))
    tg, tp = _to_port(grid, pose0)
    rt, levels_t = track_frame_pyramid(tg, tp, torch.from_numpy(pts_img),
                                       params=PARAMS, cfg=cfg, levels=(2, 1))
    assert [r.iterations for r in levels_t] == [int(r.iterations) for r in levels_j]
    t_err, r_err = _pose_err(rt.pose, rj.pose)
    assert t_err < TOL_T and r_err < TOL_R, (t_err, r_err)
    with pytest.raises(ValueError):
        track_frame_pyramid(tg, tp, torch.from_numpy(pts_img), params=PARAMS,
                            cfg=cfg, levels=(2,))


def test_track_frame_with_no_valid_points_takes_no_step():
    """All-NaN points: the degenerate system's guard keeps the pose."""
    grid, pts_img = _grid_and_points()
    tg, tp = _to_port(grid, POSE)
    pts = torch.full((64, 3), float("nan"))
    rt = track_frame(tg, tp, pts, params=PARAMS, cfg=TrackingConfig())
    assert rt.num_valid == 0 and rt.iterations == 1
    assert torch.allclose(rt.pose.t, tp.t) and torch.allclose(rt.pose.R, tp.R)


def _brick_views(value_dtype=jnp.bfloat16):
    """The JAX package's and the port's brick-major views of one grid."""
    grid, pts_img = _grid_and_points()
    bs = (8, 8, 8)
    jb = brick_grid_from_dense(grid, bs, value_dtype=value_dtype)
    tb = brick_grid_from_numpy(jb._asdict(), device="cpu")
    return brick_masked_view(jb, PARAMS, bs), tview(tb, PARAMS, bs), pts_img


@pytest.mark.parametrize("cfg", [
    TrackingConfig(min_iterations=5),
    TrackingConfig(convergence="signed"),
    TrackingConfig(pose_update="reference"),
    TrackingConfig(damping=1.0, damping_decay=0.8),
], ids=["min_iterations", "signed", "reference_update", "damping_decay"])
def test_gn_step_reference_under_done_mask_matches_jax(cfg):
    """cfg.max_iterations plain steps, never stopping early (the done flag
    freezes the state, as on the card), against the JAX while_loop on the
    bf16 brick view."""
    jview, view, pts_img = _brick_views()
    pts = pts_img[::2, ::2].reshape(-1, 3)
    pose0 = _perturbed()
    rj = jtrack(None, pose0, jnp.asarray(pts), params=PARAMS, cfg=cfg, Dm=jview)
    state = tgn.init_state(pose_from_numpy(pose0.R, pose0.t, device="cpu"), cfg.damping)
    flat = torch.from_numpy(np.ascontiguousarray(pts))
    for _ in range(cfg.max_iterations):
        tgn.gn_step_reference(view, state, flat, PARAMS, cfg)
    ints = state.view(torch.int32)
    assert int(ints[tgn.S_COUNT]) == int(rj.iterations) > 1
    assert int(ints[tgn.S_DONE]) == int(int(rj.iterations) < cfg.max_iterations)
    assert int(ints[tgn.S_TICKET]) == 0
    assert int(state[tgn.S_NVALID]) == int(rj.num_valid)
    np.testing.assert_allclose(state[tgn.S_TWIST:tgn.S_TWIST + 6].numpy(),
                               np.asarray(rj.final_twist), rtol=0, atol=1e-5)
    t_err, r_err = _pose_err(tgn.state_pose(state), rj.pose)
    assert t_err < TOL_T and r_err < TOL_R, (t_err, r_err)
    lam = cfg.damping * cfg.damping_decay ** int(rj.iterations)
    assert abs(float(state[tgn.S_LAM]) - lam) <= 1e-6 * max(lam, 1.0)


def test_gn_step_reference_with_no_valid_query_is_done_at_once():
    """All-NaN queries: the zero system's step is zero, done is set by the
    first step, and later steps leave the state as it is."""
    jview, view, _ = _brick_views()
    cfg = TrackingConfig()
    pts = np.full((300, 3), np.nan, np.float32)
    rj = jtrack(None, POSE, jnp.asarray(pts), params=PARAMS, cfg=cfg, Dm=jview)
    pose = pose_from_numpy(POSE.R, POSE.t, device="cpu")
    state = tgn.init_state(pose, cfg.damping)
    tgn.gn_step_reference(view, state, torch.from_numpy(pts), PARAMS, cfg)
    after_one = state.clone()
    ints = state.view(torch.int32)
    assert int(ints[tgn.S_COUNT]) == int(rj.iterations) == 1
    assert int(ints[tgn.S_DONE]) == 1 and int(state[tgn.S_NVALID]) == 0
    assert torch.equal(state[tgn.S_TWIST:tgn.S_TWIST + 6], torch.zeros(6))
    t_err, r_err = _pose_err(tgn.state_pose(state), rj.pose)
    assert t_err < TOL_T and r_err < TOL_R
    assert torch.equal(tgn.state_pose(state).t, pose.t)
    for _ in range(3):
        tgn.gn_step_reference(view, state, torch.from_numpy(pts), PARAMS, cfg)
    assert torch.equal(state, after_one)


def test_track_frame_on_strided_view_matches_flat_points():
    """The organized-image view that the pyramid passes reads the same
    queries as their flat copy, and the CPU step launches no kernel."""
    _, view, pts_img = _brick_views(jnp.float32)
    img = torch.from_numpy(pts_img)
    pose0 = pose_from_numpy(_perturbed().R, _perturbed().t, device="cpu")
    before = (tgn.launches_step, tgn.launches_step_brick)
    a = track_frame(None, pose0, img[::2, ::2], params=PARAMS, Dm=view).read()
    b = track_frame(None, pose0, img[::2, ::2].reshape(-1, 3), params=PARAMS,
                    Dm=view).read()
    assert (tgn.launches_step, tgn.launches_step_brick) == before
    assert a.iterations == b.iterations > 1 and a.num_valid == b.num_valid
    assert torch.equal(a.pose.R, b.pose.R) and torch.equal(a.pose.t, b.pose.t)


@pytest.mark.parametrize("field,value", [("convergence", "max"),
                                         ("pose_update", "left")])
def test_gn_step_rejects_unknown_modes(field, value):
    _, view, _ = _brick_views(jnp.float32)
    cfg = TrackingConfig()._replace(**{field: value})
    state = tgn.init_state(pose_from_numpy(POSE.R, POSE.t, device="cpu"), cfg.damping)
    with pytest.raises(ValueError):
        tgn.gn_step(view, state, torch.zeros(4, 3), PARAMS, cfg)
