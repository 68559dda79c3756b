"""Port vs JAX package: the reference's 13-probe central-difference tracker
(``TrackingConfig(jacobian="central")``).

Tolerances: phi, J and the mask of ``pixel_residuals_central`` at rtol 1e-5
/ atol 1e-4 (tests/test_pallas_gn.py's); a level of ``track_frame`` with the
reference's signed convergence to 1e-5 m; the frame loop's poses to 1e-5 m
in every fusion layout, the brick-major one tracking against its dense view
as the JAX package does.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracking_sdf_tpu import config as jconfig
from tracking_sdf_tpu.core.camera import PinholeCamera as JCam
from tracking_sdf_tpu.core.camera import backproject
from tracking_sdf_tpu.core.lie import Pose as JPose
from tracking_sdf_tpu.data.synthetic import (
    CuboidScene, SphereScene, grid_from_scene, look_at, render_scene_depth)
from tracking_sdf_tpu.pipeline.runner import Reconstruction as JRecon
from tracking_sdf_tpu.tracking import gauss_newton as jgn
from tracking_sdf_tpu_torch import config
from tracking_sdf_tpu_torch.core.camera import PinholeCamera
from tracking_sdf_tpu_torch.core.lie import Pose, pose_from_numpy
from tracking_sdf_tpu_torch.grid.grid import grid_from_numpy
from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction
from tracking_sdf_tpu_torch.tracking import gauss_newton as tgn
from tracking_sdf_tpu_torch.tracking import gn_reduce
from tracking_sdf_tpu_torch.tracking.pyramid import track_frame_pyramid

torch.set_num_threads(2)

GRID = dict(m=48, width=2.0, height=2.0, depth=2.0, origin=(-1.0, -1.0, -1.0),
            delta=0.15, epsilon=0.02)
JPARAMS, PARAMS = jconfig.GridParams(**GRID), config.GridParams(**GRID)
CAM = PinholeCamera(fx=60.0, fy=60.0, cx=47.5, cy=35.5, width=96, height=72)
SPHERE = SphereScene(center=(0.15, 0.1, 0.0), radius=0.4)
BOX = CuboidScene(min_corner=(-0.75, -0.4, -0.55), max_corner=(-0.35, 0.4, 0.15))
WALL = CuboidScene(min_corner=(-4.0, 0.8, -4.0), max_corner=(4.0, 1.2, 4.0))
EYES = [(0.0, -2.5, 0.25), (0.03, -2.49, 0.26), (0.06, -2.48, 0.24)]


class Scene:
    def sdf(self, x):
        return jnp.minimum(jnp.minimum(SPHERE.sdf(x), BOX.sdf(x)), WALL.sdf(x))

    def color(self, x):
        return SPHERE.color(x)

    def intersect(self, o, d):
        t = SPHERE.intersect(o, d)
        for s in (BOX, WALL):
            tb = s.intersect(o, d)
            t = jnp.where(jnp.isnan(t), tb, jnp.where(jnp.isnan(tb), t, jnp.minimum(t, tb)))
        return t


def _grids():
    """The scene's SDF on the grid, truncated at delta with W = 1 inside the
    band and 0 far outside (unobserved corners, as a fused grid has them)."""
    g = grid_from_scene(JPARAMS, Scene())
    D = np.asarray(g.D)
    W = np.where(np.abs(D) < 2.5 * GRID["delta"], 1.0, 0.0).astype(np.float32)
    D = np.clip(D, -GRID["delta"], GRID["delta"]).astype(np.float32)
    arrays = dict(D=D, W=W, R=np.asarray(g.R), G=np.asarray(g.G), B=np.asarray(g.B),
                  Wc=np.asarray(g.Wc))
    return g._replace(D=jnp.asarray(D), W=jnp.asarray(W)), grid_from_numpy(arrays,
                                                                           device="cpu")


def _points(eye):
    pose = look_at(eye, (0.0, 0.0, 0.0))
    depth = np.array(render_scene_depth(Scene(), JCam(*CAM), pose))
    depth[30:38, 10:24] = np.nan
    return pose, np.array(backproject(JCam(*CAM), jnp.asarray(depth)))


@pytest.mark.parametrize("offset", [(0.0, 0.0, 0.0), (0.03, -0.02, 0.015)])
def test_pixel_residuals_central_match_jax(offset):
    jg, tg = _grids()
    pose, pts = _points(EYES[1])
    jpose = JPose(pose.R, pose.t + jnp.asarray(offset, jnp.float32))
    q = pts[::2, ::2].reshape(-1, 3)
    want = jgn.pixel_residuals_central(jg, jpose, jnp.asarray(q), params=JPARAMS)
    got = tgn.pixel_residuals_central(tg, pose_from_numpy(jpose.R, jpose.t, device="cpu"),
                                      torch.from_numpy(q), params=PARAMS)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    m = np.asarray(want[2])
    assert m.sum() > 200 and (~m).sum() > 50
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(a.numpy()[m], np.asarray(b)[m], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("convergence", ["signed", "norm"])
def test_track_frame_central_matches_jax(convergence):
    jg, tg = _grids()
    pose, pts = _points(EYES[2])
    q = pts[::3, ::3].reshape(-1, 3)
    jcfg = jconfig.TrackingConfig(jacobian="central", convergence=convergence)
    p0 = JPose(pose.R, pose.t + jnp.asarray([0.02, -0.015, 0.01], jnp.float32))
    want = jgn.track_frame(jg, p0, jnp.asarray(q), params=JPARAMS, cfg=jcfg)
    got = tgn.track_frame(tg, pose_from_numpy(p0.R, p0.t, device="cpu"), torch.from_numpy(q),
                          params=PARAMS, cfg=config.TrackingConfig(*jcfg)).read()
    assert got.iterations == int(want.iterations) and got.num_valid == int(want.num_valid)
    np.testing.assert_allclose(got.pose.t.numpy(), np.asarray(want.pose.t), atol=1e-5)
    np.testing.assert_allclose(got.pose.R.numpy(), np.asarray(want.pose.R), atol=1e-5)
    np.testing.assert_allclose(got.mean_abs_residual, float(want.mean_abs_residual),
                               rtol=1e-4)
    # the solve came closer to the true pose than the start
    assert np.linalg.norm(got.pose.t.numpy() - np.asarray(pose.t)) < 0.01


def test_central_pyramid_and_shared_solve():
    """The pyramid passes the grid through to every level (no masked view),
    and the central scheme advances its state through the same
    gn_reduce.advance_state as the analytic plain step."""
    _, tg = _grids()
    pose, pts = _points(EYES[1])
    cfg = config.TrackingConfig(jacobian="central")
    p0 = pose_from_numpy(pose.R, pose.t, device="cpu")
    res, levels = track_frame_pyramid(tg, p0, torch.from_numpy(pts), params=PARAMS, cfg=cfg,
                                      levels=(2, 1))
    assert len(levels) == 2 and res.read().num_valid > 100
    with pytest.raises(ValueError, match="central"):
        tgn.track_frame(None, p0, torch.from_numpy(pts[::3, ::3]), params=PARAMS, cfg=cfg)
    # one step by hand equals track_frame's first step
    q = torch.from_numpy(pts[::3, ::3].reshape(-1, 3))
    state = gn_reduce.init_state(p0, cfg.damping)
    gn_reduce.advance_state(state, *tgn.central_sums(tg, gn_reduce.state_pose(state), q,
                                                     PARAMS, cfg), cfg)
    one = tgn.track_frame(tg, p0, q, params=PARAMS, cfg=cfg._replace(max_iterations=1))
    assert torch.equal(state, one.state)


@pytest.mark.parametrize("mode", ["dense", "bricked", "brickmajor"])
def test_central_reconstruction_matches_jax(mode):
    """Reconstruction with the central Jacobian in every fusion layout:
    poses 1e-5 m per frame, equal GN iterations and valid counts. The
    port's chunked runner also tracks by it on brick-major rows, which the
    JAX package's refuses: a twin that takes the last frame as a chunk ends
    bit for bit where the per-frame loop does."""
    fusion = dict(mode=mode, brick_shape=(8, 8, 8), brick_cap=256, brick_cap_free=256)
    cfgs = []
    for pkg in (jconfig, config):
        base = pkg.PipelineConfig()
        cfgs.append(dataclasses.replace(
            base, grid=pkg.GridParams(**GRID), trajectory_path=None,
            bilateral_mode="separable", tracking=base.tracking._replace(jacobian="central"),
            fusion=base.fusion._replace(**fusion),
            pyramid_levels=(2, 1) if mode == "brickmajor" else None))
    first = look_at(EYES[0], (0.0, 0.0, 0.0))
    j = JRecon(JCam(*CAM), cfgs[0], initial_pose=first)
    t = Reconstruction(CAM, cfgs[1], initial_pose=pose_from_numpy(first.R, first.t,
                                                                  device="cpu"), device="cpu")
    for k, eye in enumerate(EYES):
        depth = np.array(render_scene_depth(Scene(), JCam(*CAM), look_at(eye, (0.0, 0.0, 0.0))))
        sj = j.process_frame(depth, timestamp=float(k))
        st = t.process_frame(depth, timestamp=float(k))
        assert (st.gn_iterations, st.num_valid, st.rejected) == (
            sj.gn_iterations, sj.num_valid, sj.rejected), k
        np.testing.assert_allclose(t.pose.t.numpy(), np.asarray(j.pose.t), atol=1e-5)
        np.testing.assert_allclose(t.pose.R.numpy(), np.asarray(j.pose.R), atol=1e-5)
    assert sum(s.gn_iterations for s in t.stats) > 2
    if mode == "brickmajor":
        twin = Reconstruction(CAM, cfgs[1], initial_pose=pose_from_numpy(first.R, first.t,
                                                                         device="cpu"),
                              device="cpu")
        for k, eye in enumerate(EYES):
            depth = np.array(render_scene_depth(Scene(), JCam(*CAM),
                                                look_at(eye, (0.0, 0.0, 0.0))))
            if k + 1 < len(EYES):
                twin.process_frame(depth, timestamp=float(k))
            else:
                sc = twin.process_chunk(depth[None], timestamps=[float(k)])[0]
        assert (sc.gn_iterations, sc.num_valid, sc.mean_abs_residual) == (
            st.gn_iterations, st.num_valid, st.mean_abs_residual)
        assert torch.equal(twin.pose.R, t.pose.R) and torch.equal(twin.pose.t, t.pose.t)


@pytest.mark.parametrize("convergence", ["signed", "norm"])
@pytest.mark.parametrize("eye", [0, 1, 2])
def test_central_sums_through_pack_advance_the_state_alike(eye, convergence):
    """A central level whose normal equations travel as K1's 29 sums
    (``pack``, then the finisher the card launches ``gn_finish`` through,
    whose plain version is ``advance_state`` on ``unpack``) holds the state
    of ``advance_state`` on the tracker's own sums, bit for bit, iteration
    by iteration: on the CPU JᵀJ is symmetric bit for bit, so its upper
    triangle carries all of it."""
    _, tg = _grids()
    pose, pts = _points(EYES[eye])
    q = torch.from_numpy(pts[::3, ::3].reshape(-1, 3))
    cfg = config.TrackingConfig(jacobian="central", convergence=convergence)
    p0 = pose_from_numpy(pose.R, pose.t + np.float32([0.02, -0.015, 0.01]), device="cpu")
    direct = gn_reduce.init_state(p0, cfg.damping)
    packed = gn_reduce.init_state(p0, cfg.damping)
    finish = gn_reduce.finisher(packed, cfg)
    for _ in range(cfg.max_iterations):
        A, b, n, s = tgn.central_sums(tg, gn_reduce.state_pose(direct), q, PARAMS, cfg)
        assert torch.equal(A, A.T) and int(n) > 100
        gn_reduce.advance_state(direct, A, b, n, s, cfg)
        finish(gn_reduce.pack(*tgn.central_sums(tg, gn_reduce.state_pose(packed), q,
                                                PARAMS, cfg)))
        assert torch.equal(direct.view(torch.int32), packed.view(torch.int32))
    assert int(direct.view(torch.int32)[gn_reduce.S_COUNT]) > 1
