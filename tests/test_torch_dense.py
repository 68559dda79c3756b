"""Port vs JAX package: the reference-exact path. so3_log / se3_log, the full
2-D bilateral filter, and the dense-fusion frame loop (``FusionConfig()``'s
``mode="dense"``, ``PipelineConfig()``'s full filter) with the render, mesh
and checkpoint paths on its flat grid.

Tolerances: the logs 1e-6 (near 0 and near pi too); the filter's NaN masks
equal and values within 1e-6 m + 1e-6 relative (the port sums the 121 taps
in another order than the JAX loop, whose own float32 rounding is a few ulps
of the depth, ~4e-6 m at 4.5 m against a float64 evaluation); the dense loop's
grids 1e-5 (tests/test_brick_fusion.py's float32 association) and poses
1e-5 m.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracking_sdf_tpu import config as jconfig
from tracking_sdf_tpu.core import lie as jlie
from tracking_sdf_tpu.core.camera import PinholeCamera as JCam
from tracking_sdf_tpu.data.synthetic import (
    CuboidScene, SphereScene, look_at, render_scene_depth)
from tracking_sdf_tpu.pipeline.runner import Reconstruction as JRecon
from tracking_sdf_tpu.tracking import preprocess as jpre
from tracking_sdf_tpu_torch import config
from tracking_sdf_tpu_torch.core import lie
from tracking_sdf_tpu_torch.core.camera import PinholeCamera
from tracking_sdf_tpu_torch.core.lie import Pose, pose_from_numpy
from tracking_sdf_tpu_torch.grid.grid import FIELDS, grid_to_numpy
from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction
from tracking_sdf_tpu_torch.tracking import preprocess as tpre

torch.set_num_threads(2)

CAM = PinholeCamera(fx=60.0, fy=60.0, cx=47.5, cy=35.5, width=96, height=72)
GRID = dict(m=48, width=2.0, height=2.0, depth=2.0, origin=(-1.0, -1.0, -1.0),
            delta=0.15, epsilon=0.02)
SPHERE = SphereScene(center=(0.15, 0.1, 0.0), radius=0.4)
BOX = CuboidScene(min_corner=(-0.75, -0.4, -0.55), max_corner=(-0.35, 0.4, 0.15))
WALL = CuboidScene(min_corner=(-4.0, 0.8, -4.0), max_corner=(4.0, 1.2, 4.0))
EYES = [(0.0, -2.5, 0.25), (0.03, -2.49, 0.26), (0.06, -2.48, 0.24), (0.08, -2.47, 0.26)]


class Scene:
    def intersect(self, o, d):
        t = SPHERE.intersect(o, d)
        for s in (BOX, WALL):
            tb = s.intersect(o, d)
            t = jnp.where(jnp.isnan(t), tb, jnp.where(jnp.isnan(tb), t, jnp.minimum(t, tb)))
        return t


def frames(n=len(EYES)):
    """(depth, rgb, pose) as numpy, rendered by the JAX package, with a NaN
    hole and one color per frame."""
    out = []
    for k, eye in enumerate(EYES[:n]):
        pose = look_at(eye, (0.0, 0.0, 0.0))
        depth = np.array(render_scene_depth(Scene(), JCam(*CAM), pose))
        depth[30:38, 10 + 3 * k:24 + 3 * k] = np.nan
        rgb = np.broadcast_to(np.random.default_rng(k).uniform(size=3).astype(np.float32),
                              depth.shape + (3,))
        out.append((depth, np.ascontiguousarray(rgb), pose))
    return out


# --- so3_log / se3_log ---------------------------------------------------------

def _twists():
    rng = np.random.default_rng(3)
    w = [rng.normal(size=3) * s for s in (1e-9, 1e-5, 0.3, 1.5)]
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    w += [axis * (np.pi - 1e-3), axis * (np.pi - 1e-2)]  # near pi
    return np.stack([np.concatenate([rng.normal(size=3), x]) for x in w]).astype(np.float32)


def test_so3_se3_log_match_jax():
    xi = _twists()
    jp = jlie.se3_exp(jnp.asarray(xi))
    R, t = np.asarray(jp.R), np.asarray(jp.t)
    np.testing.assert_allclose(lie.so3_log(torch.from_numpy(R)).numpy(),
                               np.asarray(jlie.so3_log(jnp.asarray(R))), atol=1e-6)
    got = lie.se3_log(Pose(torch.from_numpy(R), torch.from_numpy(t))).numpy()
    np.testing.assert_allclose(got, np.asarray(jlie.se3_log(jp)), atol=1e-6)
    # a round trip away from pi, where the log is well conditioned
    np.testing.assert_allclose(got[:3], xi[:3], atol=1e-5)


def test_so3_log_identity_and_batch_shape():
    eye = torch.eye(3).expand(2, 5, 3, 3)
    w = lie.so3_log(eye)
    assert w.shape == (2, 5, 3) and float(w.abs().max()) == 0.0


# --- the full 2-D bilateral filter -----------------------------------------------

def _speckled(h, w, base, seed):
    rng = np.random.default_rng(seed)
    v, u = np.mgrid[0:h, 0:w].astype(np.float32)
    d = base + 0.004 * u + 0.002 * v + 0.2 * (u > w // 2) + rng.normal(scale=0.01, size=(h, w))
    d[rng.random(d.shape) < 0.1] = np.nan
    d[5:9, 5:30] = np.nan
    return d.astype(np.float32)


@pytest.mark.parametrize("h,w,base", [(72, 96, 1.2), (48, 64, 4.5)])
def test_bilateral_filter_matches_jax(h, w, base):
    d = _speckled(h, w, base, seed=h)
    want = np.asarray(jpre.bilateral_filter(jnp.asarray(d)))
    got = tpre.bilateral_filter(torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    # the tap order aside, the port's sum is the float64 filter's within ulps
    f64 = tpre.bilateral_filter(torch.from_numpy(d).double()).numpy()
    np.testing.assert_allclose(got, f64, atol=1e-6, rtol=1e-6)


def test_bilateral_filter_all_nan_and_options():
    nan = torch.full((12, 16), float("nan"))
    assert torch.isnan(tpre.bilateral_filter(nan)).all()
    d = _speckled(24, 32, 2.0, seed=1)
    want = np.asarray(jpre.bilateral_filter(jnp.asarray(d), radius=2, sigma_spatial=1.5,
                                            sigma_range=0.05))
    got = tpre.bilateral_filter(torch.from_numpy(d), radius=2, sigma_spatial=1.5,
                                sigma_range=0.05).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


# --- the dense frame loop ----------------------------------------------------------

VARIANTS = {
    # PipelineConfig() itself (dense fusion, full filter, flat GN)
    "defaults": {},
    # the tum presets' options on the dense layout: pyramid, clamp, color cadence
    "pyramid_clamp": dict(pyramid_levels=(2, 1), fusion=dict(max_weight=3.0, color_every=2,
                                                             distance="point_to_point")),
}


def _configs(variant):
    kw = dict(VARIANTS[variant])
    fusion = kw.pop("fusion", {})
    out = []
    for pkg in (jconfig, config):
        base = pkg.PipelineConfig()
        out.append(dataclasses.replace(base, grid=pkg.GridParams(**GRID), trajectory_path=None,
                                       fusion=base.fusion._replace(**fusion), **kw))
    return out


def _run_both(variant, n=4, groundtruth=False):
    jcfg, tcfg = _configs(variant)
    if groundtruth:
        jcfg = dataclasses.replace(jcfg, use_groundtruth=True)
        tcfg = dataclasses.replace(tcfg, use_groundtruth=True)
    fr = frames(n)
    j = JRecon(JCam(*CAM), jcfg, initial_pose=fr[0][2])
    t = Reconstruction(CAM, tcfg, initial_pose=pose_from_numpy(fr[0][2].R, fr[0][2].t,
                                                               device="cpu"), device="cpu")
    for k, (depth, rgb, pose) in enumerate(fr):
        gt = pose_from_numpy(pose.R, pose.t, device="cpu") if groundtruth else None
        sj = j.process_frame(depth, rgb=rgb, timestamp=float(k),
                             gt_pose=pose if groundtruth else None)
        st = t.process_frame(depth, rgb=rgb, timestamp=float(k), gt_pose=gt)
        assert (sj.gn_iterations, sj.num_valid, sj.rejected) == (
            st.gn_iterations, st.num_valid, st.rejected), k
        np.testing.assert_allclose(t.pose.t.numpy(), np.asarray(j.pose.t), atol=1e-5)
        np.testing.assert_allclose(t.pose.R.numpy(), np.asarray(j.pose.R), atol=1e-5)
    assert t.config.fusion.mode == "dense" and t.brick_grid is None
    assert all(not s.rejected for s in t.stats)
    return j, t


def _assert_grids(t, j):
    """Every leaf within 1e-5 but on at most 1e-4 of the voxels (a handful
    at 48^3): a voxel centre that projects within float32 rounding of a
    pixel boundary truncates to either pixel (XLA and PyTorch round the
    projection differently), and then reads that pixel's normal."""
    got = grid_to_numpy(t.grid)
    for k in FIELDS:
        err = np.abs(got[k] - np.asarray(getattr(j.grid, k)))
        assert (err > 1e-5).mean() <= 1e-4, (k, int((err > 1e-5).sum()), err.max())
    assert (got["W"] > 0).sum() > 1000


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_dense_fusion_matches_jax(variant):
    """Fusion alone: groundtruth poses, the same in both."""
    _assert_grids(*_run_both(variant, groundtruth=True)[::-1])


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_dense_reconstruction_matches_jax(variant):
    """The tracked loop: poses within 1e-5 m every frame, then the grids."""
    _assert_grids(*_run_both(variant)[::-1])


def test_dense_paths_render_mesh_checkpoint(tmp_path):
    """Render, mesh and checkpoint read the flat dense grid; process_chunk
    keeps the JAX package's contract (brick-major only) and run(chunk=)
    falls back to per frame."""
    _, tcfg = _configs("defaults")
    fr = frames(3)
    p0 = pose_from_numpy(fr[0][2].R, fr[0][2].t, device="cpu")
    t = Reconstruction(CAM, tcfg, initial_pose=p0, device="cpu")
    for k, (depth, rgb, _) in enumerate(fr[:2]):
        t.process_frame(depth, rgb=rgb, timestamp=float(k))
    r = t.render()
    assert r.hit.float().mean() > 0.1 and int(r.dropped) == 0
    assert t.export_mesh(str(tmp_path / "m.ply")) > 1000
    t.save_checkpoint(str(tmp_path / "ck"))
    u = Reconstruction(CAM, tcfg, initial_pose=p0, device="cpu")
    u.restore_checkpoint(str(tmp_path / "ck"))
    for x in (t, u):
        x.process_frame(fr[2][0], rgb=fr[2][1], timestamp=2.0)
    for k in FIELDS:
        assert torch.equal(getattr(t.grid, k), getattr(u.grid, k)), k
    with pytest.raises(ValueError, match="brickmajor"):
        t.process_chunk(np.stack([fr[2][0]]))
    with pytest.warns(RuntimeWarning, match="running per frame"):
        t.run([], chunk=4)


def test_presets_synthetic64_and_tum128_construct():
    """The two dense presets (BASELINE configs #1 and #2) run unmodified."""
    for name in ("synthetic64", "tum128"):
        cfg = config.preset(name)
        assert cfg.fusion.mode == "dense" and cfg.bilateral_mode == "full"
        r = Reconstruction(CAM, dataclasses.replace(cfg, trajectory_path=None), device="cpu")
        assert r.grid.D.shape == (cfg.grid.m,) * 3
