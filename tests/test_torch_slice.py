"""The port's frame loop vs the JAX package's.

Two configurations, each shrunk to a 2 m cube and a 96x72 camera:
  * the presets' brick-major path: tum256 as it is at m=48, and tum512 as it
    is at m=64 (hier_classify 4, pyramid (4, 2, 1)) with cap_mixed=8, both
    with brick_cap and brick_cap_free at NB so that no brick drops;
  * the flat bricked layout with the in-place merge tail (tum256 with
    fusion mode "bricked"), at m=48 with brick_cap=256 (the preset's 6144
    would allocate 75 MB update tensors per frame on the CPU). JAX runs
    brick_merge="xla": its runner passes no interpret flag, and the xla tail
    is pinned equal to the Pallas one.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracking_sdf_tpu.config import GridParams, preset
from tracking_sdf_tpu.core.camera import PinholeCamera
from tracking_sdf_tpu.data.synthetic import (
    CuboidScene, SphereScene, look_at, render_scene_depth)
from tracking_sdf_tpu.pipeline import Reconstruction as JReconstruction
from tracking_sdf_tpu.pipeline import Trajectory as JTrajectory
from tracking_sdf_tpu.pipeline import ate_rmse as jate_rmse
from tracking_sdf_tpu.pipeline import read_trajectory as jread_trajectory
from tracking_sdf_tpu_torch.core.lie import pose_from_numpy
from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction
from tracking_sdf_tpu_torch.pipeline.trajectory import (
    Trajectory, TrajectoryWriter, ate_rmse, read_trajectory)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = GridParams(m=48, width=2.0, height=2.0, depth=2.0,
                    origin=(-1.0, -1.0, -1.0), delta=0.15, epsilon=0.02)
CAM = PinholeCamera(fx=60.0, fy=60.0, cx=47.5, cy=35.5, width=96, height=72)
SPHERE = SphereScene(center=(0.15, 0.1, 0.0), radius=0.4)
BOX = CuboidScene(min_corner=(-0.75, -0.4, -0.55), max_corner=(-0.35, 0.4, 0.15))
# per-frame pose agreement (m, rad) and final grid agreement where observed
TOL_POSE, TOL_GRID = 1e-4, 1e-4


WALL = CuboidScene(min_corner=(-4.0, 0.8, -4.0), max_corner=(4.0, 1.2, 4.0))


class Scene:
    def __init__(self, parts=(SPHERE, BOX)):
        self.parts = parts

    def intersect(self, o, d):
        t = self.parts[0].intersect(o, d)
        for s in self.parts[1:]:
            tb = s.intersect(o, d)
            t = jnp.where(jnp.isnan(t), tb, jnp.where(jnp.isnan(tb), t, jnp.minimum(t, tb)))
        return t


def _orbit(n, dist=1.45):
    poses = []
    for i in range(n):
        a = 0.12 * np.sin(2 * np.pi * i / n)
        eye = (0.45 * np.sin(a), -dist * np.cos(a * 0.5), 0.25)
        poses.append(look_at(eye, (0.0, 0.0, 0.0)))
    return poses


def preset_config(name, m, trajectory_path, **fusion):
    """``name`` as it is, at m voxels over the 2 m cube, caps at NB."""
    cfg = preset(name)
    nb = (m // 8) ** 3
    return dataclasses.replace(
        cfg, grid=PARAMS._replace(m=m), trajectory_path=trajectory_path,
        fusion=cfg.fusion._replace(brick_cap=nb, brick_cap_free=nb, **fusion))


PRESETS = [("tum256", 48, {}), ("tum512", 64, {"cap_mixed": 8})]
_PRESET_RUNS = {}


def preset_run(tmp_path, name, m, fusion):
    """Both runners over the preset loop's five frames, once per preset for
    the tests of this module that read it: the runners (closed) and, per
    frame, both FrameStats, poses and FuseStats."""
    key = (name, m)
    if key in _PRESET_RUNS:
        return _PRESET_RUNS[key]
    cfg_t = preset_config(name, m, str(tmp_path / "port.txt"), **fusion)
    cfg_j = preset_config(name, m, str(tmp_path / "jax.txt"), **fusion)
    assert cfg_t.fusion.mode == "brickmajor"
    poses = _orbit(5, dist=2.45)  # far enough for whole FREE bricks
    p0 = poses[0]
    rj = JReconstruction(CAM, cfg_j, initial_pose=p0)
    rt = Reconstruction(CAM, cfg_t, device="cpu",
                        initial_pose=pose_from_numpy(p0.R, p0.t, device="cpu"))
    rng = np.random.default_rng(1)
    frames = []
    for i, p in enumerate(poses):
        # the wall behind the objects gives whole FREE bricks; a block of
        # holes (a speckle would leave no brick whose pixels are all valid)
        depth = np.array(render_scene_depth(Scene((SPHERE, BOX, WALL)), CAM, p))
        depth[30:40, 10 + 4 * i:25 + 4 * i] = np.nan
        rgb = np.broadcast_to(rng.uniform(size=3), depth.shape + (3,)).astype(np.float32)
        sj = rj.process_frame(depth, rgb=rgb, timestamp=10.0 + i)
        st = rt.process_frame(depth, rgb=rgb, timestamp=10.0 + i)
        frames.append(dict(sj=sj, st=st, pose_j=(np.asarray(rj.pose.R), np.asarray(rj.pose.t)),
                           pose_t=(rt.pose.R.numpy(), rt.pose.t.numpy()),
                           fuse_j=rj.last_fuse_stats, fuse_t=rt.last_fuse_stats))
    rj.close()
    rt.close()
    _PRESET_RUNS[key] = dict(rj=rj, rt=rt, frames=frames, tmp_path=tmp_path)
    return _PRESET_RUNS[key]


@pytest.mark.parametrize("name,m,fusion", PRESETS)
def test_preset_matches_jax_runner(tmp_path, name, m, fusion):
    """Per frame: equal GN iterations, rejection and valid counts, the pose to
    1e-4, and equal FuseStats; then the trajectories and the grids."""
    run = preset_run(tmp_path, name, m, fusion)
    rj, rt, tmp_path = run["rj"], run["rt"], run["tmp_path"]
    assert rt._bgrid.D.dtype == torch.bfloat16 and rt._bgrid.W.dtype == torch.bfloat16
    n_free = 0
    for i, f in enumerate(run["frames"]):
        st, sj = f["st"], f["sj"]
        assert (st.gn_iterations, st.rejected, st.num_valid) == (
            sj.gn_iterations, sj.rejected, sj.num_valid), i
        np.testing.assert_allclose(f["pose_t"][1], f["pose_j"][1],
                                   atol=TOL_POSE, err_msg=f"frame {i}")
        np.testing.assert_allclose(f["pose_t"][0], f["pose_j"][0],
                                   atol=TOL_POSE, err_msg=f"frame {i}")
        fj = f["fuse_j"]
        assert dataclasses.astuple(f["fuse_t"]) == tuple(int(getattr(fj, k)) for k in (
            "n_full", "overflow", "n_free", "overflow_active", "overflow_mixed",
            "n_sat")), i
        n_free += f["fuse_t"].n_free
    assert sum(s.gn_iterations for s in rt.stats) > 4
    assert not any(s.rejected for s in rt.stats)
    assert rt.last_fuse_stats.n_full > 0 and n_free > 0
    traj_t = read_trajectory(str(tmp_path / "port.txt"))
    traj_j = jread_trajectory(str(tmp_path / "jax.txt"))
    assert len(traj_t) == len(traj_j) == 5
    np.testing.assert_allclose(traj_t.translations, traj_j.translations, atol=TOL_POSE)
    # bf16 storage: the grids agree to a few bf16 quanta where observed
    gt, gj = rt.grid, rj.grid
    W_j = np.asarray(gj.W)
    np.testing.assert_array_equal(gt.W.numpy() > 0, W_j > 0)
    np.testing.assert_allclose(gt.W.numpy(), W_j, rtol=2 ** -7)
    seen = W_j > 0
    np.testing.assert_allclose(gt.D.numpy()[seen], np.asarray(gj.D)[seen],
                               atol=2 * PARAMS.delta / 128)


@pytest.mark.parametrize("name,m,fusion", PRESETS)
def test_preset_mean_residual_matches_jax(tmp_path, name, m, fusion):
    """FrameStats.mean_abs_residual per frame: a float32 value, Σ|r| over
    max(num_valid, 1) divided in float32 as the JAX package does on the
    device, equal to the JAX package's to 1e-4 relative (the sums run in
    another order, at poses 1e-5 apart)."""
    run = preset_run(tmp_path, name, m, fusion)
    for i, f in enumerate(run["frames"]):
        ours, theirs = f["st"].mean_abs_residual, f["sj"].mean_abs_residual
        assert float(np.float32(ours)) == ours, i
        assert float(np.float32(theirs)) == theirs, i
        np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-9, err_msg=f"frame {i}")
    assert all(f["st"].mean_abs_residual > 0 for f in run["frames"][1:])


@pytest.mark.parametrize("tracking", [{"jacobian": "central"}], ids=["central_under_a_mesh"])
def test_unported_modes_raise(tracking):
    """The one combination the port refuses, as the JAX package's sharded
    tracker does: it raises before the mesh is touched."""
    cfg = preset("tum256")
    cfg = dataclasses.replace(cfg, trajectory_path=None,
                              tracking=cfg.tracking._replace(**tracking))
    with pytest.raises(NotImplementedError, match="central"):
        Reconstruction(CAM, cfg, mesh=object())


def slice_config(trajectory_path, brick_merge="pallas", pose_init="previous"):
    cfg = preset("tum256")
    return dataclasses.replace(
        cfg, grid=PARAMS, trajectory_path=trajectory_path, pose_init=pose_init,
        fusion=cfg.fusion._replace(mode="bricked", brick_merge=brick_merge,
                                   brick_cap=256))


@pytest.mark.parametrize("pose_init,wire", [("previous", False), ("velocity", True)],
                         ids=["previous_float", "velocity_u16_u8"])
def test_slice_matches_jax_runner(tmp_path, pose_init, wire):
    """``wire``: feed TUM's uint16 depth (1/5000 m, 0 = hole) and uint8 color."""
    poses = _orbit(5)
    cfg_t = slice_config(str(tmp_path / "port.txt"), pose_init=pose_init)
    cfg_j = slice_config(str(tmp_path / "jax.txt"), brick_merge="xla",
                         pose_init=pose_init)
    p0 = poses[0]
    rj = JReconstruction(CAM, cfg_j, initial_pose=p0)
    rt = Reconstruction(CAM, cfg_t, device="cpu",
                        initial_pose=pose_from_numpy(p0.R, p0.t, device="cpu"))
    rng = np.random.default_rng(0)
    for i, p in enumerate(poses):
        depth = np.array(render_scene_depth(Scene(), CAM, p))
        depth[rng.random(depth.shape) < 0.01] = np.nan
        rgb = np.broadcast_to(rng.uniform(size=3), depth.shape + (3,)).astype(np.float32)
        if wire:
            depth = np.where(np.isfinite(depth), np.round(depth * 5000.0), 0).astype(np.uint16)
            rgb = np.round(rgb * 255.0).astype(np.uint8)
        sj = rj.process_frame(depth, rgb=rgb, timestamp=10.0 + i)
        st = rt.process_frame(depth, rgb=rgb, timestamp=10.0 + i)
        assert (st.gn_iterations, st.rejected, st.num_valid) == (
            sj.gn_iterations, sj.rejected, sj.num_valid), i
        np.testing.assert_allclose(rt.pose.t.numpy(), np.asarray(rj.pose.t),
                                   atol=TOL_POSE, err_msg=f"frame {i}")
        np.testing.assert_allclose(rt.pose.R.numpy(), np.asarray(rj.pose.R),
                                   atol=TOL_POSE, err_msg=f"frame {i}")
        assert (rt.last_fuse_stats.n_full, rt.last_fuse_stats.n_free) == (
            int(rj.last_fuse_stats.n_full), int(rj.last_fuse_stats.n_free))
    rj.close()
    rt.close()
    assert sum(s.gn_iterations for s in rt.stats) > 4
    assert not any(s.rejected for s in rt.stats)

    traj_t = read_trajectory(str(tmp_path / "port.txt"))
    traj_j = jread_trajectory(str(tmp_path / "jax.txt"))
    assert len(traj_t) == len(traj_j) == 5
    np.testing.assert_array_equal(traj_t.timestamps, traj_j.timestamps)
    np.testing.assert_allclose(traj_t.translations, traj_j.translations, atol=TOL_POSE)
    np.testing.assert_allclose(traj_t.quaternions, traj_j.quaternions, atol=TOL_POSE)

    W_j = np.asarray(rj.grid.W)
    np.testing.assert_allclose(rt.grid.W.numpy(), W_j, atol=TOL_GRID)
    seen = W_j > 0
    assert seen.mean() > 0.03
    np.testing.assert_allclose(rt.grid.D.numpy()[seen], np.asarray(rj.grid.D)[seen],
                               atol=TOL_GRID)
    # color fused on frames 2 and 4 only (color_every=2)
    np.testing.assert_allclose(rt.grid.Wc.numpy(), np.asarray(rj.grid.Wc), atol=TOL_GRID)


def test_trajectory_metrics_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    stamps = 10.0 + 0.1 * np.arange(12)
    gt_t = rng.normal(size=(12, 3))
    q = rng.normal(size=(12, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    est_t = gt_t @ np.linalg.qr(rng.normal(size=(3, 3)))[0].T + 0.5
    est_t += rng.normal(scale=0.01, size=est_t.shape)
    ours = ate_rmse(Trajectory(stamps + 0.003, est_t, q), Trajectory(stamps, gt_t, q))
    theirs = jate_rmse(JTrajectory(stamps + 0.003, est_t, q), JTrajectory(stamps, gt_t, q))
    assert ours[1] == theirs[1] == 12
    assert abs(ours[0] - theirs[0]) < 1e-12 and 0.0 < ours[0] < 0.05
    path = str(tmp_path / "t.txt")
    p = pose_from_numpy(_orbit(3)[1].R, _orbit(3)[1].t, device="cpu")
    with TrajectoryWriter(path) as w:
        w.write(5.0, p)
    back = read_trajectory(path)
    np.testing.assert_allclose(back.translations[0], p.t.numpy(), atol=1e-6)


def test_port_runs_without_jax(tmp_path):
    """Two frames through the port on the CPU in a fresh interpreter, a render
    and a mesh of them, then a sequence written by its generator and replayed
    through its CLI (native loader, chunked, checkpointed, evaluated, meshed
    live and at the end, rendered), then every lazy subpackage of the
    package imported: the interpreter must never load jax, any
    module of the JAX package, or PIL (the test process itself has them
    loaded)."""
    script = textwrap.dedent(f"""
        import dataclasses, importlib, sys
        import torch
        from tracking_sdf_tpu_torch.config import GridParams, preset
        from tracking_sdf_tpu_torch.pipeline import visualizer
        for name in ("image_io", "marching_cubes", "raycast"):  # the modules
            importlib.import_module("tracking_sdf_tpu_torch.render." + name)
        from tracking_sdf_tpu_torch.core.camera import PinholeCamera
        from tracking_sdf_tpu_torch.data.synthetic import SphereScene, look_at, render_scene_depth
        from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction
        from tracking_sdf_tpu_torch.parallel import mesh, render, sharded, worker
        torch.set_num_threads(2)
        cfg = preset("tum256")
        cfg = dataclasses.replace(
            cfg, grid=GridParams(m=48, width=2.0, height=2.0, depth=2.0,
                                 origin=(-1.0, -1.0, -1.0), delta=0.15, epsilon=0.02),
            trajectory_path={str(tmp_path / "t.txt")!r})
        cam = PinholeCamera(fx=60.0, fy=60.0, cx=47.5, cy=35.5, width=96, height=72)
        scene = SphereScene(center=(0.0, 0.0, 0.0), radius=0.4)
        # the presets' brick-major path, then the flat bricked one
        for fusion in (dict(brick_cap=216, brick_cap_free=216),
                       dict(mode="bricked", brick_merge="pallas", brick_cap=256)):
            c = dataclasses.replace(cfg, fusion=cfg.fusion._replace(**fusion))
            r = Reconstruction(cam, c, device="cpu", initial_pose=look_at(
                (0.0, -1.5, 0.2), (0.0, 0.0, 0.0), device="cpu"))
            for i, eye in enumerate([(0.0, -1.5, 0.2), (0.02, -1.5, 0.2)]):
                r.process_frame(render_scene_depth(
                    scene, cam, look_at(eye, (0.0, 0.0, 0.0), device="cpu")))
            assert r.render(stride=4).hit.any()
            assert r.export_mesh({str(tmp_path / "m.ply")!r}) > 0
            r.close()
            assert not any(s.rejected for s in r.stats), r.stats
            assert r.stats[1].gn_iterations > 0
        from tracking_sdf_tpu_torch import cli, config
        from tracking_sdf_tpu_torch.data import make_sequence
        seq = {str(tmp_path / "seq")!r}
        assert make_sequence.main(["--out", seq, "--frames", "4", "--width", "160",
                                   "--height", "120", "--cpu"]) == 0
        config.preset = lambda name: dataclasses.replace(
            cfg, grid=GridParams(m=48), fusion=cfg.fusion._replace(
                brick_cap=216, brick_cap_free=216))
        assert cli.main(["--dataset", seq, "--camera", "129.325,129.125,79.65,63.825,160,120",
                         "--native-loader", "--chunk", "2", "--eval", "--json", "--cpu",
                         "--checkpoint", {str(tmp_path / "ck")!r}, "--checkpoint-every", "3",
                         "--profile", {str(tmp_path / "prof")!r},
                         "--mesh", {str(tmp_path / "cli.ply")!r},
                         "--mesh-async", {str(tmp_path / "live.ply")!r},
                         "--render", {str(tmp_path / "cli.png")!r},
                         "--trajectory", {str(tmp_path / "cli.txt")!r}]) == 0
        assert len(open({str(tmp_path / "cli.txt")!r}).readlines()) >= 1
        import tracking_sdf_tpu_torch as port
        for name in port._SUBMODULES:  # every lazy subpackage and its exports
            assert getattr(port, name).__name__ == "tracking_sdf_tpu_torch." + name
        assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
        assert "PIL" not in sys.modules
        jax_pkg = sorted(m for m in sys.modules
                         if m == "tracking_sdf_tpu" or m.startswith("tracking_sdf_tpu."))
        assert not jax_pkg, jax_pkg
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("OK")
