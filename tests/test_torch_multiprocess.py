"""Port vs JAX package: real multi-process runs of the port's sharded
pipeline, Gloo groups on the CPU (counterpart of tests/test_multiprocess.py).

The ranks are processes of ``python -m tracking_sdf_tpu_torch.parallel.worker``
(which imports no JAX) or of the port's CLI, each with one thread, over a TCP
store on localhost. One module-scoped 2-rank run does fusion, tracking, the
runner per frame (7 frames), the same frames chunked, a render, a mesh and a
checkpoint round trip; it is held to the JAX package's 2-device mesh on the
same frames with the JAX suite's tolerances (tests/test_parallel.py:314-372,
:374-435): fusion within 1e-5, one frame's tracking within 5e-5 with equal
valid counts, the runner's pose within 1e-4, W within 1e-3 and D within 1e-3
(float32 storage). The ranks' poses and trajectory files must be identical.
A 4-rank run holds the mesh across three rank boundaries, exactly; the CLI
runs --multihost with 2 ranks, and --realtime --multihost.
"""
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracking_sdf_tpu.config import FusionConfig, GridParams, PipelineConfig, TrackingConfig
from tracking_sdf_tpu.core.camera import PinholeCamera
from tracking_sdf_tpu.core.lie import pose_compose as jcompose
from tracking_sdf_tpu.core.lie import se3_exp as jse3_exp
from tracking_sdf_tpu.data.synthetic import CuboidScene, SphereScene, look_at, render_scene_depth
from tracking_sdf_tpu.fusion.brickmajor import brick_grid_from_dense as jbm_from_dense
from tracking_sdf_tpu.fusion.brickmajor import dense_from_brick_grid as jdense_from_bm
from tracking_sdf_tpu.grid.grid import empty_grid as jempty_grid
from tracking_sdf_tpu.parallel import make_mesh as jmake_mesh
from tracking_sdf_tpu.parallel import sharded as jsh
from tracking_sdf_tpu.pipeline import Reconstruction as JReconstruction
from tracking_sdf_tpu.tracking.preprocess import preprocess_frame as jpreprocess
from tracking_sdf_tpu_torch.fusion import brickmajor as tbm
from tracking_sdf_tpu_torch.render.marching_cubes import marching_cubes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = GridParams(m=48, width=2.0, height=2.0, depth=2.0,
                    origin=(-1.0, -1.0, -1.0), delta=0.15, epsilon=0.02)
CAM = PinholeCamera(fx=60.0, fy=60.0, cx=47.5, cy=35.5, width=96, height=72)
SPHERE = SphereScene(center=(0.15, 0.1, 0.0), radius=0.4)
BOX = CuboidScene(min_corner=(-0.75, -0.4, -0.55), max_corner=(-0.35, 0.4, 0.15))
BS = (2, 8, 16)
FRAMES = 7
XI = [0.02, -0.015, 0.02, 0.01, -0.015, 0.01]
FUSION = dict(mode="brickmajor", brick_shape=BS, brick_cap=768, brick_cap_free=768,
              fuse_color=True, color_every=2)
TRACKING = dict(max_iterations=20)
LAUNCH_TIMEOUT = 300  # s, each group of processes


class Scene:
    def intersect(self, o, d):
        ta, tb = SPHERE.intersect(o, d), BOX.intersect(o, d)
        return jnp.where(jnp.isnan(ta), tb,
                         jnp.where(jnp.isnan(tb), ta, jnp.minimum(ta, tb)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    return env


def _communicate(procs, what):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=LAUNCH_TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"{what} rank failed:\n{(err or out)[-4000:]}"
    return outs


def _orbit(k):
    ang = 0.05 * k
    return look_at((1.5 * np.sin(ang), -1.5 * np.cos(ang), 0.25), (0.0, 0.0, 0.0))


def _inputs(path):
    poses = [_orbit(k) for k in range(FRAMES)]
    depths = np.stack([np.asarray(render_scene_depth(Scene(), CAM, p)) for p in poses])
    rgbs = np.broadcast_to(np.asarray([0.6, 0.4, 0.3], np.float32),
                           depths.shape + (3,)).copy()
    np.savez(path, depths=depths.astype(np.float32), rgbs=rgbs,
             poses_R=np.stack([np.asarray(p.R) for p in poses]),
             poses_t=np.stack([np.asarray(p.t) for p in poses]))
    return depths, rgbs, poses


def _launch(n, runs, tmp, inputs):
    spec = dict(coordinator=f"localhost:{_free_port()}", ranks=n, device="cpu",
                out=str(tmp), inputs=str(inputs), cam=CAM._asdict(), runs=runs)
    path = tmp / "spec.json"
    path.write_text(json.dumps(spec))
    procs = [subprocess.Popen([sys.executable, "-m", "tracking_sdf_tpu_torch.parallel.worker",
                               str(path), str(r)], cwd=REPO, env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(n)]
    _communicate(procs, "worker")
    return {run["name"]: [np.load(tmp / f"{run['name']}_{r}.npz") for r in range(n)]
            for run in runs}


def _config():
    return dict(preset=None, grid=PARAMS._asdict(), fusion=FUSION, tracking=TRACKING,
                bilateral_filter=False)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_mp2")
    depths, rgbs, poses = _inputs(tmp / "inputs.npz")
    runs = [dict(name="frames", config=_config(), frames=FRAMES, fuse_check=True,
                 track_check=dict(xi=XI, stride=2), cap=384,
                 render=dict(stride=1, with_color=False), mesh=True, checkpoint=True),
            dict(name="chunk", config=_config(), frames=FRAMES, chunk=[3, 3])]
    out = _launch(2, runs, tmp, tmp / "inputs.npz")
    return out, tmp, (depths, rgbs, poses)


def test_ranks_agree_and_chunk_equals_frames(two_ranks):
    """Both ranks end on the same pose bit for bit with identical
    trajectory files, and the chunked run equals the per-frame run."""
    out, tmp, _ = two_ranks
    a, b = out["frames"]
    for key in ("pose_R", "pose_t", "num_valid", "iterations"):
        np.testing.assert_array_equal(a[key], b[key])
    assert not a["rejected"].any() and int(a["overflow"]) == 0
    t0 = (tmp / "frames_traj_0.txt").read_text()
    assert t0 == (tmp / "frames_traj_1.txt").read_text()
    assert len(t0.splitlines()) == FRAMES
    c = out["chunk"][0]
    np.testing.assert_array_equal(c["pose_t"], a["pose_t"])
    np.testing.assert_array_equal(c["pose_R"], a["pose_R"])
    np.testing.assert_array_equal(c["num_valid"], a["num_valid"])
    for key in ("D", "W", "C"):
        np.testing.assert_array_equal(c[key], a[key], err_msg=key)
    assert (tmp / "chunk_traj_0.txt").read_text() == t0


def test_fusion_and_tracking_match_the_jax_mesh(two_ranks):
    """One frame fused from empty by the 2-rank slab form: within 1e-5 of
    the JAX package's sharded brick-major fusion on 2 devices; tracking off
    the rows from a perturbed pose: equal valid count, pose within 5e-5."""
    out, _, (depths, rgbs, poses) = two_ranks
    mesh = jmake_mesh(jax.devices()[:2])
    cfg = FusionConfig(**FUSION)
    pts, nrm = jpreprocess(jnp.asarray(depths[0]), cam=CAM, bilateral=False)
    fuse = jsh.sharded_fuse_frame_brickmajor(mesh, params=PARAMS, cam=CAM, cfg=cfg, cap=384,
                                             emit_dm=False)
    bg, _, st = fuse(jsh.shard_brick_grid(jbm_from_dense(jempty_grid(PARAMS), BS), mesh),
                     poses[0], pts, nrm, jnp.asarray(rgbs[0]))
    r0 = out["frames"][0]
    assert int(r0["fuse_counts"][0]) == int(st.n_full) > 0
    assert int(r0["fuse_counts"][1]) == 0
    g_j = jdense_from_bm(bg, PARAMS, BS)
    rows = tbm.brick_grid_from_numpy({"D": r0["fuse_D"], "W": r0["fuse_W"],
                                      "C": r0["fuse_C"]}, device="cpu")
    g = tbm.dense_from_brick_grid(rows, PARAMS, BS)
    np.testing.assert_allclose(g.W.numpy(), np.asarray(g_j.W), atol=1e-5)
    ok = np.asarray(g_j.W) > 0
    np.testing.assert_allclose(g.D.numpy()[ok], np.asarray(g_j.D)[ok], atol=1e-5)

    pose0 = jcompose(jse3_exp(jnp.asarray(XI, jnp.float32)), poses[0])
    r_j = jsh.sharded_track_frame_brickmajor(
        mesh, params=PARAMS, cfg=TrackingConfig(**TRACKING), bs=BS)(
        bg.D, pose0, pts[::2, ::2].reshape(-1, 3))
    assert int(r0["track_valid"]) == int(r_j.num_valid)
    np.testing.assert_allclose(r0["track_t"], np.asarray(r_j.pose.t), atol=5e-5)
    np.testing.assert_allclose(r0["track_R"], np.asarray(r_j.pose.R), atol=5e-5)


def test_runner_matches_the_jax_mesh(two_ranks):
    """The 2-rank runner over the 7 frames against the JAX package's
    Reconstruction on a 2-device mesh: pose within 1e-4, W within 1e-3, D
    within 1e-3 where observed."""
    out, _, (depths, rgbs, poses) = two_ranks
    cfg = PipelineConfig(grid=PARAMS, tracking=TrackingConfig(**TRACKING),
                         fusion=FusionConfig(**FUSION), trajectory_path=None,
                         bilateral_filter=False)
    r = JReconstruction(CAM, cfg, initial_pose=poses[0], mesh=jmake_mesh(jax.devices()[:2]))
    for k in range(FRAMES):
        r.process_frame(depths[k], rgbs[k], timestamp=float(k))
    r.close()
    r0 = out["frames"][0]
    np.testing.assert_allclose(r0["pose_t"], np.asarray(r.pose.t), atol=1e-4)
    rows = tbm.brick_grid_from_numpy({"D": r0["D"], "W": r0["W"], "C": r0["C"]},
                                     device="cpu")
    g, g_j = tbm.dense_from_brick_grid(rows, PARAMS, BS), r.grid
    np.testing.assert_allclose(g.W.numpy(), np.asarray(g_j.W), atol=1e-3)
    ok = np.asarray(g_j.W) > 0
    np.testing.assert_allclose(g.D.numpy()[ok], np.asarray(g_j.D)[ok], atol=1e-3)


def test_render_mesh_and_checkpoint_of_the_group(two_ranks):
    """The sharded render equals the single-device render of the gathered
    grid bitwise on both ranks; the ranks' mesh slabs in rank order equal
    marching_cubes of the gathered grid exactly; a checkpoint the group
    saved restores bitwise into a new 2-rank run and into one device."""
    out, _, _ = two_ranks
    r0, r1 = out["frames"]
    for r in (r0, r1):
        assert bool(r["render_equal"]) and int(r["render_dropped"]) == 0
        assert int(r["render_hits"]) > 300
        assert bool(r["restore_equal"])
    assert bool(r0["restore_single_equal"])
    rows = tbm.brick_grid_from_numpy({"D": r0["D"], "W": r0["W"], "C": r0["C"]},
                                     device="cpu")
    ref = marching_cubes(tbm.dense_from_brick_grid(rows, PARAMS, BS), params=PARAMS,
                         with_colors=True)
    assert ref.num_triangles > 300 and int(r0["dropped_cells"]) + int(r1["dropped_cells"]) == 0
    np.testing.assert_array_equal(np.concatenate([r0["tris"], r1["tris"]]), ref.vertices)
    np.testing.assert_array_equal(np.concatenate([r0["cols"], r1["cols"]]), ref.colors)


def test_four_ranks_mesh_exactly(tmp_path):
    """4 ranks, three rank boundaries: the slabs' meshes concatenated equal
    marching_cubes of the gathered grid exactly."""
    _inputs(tmp_path / "inputs.npz")
    out = _launch(4, [dict(name="mesh4", config=_config(), frames=1, mesh=True)],
                  tmp_path, tmp_path / "inputs.npz")["mesh4"]
    rows = tbm.brick_grid_from_numpy({"D": out[0]["D"], "W": out[0]["W"],
                                      "C": out[0]["C"]}, device="cpu")
    ref = marching_cubes(tbm.dense_from_brick_grid(rows, PARAMS, BS), params=PARAMS,
                         with_colors=True)
    assert ref.num_triangles > 300 and sum(int(o["dropped_cells"]) for o in out) == 0
    assert all(o["tris"].shape[0] > 0 for o in out[1:3])
    np.testing.assert_array_equal(np.concatenate([o["tris"] for o in out]), ref.vertices)
    np.testing.assert_array_equal(np.concatenate([o["cols"] for o in out]), ref.colors)


def _cli(tmp_path, extra, frames):
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tracking_sdf_tpu_torch.cli", "--cpu", "--multihost",
         "--coordinator", f"localhost:{port}", "--num-processes", "2", "--process-id",
         str(r), "--distributed", "--preset", "synthetic64", "--fusion-mode", "brickmajor",
         "--synthetic", "--frames", str(frames),
         "--trajectory", str(tmp_path / f"traj_{r}.txt"), "--eval", "--json"] + extra,
        cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = _communicate(procs, "cli")
    summaries = [json.loads(out.splitlines()[-1]) for out, _ in outs]
    t0 = (tmp_path / "traj_0.txt").read_text()
    assert t0 == (tmp_path / "traj_1.txt").read_text()
    return summaries, t0


def test_multihost_cli(tmp_path):
    """`cli --multihost --coordinator ... --distributed`: two processes, one
    group; both converge (ATE < 0.05 m) with byte-identical trajectories."""
    summaries, traj = _cli(tmp_path, [], 4)
    for s in summaries:
        assert s["frames"] == 4.0 and s["ranks"] == 2.0
        assert s["ate_rmse_m"] is not None and s["ate_rmse_m"] < 0.05
    assert len(traj.splitlines()) == 4


def test_multihost_cli_realtime(tmp_path):
    """--realtime --multihost: rank 0's clock chooses the frames and both
    ranks deliver the same ones: identical drops (some, at 120 Hz on the
    CPU), identical trajectories."""
    (s0, s1), traj = _cli(tmp_path, ["--realtime", "120"], 8)
    assert s0["realtime_dropped"] > 0
    assert (s0["realtime_dropped"], s0["realtime_yielded"]) == (
        s1["realtime_dropped"], s1["realtime_yielded"])
    assert s0["realtime_yielded"] + s0["realtime_dropped"] == 8
    for s in (s0, s1):
        assert s["frames"] == s["realtime_yielded"]
        assert s["ate_rmse_m"] is not None and s["ate_rmse_m"] < 0.08
    assert len(traj.splitlines()) == s0["realtime_yielded"]
