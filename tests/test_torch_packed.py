"""Port vs JAX package: ``FusionConfig(mode="packed")`` on one device.

The JAX package's packed layout (fusion/packed.py: one (NB, 6, BV) array)
computes brick-major fusion on float32 leaves whatever the storage dtypes
say, with the flat classifier; the port runs that as float32 brick-major
rows (``runner.packed_fusion_config``) through K2's plain version. Held
here, on the scenes and sizes of tests/test_torch_brickmajor.py and
tests/test_torch_chunk.py:
  * one fusion call against JAX ``fuse_frame_packed``: FuseStats equal, the
    six dense leaves within the JAX suite's grid tolerance, atol 1e-5 (JAX's
    packed and brick-major functions themselves differ by float32 rounding:
    XLA fuses the running mean in another order);
  * the runner over five frames against the JAX runner in packed mode at
    m=48 and m=64: equal GN iterations, valid counts and FuseStats, poses
    within 1e-4 (tests/test_torch_slice.py's TOL_POSE), the dense leaves
    within 1e-4 where observed (a pose 1e-5 apart moves a voxel's distance
    by about as much) and W > 0 on the same voxels;
  * checkpoints crossing both ways bit for bit, sat_skip and hier_classify
    ignored, ``process_chunk`` refused and ``run(chunk=N)`` run per frame,
    and the CLI's --fusion-mode packed.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_brickmajor import BS, POSES, _frame
from test_torch_brickmajor import CAM as CAM48
from test_torch_brickmajor import PARAMS as PARAMS48
from test_torch_chunk import chunk_config, make_frames, new_recon
from test_torch_cli import Run, camera_arg, sequence  # noqa: F401 (a fixture)
from test_torch_slice import CAM, TOL_POSE, _orbit
from tracking_sdf_tpu import config as jconfig
from tracking_sdf_tpu.config import preset as jpreset
from tracking_sdf_tpu.fusion import packed as jpacked
from tracking_sdf_tpu.pipeline import Reconstruction as JReconstruction
from tracking_sdf_tpu_torch import cli, config
from tracking_sdf_tpu_torch.core.lie import pose_from_numpy
from tracking_sdf_tpu_torch.data.tum import TUMFrame
from tracking_sdf_tpu_torch.fusion import brickmajor as tbm
from tracking_sdf_tpu_torch.grid.grid import FIELDS
from tracking_sdf_tpu_torch.pipeline.runner import packed_fusion_config

torch.set_num_threads(2)

ATOL_GRID = 1e-5  # one fusion call (tests/test_brick_fusion.py's grid tolerance)
ATOL_RUN = 1e-4  # after five tracked frames
PRESETS = [("tum256", 48), ("tum512", 64)]


def _packed_fusion(pkg, **kw):
    """The tum256 preset's fusion in packed mode: bf16 storage and
    hierarchical classification asked for, both of which packed ignores."""
    return pkg.preset("tum256").fusion._replace(mode="packed", hier_classify=2, **kw)


@pytest.mark.parametrize("color", [True, False], ids=["color", "geometry"])
def test_packed_frame_matches_jax(color):
    cap, cap_free = 220, 150
    jcfg = _packed_fusion(jconfig, fuse_color=color)
    tcfg = packed_fusion_config(dataclasses.replace(
        config.PipelineConfig(), fusion=_packed_fusion(config, fuse_color=color))).fusion
    assert (tcfg.mode, tcfg.storage_dtype, tcfg.weight_dtype, tcfg.hier_classify) == (
        "brickmajor", "float32", "float32", 0)
    jp = jpacked.empty_packed_grid(PARAMS48, BS)
    tb = tbm.empty_brick_grid(PARAMS48, BS, device="cpu")
    for i, pose in enumerate(POSES):
        pts, nrm, rgb = _frame(pose, i)
        jp, _, sj = jpacked.fuse_frame_packed(
            jp, pose, jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(rgb) if color else None,
            params=PARAMS48, cam=CAM48, cfg=jcfg, bs=BS, cap=cap, cap_free=cap_free)
        _, _, st = tbm.fuse_frame_brickmajor(
            tb, pose_from_numpy(pose.R, pose.t, device="cpu"), torch.from_numpy(pts),
            torch.from_numpy(nrm), torch.from_numpy(rgb) if color else None, params=PARAMS48,
            cam=CAM48, cfg=tcfg, bs=BS, cap=cap, cap_free=cap_free)
        assert dataclasses.astuple(st) == tuple(int(getattr(sj, k)) for k in (
            "n_full", "overflow", "n_free", "overflow_active", "overflow_mixed", "n_sat")), i
        assert st.n_full > 0 and st.n_free > 0
    gj = jpacked.dense_from_packed(jp, PARAMS48, BS)
    gt = tbm.dense_from_brick_grid(tb, PARAMS48, BS)
    assert ((gt.Wc > 0).sum() > 100) == color
    for k in FIELDS:
        np.testing.assert_allclose(getattr(gt, k).numpy(), np.asarray(getattr(gj, k)),
                                   atol=ATOL_GRID, rtol=0, err_msg=k)


def _packed_config(pkg, name, m, trajectory_path=None, **fusion):
    cfg = chunk_config(name, m, trajectory_path, package=pkg.preset, **fusion)
    return dataclasses.replace(cfg, fusion=cfg.fusion._replace(mode="packed"))


def _runners(name, m, n=5):
    """The same n frames through both packages' runners in packed mode."""
    depths, rgbs = make_frames(n)
    p0 = _orbit(7, dist=2.45)[0]
    rj = JReconstruction(CAM, _packed_config(jconfig, name, m), initial_pose=p0)
    rt = new_recon(_packed_config(config, name, m))
    frames = []
    for i in range(n):
        sj = rj.process_frame(depths[i], rgbs[i], timestamp=float(i))
        st = rt.process_frame(depths[i], rgbs[i], timestamp=float(i))
        frames.append((sj, st, rj.last_fuse_stats, rt.last_fuse_stats,
                       np.asarray(rj.pose.t), rt.pose.t.numpy(),
                       np.asarray(rj.pose.R), rt.pose.R.numpy()))
    return rj, rt, frames


@pytest.mark.parametrize("name,m", PRESETS)
def test_packed_runner_matches_jax(name, m):
    rj, rt, frames = _runners(name, m)
    assert rt.packed and rt.brick_grid.D.dtype == rt.brick_grid.W.dtype == torch.float32
    assert rt.config.fusion.hier_classify == 0 and rt._sat is None
    for i, (sj, st, fj, ft, tj, tt, Rj, Rt) in enumerate(frames):
        assert (st.gn_iterations, st.rejected, st.num_valid) == (
            sj.gn_iterations, sj.rejected, sj.num_valid), i
        np.testing.assert_allclose(tt, tj, atol=TOL_POSE, err_msg=f"frame {i}")
        np.testing.assert_allclose(Rt, Rj, atol=TOL_POSE, err_msg=f"frame {i}")
        assert dataclasses.astuple(ft) == tuple(int(getattr(fj, k)) for k in (
            "n_full", "overflow", "n_free", "overflow_active", "overflow_mixed", "n_sat")), i
    assert sum(s.gn_iterations for s in rt.stats) > 4 and not any(s.rejected for s in rt.stats)
    gj, gt = rj.grid, rt.grid
    seen = np.asarray(gj.W) > 0
    np.testing.assert_array_equal(gt.W.numpy() > 0, seen)
    for k in FIELDS:
        np.testing.assert_allclose(getattr(gt, k).numpy()[seen], np.asarray(getattr(gj, k))[seen],
                                   atol=ATOL_RUN, rtol=0, err_msg=k)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_packed_checkpoints_cross_packages(tmp_path, direction):
    """Checkpoints go through the dense view: each package restores what the
    other wrote, grid and pose bit for bit, into its packed rows."""
    rj, rt, _ = _runners("tum256", 48, n=3)
    path = str(tmp_path / "ck")
    if direction == "jax_to_port":
        rj.save_checkpoint(path)
        dst = new_recon(_packed_config(config, "tum256", 48))
        src_grid = rj.grid
    else:
        rt.save_checkpoint(path)
        dst = JReconstruction(CAM, _packed_config(jconfig, "tum256", 48),
                              initial_pose=_orbit(7, dist=2.45)[0])
        src_grid = rt.grid
    dst.restore_checkpoint(path)
    assert dst.frame_num == 3
    for k in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(dst.grid, k)).view(np.int32),
                                      np.asarray(getattr(src_grid, k)).view(np.int32),
                                      err_msg=k)
    if direction == "jax_to_port":
        assert dst.brick_grid.D.dtype == torch.float32
        assert bool(torch.isnan(dst.brick_grid.D[dst.brick_grid.W == 0]).all())
        np.testing.assert_array_equal(dst.pose.t.numpy(), np.asarray(rj.pose.t))


def test_packed_ignores_sat_skip_and_hier_classify():
    """As in the JAX package: the rows are those of packed without either,
    bit for bit, and no bitset exists."""
    depths, rgbs = make_frames(4)
    runs = []
    for fusion in ({}, {"sat_skip": True, "hier_classify": 4, "cap_mixed": 2}):
        r = new_recon(_packed_config(config, "tum512", 64, **fusion))
        for i in range(4):
            r.process_frame(depths[i], rgbs[i], timestamp=float(i))
        assert r._sat is None and r.config.fusion.hier_classify == 0
        runs.append(r)
    for k in ("D", "W", "C"):
        assert torch.equal(getattr(runs[0].brick_grid, k).view(torch.int16),
                           getattr(runs[1].brick_grid, k).view(torch.int16)), k
    assert runs[1].last_fuse_stats == runs[0].last_fuse_stats


def test_packed_runs_per_frame_only(tmp_path):
    """process_chunk raises ValueError (the JAX package's contract);
    run(chunk=N) warns and runs per frame, equal to the per-frame loop."""
    depths, rgbs = make_frames(5)
    per = new_recon(_packed_config(config, "tum256", 48))
    for i in range(5):
        per.process_frame(depths[i], rgbs[i], timestamp=float(i))
    chk = new_recon(_packed_config(config, "tum256", 48))
    chk.process_frame(depths[0], rgbs[0], timestamp=0.0)
    with pytest.raises(ValueError, match="packed"):
        chk.process_chunk(np.stack(depths[1:3]), np.stack(rgbs[1:3]))
    assert chk.frame_num == 1
    run = new_recon(_packed_config(config, "tum256", 48))
    frames = [TUMFrame(depth=d, rgb=c, timestamp=float(i))
              for i, (d, c) in enumerate(zip(depths, rgbs))]
    with pytest.warns(RuntimeWarning, match="per frame"):
        run.run(frames, chunk=8)
    assert run.frame_num == 5
    for k in ("D", "W", "C"):
        assert torch.equal(getattr(run.brick_grid, k).view(torch.int16),
                           getattr(per.brick_grid, k).view(torch.int16)), k
    assert torch.equal(run.pose.t, per.pose.t) and torch.equal(run.pose.R, per.pose.R)


def test_cli_fusion_mode_packed_exits_0(sequence, tmp_path, monkeypatch):  # noqa: F811
    """--fusion-mode packed runs on one device: float32 rows, flat
    classification, and a trajectory that tracks (ATE under
    tests/test_torch_cli.py's 0.05 m)."""
    root, stats = sequence
    got = Run(cli, ["--dataset", root, "--camera", camera_arg(stats), "--eval",
                    "--fusion-mode", "packed"], tmp_path, "packed", monkeypatch)
    assert got.rc == 0, got.stderr
    r = got.recon
    assert r.packed and r.brick_grid.D.dtype == torch.float32
    assert got.summary["ate_rmse_m"] < 0.05
