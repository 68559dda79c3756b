"""Port vs JAX package: the saturated-FREE skip (``FusionConfig.sat_skip``)
on the brick-major path, through K2 ``brick_fuse_rows``' plain version.

The scene and schedule of tests/test_sat_skip.py: a sphere before a wall at
rest (FREE bricks saturate at max_weight=3), then moved toward the camera
into bricks that were FREE (they turn FULL and their bits must clear), then
back. Held here:
  * the bitset and n_sat equal to the JAX package's every frame, flat and
    hierarchical classification, the rows within 1e-5 (float32 storage);
  * the JAX tests' three contracts on the port alone: skip-on equals
    skip-off bit for bit, a FULL touch clears the bit, and the skip is inert
    without max_weight;
  * the frame loop per frame and chunked: the bitset and n_sat of the
    chunk equal the per-frame loop's, which equal the JAX package's, and a
    grid assignment or a restore leaves no bit set (the JAX package's fault
    R1 is not copied).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracking_sdf_tpu import config as jconfig
from tracking_sdf_tpu.core.camera import PinholeCamera as JCam
from tracking_sdf_tpu.core.camera import backproject
from tracking_sdf_tpu.data.synthetic import CuboidScene, SphereScene, look_at, render_scene_depth
from tracking_sdf_tpu.fusion import brickmajor as jbm
from tracking_sdf_tpu.pipeline.runner import Reconstruction as JRecon
from tracking_sdf_tpu.tracking import estimate_normals
from tracking_sdf_tpu_torch import config
from tracking_sdf_tpu_torch.core.camera import PinholeCamera
from tracking_sdf_tpu_torch.core.lie import pose_from_numpy
from tracking_sdf_tpu_torch.fusion import brick_fuse as tfuse
from tracking_sdf_tpu_torch.fusion import brickmajor as tbm
from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction

torch.set_num_threads(2)

GRID = dict(m=48, width=2.0, height=2.0, depth=2.0, origin=(-1.0, -1.0, -1.0),
            delta=0.15, epsilon=0.02)
JPARAMS, PARAMS = jconfig.GridParams(**GRID), config.GridParams(**GRID)
CAM = PinholeCamera(fx=60.0, fy=60.0, cx=47.5, cy=35.5, width=96, height=72)
BS = (8, 8, 8)
NB = (48 // 8) ** 3
POSE = look_at((0.0, -1.5, 0.25), (0.0, 0.0, 0.0))
TPOSE = pose_from_numpy(POSE.R, POSE.t, device="cpu")
WALL = CuboidScene(min_corner=(-4.0, 0.8, -4.0), max_corner=(4.0, 1.2, 4.0))


def _depth(sphere_y):
    sphere = SphereScene(center=(0.15, sphere_y, 0.0), radius=0.4)

    class Scene:
        def intersect(self, o, d):
            t, tb = sphere.intersect(o, d), WALL.intersect(o, d)
            return jnp.where(jnp.isnan(t), tb, jnp.where(jnp.isnan(tb), t, jnp.minimum(t, tb)))

    return np.array(render_scene_depth(Scene(), JCam(*CAM), POSE))


def _frame(depth):
    pts = backproject(JCam(*CAM), jnp.asarray(depth))
    rgb = np.broadcast_to(np.asarray([0.7, 0.4, 0.2], np.float32), depth.shape + (3,))
    return np.array(pts), np.array(estimate_normals(pts)), np.ascontiguousarray(rgb)


DEPTH_A, DEPTH_B = _depth(0.1), _depth(-0.45)
FRAME_A, FRAME_B = _frame(DEPTH_A), _frame(DEPTH_B)
SCHEDULE = [FRAME_A] * 6 + [FRAME_B] * 3 + [FRAME_A] * 4


def _cfg(pkg, **kw):
    return pkg.FusionConfig(**dict(dict(mode="brickmajor", brick_shape=BS, max_weight=3.0,
                                        free_fold=True, cap_mixed=8), **kw))


def _port_fuse(bg, frame, cfg, sat, cap_free=256):
    pts, nrm, rgb = (torch.from_numpy(a) for a in frame)
    return tbm.fuse_frame_brickmajor(bg, TPOSE, pts, nrm, rgb if cfg.fuse_color else None,
                                     params=PARAMS, cam=CAM, cfg=cfg, bs=BS, cap=256,
                                     cap_free=cap_free, sat=sat)[2]


@pytest.mark.parametrize("hier", [0, 3], ids=["flat", "hier3"])
def test_sat_bitset_matches_jax(hier):
    jcfg, tcfg = _cfg(jconfig, hier_classify=hier), _cfg(config, hier_classify=hier)
    jb = jbm.empty_brick_grid(JPARAMS, BS)
    tb = tbm.empty_brick_grid(PARAMS, BS, device="cpu")
    jsat, tsat = jnp.zeros((NB,), bool), torch.zeros(NB, dtype=torch.bool)
    saw = 0
    for f, frame in enumerate(SCHEDULE):
        jb, _, sj, jsat = jbm.fuse_frame_brickmajor(
            jb, POSE, *(jnp.asarray(a) for a in frame), params=JPARAMS, cam=JCam(*CAM),
            cfg=jcfg, bs=BS, cap=256, cap_free=256, emit_dm=False, sat=jsat)
        before = tfuse.launches_sat
        st = _port_fuse(tb, frame, tcfg, tsat)
        assert tfuse.launches_sat == before  # CPU tensors: the plain version
        np.testing.assert_array_equal(tsat.numpy(), np.asarray(jsat), err_msg=f"frame {f}")
        assert (st.n_sat, st.n_free, st.n_full, st.overflow_active) == (
            int(sj.n_sat), int(sj.n_free), int(sj.n_full), int(sj.overflow_active)), f
        saw = max(saw, st.n_sat)
    for name in ("D", "W"):
        j, t = np.asarray(getattr(jb, name)), getattr(tb, name).numpy()
        np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
        np.testing.assert_allclose(t[~np.isnan(j)], j[~np.isnan(j)], atol=1e-5)
    assert saw > 0 and int(tsat.sum()) > 0


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("hier", [0, 3], ids=["flat", "hier3"])
def test_sat_skip_bitwise_equals_noskip(hier, storage):
    """The skip is invisible: every leaf bit for bit the run without it,
    every frame, through the scene change and back; it engaged (n_sat > 0)
    and took FREE candidates out (n_free lower)."""
    cfg = _cfg(config, hier_classify=hier, storage_dtype=storage, weight_dtype=storage)
    dt = tbm.storage_dtype(storage)
    ref = tbm.empty_brick_grid(PARAMS, BS, device="cpu", value_dtype=dt, weight_dtype=dt)
    got = tbm.empty_brick_grid(PARAMS, BS, device="cpu", value_dtype=dt, weight_dtype=dt)
    sat = torch.zeros(NB, dtype=torch.bool)
    fewer = False
    for f, frame in enumerate(SCHEDULE):
        s_ref = _port_fuse(ref, frame, cfg, None)
        s_got = _port_fuse(got, frame, cfg, sat)
        for name in ("D", "W", "C"):
            a, b = getattr(ref, name), getattr(got, name)
            assert torch.equal(a.view(torch.int16), b.view(torch.int16)), (f, name)
        assert s_ref.n_full == s_got.n_full and s_got.n_free <= s_ref.n_free
        assert s_ref.n_sat == 0
        fewer |= s_got.n_free < s_ref.n_free
    assert fewer and int(sat.sum()) > 0


def test_sat_clears_on_full_touch():
    cfg = _cfg(config, fuse_color=False)
    bg = tbm.empty_brick_grid(PARAMS, BS, device="cpu")
    sat = torch.zeros(NB, dtype=torch.bool)
    for _ in range(6):
        _port_fuse(bg, FRAME_A, cfg, sat)
    before = sat.clone()
    assert int(before.sum()) > 0
    ids, _ = tbm.classify_compact_rows(PARAMS, TPOSE, *(torch.from_numpy(a) for a in FRAME_B[:2]),
                                       cam=CAM, cfg=cfg, bs=BS, cap=256, cap_free=256)
    full = ids[:256][ids[:256] < NB].long()
    touched = full[before[full]]
    assert touched.numel() > 0  # the moved sphere reaches saturated bricks
    st = _port_fuse(bg, FRAME_B, cfg, sat)
    assert not bool(sat[full].any()) and st.n_sat == int(sat.sum()) < int(before.sum())


def test_sat_skip_inert_without_max_weight():
    cfg = _cfg(config, fuse_color=False, max_weight=None)
    bg = tbm.empty_brick_grid(PARAMS, BS, device="cpu")
    sat = torch.zeros(NB, dtype=torch.bool)
    for _ in range(5):
        st = _port_fuse(bg, FRAME_A, cfg, sat)
        assert st.n_sat == 0
    assert not bool(sat.any())


def _loops(chunk_sizes=(2, 3)):
    """The frame loop with sat_skip on the static scene: JAX per frame, the
    port per frame and the port chunked (frame 0 per frame)."""
    cfgs = []
    for pkg in (jconfig, config):
        base = pkg.PipelineConfig()
        cfgs.append(dataclasses.replace(
            base, grid=pkg.GridParams(**GRID), trajectory_path=None, bilateral_filter=False,
            fusion=_cfg(pkg, sat_skip=True, brick_cap=256, brick_cap_free=256)))
    n = 1 + sum(chunk_sizes)
    j = JRecon(JCam(*CAM), cfgs[0], initial_pose=POSE)
    per = Reconstruction(CAM, cfgs[1], initial_pose=TPOSE, device="cpu")
    chk = Reconstruction(CAM, cfgs[1], initial_pose=TPOSE, device="cpu")
    for k in range(n):
        j.process_frame(DEPTH_A, timestamp=float(k))
        per.process_frame(DEPTH_A, timestamp=float(k))
    chk.process_frame(DEPTH_A, timestamp=0.0)
    for size in chunk_sizes:
        chk.process_chunk(np.stack([DEPTH_A] * size))
    return j, per, chk


def test_sat_frame_loop_per_frame_and_chunked_match_jax():
    j, per, chk = _loops()
    np.testing.assert_array_equal(per._sat.numpy(), np.asarray(j._sat))
    assert per.last_fuse_stats.n_sat == int(j.last_fuse_stats.n_sat) > 0
    assert torch.equal(chk._sat, per._sat)
    assert chk.chunk_fuse_stats[-1] == per.last_fuse_stats
    for name in ("D", "W", "C"):
        assert torch.equal(getattr(chk.brick_grid, name).view(torch.int16),
                           getattr(per.brick_grid, name).view(torch.int16)), name
    assert torch.equal(chk.pose.t, per.pose.t)


def test_grid_assignment_and_restore_reset_the_bitset(tmp_path):
    """A bit states that the brick's rows survived its last FREE update
    unchanged: after a new grid (assignment or restore) none may be left
    set, or the next frames would skip updates the new rows need."""
    _, per, _ = _loops(chunk_sizes=(3,))
    assert int(per._sat.sum()) > 0
    per.save_checkpoint(str(tmp_path / "ck"))
    addr = per._sat.data_ptr()
    per.grid = per.grid
    assert not bool(per._sat.any()) and per._sat.data_ptr() == addr
    per.process_frame(DEPTH_A, timestamp=9.0)
    assert int(per._sat.sum()) > 0
    per.restore_checkpoint(str(tmp_path / "ck"))
    assert not bool(per._sat.any())
