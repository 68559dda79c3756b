"""Port vs JAX package: bricked fusion, its stats, and the merge (K2's plain
version), plus the port's own bricked == dense contract.

Grids are compared at atol 1e-5 (tests/test_brick_fusion.py: float32
association in the merge). FuseStats counts must be exactly equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracking_sdf_tpu.config import FusionConfig, GridParams
from tracking_sdf_tpu.core.camera import PinholeCamera, backproject
from tracking_sdf_tpu.data.synthetic import (
    CuboidScene, SphereScene, look_at, render_scene_depth)
from tracking_sdf_tpu.fusion.brick import fuse_frame_bricked as jfuse_bricked
from tracking_sdf_tpu.fusion.pallas_merge import merge_active_bricks
from tracking_sdf_tpu.grid.grid import empty_grid as jempty_grid
from tracking_sdf_tpu.tracking import estimate_normals
from tracking_sdf_tpu_torch.core.lie import pose_from_numpy
from tracking_sdf_tpu_torch.fusion import brick_merge as tmerge
from tracking_sdf_tpu_torch.fusion.brick import fuse_frame_bricked
from tracking_sdf_tpu_torch.fusion.fuse import fuse_frame
from tracking_sdf_tpu_torch.grid.grid import (
    FIELDS, empty_grid, grid_from_numpy, grid_to_numpy)

torch.set_num_threads(2)

PARAMS = GridParams(m=48, width=2.0, height=2.0, depth=2.0,
                    origin=(-1.0, -1.0, -1.0), delta=0.15, epsilon=0.02)
CAM = PinholeCamera(fx=60.0, fy=60.0, cx=47.5, cy=35.5, width=96, height=72)
BS = (8, 8, 8)
NB = (48 // 8) ** 3
SPHERE = SphereScene(center=(0.15, 0.1, 0.0), radius=0.4)
BOX = CuboidScene(min_corner=(-0.75, -0.4, -0.55), max_corner=(-0.35, 0.4, 0.15))
WALL = CuboidScene(min_corner=(-4.0, 0.8, -4.0), max_corner=(4.0, 1.2, 4.0))
POSES = [
    look_at((0.0, -2.5, 0.25), (0.0, 0.0, 0.0)),
    look_at((0.4, -2.4, 0.1), (0.0, 0.0, 0.0)),
    look_at((-0.3, -2.45, 0.2), (0.05, 0.0, 0.0)),
]
ATOL = 1e-5


class Scene:
    def intersect(self, o, d):
        t = SPHERE.intersect(o, d)
        for s in (BOX, WALL):
            tb = s.intersect(o, d)
            t = jnp.where(jnp.isnan(t), tb,
                          jnp.where(jnp.isnan(tb), t, jnp.minimum(t, tb)))
        return t


def _frame(pose, seed):
    """(points, normals, rgb) as numpy: exact depth with a NaN hole, and one
    color per frame. (A voxel on a pixel boundary may truncate to either
    neighbour under float32 round-off, so per-pixel random colors would not
    compare at 1e-5.)"""
    depth = np.array(render_scene_depth(Scene(), CAM, pose))
    depth[30:40, 10 + 4 * seed:25 + 4 * seed] = np.nan
    pts = backproject(CAM, jnp.asarray(depth))
    nrm = estimate_normals(pts)
    rgb = np.broadcast_to(np.random.default_rng(seed).uniform(size=3),
                          depth.shape + (3,))
    return np.array(pts), np.array(nrm), np.array(rgb, np.float32)


def _port(pose):
    return pose_from_numpy(pose.R, pose.t, device="cpu")


def _assert_grids(port_grid, jax_grid, atol=ATOL):
    got = grid_to_numpy(port_grid)
    for k in FIELDS:
        np.testing.assert_allclose(got[k], np.asarray(getattr(jax_grid, k)),
                                   atol=atol, err_msg=k)


def _merge_inputs(seed, color, bs=BS):
    """A random grid state and a random active-brick list: FULL bricks with
    update rows, FULL bricks past the cap (zero row), FREE bricks."""
    rng = np.random.default_rng(seed)
    m = PARAMS.m
    nb = (m // bs[0]) * (m // bs[1]) * (m // bs[2])
    arrays = {k: rng.uniform(0.1, 1.0, (m, m, m)).astype(np.float32)
              for k in FIELDS}
    arrays["W"] = rng.uniform(0.0, 3.0, (m, m, m)).astype(np.float32)
    arrays["W"][rng.random((m, m, m)) < 0.3] = 0.0
    arrays["Wc"] = rng.uniform(0.0, 3.0, (m, m, m)).astype(np.float32)
    cap = 24
    act = np.sort(rng.choice(nb, size=100, replace=False)).astype(np.int32)
    cls = np.where(rng.random(100) < 0.4, 2, 1).astype(np.int32)
    full_pos = np.nonzero(cls == 2)[0]
    slot = np.full(100, cap, np.int32)
    slot[full_pos[:cap]] = np.arange(min(cap, len(full_pos)))
    C = 6 if color else 2
    upd = rng.uniform(0.0, 1.0, (cap + 1,) + bs + (C,)).astype(np.float32)
    upd[..., 0][rng.random(upd.shape[:-1]) < 0.3] = 0.0  # some voxels get no update
    upd[cap] = 0.0
    return arrays, upd, act, cls, slot


@pytest.mark.parametrize("bs", [BS, (1, 8, 16)], ids=["8x8x8", "1x8x16"])
@pytest.mark.parametrize("color", [False, True], ids=["geometry", "color"])
def test_merge_reference_matches_pallas_interpret(color, bs):
    """The dense merge's plain version (the flat tail with brick_merge
    "pallas" on the CPU) against the Pallas kernel in interpret mode, at the
    presets' 8^3 bricks and at a flat brick shape like the config's default
    (1, 8, 128)."""
    arrays, upd, act, cls, slot = _merge_inputs(0, color, bs)
    # the Pallas kernel takes cap_act slots with PAD (class 0, brick 0) first
    pad = 8
    bid_j = np.concatenate([np.zeros(pad, np.int32), act])
    cls_j = np.concatenate([np.zeros(pad, np.int32), cls])
    slot_j = np.concatenate([np.full(pad, upd.shape[0] - 1, np.int32), slot])
    jgrid = jempty_grid(PARAMS)._replace(**{k: jnp.asarray(v) for k, v in arrays.items()})
    out_j = merge_active_bricks(
        jgrid, jnp.asarray(upd), jnp.asarray(bid_j), jnp.asarray(cls_j),
        jnp.asarray(slot_j), bs=bs, cap_act=len(bid_j), delta=PARAMS.delta,
        fuse_color=color, interpret=True)
    g = grid_from_numpy(arrays, device="cpu")
    tmerge.brick_merge_reference(
        g, torch.from_numpy(upd), torch.from_numpy(act), torch.from_numpy(cls),
        torch.from_numpy(slot), bs=bs, delta=PARAMS.delta, max_weight=None)
    _assert_grids(g, out_j)
    # the dispatching wrapper takes the plain version for CPU tensors
    g2 = grid_from_numpy(arrays, device="cpu")
    before = tmerge.launches
    tmerge.brick_merge(
        g2, torch.from_numpy(upd), torch.from_numpy(act), torch.from_numpy(cls),
        torch.from_numpy(slot), bs=bs, delta=PARAMS.delta, max_weight=None)
    assert tmerge.launches == before
    for k in FIELDS:
        assert torch.equal(getattr(g2, k), getattr(g, k))


def _run_both(cfg, frames, cap, cap_act=None):
    """Fuse the frames with the port and with JAX merge='xla'."""
    gj = jempty_grid(PARAMS)
    gt = empty_grid(PARAMS, device="cpu")
    for pose, (pts, nrm, rgb) in frames:
        rgb_in = rgb if cfg.fuse_color else None
        gj, sj = jfuse_bricked(gj, pose, jnp.asarray(pts), jnp.asarray(nrm),
                               None if rgb_in is None else jnp.asarray(rgb_in),
                               params=PARAMS, cam=CAM, cfg=cfg, bs=BS, cap=cap,
                               merge="xla")
        gt, st = fuse_frame_bricked(
            gt, _port(pose), torch.from_numpy(pts), torch.from_numpy(nrm),
            None if rgb_in is None else torch.from_numpy(rgb_in),
            params=PARAMS, cam=CAM, cfg=cfg, bs=BS, cap=cap, cap_act=cap_act)
        assert (st.n_full, st.overflow, st.n_free) == (
            int(sj.n_full), int(sj.overflow), int(sj.n_free))
        yield gt, gj, st


def test_fuse_bricked_matches_jax_with_share_p2p_and_clamp():
    """The slice's fusion settings (share 4x4, point-to-point, color) with
    max_weight=2.0 so the clamp is reached by the second frame. JAX runs its
    XLA tail, which clamps: the port's merge must clamp too (the Pallas
    kernel does not)."""
    cfg = FusionConfig(mode="bricked", brick_merge="pallas", pixel_share=4,
                       pixel_share_j=4, distance="point_to_point",
                       max_weight=2.0)
    frames = [(p, _frame(p, i)) for i, p in enumerate(POSES)]
    for gt, gj, st in _run_both(cfg, frames, cap=256):
        assert st.overflow_active == 0 and st.n_full > 0 and st.n_free > 0
    _assert_grids(gt, gj)
    W = grid_to_numpy(gt)["W"]
    assert W.max() == 2.0 and (W == 2.0).sum() > 1000  # the clamp was reached


def test_fuse_bricked_matches_jax_exact_p2plane():
    cfg = FusionConfig(mode="bricked", brick_merge="pallas")
    frames = [(p, _frame(p, i)) for i, p in enumerate(POSES[:2])]
    for gt, gj, _ in _run_both(cfg, frames, cap=256):
        pass
    _assert_grids(gt, gj)


def test_fuse_bricked_overflow_stats_match_jax():
    """cap=2 drops FULL bricks, a small cap_act drops active ones: both are
    reported, and the FULL drops match JAX's."""
    cfg = FusionConfig(mode="bricked", brick_merge="pallas", fuse_color=False)
    frames = [(POSES[0], _frame(POSES[0], 0))]
    for gt, gj, st in _run_both(cfg, frames, cap=2, cap_act=8):
        assert st.overflow > 0 and st.overflow_active > 0
        assert st.overflow_active == st.n_full + st.n_free - 8
    assert torch.isfinite(gt.D).all() and float(gt.W.sum()) > 0
    # with only the cap_act cut lifted, the grid is JAX's
    for gt, gj, st in _run_both(cfg, frames, cap=2, cap_act=NB):
        assert st.overflow_active == 0
    _assert_grids(gt, gj)


def test_port_bricked_matches_port_dense_geometry_two_frames():
    cfg = FusionConfig(mode="bricked", brick_merge="pallas", fuse_color=False)
    gd = empty_grid(PARAMS, device="cpu")
    gb = empty_grid(PARAMS, device="cpu")
    for i, pose in enumerate(POSES[:2]):
        pts, nrm, _ = (torch.from_numpy(a) for a in _frame(pose, i))
        gd = fuse_frame(gd, _port(pose), pts, nrm, None, params=PARAMS, cam=CAM,
                        cfg=cfg)
        gb, st = fuse_frame_bricked(gb, _port(pose), pts, nrm, None,
                                    params=PARAMS, cam=CAM, cfg=cfg, bs=BS,
                                    cap=256)
        assert st.overflow == 0 and st.n_full > 0
    torch.testing.assert_close(gb.W, gd.W, atol=ATOL, rtol=0)
    torch.testing.assert_close(gb.D, gd.D, atol=ATOL, rtol=0)
