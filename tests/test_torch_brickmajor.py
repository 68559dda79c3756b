"""Port vs JAX package: the brick-major layout, its fusion with K2's row form
(plain version) and the hierarchical classification, plus the port's own
brick-major == dense contract.

Inputs are made with numpy and handed to both sides. Tolerances: float32
storage as the JAX suite's grids (atol 1e-5, tests/test_brick_fusion.py);
bfloat16 storage at least 99% of the stored values bitwise equal and every
value within 1 bf16 ulp (float32 rounding of the update sums may differ in
the last bit, which can flip a bf16 rounding). FuseStats must be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracking_sdf_tpu.config import FusionConfig, GridParams
from tracking_sdf_tpu.core.camera import PinholeCamera, backproject
from tracking_sdf_tpu.data.synthetic import (
    CuboidScene, SphereScene, look_at, render_scene_depth)
from tracking_sdf_tpu.fusion import brickmajor as jbm
from tracking_sdf_tpu.fusion.brick import classify_compact_hier as jhier
from tracking_sdf_tpu.grid.grid import empty_grid as jempty_grid
from tracking_sdf_tpu.tracking import estimate_normals
from tracking_sdf_tpu_torch.core.lie import pose_from_numpy
from tracking_sdf_tpu_torch.fusion import brick_fuse as tfuse
from tracking_sdf_tpu_torch.fusion import brick_merge as tmerge
from tracking_sdf_tpu_torch.fusion import brickmajor as tbm
from tracking_sdf_tpu_torch.fusion.brick import classify_compact_hier
from tracking_sdf_tpu_torch.fusion.fuse import fuse_frame
from tracking_sdf_tpu_torch.grid.grid import FIELDS, empty_grid, grid_from_numpy
from tracking_sdf_tpu_torch.grid.interp import masked_view

torch.set_num_threads(2)

PARAMS = GridParams(m=48, width=2.0, height=2.0, depth=2.0,
                    origin=(-1.0, -1.0, -1.0), delta=0.15, epsilon=0.02)
CAM = PinholeCamera(fx=60.0, fy=60.0, cx=47.5, cy=35.5, width=96, height=72)
BS = (8, 8, 8)
SPHERE = SphereScene(center=(0.15, 0.1, 0.0), radius=0.4)
BOX = CuboidScene(min_corner=(-0.75, -0.4, -0.55), max_corner=(-0.35, 0.4, 0.15))
WALL = CuboidScene(min_corner=(-4.0, 0.8, -4.0), max_corner=(4.0, 1.2, 4.0))
# far enough from the wall that free space holds whole 8^3 bricks
POSES = [look_at((0.0, -2.5, 0.25), (0.0, 0.0, 0.0)),
         look_at((0.4, -2.4, 0.1), (0.0, 0.0, 0.0))]
ATOL = 1e-5
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


class Scene:
    def intersect(self, o, d):
        t = SPHERE.intersect(o, d)
        for s in (BOX, WALL):
            tb = s.intersect(o, d)
            t = jnp.where(jnp.isnan(t), tb,
                          jnp.where(jnp.isnan(tb), t, jnp.minimum(t, tb)))
        return t


def _frame(pose, seed, cam=CAM):
    """(points, normals, rgb) as numpy: exact depth with a NaN hole, one
    color per frame."""
    depth = np.array(render_scene_depth(Scene(), cam, pose))
    depth[30:40, 10 + 4 * seed:25 + 4 * seed] = np.nan
    pts = backproject(cam, jnp.asarray(depth))
    rgb = np.broadcast_to(np.random.default_rng(seed).uniform(size=3),
                          depth.shape + (3,))
    return np.array(pts), np.array(estimate_normals(pts)), np.array(rgb, np.float32)


def _bits(x) -> np.ndarray:
    """16-bit storage -> ordered integers (sign-magnitude to two's complement):
    neighbouring bf16 values differ by 1, and +0 == -0."""
    u = np.asarray(x).view(np.uint16).astype(np.int32)
    return np.where(u & 0x8000, -(u & 0x7FFF), u)


def _port_bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def _assert_same_bits(t: torch.Tensor, j, name):
    """Equal storage bits element by element, except that NaNs compare by
    position only."""
    j = np.asarray(j)
    ints = {2: (torch.int16, np.uint16), 4: (torch.int32, np.uint32)}[j.dtype.itemsize]
    nan = np.isnan(np.asarray(j, np.float32))
    assert torch.equal(torch.isnan(t.float()), torch.from_numpy(nan)), name
    got = t.contiguous().view(ints[0]).numpy().view(ints[1])
    np.testing.assert_array_equal(got[~nan], j.view(ints[1])[~nan], err_msg=name)


def _random_dense(seed):
    rng = np.random.default_rng(seed)
    m = PARAMS.m
    arrays = {k: rng.uniform(0.0, 1.0, (m, m, m)).astype(np.float32) for k in FIELDS}
    arrays["D"] = rng.uniform(-0.15, 0.15, (m, m, m)).astype(np.float32)
    arrays["W"][rng.random((m, m, m)) < 0.5] = 0.0
    return arrays


@pytest.mark.parametrize("vdt,wdt", [("float32", "float32"), ("bfloat16", "bfloat16"),
                                     ("bfloat16", "float32")])
def test_brick_grid_roundtrip_and_lanes_match_jax(vdt, wdt):
    arrays = _random_dense(0)
    bs = (8, 8, 16)
    jg = jempty_grid(PARAMS)._replace(**{k: jnp.asarray(v) for k, v in arrays.items()})
    jb = jbm.brick_grid_from_dense(jg, bs, DTYPES[vdt][0], DTYPES[wdt][0])
    tb = tbm.brick_grid_from_dense(grid_from_numpy(arrays, device="cpu"), bs,
                                   DTYPES[vdt][1], DTYPES[wdt][1])
    # the port's leaves carry the JAX leaves' bits (NaN sentinels by isnan)
    for name in ("D", "W", "C"):
        _assert_same_bits(getattr(tb, name), getattr(jb, name), name)
    # and brick_grid_from_numpy carries them over bit for bit
    tb2 = tbm.brick_grid_from_numpy(jb._asdict(), device="cpu")
    for name in ("D", "W", "C"):
        assert torch.equal(getattr(tb2, name).view(torch.int16),
                           getattr(tb, name).view(torch.int16)), name
    back = tbm.brick_grid_to_numpy(tb2)
    np.testing.assert_array_equal(back["C"], np.asarray(jb.C))
    np.testing.assert_array_equal(back["W"], np.asarray(jb.W, np.float32))
    # dense round trip: the far value where W <= 0, upcast values elsewhere
    jd = jbm.dense_from_brick_grid(jb, PARAMS, bs)
    td = tbm.dense_from_brick_grid(tb, PARAMS, bs)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(td, k).numpy(), np.asarray(getattr(jd, k)),
                                      err_msg=k)
    np.testing.assert_array_equal(tbm.masked_dense_D(tb, PARAMS, bs).float().numpy(),
                                  np.asarray(jbm.masked_dense_D(jb, PARAMS, bs), np.float32))
    # unpacked color equals the rows of the dense leaves
    R, _, _, Wc = tbm.unpack_color_grid(tb)
    assert R.dtype == DTYPES[vdt][1] and Wc.dtype == DTYPES[wdt][1]
    np.testing.assert_array_equal(R.float().numpy(),
                                  tbm._to_rows(td.R, bs).numpy())
    je = jbm.empty_brick_grid(PARAMS, bs, value_dtype=DTYPES[vdt][0],
                              weight_dtype=DTYPES[wdt][0])
    te = tbm.empty_brick_grid(PARAMS, bs, device="cpu", value_dtype=DTYPES[vdt][1],
                              weight_dtype=DTYPES[wdt][1])
    for name in ("D", "W", "C"):
        _assert_same_bits(getattr(te, name), getattr(je, name), name)


def test_lane_order_matches_jax_bitcast():
    """torch's int16 view of float32 puts the low half first, as
    jax.lax.bitcast_convert_type to uint16 does on a little-endian host."""
    x = np.random.default_rng(1).normal(size=(5, 7)).astype(np.float32)
    got = tbm._lanes(torch.from_numpy(x)).numpy().view(np.uint16)
    want = np.asarray(jax.lax.bitcast_convert_type(jnp.asarray(x), jnp.uint16))
    np.testing.assert_array_equal(got, want.reshape(5, 14))
    back = tbm._unlanes(torch.from_numpy(got.view(np.int16)), torch.float32)
    np.testing.assert_array_equal(back.numpy(), x)


def _preset_fusion(**kw):
    """The presets' brick-major fusion settings (tum256), overridable."""
    base = FusionConfig(mode="brickmajor", brick_shape=BS, pixel_share=4,
                        pixel_share_j=4, distance="point_to_point", free_fold=True,
                        storage_dtype="bfloat16", weight_dtype="bfloat16",
                        max_weight=128.0)
    return base._replace(**kw)


def _fuse_both(cfg, frames, cap, cap_free, vdt, wdt, params=PARAMS, cam=CAM):
    jb = jbm.empty_brick_grid(params, BS, value_dtype=DTYPES[vdt][0],
                              weight_dtype=DTYPES[wdt][0])
    tb = tbm.empty_brick_grid(params, BS, device="cpu", value_dtype=DTYPES[vdt][1],
                              weight_dtype=DTYPES[wdt][1])
    for pose, (pts, nrm, rgb) in frames:
        rgb_in = rgb if cfg.fuse_color else None
        jb, jview, sj = jbm.fuse_frame_brickmajor(
            jb, pose, jnp.asarray(pts), jnp.asarray(nrm),
            None if rgb_in is None else jnp.asarray(rgb_in), params=params, cam=cam,
            cfg=cfg, bs=BS, cap=cap, cap_free=cap_free, emit_dm="view")
        before = (tmerge.launches_rows, tfuse.launches)
        tb, tview, st = tbm.fuse_frame_brickmajor(
            tb, pose_from_numpy(pose.R, pose.t, device="cpu"), torch.from_numpy(pts),
            torch.from_numpy(nrm), None if rgb_in is None else torch.from_numpy(rgb_in),
            params=params, cam=cam, cfg=cfg, bs=BS, cap=cap, cap_free=cap_free)
        # CPU tensors: the plain version
        assert (tmerge.launches_rows, tfuse.launches) == before
        assert tview.rows is tb.D
        got = dataclasses.astuple(st)
        want = tuple(int(getattr(sj, k)) for k in
                     ("n_full", "overflow", "n_free", "overflow_active", "overflow_mixed",
                      "n_sat"))
        assert got == want, (got, want)
        yield jb, tb, st


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
@pytest.mark.parametrize("distance", ["point_to_plane", "point_to_point"])
def test_fuse_brickmajor_matches_jax(storage, distance):
    cfg = _preset_fusion(distance=distance, storage_dtype=storage, weight_dtype=storage,
                         max_weight=None if storage == "float32" else 128.0)
    frames = [(p, _frame(p, i)) for i, p in enumerate(POSES)]
    for jb, tb, st in _fuse_both(cfg, frames, 220, 220, storage, storage):
        assert st.n_full > 0 and st.n_free > 0 and st.overflow == 0
    _assert_leaves_match(jb, tb, storage, fused_color=True)


def _assert_leaves_match(jb, tb, storage, fused_color):
    """The six leaves: float32 storage within ATOL; bfloat16 storage at least
    99% bitwise equal and every value within 1 ulp. NaN masks equal."""
    jl = dict(zip(("R", "G", "B", "Wc"), jbm.unpack_color_grid(jb)))
    tl = dict(zip(("R", "G", "B", "Wc"), tbm.unpack_color_grid(tb)))
    jl.update(D=jb.D, W=jb.W)
    tl.update(D=tb.D, W=tb.W)
    assert (np.asarray(jb.W, np.float32) > 0).mean() > 0.05
    n_color = (np.asarray(jl["Wc"], np.float32) > 0).sum()
    assert n_color > 100 if fused_color else n_color == 0
    for name in ("D", "W", "R", "G", "B", "Wc"):
        j = np.asarray(jl[name])
        t = tl[name]
        nan_j = np.isnan(np.asarray(j, np.float32))
        np.testing.assert_array_equal(torch.isnan(t).numpy(), nan_j, err_msg=name)
        if storage == "float32":
            np.testing.assert_allclose(t.numpy()[~nan_j], j[~nan_j], atol=ATOL,
                                       err_msg=name)
        else:
            dist = np.abs(_bits(_port_bits(t)) - _bits(j))[~nan_j]
            share = float((dist == 0).mean())
            print(f"{name}: {100 * share:.3f}% of {dist.size} stored bf16 values "
                  f"bitwise equal, max {dist.max()} ulp")
            assert share >= 0.99 and dist.max() <= 1, (name, share, dist.max())


@pytest.mark.parametrize("option", [
    dict(weighting="linear"), dict(weighting="constant"),
    dict(weighting="narrow_exponential"), dict(fuse_color=False),
    dict(pixel_share=1, pixel_share_j=1)],
    ids=["linear", "constant", "narrow_exponential", "color_off", "share_1"])
def test_fuse_brickmajor_options_match_jax(option):
    """The preset's bf16 rows at m = 64 under the other weightings, with
    color off (a 4-channel pixel table) and with one pixel row per voxel."""
    params = PARAMS._replace(m=64)
    nb = (64 // 8) ** 3
    cfg = _preset_fusion(**option)
    frames = [(p, _frame(p, i)) for i, p in enumerate(POSES)]
    for jb, tb, st in _fuse_both(cfg, frames, nb, nb, "bfloat16", "bfloat16",
                                 params=params):
        assert st.n_full > 0 and st.n_free > 0 and st.overflow == 0
    _assert_leaves_match(jb, tb, "bfloat16", fused_color=cfg.fuse_color)


@pytest.mark.parametrize("hier,cap_mixed", [(0, 2048), (2, 2)], ids=["flat", "hier"])
def test_fuse_brickmajor_overflow_reported_like_jax(hier, cap_mixed):
    """Tight caps drop FULL bricks and FREE bricks (flat) or mixed
    super-bricks (hierarchical): every drop is reported, equal to JAX's, and
    the same bricks drop (the grids agree)."""
    cfg = _preset_fusion(storage_dtype="float32", weight_dtype="float32",
                         max_weight=None, hier_classify=hier, cap_mixed=cap_mixed)
    frames = [(POSES[0], _frame(POSES[0], 0))]
    for jb, tb, st in _fuse_both(cfg, frames, 4, 8, "float32", "float32"):
        assert st.overflow > 0
        assert st.overflow_mixed > 0 if hier else st.overflow_active > 0
    for name in ("D", "W"):
        j = np.asarray(getattr(jb, name))
        ok = ~np.isnan(j)
        np.testing.assert_array_equal(np.isnan(getattr(tb, name).numpy()), ~ok)
        np.testing.assert_allclose(getattr(tb, name).numpy()[ok], j[ok], atol=ATOL)
    assert (tb.W > 0).any()


@pytest.mark.parametrize("factor", [2, 4])
def test_classify_compact_hier_matches_jax(factor):
    """ids in the JAX package's (mixed-super rank, child) order, and stats."""
    params = PARAMS._replace(m=64)
    nb = (64 // 8) ** 3
    rows = []
    for i, pose in enumerate(POSES):
        pts, nrm, _ = _frame(pose, i)
        for cap, cap_free, cap_mixed in ((nb, nb, nb), (40, 6, 3)):
            want = jax.jit(lambda p, a, b: jhier(
                params, p, a, b, CAM, BS, jnp.float32, 8, 0, "point_to_point", cap,
                cap_free, factor, cap_mixed))(pose, jnp.asarray(pts), jnp.asarray(nrm))
            got = classify_compact_hier(
                params, pose_from_numpy(pose.R, pose.t, device="cpu"),
                torch.from_numpy(pts), torch.from_numpy(nrm), CAM, BS,
                "point_to_point", cap, cap_free, factor, cap_mixed)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            rows.append([int(x) for x in got[2:]])
    n_full, n_free, ovf_mixed, ovf_free = np.array(rows).T
    assert n_full.min() > 0 and n_free.min() > 0
    assert ovf_mixed.max() > 0 and ovf_free.max() > 0  # the tight caps drop


@pytest.mark.parametrize("distance", ["point_to_plane", "point_to_point"])
def test_brickmajor_matches_port_dense(distance):
    """The port's brick-major fusion == the port's dense fusion (geometry
    everywhere, color where color was fused), and the view it returns is the
    masked view of the merged grid. One color for both frames, as in the
    JAX suite: brick-major fuses color in FULL bricks only, so a color that
    changed between frames would differ where dense also fused FREE voxels."""
    cfg = FusionConfig(mode="brickmajor", distance=distance)
    gd = empty_grid(PARAMS, device="cpu")
    bg = tbm.brick_grid_from_dense(empty_grid(PARAMS, device="cpu"), BS)
    rgb = torch.tensor([0.7, 0.4, 0.2]).expand(CAM.height, CAM.width, 3).contiguous()
    for i, pose in enumerate(POSES):
        pts, nrm, _ = (torch.from_numpy(a) for a in _frame(pose, i))
        tp = pose_from_numpy(pose.R, pose.t, device="cpu")
        gd = fuse_frame(gd, tp, pts, nrm, rgb, params=PARAMS, cam=CAM, cfg=cfg)
        bg, view, st = tbm.fuse_frame_brickmajor(bg, tp, pts, nrm, rgb, params=PARAMS,
                                                 cam=CAM, cfg=cfg, bs=BS, cap=220)
        assert st.overflow == 0 and st.n_full > 0
    gb = tbm.dense_from_brick_grid(bg, PARAMS, BS)
    torch.testing.assert_close(gb.W, gd.W, atol=ATOL, rtol=0)
    torch.testing.assert_close(gb.D, gd.D, atol=ATOL, rtol=0)
    fused_c = gb.Wc > 0
    assert int(fused_c.sum()) > 100
    torch.testing.assert_close(gb.R[fused_c], gd.R[fused_c], atol=ATOL, rtol=0)
    Dm = tbm.masked_dense_D(bg, PARAMS, BS)
    ref = masked_view(gb.D, gb.W)
    assert torch.equal(torch.isnan(Dm), torch.isnan(ref))
    assert torch.equal(Dm[~torch.isnan(ref)], ref[~torch.isnan(ref)])
    assert view.rows is bg.D
