"""Brick classification, compaction and the pixel table (K5, K6, K7 on the
card): the plain versions against the JAX package, the CPU dispatch, the
wrappers' argument checks and the chunk's launch counters.

Inputs are made with numpy from a seed and handed to both sides: the
sphere, box and wall of tests/test_torch_brickmajor.py rendered exactly at
48x64 and at a ragged 37x53, with NaN speckle, an all-NaN row and a NaN
block, depth jumps at the objects' edges; seen from outside the m=64 grid
of 8^3 bricks, and from inside it (part of the grid behind the camera and
off the image). Classes and ids must be exactly equal; the float tables
within atol 1e-5 with equal +-inf / NaN masks, as tests/test_torch_core.py
(the two frameworks round a division by a Python scalar differently). The
kernels themselves run only on a card: tests/test_torch_kernels_cuda.py
and chip_smoke.py phase 13.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracking_sdf_tpu.config import FusionConfig, GridParams
from tracking_sdf_tpu.core.camera import PinholeCamera, backproject
from tracking_sdf_tpu.data.synthetic import (
    CuboidScene, SphereScene, look_at, render_scene_depth)
from tracking_sdf_tpu.fusion import brick as jbrick
from tracking_sdf_tpu.tracking import estimate_normals
from tracking_sdf_tpu_torch.core.lie import pose_from_numpy
from tracking_sdf_tpu_torch.fusion import brick as tbrick
from tracking_sdf_tpu_torch.fusion import brick_classify as k567
from tracking_sdf_tpu_torch.fusion import brickmajor as tbm
from tracking_sdf_tpu_torch.kernels import _build

torch.set_num_threads(2)

PARAMS = GridParams(m=64, width=2.0, height=2.0, depth=2.0,
                    origin=(-1.0, -1.0, -1.0), delta=0.15, epsilon=0.02)
BS = (8, 8, 8)
ATOL = 1e-5
SIZES = [(48, 64), (37, 53)]
PARTS = (SphereScene(center=(0.15, 0.1, 0.0), radius=0.4),
         CuboidScene(min_corner=(-0.75, -0.4, -0.55), max_corner=(-0.35, 0.4, 0.15)),
         CuboidScene(min_corner=(-4.0, 0.8, -4.0), max_corner=(4.0, 1.2, 4.0)))
VIEWS = {"outside": ((0.3, -2.4, 0.15), (0.0, 0.0, 0.0)),
         "inside": ((0.1, -0.45, 0.1), (0.3, 1.0, 0.25))}
SHARE = 0.0883883  # the world radius of a 4x4 share group at m=64


class Scene:
    def intersect(self, o, d):
        t = PARTS[0].intersect(o, d)
        for s in PARTS[1:]:
            tb = s.intersect(o, d)
            t = jnp.where(jnp.isnan(t), tb, jnp.where(jnp.isnan(tb), t, jnp.minimum(t, tb)))
        return t


def _cam(h, w):
    return PinholeCamera(fx=0.83 * w, fy=0.83 * w, cx=(w - 1) / 2, cy=(h - 1) / 2,
                         width=w, height=h)


_FRAMES = {}


def _frame(h, w, view="outside", speckle=True, seed=0):
    """(cam, JAX pose, points, normals, rgb) with numpy arrays, cached. The
    clean frame (exact depth) keeps whole bricks provably FREE; a NaN in a
    brick's mip window rules FREE out."""
    key = (h, w, view, speckle, seed)
    if key not in _FRAMES:
        cam = _cam(h, w)
        pose = look_at(*VIEWS[view])
        depth = np.array(render_scene_depth(Scene(), cam, pose))
        rng = np.random.default_rng(seed + 100 * h + w)
        if speckle:
            depth[rng.random(depth.shape) < 0.05] = np.nan
            depth[h // 3] = np.nan
            depth[h // 2:h // 2 + 5, 3:11] = np.nan
        pts = backproject(cam, jnp.asarray(depth))
        nrm = estimate_normals(pts)
        rgb = rng.uniform(size=depth.shape + (3,)).astype(np.float32)
        _FRAMES[key] = (cam, pose, np.array(pts), np.array(nrm), rgb)
    return _FRAMES[key]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _tpose(pose):
    return pose_from_numpy(np.asarray(pose.R), np.asarray(pose.t), device="cpu")


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=ATOL)


@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("share", [0.0, SHARE])
@pytest.mark.parametrize("distance", ["point_to_plane", "point_to_point"])
def test_mip_levels_match_jax(distance, share, h, w):
    """The zeta min-mip and eta max-mip, every level and its row-below
    companion, against the JAX package's 32-lane table."""
    cam, _, pts, nrm, _ = _frame(h, w)
    t32, offsets, dims = jbrick._zeta_mip(jnp.asarray(pts), jnp.asarray(nrm), cam, PARAMS.delta,
                                          jnp.float32, distance, share)
    got = tbrick._zeta_mip_reference(_t(pts), _t(nrm), cam, PARAMS.delta, distance, share)
    assert got.offsets == [int(o) for o in offsets]
    assert got.dims == [tuple(int(x) for x in d) for d in dims]
    assert (tuple(got.offsets), tuple(got.dims)) == k567.mip_layout(h, w)
    total = got.zeta.shape[0]
    t32 = np.asarray(t32)
    for name, lane in (("zeta", 0), ("zeta_down", 8), ("eta", 16), ("eta_down", 24)):
        _close(getattr(got, name).numpy(), t32[:, lane:lane + 4].reshape(-1)[:total])
    assert np.isfinite(got.zeta.numpy()).any() and np.isneginf(got.zeta.numpy()).any()


@pytest.mark.parametrize("h,w", [(7, 9), (8, 8), (9, 17), (480, 640), (1, 1)])
def test_mip_layout_is_the_reference_levels(h, w):
    got = tbrick._zeta_mip_reference(torch.zeros(h, w, 3), torch.zeros(h, w, 3),
                                     _cam(h, w), 0.1)
    assert (tuple(got.offsets), tuple(got.dims)) == k567.mip_layout(h, w)
    if (h, w) == (480, 640):
        assert sum(a * b for a, b in got.dims) == 6409


@pytest.mark.parametrize("slab", [False, True])
@pytest.mark.parametrize("view,speckle", [("outside", False), ("outside", True),
                                          ("inside", True)])
@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("distance", ["point_to_plane", "point_to_point"])
def test_classify_bricks_matches_jax(distance, h, w, view, speckle, slab):
    """Brick classes exactly the JAX package's, on the whole grid and on a
    slab (nbi, i_offset)."""
    cam, pose, pts, nrm, _ = _frame(h, w, view, speckle)
    nbi, i_offset = (4, 32) if slab else (8, 0)
    share = SHARE if distance == "point_to_plane" else 0.0
    want = jbrick.classify_bricks(PARAMS, pose, jnp.asarray(pts), jnp.asarray(nrm), cam, BS,
                                  jnp.float32, nbi, i_offset, distance, share_margin=share)
    got = tbrick.classify_bricks_reference(PARAMS, _tpose(pose), _t(pts), _t(nrm), cam, BS,
                                           distance, share, nbi=nbi, i_offset=i_offset)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    counts = np.bincount(got.numpy().reshape(-1), minlength=3)
    assert counts[2] > 0 and counts[0] > 0
    if not speckle:
        assert counts[1] > 0


# the main path's sizes at the presets' caps: tum512's 4,096 supers (cap_mixed
# 1,536, cap_sfree 128), tum256's 32,768 bricks (6,144 / 2,048), tum512's
# 98,304 listed children (28,672 / 8,192); and n at K7's tile edges (2,048
# flags a tile)
MAIN_PATH_COMPACTION = [(4096, 1536), (4096, 128), (32768, 6144), (32768, 2048),
                        (98304, 28672), (98304, 8192), (2047, 2048), (2048, 600),
                        (2049, 2048), (4097, 1000), (6143, 6144)]


@pytest.mark.parametrize("n,cap", [(n, c) for n in (512, 700) for c in (1, 37, 200, 1000)]
                         + MAIN_PATH_COMPACTION)
def test_compaction_matches_jax(n, cap):
    """_compact_vals / _compact_ids: the first cap set flags in order, the
    rest of the cap padded; overflow keeps the first ones."""
    rng = np.random.default_rng(n + cap)
    flags = rng.random(n) < 0.3
    vals = rng.integers(0, 10_000, n).astype(np.int32)
    want = jbrick._compact_vals(jnp.asarray(flags), jnp.asarray(vals), cap, -7)
    got = tbrick._compact_vals(_t(flags), _t(vals), cap, -7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want_ids = jbrick._compact_ids(jnp.asarray(flags), cap, n)
    got_ids = tbrick._compact_ids(_t(flags), cap, n)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    assert int((got_ids < n).sum()) == min(cap, int(flags.sum()))


@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("color", [False, True])
@pytest.mark.parametrize("distance", ["point_to_plane", "point_to_point"])
def test_pixel_table_matches_jax(distance, color, h, w):
    _, _, pts, nrm, rgb = _frame(h, w)
    want = jbrick._pixel_table(jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(rgb), color,
                               jnp.float32, distance)
    got = tbrick._pixel_table_reference(_t(pts), _t(nrm), _t(rgb), color, distance)
    assert tuple(got.shape) == (h * w, 8 if color else 4)
    _close(got.numpy(), np.asarray(want))


def _launches():
    return k567.launches_tables, k567.launches_classify, k567.launches_compact


def _cfg(hier):
    return FusionConfig(mode="brickmajor", distance="point_to_plane", pixel_share=4,
                        pixel_share_j=4, hier_classify=hier, cap_mixed=3)


CPU_CALLS = {
    "_zeta_mip": (lambda f: tbrick._zeta_mip(f[2], f[3], f[0], 0.15, "point_to_plane", SHARE),
                  lambda f: tbrick._zeta_mip_reference(f[2], f[3], f[0], 0.15,
                                                       "point_to_plane", SHARE)),
    "_pixel_table": (lambda f: tbrick._pixel_table(f[2], f[3], f[4], True),
                     lambda f: tbrick._pixel_table_reference(f[2], f[3], f[4], True)),
    "frame_tables": (
        lambda f: tbrick.frame_tables(f[2], f[3], f[4], True, f[0], 0.15, "point_to_point"),
        lambda f: (tbrick._zeta_mip_reference(f[2], f[3], f[0], 0.15, "point_to_point"),
                   tbrick._pixel_table_reference(f[2], f[3], f[4], True, "point_to_point"))),
    "classify_bricks": (
        lambda f: tbrick.classify_bricks(PARAMS, f[1], f[2], f[3], f[0], BS, nbi=4,
                                         i_offset=32),
        lambda f: tbrick.classify_bricks_reference(PARAMS, f[1], f[2], f[3], f[0], BS, nbi=4,
                                                   i_offset=32)),
    "classify_compact_hier": (
        lambda f: tbrick.classify_compact_hier(PARAMS, f[1], f[2], f[3], f[0], BS,
                                               "point_to_plane", 20, 12, 2, 3),
        lambda f: tbrick.classify_compact_hier_reference(PARAMS, f[1], f[2], f[3], f[0], BS,
                                                         "point_to_plane", 20, 12, 2, 3)),
    "classify_compact_rows_flat": (
        lambda f: tbm.classify_compact_rows(PARAMS, f[1], f[2], f[3], cam=f[0], cfg=_cfg(0),
                                            bs=BS, cap=20, cap_free=12),
        lambda f: tbm.classify_compact_rows_reference(PARAMS, f[1], f[2], f[3], cam=f[0],
                                                      cfg=_cfg(0), bs=BS, cap=20,
                                                      cap_free=12)),
    "classify_compact_rows_hier": (
        lambda f: tbm.classify_compact_rows(PARAMS, f[1], f[2], f[3], cam=f[0], cfg=_cfg(4),
                                            bs=BS, cap=20, cap_free=12),
        lambda f: tbm.classify_compact_rows_reference(PARAMS, f[1], f[2], f[3], cam=f[0],
                                                      cfg=_cfg(4), bs=BS, cap=20,
                                                      cap_free=12)),
}


def _flat_tensors(x):
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, k567.ZetaMip):
        return [x.zeta, x.zeta_down, x.eta, x.eta_down]
    return [t for y in x for t in _flat_tensors(y)]


@pytest.mark.parametrize("name", list(CPU_CALLS))
def test_cpu_dispatch_is_the_plain_version(name, monkeypatch):
    """On the CPU the public names return the plain version's bits and never
    reach the kernel library; no launch is counted."""
    def no_library():
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(_build, "library", no_library)
    cam, pose, pts, nrm, rgb = _frame(37, 53, "inside")
    f = (cam, _tpose(pose), _t(pts), _t(nrm), _t(rgb))
    before = _launches()
    call, plain = CPU_CALLS[name]
    got, want = _flat_tensors(call(f)), _flat_tensors(plain(f))
    assert _launches() == before
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.is_floating_point():
            assert torch.equal(torch.isnan(a), torch.isnan(b))
            a, b = a.nan_to_num(), b.nan_to_num()
        assert torch.equal(a, b)


def test_other_devices_raise():
    cam, pose, pts, nrm, rgb = _frame(37, 53)
    p, n = (torch.empty(37, 53, 3, device="meta") for _ in range(2))
    tpose = _tpose(pose)
    for fn in (lambda: tbrick._zeta_mip(p, n, cam, 0.15),
               lambda: tbrick._pixel_table(p, n, None, False),
               lambda: tbrick.frame_tables(p, n, None, False, cam, 0.15),
               lambda: tbrick.classify_bricks(PARAMS, tpose, p, n, cam, BS),
               lambda: tbm.classify_compact_rows(PARAMS, tpose, p, n, cam=cam, cfg=_cfg(0),
                                                 bs=BS, cap=8, cap_free=8)):
        with pytest.raises(ValueError, match="unsupported device"):
            fn()


def test_wrappers_reject_what_the_kernels_do_not_take():
    """The wrappers raise before any launch: CPU tensors (no plain fallback
    at this level), wrong dtypes and shapes, a mip without a camera."""
    cam, pose, pts, nrm, rgb = _frame(37, 53)
    p, n = _t(pts), _t(nrm)
    with pytest.raises(ValueError, match="unsupported device"):
        k567.frame_tables(p, n, None, cam=cam, delta=0.15)
    with pytest.raises(ValueError):
        k567.frame_tables(p.double(), n, None, cam=cam, delta=0.15)
    with pytest.raises(ValueError):
        k567.frame_tables(p[None], n, None, cam=cam, delta=0.15)
    with pytest.raises(ValueError):
        k567.frame_tables(p, n, None, cam=cam, delta=0.15, fuse_color=True)
    with pytest.raises(ValueError):
        k567.frame_tables(p, n, None, delta=0.15)  # the mip needs the camera
    with pytest.raises(ValueError):
        k567.frame_tables(p, n, None, cam=cam, mip=False, table=False)
    with pytest.raises(ValueError, match="unknown distance"):
        k567.frame_tables(p, n, None, cam=cam, distance="l1")
    mip = tbrick._zeta_mip_reference(p, n, cam, 0.15)
    tpose = _tpose(pose)
    R, base = tbrick._card_pose(tpose)
    geo = dict(params=PARAMS, cam=cam, hw=(37, 53), bs=BS, grid=(8, 8, 8))
    with pytest.raises(ValueError, match="unsupported device"):
        k567.classify_bricks(mip, R, base, **geo)
    with pytest.raises(ValueError):
        k567.classify_bricks(mip, R.double(), base, **geo)
    with pytest.raises(ValueError):
        k567.classify_bricks(mip, R, base, sat=torch.zeros(5, dtype=torch.bool), **geo)
    with pytest.raises(ValueError):
        k567.classify_children(mip, R, base, torch.zeros(3, dtype=torch.int64), factor=2,
                               **geo)
    with pytest.raises(ValueError):
        k567.classify_children(mip, R, base, torch.zeros(3, dtype=torch.int32), factor=3,
                               **geo)
    cls = torch.zeros(512, dtype=torch.uint8)
    with pytest.raises(ValueError, match="unsupported device"):
        k567.compact_lists(cls, None, 8, 8, 512)
    with pytest.raises(ValueError):
        k567.compact_lists(cls.to(torch.int32), None, 8, 8, 512)
    with pytest.raises(ValueError):
        k567.compact_lists(cls, torch.zeros(3, dtype=torch.bool), 8, 8, 512)
    with pytest.raises(ValueError):
        k567.compact_lists_hier(cls[:64], torch.zeros(64, dtype=torch.int32), None,
                                torch.zeros(1, dtype=torch.int64),
                                torch.zeros(4, dtype=torch.int64), cap=8, cap_free=8,
                                cap_mixed=8, grid=(8, 8, 8), factor=2)
    with pytest.raises(ValueError):
        k567._level_table((0,) * 30, ((1, 1),) * 30)
    # K7 packs its counts in 31 bits and indexes with C ints
    huge = torch.empty(2 ** 31, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="2\\^31"):
        k567.compact_lists(huge, None, 8, 8, 0)
    with pytest.raises(ValueError, match="2\\^31"):
        k567.compact_lists(cls, None, 2 ** 30, 2 ** 30, 512)
    with pytest.raises(ValueError, match="2\\^31"):
        k567.compact_lists_hier(huge, torch.empty(2 ** 31, dtype=torch.int32, device="meta"),
                                None, torch.zeros(1, dtype=torch.int32),
                                torch.zeros(4, dtype=torch.int64), cap=8, cap_free=8,
                                cap_mixed=2 ** 31, grid=(8, 8, 8), factor=1)
    with pytest.raises(ValueError):
        k567.compact_lists(cls, None, -1, 8, 512)


def test_compact_scratch_grows_outside_a_capture_only(monkeypatch):
    """K7's scratch: zeros, one status word a tile after the head, reused
    while large enough, grown to the largest tile count asked for with the
    older buffer kept alive (a captured graph may hold its address), and
    never grown inside a CUDA graph capture."""
    dev = torch.device("cpu")
    monkeypatch.setattr(k567, "_SCRATCH", {})
    a = k567.compact_scratch(dev, 3)
    assert a.dtype == torch.int64 and a.numel() == k567.SCRATCH_HEAD + 3 and not a.any()
    assert k567.compact_scratch(dev, 2) is a
    b = k567.compact_scratch(dev, 48)
    assert b.numel() == k567.SCRATCH_HEAD + 48 and k567._SCRATCH[dev] == [a, b]
    monkeypatch.setattr(k567, "_capturing", lambda d: True)
    assert k567.compact_scratch(dev, 48) is b
    with pytest.raises(RuntimeError, match="capture"):
        k567.compact_scratch(dev, 49)
    assert [k567.compact_tiles(n) for n in (0, 1, 2047, 2048, 2049, 32768, 98304)] == [
        1, 1, 1, 1, 2, 16, 48]


def test_kernel_constants_match_the_source(monkeypatch):
    """The wrappers' copies of csrc/brick_classify.cu's constants, and K6's
    choice of lanes a brick: whole warps a block; 8 lanes for tum512's 4,096
    supers and one for tum256's 32,768 bricks and the 98,304 children on the
    H100's 132 SMs, 8 exactly while a launch's threads stay within
    CLASSIFY_LANE_THREADS an SM; the wrapper hands that choice to the entry
    point (checked through a stand-in library)."""
    import re
    from pathlib import Path

    src = (Path(_build.CSRC) / "brick_classify.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert const["kCompactThreads"] * const["kFlagsPerThread"] == k567.COMPACT_TILE
    assert const["kScratchHead"] == k567.SCRATCH_HEAD
    assert const["kMaxLevels"] == k567.MAX_LEVELS and const["kTile"] == k567.TILE
    assert const["kClassifyThreads"] == k567.CLASSIFY_THREADS
    assert k567.CLASSIFY_THREADS % 32 == 0 and k567.CLASSIFY_THREADS <= 1024
    assert [k567.classify_lanes(n, 132) for n in (4096, 32768, 98304)] == [8, 1, 1]
    edge = 132 * k567.CLASSIFY_LANE_THREADS // 8
    assert [k567.classify_lanes(n, 132) for n in (1, edge, edge + 1, 10 ** 6)] == [8, 8, 1, 1]
    lib = _FakeLibrary()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(k567, "_check", lambda *a, **k: None)
    monkeypatch.setattr(k567, "_sm_count", lambda index: 132)
    h, w = 48, 64
    cam, pose, pts, nrm, _ = _frame(h, w)
    zm, _ = k567.frame_tables(_t(pts), _t(nrm), None, cam=cam, delta=0.15)
    R, base = torch.eye(3), torch.zeros(3)
    geo = dict(params=PARAMS, cam=cam, hw=(h, w))
    for grid, lanes in (((16, 16, 16), 8), ((32, 32, 32), 1)):
        k567.classify_bricks(zm, R, base, bs=BS, grid=grid, **geo)
        name, args = lib.calls[-1]
        assert name == "tsdf_classify_bricks" and len(args) == len(_build._SIGNATURES[name])
        assert args[-2] == lanes, grid
    k567.classify_children(zm, R, base, torch.zeros(600, dtype=torch.int32), bs=BS,
                           grid=(32, 32, 32), factor=4, **geo)
    assert lib.calls[-1][1][-2] == 1  # 38,400 children


class _FakeLibrary:
    """Records each entry point's arguments and returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.mark.parametrize("case", ["aligned", "w % 4", "offset"])
def test_wrappers_take_vector_loads_only_when_aligned(case, monkeypatch):
    """K5 asks for 16-byte loads only for w % 4 == 0 and 16-byte-aligned
    points, normals and rgb; K7 only for aligned flags (and ids); K7 gets
    its scratch with room for its tiles. The arguments are checked against
    the C signatures' order through a stand-in library."""
    lib = _FakeLibrary()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(k567, "_check", lambda *a, **k: None)
    monkeypatch.setattr(k567, "_SCRATCH", {})
    h, w = (37, 53) if case == "w % 4" else (48, 64)
    cam, _, pts, nrm, rgb = _frame(h, w)
    p, n, c = _t(pts), _t(nrm), _t(rgb)
    if case == "offset":
        p = torch.cat([torch.zeros(1), p.reshape(-1)])[1:].view(h, w, 3)
    assert p.is_contiguous() and k567.aligned16(p) == (case != "offset")
    k567.frame_tables(p, n, c, cam=cam, delta=0.15, fuse_color=True)
    name, args = lib.calls[-1]
    assert name == "tsdf_frame_tables" and len(args) == len(_build._SIGNATURES[name])
    assert args[12] == int(case == "aligned")  # vec, after channels
    n_flags = 5000 if case == "aligned" else 4099
    cls = torch.zeros(n_flags + 1, dtype=torch.uint8)
    cls = cls[1:] if case == "offset" else cls[:n_flags]
    k567.compact_lists(cls, None, 8, 8, n_flags)
    name, args = lib.calls[-1]
    assert name == "tsdf_compact_lists" and len(args) == len(_build._SIGNATURES[name])
    assert args[9] >= k567.compact_tiles(n_flags) == 3 and args[10] == int(case != "offset")
    k567.compact_lists_hier(cls[:4096], torch.zeros(4096, dtype=torch.int32), None,
                            torch.zeros(2, dtype=torch.int32), torch.zeros(4, dtype=torch.int64),
                            cap=8, cap_free=8, cap_mixed=64, grid=(16, 16, 16), factor=4)
    name, args = lib.calls[-1]
    assert name == "tsdf_compact_lists_hier" and len(args) == len(_build._SIGNATURES[name])
    assert args[20] >= 3 and args[21] == int(case != "offset")


def test_chunk_counts_the_classification_launches():
    """The chunk's replays add K5-K7's launches to their counters, and the
    multi-process worker records them."""
    import inspect

    from tracking_sdf_tpu_torch.parallel import worker
    from tracking_sdf_tpu_torch.pipeline import chunk

    names = {(mod.__name__, attr) for mod, attr in chunk._COUNTERS}
    src = inspect.getsource(worker)
    for attr in ("launches_tables", "launches_classify", "launches_compact"):
        assert (k567.__name__, attr) in names
        assert attr in src
