"""Port vs JAX package: the multi-device layer (tracking_sdf_tpu_torch.parallel
against tracking_sdf_tpu.parallel), with no process launched.

The slab functions take the slab's place (i0, slab) explicitly, so one
process runs them for every rank in turn; where a function issues
collectives, the ranks run as threads of this process over ``ThreadMesh``,
a test double of parallel.mesh.Mesh that exchanges tensors between the
threads. The JAX side runs on conftest's 8 virtual CPU devices
(``make_mesh(jax.devices()[:n])``), on the scenes of tests/test_parallel.py
at m = 48, for n = 2 and 4 ranks (and n = 1 for the sharded trackers).

Tolerances: fusion is voxel-local, so every sharded layout is bitwise equal
to the port's single-device fusion and within atol 1e-5 of the JAX
package's (its own sharded-vs-dense bar, tests/test_parallel.py:73-107);
K1's slab form sums to the unsharded normal equations within rtol 1e-5 /
atol 1e-4 (A) and atol 1e-5 (b), with equal valid counts (ownership
partitions the queries); tracked poses within 5e-5 of the JAX package's
sharded trackers (tests/test_parallel.py:111-135); the render bitwise and
the mesh triangle for triangle against the port's single-device functions
on the gathered grid.
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracking_sdf_tpu.config import (
    FusionConfig, GridParams, PipelineConfig, RaycastConfig, TrackingConfig)
from tracking_sdf_tpu.core.camera import PinholeCamera, backproject
from tracking_sdf_tpu.core.lie import pose_compose as jcompose
from tracking_sdf_tpu.core.lie import se3_exp as jse3_exp
from tracking_sdf_tpu.data.synthetic import (
    CuboidScene, SphereScene, grid_from_scene, look_at, render_scene_depth)
from tracking_sdf_tpu.fusion.brickmajor import brick_grid_from_dense as jbm_from_dense
from tracking_sdf_tpu.fusion.brickmajor import dense_from_brick_grid as jdense_from_bm
from tracking_sdf_tpu.fusion.fuse import fuse_frame as jfuse
from tracking_sdf_tpu.grid.grid import empty_grid as jempty_grid
from tracking_sdf_tpu.grid.interp import masked_view as jmasked_view
from tracking_sdf_tpu.parallel import make_mesh as jmake_mesh
from tracking_sdf_tpu.parallel import sharded as jsh
from tracking_sdf_tpu.parallel.mesh import shard_grid as jshard_grid
from tracking_sdf_tpu.tracking import estimate_normals, strided_points
from tracking_sdf_tpu_torch.core.lie import pose_from_numpy
from tracking_sdf_tpu_torch.fusion import brickmajor as tbm
from tracking_sdf_tpu_torch.fusion.brick import fuse_frame_bricked
from tracking_sdf_tpu_torch.fusion.brick_fuse import brick_fuse_rows_reference
from tracking_sdf_tpu_torch.fusion.fuse import fuse_frame
from tracking_sdf_tpu_torch.grid.grid import FIELDS, TSDFGrid, empty_grid, grid_from_numpy
from tracking_sdf_tpu_torch.grid.interp import BrickMaskedView, masked_view
from tracking_sdf_tpu_torch.parallel import render as prender
from tracking_sdf_tpu_torch.parallel import sharded as psh
from tracking_sdf_tpu_torch.parallel.mesh import Mesh, shard_brick_grid, shard_grid
from tracking_sdf_tpu_torch.pipeline.realtime import MultihostRealtimePacer
from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction
from tracking_sdf_tpu_torch.render.marching_cubes import (
    marching_cubes, marching_cubes_sharded)
from tracking_sdf_tpu_torch.render.raycast import raycast
from tracking_sdf_tpu_torch.tracking.gn_reduce import (
    advance_state, gn_reduce_reference, init_state, slab_stepper, state_pose, unpack)

torch.set_num_threads(1)

PARAMS = GridParams(m=48, width=2.0, height=2.0, depth=2.0,
                    origin=(-1.0, -1.0, -1.0), delta=0.15, epsilon=0.02)
CAM = PinholeCamera(fx=60.0, fy=60.0, cx=47.5, cy=35.5, width=96, height=72)
SCENE_A = SphereScene(center=(0.15, 0.1, 0.0), radius=0.4)
SCENE_B = CuboidScene(min_corner=(-0.75, -0.4, -0.55), max_corner=(-0.35, 0.4, 0.15))
TRUE_POSE = look_at((0.0, -1.5, 0.25), (0.0, 0.0, 0.0))
XI = [0.02, -0.015, 0.02, 0.01, -0.015, 0.01]
BS = (2, 8, 16)  # slab 24 / 12 voxels at n = 2 / 4: whole brick layers
ATOL = 1e-5
RANKS = (2, 4)


class TwoScenes:
    def sdf(self, x):
        return jnp.minimum(SCENE_A.sdf(x), SCENE_B.sdf(x))

    def color(self, x):
        return SCENE_A.color(x)

    def intersect(self, o, d):
        ta, tb = SCENE_A.intersect(o, d), SCENE_B.intersect(o, d)
        return jnp.where(jnp.isnan(ta), tb,
                         jnp.where(jnp.isnan(tb), ta, jnp.minimum(ta, tb)))


SCENE = TwoScenes()


# --- the ranks as threads -----------------------------------------------------

class _Hub:
    def __init__(self, n):
        self.n = n
        self.slots = [None] * n
        self.barrier = threading.Barrier(n, timeout=120)

    def exchange(self, rank, t):
        self.slots[rank] = t
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()
        return out


class ThreadMesh(Mesh):
    """Rank ``rank`` of n ranks that are threads of this process: each
    collective exchanges the ranks' tensors at a barrier."""

    def __init__(self, hub: _Hub, rank: int):
        super().__init__(group=None, size=hub.n, rank=rank, backend="threads",
                         device=torch.device("cpu"))
        self.hub = hub

    def all_reduce_(self, t):
        self.collectives += 1
        every = self.hub.exchange(self.rank, t.clone())
        acc = every[0].clone()
        for x in every[1:]:
            acc += x
        return t.copy_(acc)

    def all_gather(self, t):
        self.collectives += 1
        return torch.cat(self.hub.exchange(self.rank, t.clone()))

    def broadcast_(self, t, src=0):
        self.collectives += 1
        return t.copy_(self.hub.exchange(self.rank, t.clone())[src])

    def barrier(self):
        self.hub.exchange(self.rank, None)


def run_ranks(n, fn):
    """fn(mesh) on n threads, one per rank; their results in rank order."""
    hub = _Hub(n)
    out, errors = [None] * n, []

    def body(r):
        try:
            out[r] = fn(ThreadMesh(hub, r))
        except BaseException as e:  # re-raised below, after every thread ended
            errors.append(e)
            hub.barrier.abort()

    threads = [threading.Thread(target=body, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not any(t.is_alive() for t in threads)
    real = [e for e in errors if not isinstance(e, threading.BrokenBarrierError)]
    if errors:
        raise (real or errors)[0]
    return out


# --- inputs -------------------------------------------------------------------

@pytest.fixture(scope="module")
def frame():
    depth = render_scene_depth(SCENE, CAM, TRUE_POSE)
    pts = backproject(CAM, depth)
    normals = estimate_normals(pts)
    rgb = jnp.full(pts.shape, 0.5, dtype=jnp.float32)
    return np.asarray(pts), np.asarray(normals), np.asarray(rgb)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _tpose(p):
    return pose_from_numpy(p.R, p.t, device="cpu")


def _cat(grids):
    return TSDFGrid(*(torch.cat([getattr(g, k) for g in grids]) for k in FIELDS))


def _equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise, NaN equal to NaN."""
    return torch.equal(a.contiguous().view(torch.int16 if a.element_size() == 2
                                           else torch.int32),
                       b.contiguous().view(torch.int16 if b.element_size() == 2
                                           else torch.int32))


def _close(port: torch.Tensor, ref, atol=ATOL, mask=None):
    a, b = port.float().numpy(), np.asarray(ref, np.float32)
    if mask is not None:
        a, b = a[mask], b[mask]
    np.testing.assert_allclose(a, b, rtol=0, atol=atol)


# --- fusion -------------------------------------------------------------------

@pytest.mark.parametrize("n", RANKS)
def test_sharded_dense_fusion(n, frame):
    """Each rank's slab fused with its i_offset, concatenated: bitwise the
    port's single-device fusion; within 1e-5 of the JAX package's sharded
    fusion on n devices."""
    pts, nrm, rgb = (_t(x) for x in frame)
    pose = _tpose(TRUE_POSE)
    cfg = FusionConfig()
    one = fuse_frame(empty_grid(PARAMS, device="cpu"), pose, pts, nrm, rgb, params=PARAMS,
                     cam=CAM, cfg=cfg)
    slab = PARAMS.m // n
    parts = [fuse_frame(empty_grid(PARAMS, device="cpu", mi=slab), pose, pts, nrm, rgb,
                        params=PARAMS, cam=CAM, cfg=cfg, i_offset=r * slab)
             for r in range(n)]
    sh = _cat(parts)
    assert all(_equal(getattr(sh, k), getattr(one, k)) for k in FIELDS)

    mesh = jmake_mesh(jax.devices()[:n])
    g_j = jsh.sharded_fuse_frame(mesh, params=PARAMS, cam=CAM, cfg=cfg)(
        jshard_grid(jempty_grid(PARAMS), mesh), TRUE_POSE, *frame)
    for k in FIELDS:
        _close(getattr(sh, k), getattr(g_j, k))


@pytest.mark.parametrize("n", RANKS)
def test_sharded_bricked_fusion(n, frame):
    """Flat bricked fusion per slab (merge "xla", cap per rank, ids local):
    bitwise the single-device fusion, the FuseStats summed equal to its;
    D and W within 1e-5 of the JAX package's sharded_fuse_frame_bricked."""
    pts, nrm, _ = (_t(x) for x in frame)
    pose = _tpose(TRUE_POSE)
    cfg = FusionConfig(fuse_color=False, brick_shape=(1, 8, 16))
    one, st1 = fuse_frame_bricked(empty_grid(PARAMS, device="cpu"), pose, pts, nrm, None,
                                  params=PARAMS, cam=CAM, cfg=cfg, bs=cfg.brick_shape,
                                  cap=2048, merge="xla")
    slab = PARAMS.m // n
    runs = [fuse_frame_bricked(empty_grid(PARAMS, device="cpu", mi=slab), pose, pts, nrm,
                               None, params=PARAMS, cam=CAM, cfg=cfg, bs=cfg.brick_shape,
                               cap=1792 // n, merge="xla", i_offset=r * slab)
            for r in range(n)]
    sh = _cat([g for g, _ in runs])
    assert all(_equal(getattr(sh, k), getattr(one, k)) for k in FIELDS)
    assert sum(s.n_full for _, s in runs) == st1.n_full > 0
    assert sum(s.n_free for _, s in runs) == st1.n_free
    assert sum(s.overflow for _, s in runs) == 0

    mesh = jmake_mesh(jax.devices()[:n])
    g_j, st_j = jsh.sharded_fuse_frame_bricked(mesh, params=PARAMS, cam=CAM, cfg=cfg,
                                               cap=1792 // n)(
        jshard_grid(jempty_grid(PARAMS), mesh), TRUE_POSE, frame[0], frame[1])
    assert int(st_j.n_full) == st1.n_full
    _close(sh.W, g_j.W)
    _close(sh.D, g_j.D)


def _brickmajor_slabs(n, cfg, frame, cap, dtype=torch.float32):
    """Every rank's rows fused from empty with the slab form, and the summed
    counts."""
    pts, nrm, rgb = (_t(x) for x in frame)
    pose = _tpose(TRUE_POSE)
    slab = PARAMS.m // n
    rows, counts = [], 0
    for r in range(n):
        bg = tbm.empty_brick_grid(PARAMS, BS, device="cpu", value_dtype=dtype,
                                  nbi=slab // BS[0])
        counts = counts + psh.fuse_brickmajor_slab(
            bg, pose, pts, nrm, rgb, i0=r * slab, slab=slab, params=PARAMS, cam=CAM,
            cfg=cfg, bs=BS, cap=cap)
        rows.append(bg)
    return tbm.BrickGrid(*(torch.cat([getattr(b, k) for b in rows]) for k in "DWC")), counts


@pytest.mark.parametrize("hier", [False, True])
@pytest.mark.parametrize("n", RANKS)
def test_sharded_brickmajor_fusion(n, hier, frame):
    """K2's slab form (plain version) per rank, flat or hierarchical
    classification per slab: the rows concatenated are bitwise the
    single-device rows, the counts summed equal the single-device counts,
    and the dense view lies within 1e-5 of the JAX package's sharded
    brick-major fusion (geometry everywhere, color where fused)."""
    cfg = FusionConfig(fuse_color=True, brick_shape=BS)
    if hier:
        cfg = cfg._replace(hier_classify=3, cap_mixed=64)
    rows, counts = _brickmajor_slabs(n, cfg, frame, cap=768 // n)
    one = tbm.empty_brick_grid(PARAMS, BS, device="cpu")
    c1 = tbm.fuse_frame_brickmajor_core(one, _tpose(TRUE_POSE), *(_t(x) for x in frame),
                                        params=PARAMS, cam=CAM, cfg=cfg, bs=BS, cap=4096)
    for k in "DWC":
        assert _equal(getattr(rows, k), getattr(one, k)), k
    st, st1 = tbm.fuse_stats(counts.tolist()), tbm.fuse_stats(c1.tolist())
    assert (st.n_full, st.overflow, st.overflow_active, st.overflow_mixed) == (
        st1.n_full, 0, 0, 0) and st.n_full > 0

    mesh = jmake_mesh(jax.devices()[:n])
    fuse_j = jsh.sharded_fuse_frame_brickmajor(mesh, params=PARAMS, cam=CAM, cfg=cfg,
                                               cap=768 // n, emit_dm=False)
    bg_j, _, st_j = fuse_j(jsh.shard_brick_grid(jbm_from_dense(jempty_grid(PARAMS), BS),
                                                mesh), TRUE_POSE, *frame)
    assert int(st_j.n_full) == st.n_full
    g_j = jdense_from_bm(bg_j, PARAMS, BS)
    g = tbm.dense_from_brick_grid(rows, PARAMS, BS)
    _close(g.W, g_j.W)
    ok = np.asarray(g_j.W) > 0
    _close(g.D, g_j.D, mask=ok)
    okc = np.asarray(g_j.Wc) > 0
    assert okc.sum() > 100
    _close(g.R, g_j.R, mask=okc)


def test_k2_slab_form_is_the_whole_grid_form_on_its_rows(frame):
    """brick_fuse_rows_reference's slab form at i_offset 0 over the whole
    grid equals the whole-grid form bitwise; at a slab's i_offset on the
    slab's rows (local ids) it equals the whole-grid form run on the same
    bricks by global id, row for row."""
    from tracking_sdf_tpu_torch.fusion.brick import _pixel_table

    cfg = FusionConfig(fuse_color=True, brick_shape=BS)
    base, _ = _brickmajor_slabs(1, cfg, frame, cap=4096, dtype=torch.bfloat16)
    pose = _tpose(jcompose(jse3_exp(jnp.asarray([0.01, 0.0, -0.01, 0.005, 0.0, 0.01])),
                           TRUE_POSE))
    pts, nrm, rgb = (_t(x) for x in frame)
    pix = _pixel_table(pts, nrm, rgb, True, cfg.distance)
    kw = dict(hw=pts.shape[:2], params=PARAMS, cam=CAM, cfg=cfg, bs=BS)
    n, cap = 2, 256
    slab = PARAMS.m // n
    layer_rows = base.D.shape[0] // n
    for r in range(n):
        ids, _ = tbm.classify_compact_rows(PARAMS, pose, pts, nrm, cam=CAM, cfg=cfg, bs=BS,
                                           cap=cap, cap_free=cap, nbi=slab // BS[0],
                                           i_offset=r * slab)
        sl = slice(r * layer_rows, (r + 1) * layer_rows)
        part = tbm.BrickGrid(*(getattr(base, k)[sl].clone() for k in "DWC"))
        brick_fuse_rows_reference(part.D, part.W, part.C, ids, pix, pose, cap=cap,
                                  i_offset=r * slab, **kw)
        whole = tbm.BrickGrid(*(getattr(base, k).clone() for k in "DWC"))
        gids = torch.where(ids < layer_rows, ids + r * layer_rows, base.D.shape[0]).int()
        brick_fuse_rows_reference(whole.D, whole.W, whole.C, gids, pix, pose, cap=cap, **kw)
        for k in "DWC":
            assert _equal(getattr(part, k), getattr(whole, k)[sl]), (r, k)
    a = tbm.BrickGrid(*(getattr(base, k).clone() for k in "DWC"))
    b = tbm.BrickGrid(*(getattr(base, k).clone() for k in "DWC"))
    ids, _ = tbm.classify_compact_rows(PARAMS, pose, pts, nrm, cam=CAM, cfg=cfg, bs=BS,
                                       cap=cap, cap_free=cap)
    brick_fuse_rows_reference(a.D, a.W, a.C, ids, pix, pose, cap=cap, **kw)
    brick_fuse_rows_reference(b.D, b.W, b.C, ids, pix, pose, cap=cap, i_offset=0, **kw)
    for k in "DWC":
        assert _equal(getattr(a, k), getattr(b, k))


# --- tracking -----------------------------------------------------------------

def _views(form, n, frame):
    """(port views per rank with their halo, JAX input, the kind of JAX
    tracker, the unsharded port view): the dense grid of the scene (W) for "dense",
    the masked dense view of a fused grid for "masked", its brick-major D
    rows for "brick"."""
    slab = PARAMS.m // n
    nan = torch.full((1, PARAMS.m, PARAMS.m), float("nan"))
    if form == "dense":
        g_j = grid_from_scene(PARAMS, SCENE)
        Dm = masked_view(*(torch.from_numpy(np.array(x, np.float32)) for x in (g_j.D, g_j.W)))
    else:
        g_j = jfuse(jempty_grid(PARAMS), TRUE_POSE, *frame, params=PARAMS, cam=CAM,
                    cfg=FusionConfig())
        Dm = masked_view(*(torch.from_numpy(np.array(x, np.float32)) for x in (g_j.D, g_j.W)))
    if form == "brick":
        rows = tbm.brick_grid_from_dense(grid_from_numpy(g_j._asdict(), device="cpu"), BS).D
        layer = rows.shape[0] // (PARAMS.m // BS[0])
        per = rows.shape[0] // n
        views = [BrickMaskedView(torch.cat([rows[r * per:(r + 1) * per],
                                            rows[(r + 1) * per:(r + 1) * per + layer]
                                            if r < n - 1 else
                                            torch.full((layer, rows.shape[1]), float("nan"))]),
                                 PARAMS.m, BS, mi=slab + BS[0]) for r in range(n)]
        return views, jbm_from_dense(g_j, BS).D, "brick", BrickMaskedView(rows, PARAMS.m, BS)
    views = [torch.cat([Dm[r * slab:(r + 1) * slab],
                        Dm[(r + 1) * slab:(r + 1) * slab + 1] if r < n - 1 else nan])
             for r in range(n)]
    return views, (g_j if form == "dense" else jmasked_view(g_j.D, g_j.W)), form, Dm


@pytest.mark.parametrize("form", ["dense", "masked", "brick"])
@pytest.mark.parametrize("n", (1,) + RANKS)
def test_k1_slab_form_and_sharded_trackers(n, form, frame):
    """K1's slab form (plain version) per rank: the slabs' valid counts add
    up to the unsharded count exactly and their sums to the unsharded A, b;
    the slab-summed Gauss-Newton loop by hand, the ranks' slab steppers
    (``slab_stepper``'s plain path: every rank's state bit for bit the
    loop's) and the port's sharded tracker (ranks as threads) land within
    5e-5 of the JAX package's sharded tracker with its valid count."""
    views, j_in, kind, whole = _views(form, n, frame)
    slab = PARAMS.m // n
    depth = render_scene_depth(SCENE, CAM, TRUE_POSE)
    pts_np = np.asarray(strided_points(backproject(CAM, depth), 2))
    pts = _t(pts_np)
    pose0_j = jcompose(jse3_exp(jnp.asarray(XI, jnp.float32)), TRUE_POSE)
    pose0 = _tpose(pose0_j)
    sums = [gn_reduce_reference(v, pose0, pts, PARAMS, i0=r * slab, slab=slab)
            for r, v in enumerate(views)]
    ref = gn_reduce_reference(whole, pose0, pts, PARAMS)
    total = torch.stack(sums).sum(0)
    assert int(total[27]) == int(ref[27]) > 100
    np.testing.assert_allclose(total[:21].numpy(), ref[:21].numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(total[21:27].numpy(), ref[21:27].numpy(), atol=1e-5)

    tcfg = TrackingConfig(jacobian="analytic", max_iterations=30)
    mesh_j = jmake_mesh(jax.devices()[:n])
    if kind == "dense":
        r_j = jsh.sharded_track_frame(mesh_j, params=PARAMS, cfg=tcfg)(
            jshard_grid(j_in, mesh_j), pose0_j, jnp.asarray(pts_np))
    elif kind == "masked":
        r_j = jsh.sharded_track_frame_masked(mesh_j, params=PARAMS, cfg=tcfg)(
            j_in, pose0_j, jnp.asarray(pts_np))
    else:
        r_j = jsh.sharded_track_frame_brickmajor(mesh_j, params=PARAMS, cfg=tcfg, bs=BS)(
            j_in, pose0_j, jnp.asarray(pts_np))

    # the loop by hand: slab sums added, then one shared step
    state = init_state(pose0, tcfg.damping)
    for _ in range(tcfg.max_iterations):
        out = torch.stack([gn_reduce_reference(v, state, pts, PARAMS, i0=r * slab,
                                               slab=slab) for r, v in enumerate(views)]
                          ).sum(0)
        advance_state(state, *unpack(out), tcfg)
    by_hand = state_pose(state)

    # the ranks' slab steppers in this process, the sums added alike
    states = [init_state(pose0, tcfg.damping) for _ in range(n)]
    steppers = [slab_stepper(v, states[r], pts, PARAMS, tcfg, i0=r * slab, slab=slab)
                for r, v in enumerate(views)]
    for _ in range(tcfg.max_iterations):
        total = torch.stack([reduce() for reduce, _ in steppers]).sum(0)
        for _, finish in steppers:
            finish(total)
    for s in states:
        assert _equal(s, state)

    def track(mesh):
        if kind == "dense":
            g = grid_from_numpy(j_in._asdict(), device="cpu", mesh=mesh)
            return psh.sharded_track_frame(mesh, params=PARAMS, cfg=tcfg)(g, pose0, pts)
        if kind == "masked":
            Dm = torch.from_numpy(np.array(j_in, np.float32))[mesh.rows(PARAMS.m)]
            return psh.sharded_track_frame_masked(mesh, params=PARAMS, cfg=tcfg)(
                Dm.contiguous(), pose0, pts)
        rows = torch.from_numpy(np.array(j_in, np.float32))[mesh.rows(j_in.shape[0])]
        return psh.sharded_track_frame_brickmajor(mesh, params=PARAMS, cfg=tcfg, bs=BS)(
            rows, pose0, pts)

    results = run_ranks(n, track)
    reads = [r.read() for r in results]
    assert all(torch.equal(r.state, results[0].state) for r in results)  # every rank alike
    assert reads[0].num_valid == int(r_j.num_valid)
    for pose in (reads[0].pose, by_hand):
        np.testing.assert_allclose(pose.t.numpy(), np.asarray(r_j.pose.t), atol=5e-5)
        np.testing.assert_allclose(pose.R.numpy(), np.asarray(r_j.pose.R), atol=5e-5)


# --- render and mesh ----------------------------------------------------------

@pytest.fixture(scope="module")
def fused(frame):
    pts, nrm, _ = (_t(x) for x in frame)
    rgb = torch.stack([torch.full(pts.shape[:2], v) for v in (0.6, 0.3, 0.2)], -1)
    return fuse_frame(empty_grid(PARAMS, device="cpu"), _tpose(TRUE_POSE), pts, nrm, rgb,
                      params=PARAMS, cam=CAM, cfg=FusionConfig())


def _same_render(a, b):
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        if x is None or name == "dropped":
            continue
        assert (torch.equal(x, y) if x.dtype in (torch.bool, torch.int32)
                else _equal(x, y)), name


@pytest.mark.parametrize("n", RANKS)
def test_sharded_raycast_is_the_single_device_render(n, fused):
    """Rays interleaved over the ranks, one gather of the leaves each: the
    image equals raycast() of the whole grid bitwise, with and without
    color (and the chamfer leap), on every rank."""
    pose = _tpose(look_at((0.1, -1.7, 0.5), (0.0, 0.0, 0.0)))
    for with_color, cfg in ((False, RaycastConfig()),
                            (True, RaycastConfig(far_field="chamfer"))):
        one = raycast(fused, pose, params=PARAMS, cam=CAM, cfg=cfg, with_color=with_color)
        outs = run_ranks(n, lambda mesh: prender.sharded_raycast(
            mesh, params=PARAMS, cam=CAM, cfg=cfg, with_color=with_color)(
                shard_grid(fused, mesh), pose))
        for out in outs:
            _same_render(out, one)
            assert int(out.dropped) == int(one.dropped) == 0
        assert int(one.hit.sum()) > 300


def test_padding_rays_start_dead(fused, monkeypatch):
    """R2, not copied: the rays that pad the image to an even split never
    march, so they can never count as dropped. 3 ranks over a 47x35 image
    (1,645 rays, 2 padding rays); every padding ray's direction is NaN and
    it takes no step and hits nothing."""
    seen = []
    real = prender.raycast

    def spy(grid, pose, **kw):
        res = real(grid, pose, **kw)
        seen.append((kw["dirs_cam"], res))
        return res

    monkeypatch.setattr(prender, "raycast", spy)
    cam = CAM._replace(width=47, height=35, cx=23.0, cy=17.0)
    pose = _tpose(TRUE_POSE)
    cfg = RaycastConfig(two_phase="on")
    one = raycast(fused, pose, params=PARAMS, cam=cam, cfg=cfg)
    outs = run_ranks(3, lambda mesh: prender.sharded_raycast(
        mesh, params=PARAMS, cam=cam, cfg=cfg)(shard_grid(fused, mesh), pose))
    pad = [(res.steps[0][torch.isnan(d[0, :, 0])], res.hit[0][torch.isnan(d[0, :, 0])])
           for d, res in seen]
    assert sum(s.numel() for s, _ in pad) == 2
    assert all(int(s.sum()) == 0 and not bool(h.any()) for s, h in pad)
    _same_render(outs[0], one)
    assert int(outs[0].dropped) == int(one.dropped)


@pytest.mark.parametrize("n", RANKS)
def test_sharded_marching_cubes_is_the_single_device_mesh(n, fused):
    """Each rank meshes its slab with the next rank's first plane: the
    ranks' triangles in rank order equal marching_cubes of the whole grid,
    triangle for triangle, colors too."""
    ref = marching_cubes(fused, params=PARAMS, with_colors=True)
    assert ref.num_triangles > 300
    parts = run_ranks(n, lambda mesh: marching_cubes_sharded(
        shard_grid(fused, mesh), mesh, params=PARAMS, with_colors=True))
    assert sum(p.dropped_cells for p in parts) == 0
    np.testing.assert_array_equal(np.concatenate([p.vertices for p in parts]), ref.vertices)
    np.testing.assert_array_equal(np.concatenate([p.colors for p in parts]), ref.colors)


# --- the runner ---------------------------------------------------------------

def _orbit(k):
    ang = 0.05 * k
    return look_at((1.5 * np.sin(ang), -1.5 * np.cos(ang), 0.25), (0.0, 0.0, 0.0))


@pytest.fixture(scope="module")
def orbit():
    return [np.asarray(render_scene_depth(SCENE, CAM, _orbit(k))) for k in range(6)]


def _runner_cfg(**fusion):
    return PipelineConfig(grid=PARAMS, tracking=TrackingConfig(max_iterations=20),
                          fusion=FusionConfig(mode="brickmajor", brick_shape=BS,
                                              brick_cap=768, brick_cap_free=768,
                                              **fusion),
                          trajectory_path=None, bilateral_filter=False)


def test_sharded_runner_per_frame_chunked_and_checkpoint(orbit, tmp_path):
    """Reconstruction(mesh=...) on 2 ranks: every rank holds the same pose
    bit for bit; a chunk equals the per-frame loop bit for bit (poses, rows,
    stats); a checkpoint saved by the ranks and restored into a new mesh
    run and into a single-device run gives the same rows; a one-rank mesh
    equals the single-device runner without a pyramid bit for bit."""
    cfg = _runner_cfg(storage_dtype="bfloat16", fuse_color=True, color_every=2)
    rgb = np.full(orbit[0].shape + (3,), 0.5, np.float32)
    pose0 = _tpose(_orbit(0))
    ck = str(tmp_path / "ck")

    def run(mesh, chunk):
        r = Reconstruction(CAM, cfg, initial_pose=pose0, mesh=mesh)
        r.process_frame(orbit[0], rgb, timestamp=0.0)
        if chunk:
            stats = r.process_chunk(np.stack(orbit[1:]), np.stack([rgb] * 5))
        else:
            stats = [r.process_frame(d, rgb, timestamp=float(k))
                     for k, d in enumerate(orbit[1:], 1)]
        if chunk:
            r.save_checkpoint(ck)
            back = Reconstruction(CAM, cfg, initial_pose=pose0, mesh=mesh)
            back.restore_checkpoint(ck)
            assert all(_equal(getattr(back.brick_grid, k), getattr(r.brick_grid, k))
                       for k in "DWC")
        return (r.pose, r.brick_grid, [(s.num_valid, s.gn_iterations) for s in stats],
                r.mesh.collectives)

    per = run_ranks(2, lambda m: run(m, False))
    chk = run_ranks(2, lambda m: run(m, True))
    for a, b in zip(per, chk):
        assert _equal(a[0].t, per[0][0].t) and _equal(a[0].R, per[0][0].R)
        assert _equal(b[0].t, a[0].t) and _equal(b[0].R, a[0].R)
        assert all(_equal(getattr(a[1], k), getattr(b[1], k)) for k in "DWC")
        assert a[2] == b[2]
    # frame 0 fuses (the counts' all_reduce); a tracked frame adds the halo
    # and one all_reduce a GN iteration (the CPU loop stops at the done flag)
    assert per[0][3] == 1 + sum(2 + it for _, it in per[0][2])
    single = Reconstruction(CAM, cfg, initial_pose=pose0, device="cpu")
    single.restore_checkpoint(ck)
    whole = tbm.BrickGrid(*(torch.cat([getattr(c[1], k) for c in chk]) for k in "DWC"))
    assert all(_equal(getattr(single.brick_grid, k), getattr(whole, k)) for k in "DWC")

    one = run_ranks(1, lambda m: run(m, False))[0]
    ref = Reconstruction(CAM, cfg, initial_pose=pose0, device="cpu")
    for k, d in enumerate(orbit):
        ref.process_frame(d, rgb, timestamp=float(k))
    assert _equal(one[0].t, ref.pose.t) and _equal(one[0].R, ref.pose.R)
    assert all(_equal(getattr(one[1], k), getattr(ref.brick_grid, k)) for k in "DWC")


# --- the multihost pacer ------------------------------------------------------

def test_multihost_pacer_follower_rebuilds_the_drops():
    """A follower's drop count comes from the gaps between the broadcast
    indices: the scripted stream 0 1 2 5 6 9 yields 6 frames, drops 4."""
    pacer = MultihostRealtimePacer(list(range(10)), _one_rank(), hz=30.0)
    got = list(pacer.follow(iter([0, 1, 2, 5, 6, 9])))
    assert got == [0, 1, 2, 5, 6, 9]
    assert (pacer.yielded, pacer.dropped) == (6, 4)


def _one_rank():
    return Mesh(group=None, size=1, rank=0, backend="threads", device=torch.device("cpu"))


def test_multihost_pacer_ranks_run_the_same_frames():
    """Rank 0's clock (a slow consumer at 200 Hz) decides; the other ranks
    receive every index: all deliver the same frames and count the same
    drops, and yielded + dropped covers the stream."""
    import time

    def run(mesh):
        pacer = MultihostRealtimePacer(list(range(24)), mesh, hz=200.0)
        got = []
        for f in pacer:
            got.append(f)
            time.sleep(0.012)
        return got, pacer.yielded, pacer.dropped

    outs = run_ranks(3, run)
    assert all(o == outs[0] for o in outs)
    frames, yielded, dropped = outs[0]
    assert dropped > 0 and yielded + dropped == 24 and frames[:2] == [0, 1]


@pytest.mark.parametrize("mode", ["dense", "bricked", "packed"])
def test_sharded_runner_flat_layouts_match_the_jax_mesh(mode, orbit):
    """Reconstruction(mesh=...) in the flat layouts on 2 ranks (dense slabs;
    "packed" runs as sharded bricked with (1, 8, 48) bricks) against the JAX
    package's runner on a 2-device mesh over 4 frames: pose within 1e-4, W
    within 1e-3 and D within 1e-3 where observed (tests/test_parallel.py's
    runner bars)."""
    from tracking_sdf_tpu.pipeline import Reconstruction as JReconstruction

    fusion = FusionConfig(mode=mode, brick_shape=(2, 8, 16), brick_cap=768,
                          fuse_color=False)
    cfg = PipelineConfig(grid=PARAMS, tracking=TrackingConfig(max_iterations=20),
                         fusion=fusion, trajectory_path=None, bilateral_filter=False)
    pose0 = _orbit(0)

    def run(mesh):
        r = Reconstruction(CAM, cfg, initial_pose=_tpose(pose0), mesh=mesh)
        for k in range(4):
            st = r.process_frame(orbit[k], timestamp=float(k))
            assert not st.rejected
        return r.pose, r.grid, r.config.fusion

    outs = run_ranks(2, run)
    assert all(_equal(o[0].t, outs[0][0].t) for o in outs)
    pose, grid, f = outs[0]
    assert f.mode == ("bricked" if mode == "packed" else mode)
    j = JReconstruction(CAM, cfg, initial_pose=pose0, mesh=jmake_mesh(jax.devices()[:2]))
    for k in range(4):
        j.process_frame(orbit[k], timestamp=float(k))
    np.testing.assert_allclose(pose.t.numpy(), np.asarray(j.pose.t), atol=1e-4)
    _close(grid.W, j.grid.W, atol=1e-3)
    _close(grid.D, j.grid.D, atol=1e-3, mask=np.asarray(j.grid.W) > 0)


def test_mesh_publisher_under_a_mesh(orbit, tmp_path):
    """--mesh-async under a mesh: the ranks snapshot (a gather) at the same
    frames, only rank 0 runs a publisher and writes the PLY, and the ranks
    issue the same number of collectives."""
    cfg = dataclasses.replace(_runner_cfg(fuse_color=False), mesh_hz=30.0)
    ply = tmp_path / "live.ply"

    def run(mesh):
        r = Reconstruction(CAM, cfg, initial_pose=_tpose(_orbit(0)), mesh=mesh)
        pub = r.start_mesh_publisher(str(ply), with_colors=False)
        for k in range(3):
            r.process_frame(orbit[k], timestamp=float(k))
        snapshot_at = r._last_publish_frame
        r.close()
        return pub is not None, pub.published if pub else 0, snapshot_at, mesh.collectives

    outs = run_ranks(2, run)
    assert [o[0] for o in outs] == [True, False]
    assert outs[0][1] >= 1 and outs[0][2] == outs[1][2] == 3  # a snapshot each frame
    assert outs[0][3] == outs[1][3]
    assert ply.exists() and ply.stat().st_size > 1000


def test_sharded_step_and_emitted_view_match_the_jax_mesh(frame):
    """make_sharded_step (track on dense slabs, then fuse) against the JAX
    package's on 2 devices from the scene's grid: pose within 5e-5, the
    fused grid within 1e-5. Brick-major fusion with ``emit_dm``: the emitted
    slab is the masked dense view of the rank's rows, and the masked tracker
    on it lands where the zero-relayout tracker on the rows does."""
    pts, nrm, rgb = frame
    pose0_j = jcompose(jse3_exp(jnp.asarray([0.01, -0.01, 0.01, 0.005, -0.005, 0.005],
                                            jnp.float32)), TRUE_POSE)
    grid0 = grid_from_scene(PARAMS, SCENE)
    mesh_j = jmake_mesh(jax.devices()[:2])
    g_j, pose_j, _ = jsh.make_sharded_step(mesh_j, params=PARAMS, cam=CAM)(
        jshard_grid(grid0, mesh_j), pose0_j, pts, nrm, rgb)
    tcfg = TrackingConfig(jacobian="analytic", max_iterations=30)
    cfg = FusionConfig(fuse_color=False, brick_shape=BS)

    def run(mesh):
        step = psh.make_sharded_step(mesh, params=PARAMS, cam=CAM)
        g, pose, res = step(grid_from_numpy(grid0._asdict(), device="cpu", mesh=mesh),
                            _tpose(pose0_j), _t(pts), _t(nrm), _t(rgb))
        fuse = psh.sharded_fuse_frame_brickmajor(mesh, params=PARAMS, cam=CAM, cfg=cfg,
                                                 cap=384, emit_dm=True)
        bg = tbm.empty_brick_grid(PARAMS, BS, device="cpu", nbi=PARAMS.m // 2 // BS[0])
        bg, Dm, st = fuse(bg, _tpose(TRUE_POSE), _t(pts), _t(nrm))
        dense = tbm.dense_from_brick_grid(bg, PARAMS, BS)
        xi = _tpose(jcompose(jse3_exp(jnp.asarray(XI, jnp.float32)), TRUE_POSE))
        q = _t(pts)[::2, ::2]
        a = psh.sharded_track_frame_masked(mesh, params=PARAMS, cfg=tcfg)(Dm, xi, q).read()
        b = psh.sharded_track_frame_brickmajor(mesh, params=PARAMS, cfg=tcfg, bs=BS)(
            bg.D, xi, q).read()
        return g, pose, res.read().iterations, Dm, masked_view(dense.D, dense.W), a, b, st

    outs = run_ranks(2, run)
    g = _cat([o[0] for o in outs])
    for k in FIELDS:
        _close(getattr(g, k), getattr(g_j, k))
    np.testing.assert_allclose(outs[0][1].t.numpy(), np.asarray(pose_j.t), atol=5e-5)
    assert outs[0][2] >= 1 and outs[0][7].n_full > 0 and outs[0][7].overflow == 0
    for o in outs:
        assert _equal(o[3], o[4])  # the emitted view is the rows' masked view
        a, b = o[5], o[6]
        assert a.num_valid == b.num_valid
        np.testing.assert_allclose(a.pose.t.numpy(), b.pose.t.numpy(), atol=5e-5)
