"""Sharded tracking and fusion over a Mesh (counterpart of
tracking_sdf_tpu.parallel.sharded).

Every rank holds one i-slab of the grid (parallel.mesh) and runs the same
program on it:

* **Fusion** is slab-local: each rank fuses its own voxels (the dense and
  flat bricked layouts) or classifies, compacts and merges its own bricks
  (brick-major: K2's slab form, one launch a fused frame), with the image
  replicated. The only collective is the all_reduce of the FuseStats
  counts. Caps are per rank: ``max(256, cap // n)``.
* **Tracking** answers each query on the rank that owns its base voxel
  (floor of its global i coordinate). One collective per frame fetches the
  next rank's first plane (dense) or first brick layer (brick-major, nbj·nbk
  rows) as a halo, so that a trilinear stencil that straddles the boundary
  is local; the last rank's halo is unobserved (NaN). Each Gauss-Newton
  iteration is ``gn_reduce.slab_stepper``'s: K1's slab form (one launch;
  the pose read from the state on the device), one all_reduce of its 29
  sums, and ``gn_finish`` (one launch: the solve, test and update of K1's
  step) on every rank, so every rank holds the same state bit for bit. A
  level issues ``max_iterations`` iterations and the done flag freezes the
  state, with no host read (on the CPU, where the plain versions run, the
  loop stops at the flag, which every rank reads alike). No pyramid: the
  tracker runs one level at ``pixel_stride``, as the JAX package's sharded
  path.

The slab functions take the slab's place (i0, slab) explicitly, so one
process can run them for every rank in turn (the CPU tests do).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from tracking_sdf_tpu_torch.config import FusionConfig, GridParams, TrackingConfig
from tracking_sdf_tpu_torch.core.camera import PinholeCamera
from tracking_sdf_tpu_torch.core.lie import Pose
from tracking_sdf_tpu_torch.fusion.brick import FuseStats, fuse_frame_bricked
from tracking_sdf_tpu_torch.fusion.brickmajor import (
    BrickGrid, _from_rows, fuse_frame_brickmajor_core, fuse_stats)
from tracking_sdf_tpu_torch.fusion.fuse import fuse_frame
from tracking_sdf_tpu_torch.grid.grid import TSDFGrid
from tracking_sdf_tpu_torch.grid.interp import BrickMaskedView, MaskedView, masked_view
from tracking_sdf_tpu_torch.parallel.mesh import Mesh
from tracking_sdf_tpu_torch.tracking.gauss_newton import TrackResult
from tracking_sdf_tpu_torch.tracking.gn_reduce import S_DONE, init_state, slab_stepper

_NAN = float("nan")


def _check_tracking(cfg: TrackingConfig) -> None:
    if cfg.jacobian != "analytic":
        raise ValueError("sharded tracking supports jacobian='analytic' only")


def track_slab(view: MaskedView, pose0: Pose, points: torch.Tensor, *, i0: int,
               slab: int, params: GridParams, cfg: TrackingConfig,
               mesh: Mesh) -> TrackResult:
    """The Gauss-Newton loop of one rank: ``view`` holds global planes
    [i0, i0 + mi) (its slab and the halo), ``points`` (N, 3) the queries.
    Each iteration sums the owned queries' normal equations (K1's slab form
    on the card), all-reduces them over ``mesh`` and finishes the step on
    them (``gn_finish`` on the card), all on the current stream."""
    state = init_state(pose0, cfg.damping)
    reduce, finish = slab_stepper(view, state, points, params, cfg, i0=i0, slab=slab)
    ints = state.view(torch.int32)
    on_cpu = view.device.type == "cpu"
    for _ in range(cfg.max_iterations):
        finish(mesh.all_reduce_(reduce()))
        if on_cpu and bool(ints[S_DONE]):  # the same flag on every rank
            break
    return TrackResult(state)


def _flat_points(points: torch.Tensor, cfg: TrackingConfig) -> torch.Tensor:
    """(N, 3) queries: an (H, W, 3) image at ``pixel_stride``, or (N, 3)."""
    if points.dim() == 3:
        s = cfg.pixel_stride
        points = points[::s, ::s]
    return points.reshape(-1, 3)


def sharded_track_frame(mesh: Mesh, *, params: GridParams,
                        cfg: TrackingConfig = TrackingConfig()):
    """fn(grid_slab, pose, points) -> TrackResult, the same on every rank:
    tracking against this rank's dense (slab, m, m) TSDFGrid slab, the halo
    the next rank's first plane of the masked view. ``points``: (N, 3)
    queries, or the (H, W, 3) point image (taken at ``pixel_stride``)."""
    _check_tracking(cfg)
    slab = mesh.slab(params.m)

    def fn(grid: TSDFGrid, pose: Pose, points: torch.Tensor) -> TrackResult:
        Dm = masked_view(grid.D, grid.W)
        view = torch.cat([Dm, mesh.next_first(Dm[:1], _NAN)])
        return track_slab(view, pose, _flat_points(points, cfg), i0=mesh.i0(params.m),
                          slab=slab, params=params, cfg=cfg, mesh=mesh)

    return fn


def sharded_track_frame_masked(mesh: Mesh, *, params: GridParams,
                               cfg: TrackingConfig = TrackingConfig()):
    """fn(Dm_slab, pose, points) -> TrackResult: as sharded_track_frame on a
    pre-masked (slab, m, m) view (NaN where unobserved; what sharded
    brick-major fusion emits with ``emit_dm``)."""
    _check_tracking(cfg)
    slab = mesh.slab(params.m)

    def fn(Dm: torch.Tensor, pose: Pose, points: torch.Tensor) -> TrackResult:
        view = torch.cat([Dm, mesh.next_first(Dm[:1], _NAN)])
        return track_slab(view, pose, _flat_points(points, cfg), i0=mesh.i0(params.m),
                          slab=slab, params=params, cfg=cfg, mesh=mesh)

    return fn


def brick_slab_view(D_rows: torch.Tensor, halo: torch.Tensor, params: GridParams,
                    bs: Tuple[int, int, int]) -> BrickMaskedView:
    """The slab-local view of a rank's D rows and the halo brick layer."""
    slab = D_rows.shape[0] // ((params.m // bs[1]) * (params.m // bs[2])) * bs[0]
    return BrickMaskedView(torch.cat([D_rows, halo]), params.m, bs, mi=slab + bs[0])


def sharded_track_frame_brickmajor(mesh: Mesh, *, params: GridParams,
                                   cfg: TrackingConfig = TrackingConfig(),
                                   bs: Tuple[int, int, int] = (8, 8, 8)):
    """fn(D_rows, pose, points) -> TrackResult: tracking straight off this
    rank's brick-major D rows (NaN where unobserved), the zero-relayout
    tracker. The halo is the next rank's first brick layer (nbj·nbk rows,
    bi planes, of which only the first is addressed), so the view spans
    slab + bi planes."""
    _check_tracking(cfg)
    slab = mesh.slab(params.m)
    if slab % bs[0]:
        raise ValueError(f"slab {slab} not divisible by brick i-extent {bs[0]}")
    layer = (params.m // bs[1]) * (params.m // bs[2])

    def fn(D_rows: torch.Tensor, pose: Pose, points: torch.Tensor) -> TrackResult:
        view = brick_slab_view(D_rows, mesh.next_first(D_rows[:layer], _NAN), params, bs)
        return track_slab(view, pose, _flat_points(points, cfg), i0=mesh.i0(params.m),
                          slab=slab, params=params, cfg=cfg, mesh=mesh)

    return fn


def sharded_fuse_frame(mesh: Mesh, *, params: GridParams, cam: PinholeCamera,
                       cfg: FusionConfig = FusionConfig()):
    """fn(grid_slab, pose, points, normals, rgb=None) -> grid_slab: dense
    fusion of this rank's voxels, no collective."""
    mesh.slab(params.m)

    def fn(grid: TSDFGrid, pose: Pose, points, normals, rgb=None) -> TSDFGrid:
        return fuse_frame(grid, pose, points, normals, rgb, params=params, cam=cam,
                          cfg=cfg, i_offset=mesh.i0(params.m))

    return fn


def slab_caps(mesh: Mesh, params: GridParams, cfg: FusionConfig, bs=None,
              cap: Optional[int] = None) -> Tuple[int, Tuple[int, int, int], int]:
    """(slab, bs, cap): the rank's planes, the brick shape (default the
    config's) and the FULL cap per rank (default max(256, brick_cap // n))."""
    slab = mesh.slab(params.m)
    bs = tuple(bs if bs is not None else cfg.brick_shape)
    if slab % bs[0]:
        raise ValueError(f"slab {slab} not divisible by brick i-extent {bs[0]}")
    return slab, bs, cap if cap is not None else max(256, cfg.brick_cap // mesh.size)


def sharded_fuse_frame_bricked(mesh: Mesh, *, params: GridParams, cam: PinholeCamera,
                               cfg: FusionConfig = FusionConfig(), bs=None,
                               cap: Optional[int] = None):
    """fn(grid_slab, pose, points, normals, rgb=None) -> (grid_slab,
    FuseStats summed over the ranks): each rank classifies, compacts and
    merges its own bricks (``fuse_frame_bricked`` with merge "xla" and its
    i_offset). ``cap`` is per rank."""
    slab, bs, cap = slab_caps(mesh, params, cfg, bs, cap)

    def fn(grid: TSDFGrid, pose: Pose, points, normals, rgb=None):
        grid, st = fuse_frame_bricked(grid, pose, points, normals, rgb, params=params,
                                      cam=cam, cfg=cfg, bs=bs, cap=cap, merge="xla",
                                      i_offset=mesh.i0(params.m))
        keys = ("n_full", "overflow", "n_free", "overflow_active")
        counts = torch.tensor([getattr(st, k) for k in keys], dtype=torch.int64,
                              device=grid.D.device)
        mesh.all_reduce_(counts)
        return grid, FuseStats(**dict(zip(keys, counts.tolist())))

    return fn


def fuse_brickmajor_slab(bgrid: BrickGrid, pose: Pose, points, normals, rgb, *,
                         i0: int, slab: int, params: GridParams, cam: PinholeCamera,
                         cfg: FusionConfig, bs, cap: int,
                         cap_free: Optional[int] = None, debug: bool = False) -> torch.Tensor:
    """Brick-major fusion of one rank's rows (the slab of ``slab`` planes at
    global i0), K2's slab form; returns its (6,) device counts (10 with
    ``debug``: the invariant counts of the rows it wrote)."""
    return fuse_frame_brickmajor_core(bgrid, pose, points, normals, rgb, params=params,
                                      cam=cam, cfg=cfg, bs=bs, cap=cap, cap_free=cap_free,
                                      i_offset=i0, nbi_local=slab // bs[0], debug=debug)


def sharded_fuse_frame_brickmajor(mesh: Mesh, *, params: GridParams, cam: PinholeCamera,
                                  cfg: FusionConfig = FusionConfig(), bs=None,
                                  cap: Optional[int] = None,
                                  cap_free: Optional[int] = None, emit_dm: bool = False):
    """fn(bgrid_rows, pose, points, normals, rgb=None) -> (bgrid_rows,
    Dm_slab or None, FuseStats summed over the ranks): brick-major fusion of
    this rank's rows in place (K2's slab form), then the counts' all_reduce
    and one host read. ``emit_dm``: also this rank's dense (slab, m, m)
    masked view for ``sharded_track_frame_masked``. ``fn.core`` is the same
    fusion returning the summed (6,) device counts, with no host read (with
    ``debug`` also the invariant counts, in the same all_reduce, so that
    every rank sees every rank's faults). ``cap`` / ``cap_free`` are per
    rank (default max(256, cap // n))."""
    slab, bs, cap = slab_caps(mesh, params, cfg, bs, cap)
    cap_free = cap_free if cap_free is not None else cap

    def core(bgrid: BrickGrid, pose: Pose, points, normals, rgb=None,
             debug: bool = False) -> torch.Tensor:
        counts = fuse_brickmajor_slab(bgrid, pose, points, normals, rgb,
                                      i0=mesh.i0(params.m), slab=slab, params=params,
                                      cam=cam, cfg=cfg, bs=bs, cap=cap, cap_free=cap_free,
                                      debug=debug)
        return mesh.all_reduce_(counts)

    def fn(bgrid: BrickGrid, pose: Pose, points, normals, rgb=None):
        stats = fuse_stats(core(bgrid, pose, points, normals, rgb).tolist())
        Dm = (_from_rows(bgrid.D, (slab, params.m, params.m), bs) if emit_dm else None)
        return bgrid, Dm, stats

    fn.core = core
    return fn


def make_sharded_step(mesh: Mesh, *, params: GridParams, cam: PinholeCamera,
                      tracking: TrackingConfig = TrackingConfig(),
                      fusion: FusionConfig = FusionConfig()):
    """The per-frame step on a dense slab: track (all-reduced normal
    equations), then fuse (slab-local). step(grid, pose, points_img,
    normals_img, rgb=None, track_pose=True) -> (grid, pose, TrackResult or
    None)."""
    track = sharded_track_frame(mesh, params=params, cfg=tracking)
    fuse = sharded_fuse_frame(mesh, params=params, cam=cam, cfg=fusion)

    def step(grid: TSDFGrid, pose: Pose, points_img, normals_img, rgb=None,
             track_pose: bool = True):
        result = None
        if track_pose:
            result = track(grid, pose, points_img)
            pose = result.pose
        return fuse(grid, pose, points_img, normals_img, rgb), pose, result

    return step
