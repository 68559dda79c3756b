"""End-to-end frame loop (counterpart of tracking_sdf_tpu.pipeline.runner).

Per frame: preprocess (bilateral filter, full or separable, backprojection,
normals), track from the second frame on (pyramid or flat Gauss-Newton; with
the analytic Jacobian one K1 step launch per iteration, the state on the
device), read the tracking state once (its stats and the failure gate's
inputs), gate failed tracks, append the pose to the TUM trajectory, and
fuse. Every fusion mode of the JAX package runs:
  * ``mode="dense"`` (the default; the synthetic64 and tum128 presets): the
    flat (m, m, m) grid, fused voxel by voxel (fusion.fuse);
  * ``mode="brickmajor"`` (the tum256 and tum512 presets): the grid lives as
    brick rows (fusion.brickmajor, K2 in every fused frame), and tracking
    reads the brick-major masked view of the D rows; the dense grid is built
    only when ``grid`` is read. ``sat_skip`` carries its bitset here;
  * ``mode="bricked"``: the flat grid with brick compaction and the merge
    tail ``brick_merge`` ("xla", "rows" or K2's "pallas");
  * ``mode="packed"``: what the JAX package's packed layout computes, run
    as float32 brick-major rows with flat classification
    (``packed_fusion_config``); per frame only, as there.
The central Jacobian reads D and W: the flat layouts' dense grid, and in
brick-major mode the D and W rows in place (``BrickRows``; K1's central form
on the card), so no dense grid is built on the tracked path in any layout.
``process_chunk`` and ``run(chunk=N)`` process many brick-major frames per
host round trip, with either Jacobian (pipeline.chunk: CUDA-graph replays of
one captured frame step on the card).
``use_groundtruth`` is the fusion-only oracle mode (poses from the dataset's
groundtruth). Checkpoints (pipeline.checkpoint) save and restore the grid,
the pose and the frame counter.

With ``mesh`` (parallel.mesh.Mesh) the grid is split into i-slabs over the
ranks of a process group, one per device (parallel.sharded): brick-major
keeps each rank's rows and tracks straight off them (K1's and K2's slab
forms); dense and bricked keep dense slabs ("packed" maps to sharded bricked
with (1, 8, 128) bricks). Tracking runs one level at ``pixel_stride`` (no
pyramid), FULL and FREE caps are per rank (max(256, cap // n), no adaptive
ladder), and ``sat_skip`` is off. Every rank must make the same calls in the
same order (the collectives' rule): every frame, and ``grid``,
``save_checkpoint``, ``render``, ``export_mesh`` and ``process_chunk``.
"""
from __future__ import annotations

import dataclasses
import json
import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tracking_sdf_tpu_torch.config import PipelineConfig
from tracking_sdf_tpu_torch.core.camera import PinholeCamera
from tracking_sdf_tpu_torch.core.lie import Pose, matrix_from_quaternion
from tracking_sdf_tpu_torch.fusion.brick import FuseStats, fuse_frame_bricked
from tracking_sdf_tpu_torch.fusion.brickmajor import (
    COUNTS, BrickGrid, brick_grid_from_dense, brick_masked_view, brick_rows_view,
    dense_from_brick_grid, empty_brick_grid, fuse_frame_brickmajor_core, fuse_stats,
    storage_dtype)
from tracking_sdf_tpu_torch.fusion.fuse import fuse_frame
from tracking_sdf_tpu_torch.grid.grid import FIELDS, TSDFGrid, empty_grid
from tracking_sdf_tpu_torch.pipeline import chunk as chunked
from tracking_sdf_tpu_torch.pipeline.trajectory import TrajectoryWriter
from tracking_sdf_tpu_torch.tracking.gauss_newton import TrackResult, track_frame
from tracking_sdf_tpu_torch.tracking.preprocess import preprocess_frame
from tracking_sdf_tpu_torch.tracking.pyramid import track_frame_pyramid
from tracking_sdf_tpu_torch.utils import debug_nans, profiling

# The reference's initial pose (camera z along world -y, 1 m up) with its
# third row's sign flipped: the reference's literal matrix has det = -1.
REFERENCE_INITIAL_POSE = Pose(
    R=torch.tensor([[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]]),
    t=torch.tensor([0.0, 0.0, 1.0]),
)


@dataclasses.dataclass
class FrameStats:
    index: int
    timestamp: float
    track_ms: float
    fuse_ms: float
    gn_iterations: int
    num_valid: int
    mean_abs_residual: float
    rejected: bool = False  # tracking-failure gate fired; frame dropped
    preprocess_ms: float = 0.0


def unsupported(config: PipelineConfig, sharded: bool = False) -> List[str]:
    """The modes of ``config`` that the port does not run (on one device, or
    ``sharded`` over a mesh), each with the reason (the CLI exits 2 on
    them): the central Jacobian under a mesh, as in the JAX package."""
    if sharded and config.tracking.jacobian != "analytic":
        return ["tracking.jacobian='central' under a mesh (the sharded tracker "
                "is analytic only, as the JAX package's)"]
    return []


def _check_supported(config: PipelineConfig, sharded: bool) -> None:
    bad = unsupported(config, sharded)
    if bad:
        raise NotImplementedError("unsupported: " + ", ".join(bad))


def sharded_fusion_config(config: PipelineConfig) -> PipelineConfig:
    """The fusion config a mesh runs: "packed" becomes the flat bricked
    layout with (1, 8, 128) bricks (narrowed to m below 128), as the JAX
    package maps it."""
    f = config.fusion
    if f.mode != "packed":
        return config
    m = config.grid.m
    bs = (1, 8, 128) if m % 128 == 0 else (1, 8, m)
    return dataclasses.replace(config, fusion=f._replace(mode="bricked", brick_shape=bs))


def packed_fusion_config(config: PipelineConfig) -> PipelineConfig:
    """The fusion config that "packed" runs on one device: the JAX package's
    packed layout (fusion.packed, one (NB, 6, BV) array) computes brick-major
    fusion on float32 leaves whatever the storage dtypes say, with the flat
    classifier (no hierarchical classification, no saturated-FREE skip) and
    FREE bricks capped at ``brick_cap_free`` or else the frame's cap. The port
    runs that as brick-major rows with those fields; the layout itself is a
    TPU workaround and is not ported."""
    f = config.fusion
    if f.mode != "packed":
        return config
    return dataclasses.replace(config, fusion=f._replace(
        mode="brickmajor", storage_dtype="float32", weight_dtype="float32",
        hier_classify=0, sat_skip=False))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Reconstruction:
    """Stateful frame loop: owns the grid, the pose and the trajectory file."""

    def __init__(self, cam: PinholeCamera, config: PipelineConfig = PipelineConfig(),
                 initial_pose: Optional[Pose] = None, *, device=None, mesh=None):
        _check_supported(config, mesh is not None)
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's {mesh.device}")
            device = mesh.device
        elif device is None:
            # an entry point runs on the card unless the caller asks for the CPU
            if not torch.cuda.is_available():
                raise RuntimeError("Reconstruction runs on the GPU by default and no CUDA "
                                   'device is available: pass device="cpu" to run on the CPU')
            device = "cuda"
        self.device = torch.device(device)
        self.mesh = mesh
        self.cam = cam
        # "packed" is per frame only, as in the JAX package
        self.packed = config.fusion.mode == "packed" and mesh is None
        self.config = config = (sharded_fusion_config(config) if mesh is not None
                                else packed_fusion_config(config))
        self.pose = (initial_pose if initial_pose is not None
                     else REFERENCE_INITIAL_POSE).to(self.device)
        self._pose_prev: Optional[Pose] = None  # for pose_init="velocity"
        self.frame_num = 0
        self.stats: List[FrameStats] = []
        self._writer = (TrajectoryWriter(config.trajectory_path)
                        if config.trajectory_path else None)
        f = config.fusion
        self._bs = f.brick_shape
        self._grid: Optional[TSDFGrid] = None  # flat layout
        self._bgrid = None  # brick-major rows, with self._dm their masked view
        self._dm = None
        # the saturated-FREE skip's (NB,) bitset (brick-major only, as in the
        # JAX package), on the device at a fixed address; reset on every
        # grid assignment
        self._sat: Optional[torch.Tensor] = None
        m = config.grid.m
        slab = mesh.slab(m) if mesh is not None else m
        if f.mode == "brickmajor":
            self._vdt = storage_dtype(f.storage_dtype)
            self._wdt = storage_dtype(f.weight_dtype)
            if slab % self._bs[0]:
                raise ValueError(f"slab {slab} not divisible by brick i-extent {self._bs[0]}")
            self._bgrid = empty_brick_grid(config.grid, self._bs, device=self.device,
                                           value_dtype=self._vdt, weight_dtype=self._wdt,
                                           nbi=slab // self._bs[0])
            if mesh is None:
                self._dm = brick_masked_view(self._bgrid, config.grid, self._bs)
            if f.sat_skip and mesh is None:
                self._sat = torch.zeros(self._bgrid.D.shape[0], dtype=torch.bool,
                                        device=self.device)
        else:
            self._grid = empty_grid(config.grid, device=self.device, mi=slab)
        if mesh is not None:
            self._init_sharded()
        # adaptive FULL cap: the smallest of three levels that covers ~1.3x
        # the previous frame's FULL count (overflow escalates the next frame)
        cap_max = config.fusion.brick_cap
        self._cap_levels = sorted({max(256, cap_max // 4), max(256, cap_max // 2),
                                   cap_max})
        self._cap_idx = len(self._cap_levels) - 1
        self.last_fuse_stats: Optional[FuseStats] = None
        self.overflow_drops = 0  # bricks dropped at a cap, summed over the frames
        self.emit_times: List[float] = []  # run(): host clock after each frame's stats
        # chunked processing: the captured steps (dropped with the grid),
        # the phase calibration per chunk shape, and the last chunk's
        # FuseStats per frame (None on a rejected frame)
        self._chunk_steps: Optional[chunked.ChunkSteps] = None
        self._chunk_calib = {}
        self.chunk_phase_metrics = True
        self.chunk_fuse_stats: List[Optional[FuseStats]] = []
        # the last chunk's ChunkTrace when it ran traced (utils.profiling)
        self.chunk_trace: Optional[chunked.ChunkTrace] = None
        # TUM wire formats are decoded on the device by true division
        self._scale_depth = torch.full((), 5000.0, device=self.device)
        self._scale_rgb = torch.full((), 255.0, device=self.device)
        self._publisher = None  # pipeline.visualizer.MeshPublisher
        self._last_publish = float("-inf")
        self._last_publish_frame = 0  # under a mesh: the frame of the last snapshot
        self._mesh_publishing = False  # under a mesh: start_mesh_publisher was called

    def _init_sharded(self) -> None:
        """The mesh's tracker and fusion (parallel.sharded): built once, the
        caps per rank fixed at max(256, cap // n)."""
        from tracking_sdf_tpu_torch.parallel import sharded

        cfg, mesh = self.config, self.mesh
        f = cfg.fusion
        n = mesh.size
        if f.mode == "brickmajor":
            self._fuse_sh = sharded.sharded_fuse_frame_brickmajor(
                mesh, params=cfg.grid, cam=self.cam, cfg=f, bs=self._bs,
                cap_free=max(256, f.brick_cap_free // n) if f.brick_cap_free else None)
            self._track_sh = sharded.sharded_track_frame_brickmajor(
                mesh, params=cfg.grid, cfg=cfg.tracking, bs=self._bs)
        else:
            self._fuse_sh = (sharded.sharded_fuse_frame_bricked(
                mesh, params=cfg.grid, cam=self.cam, cfg=f, bs=self._bs)
                if f.mode == "bricked" else
                sharded.sharded_fuse_frame(mesh, params=cfg.grid, cam=self.cam, cfg=f))
            self._track_sh = sharded.sharded_track_frame(mesh, params=cfg.grid,
                                                         cfg=cfg.tracking)
        self._render_sh = {}

    @property
    def grid(self) -> TSDFGrid:
        """The dense (m, m, m) grid. In brick-major mode this materializes it
        from the brick rows (six float32 leaves): for tests and export, not
        for the per-frame path. Under a mesh it gathers the ranks' slabs (a
        collective: every rank reads it)."""
        from tracking_sdf_tpu_torch.parallel.mesh import gather_brick_grid, gather_grid

        if self._bgrid is not None:
            rows = (self._bgrid if self.mesh is None
                    else gather_brick_grid(self._bgrid, self.mesh))
            return dense_from_brick_grid(rows, self.config.grid, self._bs)
        return self._grid if self.mesh is None else gather_grid(self._grid, self.mesh)

    @grid.setter
    def grid(self, g: TSDFGrid) -> None:
        """Assign the whole dense grid (under a mesh every rank passes the
        same grid and keeps its slab)."""
        from tracking_sdf_tpu_torch.parallel.mesh import shard_brick_grid, shard_grid

        if debug_nans.enabled():
            self._check_invariants(debug_nans.grid_faults(g), None, "the assigned grid")
        # a saturated bit states that the brick's rows did not change under
        # its last FREE update: after a new grid no bit holds
        if self._sat is not None:
            self._sat.zero_()
        if self._bgrid is not None:
            self._bgrid = brick_grid_from_dense(g, self._bs, value_dtype=self._vdt,
                                                weight_dtype=self._wdt)
            if self.mesh is None:
                self._dm = brick_masked_view(self._bgrid, self.config.grid, self._bs)
            else:
                self._bgrid = shard_brick_grid(self._bgrid, self.mesh)
            self._chunk_steps = None  # its graphs hold the old rows' addresses
        else:
            self._grid = g if self.mesh is None else shard_grid(g, self.mesh)

    def _grid_slab(self) -> TSDFGrid:
        """This rank's dense slab of the grid (a mesh only)."""
        if self._bgrid is not None:
            return dense_from_brick_grid(self._bgrid, self.config.grid, self._bs)
        return self._grid

    @property
    def brick_grid(self):
        """The brick-major rows (fusion.brickmajor.BrickGrid), None in the
        flat layout. Fusion updates them in place."""
        return self._bgrid

    def _fuse_core(self, pose: Pose, points, normals, rgb, cap: int,
                   bgrid: Optional[BrickGrid] = None,
                   sat: Optional[torch.Tensor] = None, debug: bool = False) -> torch.Tensor:
        """Brick-major fusion into ``bgrid`` and ``sat`` (default the live
        rows and bitset) with no host read; returns the device counts
        (fusion.brickmajor; under a mesh summed over the ranks, at the
        fixed caps per rank). ``debug``: a seventh count, the invariants'
        fault code (utils.debug_nans) of the written rows and ``pose``."""
        f = self.config.fusion
        if bgrid is None:
            bgrid, sat = self._bgrid, self._sat
        if self.mesh is not None:
            counts = self._fuse_sh.core(bgrid, pose, points, normals, rgb, debug=debug)
        else:
            counts = fuse_frame_brickmajor_core(
                bgrid, pose, points, normals, rgb, params=self.config.grid, cam=self.cam,
                cfg=f, bs=self._bs, cap=cap, cap_free=f.brick_cap_free or None, sat=sat,
                debug=debug)
        if debug:
            n = len(COUNTS)
            counts = torch.cat([counts[:n], debug_nans.fault_code(counts[n:])[None]])
        return counts

    def _check_invariants(self, leaf: Optional[torch.Tensor], pose: Optional[Pose],
                          where: str) -> None:
        """--debug-nans on the host: raise if the (3,) leaf counts or the
        pose break an invariant (one read)."""
        zero = torch.zeros(1, dtype=torch.int64, device=self.device)
        faults = torch.cat([zero.repeat(3) if leaf is None else leaf,
                            zero if pose is None else debug_nans.pose_faults(pose)])
        debug_nans.check(int(debug_nans.fault_code(faults)), where)

    def _check_flat(self) -> None:
        """--debug-nans on the flat grid after a frame: the whole grid (under
        a mesh every rank's slab, the counts summed by one all_reduce) and the
        pose."""
        leaf = debug_nans.grid_faults(self._grid)
        if self.mesh is not None:
            self.mesh.all_reduce_(leaf)
        self._check_invariants(leaf, self.pose, f"frame {self.frame_num}")

    def _fuse(self, points, normals, rgb) -> None:
        cfg = self.config
        sharded = self.mesh is not None
        debug = debug_nans.enabled()
        if cfg.fusion.mode == "dense":
            self._grid = (self._fuse_sh(self._grid, self.pose, points, normals, rgb)
                          if sharded else
                          fuse_frame(self._grid, self.pose, points, normals, rgb,
                                     params=cfg.grid, cam=self.cam, cfg=cfg.fusion))
            if debug:
                self._check_flat()
            return
        cap = self._cap_levels[self._cap_idx]
        if self._bgrid is not None:
            counts = self._fuse_core(self.pose, points, normals, rgb, cap, debug=debug)
            counts = counts.tolist()  # the frame's one FuseStats read
            if debug:
                debug_nans.check(counts[-1], f"frame {self.frame_num}")
            stats = fuse_stats(counts)
        elif sharded:
            _, stats = self._fuse_sh(self._grid, self.pose, points, normals, rgb)
        else:
            _, stats = fuse_frame_bricked(
                self._grid, self.pose, points, normals, rgb, params=cfg.grid,
                cam=self.cam, cfg=cfg.fusion, bs=self._bs, cap=cap,
                merge=cfg.fusion.brick_merge,
                cap_act=cfg.fusion.brick_cap_active or None)
        if debug and self._bgrid is None:
            self._check_flat()
        self.last_fuse_stats = stats
        self.overflow_drops += stats.overflow + stats.overflow_active + stats.overflow_mixed
        need = stats.n_full * 1.3
        self._cap_idx = next((i for i, c in enumerate(self._cap_levels) if c >= need),
                             len(self._cap_levels) - 1)

    def _predict_pose(self) -> Pose:
        """Initial pose of the GN descent: the previous pose, or the
        constant-velocity prediction T_{n-1} ∘ (T_{n-2}^-1 ∘ T_{n-1})."""
        if self.config.pose_init == "velocity" and self._pose_prev is not None:
            return chunked.velocity_guess(self.pose, self._pose_prev)
        return self.pose

    def _track_levels(self, pose0: Pose, points: torch.Tensor) -> Tuple[TrackResult, ...]:
        """Tracking of one frame's (H, W, 3) points from ``pose0``: each
        level's result, coarse to fine, issued with no host read
        (brick-major: against the view of the D rows; the central Jacobian
        against D and W, brick-major's rows in place, inside the span
        ``tsdf.track.central``; under a mesh the sharded tracker, one level
        at pixel_stride)."""
        cfg = self.config
        if self.mesh is not None:
            rows = self._bgrid.D if self._bgrid is not None else self._grid
            return (self._track_sh(rows, pose0, points),)
        if cfg.tracking.jacobian == "central":
            grid = (self._grid if self._bgrid is None
                    else brick_rows_view(self._bgrid, cfg.grid, self._bs))
            with profiling.span("tsdf.track.central"):
                return self._track(grid, None, pose0, points)
        return self._track(self._grid, self._dm, pose0, points)

    def _track(self, grid, dm, pose0: Pose, points: torch.Tensor) -> Tuple[TrackResult, ...]:
        """The pyramid's levels, or the one level at pixel_stride, against
        ``grid`` or the masked view ``dm``."""
        cfg = self.config
        if cfg.pyramid_levels:
            _, levels = track_frame_pyramid(
                grid, pose0, points, params=cfg.grid, cfg=cfg.tracking,
                levels=cfg.pyramid_levels, Dm=dm)
            return levels
        s = cfg.tracking.pixel_stride
        return (track_frame(grid, pose0, points[::s, ::s], params=cfg.grid,
                            cfg=cfg.tracking, Dm=dm),)

    def _as_depth(self, depth) -> torch.Tensor:
        """A depth image on the device as float32 meters with NaN holes. TUM
        uint16 (5000 per meter, 0 = hole), a numpy array or a tensor, crosses
        as 16-bit words and is decoded there as the chunk step decodes it."""
        if not torch.is_tensor(depth):
            a = np.asarray(depth)
            depth = torch.from_numpy(np.ascontiguousarray(
                a.view(np.int16) if a.dtype == np.uint16 else a))
        elif depth.dtype == torch.uint16:
            depth = depth.view(torch.int16)
        depth = depth.to(self.device)
        if depth.dtype == torch.int16:
            return chunked.decode_tum_depth(depth, self._scale_depth)
        return depth.to(torch.float32)

    def _as_rgb(self, rgb) -> Optional[torch.Tensor]:
        """Colors on the device as float32 in [0, 1]; uint8 is divided by 255."""
        if rgb is None:
            return None
        if not torch.is_tensor(rgb):
            rgb = torch.from_numpy(np.ascontiguousarray(rgb))
        rgb = rgb.to(self.device)
        if rgb.dtype == torch.uint8:
            rgb = rgb.to(torch.float32) / self._scale_rgb
        # K5 takes contiguous colors: a crop or a transposed view is copied
        return rgb.to(torch.float32).contiguous()

    def process_frame(self, depth, rgb=None, timestamp: Optional[float] = None,
                      gt_pose: Optional[Pose] = None) -> FrameStats:
        """Run the per-frame pipeline on a (H, W) depth image in meters (NaN
        holes; or TUM uint16) and optional (H, W, 3) colors in [0, 1] (or
        uint8). With ``config.use_groundtruth`` the pose is ``gt_pose`` and
        nothing is tracked; a frame without one (a groundtruth gap) is
        rejected. Returns timing and optimizer stats."""
        cfg = self.config
        self.frame_num += 1
        timestamp = float(timestamp) if timestamp is not None else float(self.frame_num)
        t0 = time.perf_counter()
        points, normals = preprocess_frame(
            self._as_depth(depth), cam=self.cam, bilateral=cfg.bilateral_filter,
            bilateral_mode=cfg.bilateral_mode)

        gn_iters, nvalid, mean_res, rejected = 0, 0, 0.0, False
        _sync(self.device)
        preprocess_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        if cfg.use_groundtruth:
            if gt_pose is not None:
                self._pose_prev = self.pose
                self.pose = gt_pose.to(self.device)
            else:  # tracking here would mix tracked poses into an oracle run
                rejected = True
                self._pose_prev = None
        elif self.frame_num > 1:
            res = self._track_levels(self._predict_pose(), points)[-1]
            # the frame's one read of the tracking state: its stats and the
            # failure gate's inputs
            st = res.read()
            gn_iters, nvalid, mean_res = st.iterations, st.num_valid, st.mean_abs_residual
            # failure gate: a diverged or starved track must not reach the
            # grid — keep the previous pose and drop the frame
            rejected = (nvalid < cfg.min_valid_pixels
                        or (cfg.max_mean_residual > 0
                            and mean_res > cfg.max_mean_residual)
                        or not bool(torch.isfinite(st.pose.t).all()))
            if not rejected:
                self._pose_prev = self.pose
                self.pose = res.pose
            else:
                self._pose_prev = None  # the velocity estimate is stale
        track_ms = (time.perf_counter() - t0) * 1e3

        if self._writer is not None and not rejected:
            self._writer.write(timestamp, self.pose)

        t0 = time.perf_counter()
        if not rejected:
            rgb_t = self._as_rgb(rgb)
            # color fuses on every color_every-th frame only
            ce = cfg.fusion.color_every
            if ce > 1 and self.frame_num % ce:
                rgb_t = None
            self._fuse(points, normals, rgb_t)
            _sync(self.device)
        fuse_ms = (time.perf_counter() - t0) * 1e3
        if not rejected:
            self._maybe_publish()

        stat = FrameStats(index=self.frame_num, timestamp=timestamp,
                          track_ms=track_ms, fuse_ms=fuse_ms,
                          gn_iterations=gn_iters, num_valid=nvalid,
                          mean_abs_residual=mean_res, rejected=rejected,
                          preprocess_ms=preprocess_ms)
        self.stats.append(stat)
        return stat

    # --- chunked processing ------------------------------------------------

    def _chunk_supported(self) -> bool:
        cfg = self.config
        return self._bgrid is not None and not self.packed and not cfg.use_groundtruth

    def _stage(self, frames, rgb: bool) -> torch.Tensor:
        """A chunk's (N, ...) frames as the tensor its steps copy from: left
        on the device if they are there, else in host memory, pinned when
        the device is a GPU (asynchronous copies). TUM uint16 depth stays
        16-bit (as int16 bits) and uint8 color stays 8-bit: both are decoded
        on the device."""
        if torch.is_tensor(frames):
            x = frames.view(torch.int16) if frames.dtype == torch.uint16 else frames
        else:
            a = np.asarray(frames)
            x = torch.from_numpy(np.ascontiguousarray(
                a.view(np.int16) if a.dtype == np.uint16 else a))
        if x.dtype not in (torch.int16, torch.uint8):
            x = x.to(torch.float32)
        if (x.dtype == torch.uint8) != rgb and x.dtype != torch.float32:
            raise ValueError(f"process_chunk: {'colors' if rgb else 'depth'} of "
                             f"dtype {x.dtype}")
        if x.device.type != self.device.type:
            x = x.cpu()
            if self.device.type == "cuda":
                x = x.pin_memory()
        return x

    def process_chunk(self, depths, rgbs=None, timestamps=None) -> List[FrameStats]:
        """Process N frames with one host read: ``depths`` (N, H, W) float32
        meters with NaN holes, or TUM uint16 (1/5000 m, 0 = hole); ``rgbs``
        (N, H, W, 3) in [0, 1] or uint8; ``timestamps`` N floats (default the
        frame indices). Needs the brick-major mode (either Jacobian) and
        one process_frame call first (frame 0 bootstraps the grid), and
        tracked poses: the groundtruth oracle mode runs per frame
        only (the JAX package's contract).

        Each frame preprocesses, tracks from the carried pose (the
        constant-velocity guess with pose_init="velocity"), gates a failed
        track on the device (the pose is kept and the frame fuses nothing)
        and fuses at the largest cap: the per-frame loop adapts its cap to
        the previous frame's FULL count, which a chunk cannot read, so it
        holds the maximum. With the same cap, and no FULL brick dropped, the
        poses and rows equal the per-frame loop's bit for bit. Color fuses
        on the absolute frames ``frame_num % color_every == 0``.

        On the card every frame is one replay of a CUDA graph of the frame
        step (pipeline.chunk), and the replays run under
        ``torch.cuda.set_sync_debug_mode("error")``: a capture or replay
        that fails raises. ``chunk_phase_metrics`` (default True) measures
        per chunk shape a preprocess-only and a fuse-only loop over the
        chunk's frames: FrameStats then carry that preprocess_ms, that
        fuse_ms on every fused frame (0 on a rejected one) and the rest of
        the chunk's wall time as track_ms, split by GN iterations; without
        it track_ms is the chunk's wall time over N. A calibration that
        fails warns (RuntimeWarning) and leaves that fallback.

        The host reads the chunk's records once (one CPU array of N rows).
        The trajectory lines of the frames not rejected are written in one
        pass (TrajectoryWriter.write_chunk: one quaternion_from_matrix over
        the N rotations, one write, one flush) before the call returns,
        while tracing under one ``tsdf.trajectory.write`` span whose id is
        the number of lines; the file's bytes are the per-frame loop's.

        While tracing (utils.profiling.tracing_enabled) the call is the span
        ``tsdf.process_chunk`` (its id the chunk's first frame index), with
        these nested in it: ``tsdf.chunk.setup`` (staging, the color
        cadence, the steps' creation and preparation, a first use's
        ``tsdf.chunk.capture``), ``tsdf.chunk.issue`` and ``tsdf.chunk.read``
        (pipeline.chunk), then ``tsdf.chunk.post`` until the return, with
        ``tsdf.chunk.calibrate``, ``tsdf.trajectory.write`` and
        ``tsdf.publish`` inside. The frames run the steps' traced variant:
        ``chunk_trace`` holds their device stamps and per-level full GN
        steps, None when not tracing. The records, poses, rows and
        trajectory file are the same either way."""
        with profiling.span("tsdf.process_chunk", self.frame_num + 1):
            return self._process_chunk(depths, rgbs, timestamps)

    def _process_chunk(self, depths, rgbs, timestamps) -> List[FrameStats]:
        cfg = self.config
        if (not self._chunk_supported() or self.frame_num < 1):
            raise ValueError(
                "process_chunk needs mode='brickmajor' (not 'packed'), "
                "tracked (not groundtruth) poses and one process_frame call "
                "first (frame 0 bootstraps the grid)")
        with profiling.span("tsdf.chunk.setup"):
            depths = self._stage(depths, rgb=False)
            n = depths.shape[0]
            has_color = cfg.fusion.fuse_color and rgbs is not None
            rgbs = self._stage(rgbs, rgb=True) if has_color else None
            if timestamps is None:
                timestamps = [float(self.frame_num + 1 + i) for i in range(n)]
            cap = self._cap_levels[-1]
            ce = cfg.fusion.color_every
            colors = chunked.color_cadence(self.frame_num + 1, n, has_color, ce)
            if self._chunk_steps is None:
                self._chunk_steps = chunked.ChunkSteps(self)
            steps = self._chunk_steps
            prepared = steps.prepare(depths, rgbs, colors, cap)

        t0 = time.perf_counter()
        out = steps.replay(prepared, depths, rgbs, colors, self.pose, self._pose_prev)
        wall_ms = (time.perf_counter() - t0) * 1e3 / n

        with profiling.span("tsdf.chunk.post"):
            if steps.debug:  # the first frame of the chunk that broke an invariant
                codes = out[:, chunked.REC_FAULT].contiguous().view(torch.int32).tolist()
                for i, code in enumerate(codes):
                    debug_nans.check(code, f"frame {self.frame_num + 1 + i} (chunk of {n})")
            self.chunk_trace = chunked.chunk_trace(out, steps.levels) if steps.traced else None
            rec = out.numpy()
            rej = rec[:, chunked.REC_REJ] > 0
            iters = rec[:, chunked.REC_ITERS].astype(np.int64)
            counts = rec[:, chunked.REC_COUNTS:chunked.REC_FAULT].astype(np.int64).tolist()
            self.pose = Pose(steps.R.clone(), steps.t.clone())
            self._pose_prev = (None if rej[-1]
                               else Pose(steps.prev_R.clone(), steps.prev_t.clone()))
            self.chunk_fuse_stats = [None if rj else fuse_stats(c)
                                     for rj, c in zip(rej.tolist(), counts)]
            fused = [s for s in self.chunk_fuse_stats if s is not None]
            if fused:
                self.last_fuse_stats = fused[-1]

            prep_i, fuse_i = np.zeros(n), np.zeros(n)
            track_i = np.full(n, wall_ms)
            if self.chunk_phase_metrics:
                key = (n, has_color, depths.dtype == torch.int16, cap,
                       (self.frame_num + 1) % ce if has_color and ce > 1 else 0)
                try:
                    if key not in self._chunk_calib:
                        with profiling.span("tsdf.chunk.calibrate"):
                            self._chunk_calib[key] = steps.calibrate(depths, rgbs, colors, cap)
                    prep_ms, fuse_cal = self._chunk_calib[key]
                except Exception as e:  # the frames are done; only their split is lost
                    warnings.warn(f"chunk phase calibration failed ({type(e).__name__}: {e});"
                                  " the FrameStats carry wall/n in track_ms", RuntimeWarning,
                                  stacklevel=3)
                else:
                    prep_i[:] = prep_ms
                    fuse_i = np.where(rej, 0.0, fuse_cal)
                    pool = max(wall_ms * n - prep_ms * n - float(fuse_i.sum()), 0.0)
                    w_it = np.maximum(iters.astype(np.float64), 1.0)
                    track_i = pool * w_it / w_it.sum()

            if self._writer is not None:
                keep = ~rej
                with profiling.span("tsdf.trajectory.write", int(keep.sum())):
                    self._writer.write_chunk(
                        timestamps, out[:, chunked.REC_R:chunked.REC_T].reshape(n, 3, 3),
                        out[:, chunked.REC_T:chunked.REC_ITERS], keep)

            stats_out: List[FrameStats] = []
            for i, (it, nvalid, mres, rj) in enumerate(zip(
                    iters.tolist(), rec[:, chunked.REC_NVALID].tolist(),
                    rec[:, chunked.REC_MRES].tolist(), rej.tolist())):
                self.frame_num += 1
                stat = FrameStats(index=self.frame_num, timestamp=float(timestamps[i]),
                                  track_ms=float(track_i[i]), fuse_ms=float(fuse_i[i]),
                                  gn_iterations=it, num_valid=int(nvalid),
                                  mean_abs_residual=mres, rejected=rj,
                                  preprocess_ms=float(prep_i[i]))
                self.stats.append(stat)
                stats_out.append(stat)
            ovf = [COUNTS.index(k) for k in ("overflow", "overflow_active", "overflow_mixed")]
            overflow = sum(c[i] for c in counts for i in ovf)
            self.overflow_drops += overflow
            if overflow:
                warnings.warn(
                    f"process_chunk: {overflow} brick-cap overflow drops across the chunk "
                    f"(cap {cap} = the preset max; peak n_full {max(c[0] for c in counts)}: "
                    f"raise FusionConfig.brick_cap to cover it)", RuntimeWarning, stacklevel=3)
            with profiling.span("tsdf.publish"):
                self._maybe_publish()
            return stats_out

    # --- meshing and rendering ----------------------------------------------

    def _maybe_publish(self) -> None:
        """Hand the publisher a snapshot when its (effective) interval has
        passed since the last: a snapshot is a full dense copy, not worth
        making for exports that cannot keep up. The brick-major dense view is
        a fresh copy already; the flat grid is updated in place, so it is
        copied. Under a mesh the snapshot is a gather, which every rank must
        join at the same frame: the ranks decide by frame count (one
        snapshot every round(30 / mesh_hz) frames of a 30 Hz sensor), and
        only rank 0 runs a publisher."""
        if self.mesh is not None:
            every = max(1, round(30.0 / (self.config.mesh_hz or 1.0)))
            if (self._mesh_publishing
                    and self.frame_num // every > self._last_publish_frame // every):
                self._last_publish_frame = self.frame_num
                grid = self.grid
                if self._publisher is not None:
                    self._publisher.publish(grid, copy=False)
            return
        if self._publisher is None:
            return
        now = time.perf_counter()
        if now - self._last_publish >= self._publisher.effective_interval:
            self._publisher.publish(self.grid, copy=self._bgrid is None)
            self._last_publish = now

    def _extract_mesh(self, grid: TSDFGrid, with_colors: bool, color_mode: str):
        """marching_cubes of ``grid``: in 4 i-slabs at m >= 512 (bounds the
        peak device memory next to the live grid), one shot otherwise;
        vertices read back as uint16 box coordinates unless
        ``config.mesh_vertex_quant`` is False."""
        from tracking_sdf_tpu_torch.render.marching_cubes import (
            marching_cubes, marching_cubes_chunked)

        mc = marching_cubes_chunked if self.config.grid.m >= 512 else marching_cubes
        return mc(grid, params=self.config.grid, with_colors=with_colors,
                  color_mode=color_mode, vertex_quant=self.config.mesh_vertex_quant)

    def export_mesh(self, path: str, with_colors: bool = True,
                    color_mode: str = "trilinear") -> int:
        """Mesh the current grid into a PLY file; returns the triangle count.
        color_mode="shepard" is the reference's per-vertex interpolate_color."""
        from tracking_sdf_tpu_torch.render.marching_cubes import export_ply

        mesh = (self._extract_mesh(self.grid, with_colors, color_mode) if self.mesh is None
                else self._sharded_mesh(with_colors, color_mode))
        if self.mesh is None or self.mesh.rank == 0:  # under a mesh rank 0 writes
            export_ply(mesh, path)
        return mesh.num_triangles

    def _sharded_mesh(self, with_colors: bool, color_mode: str):
        """marching_cubes_sharded of this rank's slab, then the ranks'
        triangles gathered in rank order (collectives: every rank calls it);
        equals marching_cubes of the gathered grid."""
        from tracking_sdf_tpu_torch.render.marching_cubes import (
            Mesh, marching_cubes_sharded)

        mesh = self.mesh
        part = marching_cubes_sharded(self._grid_slab(), mesh, params=self.config.grid,
                                      with_colors=with_colors, color_mode=color_mode,
                                      vertex_quant=self.config.mesh_vertex_quant)
        cols = (part.vertices,) + ((part.colors,) if with_colors else ())
        local = torch.from_numpy(np.concatenate([c.reshape(-1, 9) for c in cols], axis=1)
                                 ).to(mesh.device)
        sizes = mesh.all_gather(torch.tensor([local.shape[0], part.dropped_cells],
                                             dtype=torch.int64, device=mesh.device)
                                ).reshape(-1, 2).tolist()
        top = max(1, max(k for k, _ in sizes))
        padded = torch.zeros((top, local.shape[1]), dtype=local.dtype, device=mesh.device)
        padded[:local.shape[0]] = local
        every = mesh.all_gather(padded).reshape(mesh.size, top, -1).cpu().numpy()
        rows = np.concatenate([every[r, :k] for r, (k, _) in enumerate(sizes)])
        tri = np.ascontiguousarray(rows[:, :9].reshape(-1, 3, 3))
        colors = np.ascontiguousarray(rows[:, 9:].reshape(-1, 3, 3)) if with_colors else None
        return Mesh(tri, colors, dropped_cells=sum(d for _, d in sizes))

    def start_mesh_publisher(self, path: str, with_colors: bool = True):
        """Start the background mesh export into ``path`` at config.mesh_hz
        (0 = 1 Hz). The live mesh is decimated by config.mesh_decimate (0 =
        4 at m >= 512, 2 at m >= 256, else 1; stepped down until it divides
        m): D is metric, so every dec-th voxel is the same field, dec times
        coarser. A final export_mesh is never decimated. Each export holds
        pipeline.chunk's device lock while it works on the card."""
        from tracking_sdf_tpu_torch.pipeline.visualizer import MeshPublisher
        from tracking_sdf_tpu_torch.render.marching_cubes import export_ply, marching_cubes

        g = self.config.grid
        if self.mesh is not None:
            # every rank joins the snapshots' gathers; rank 0 exports them
            self._mesh_publishing = True
            if self.mesh.rank != 0:
                return None
        dec = self.config.mesh_decimate or (4 if g.m >= 512 else 2 if g.m >= 256 else 1)
        dec = max(1, dec)
        while g.m % dec:
            dec -= 1

        def export(grid: TSDFGrid) -> None:
            with chunked.DEVICE_LOCK:
                if dec > 1:
                    coarse = TSDFGrid(*(getattr(grid, k)[::dec, ::dec, ::dec]
                                        for k in FIELDS))
                    mesh = marching_cubes(coarse, params=g._replace(m=g.m // dec),
                                          with_colors=with_colors, color_mode="trilinear",
                                          vertex_quant=self.config.mesh_vertex_quant)
                else:  # the whole grid (under a mesh the gathered snapshot)
                    mesh = self._extract_mesh(grid, with_colors, "trilinear")
            export_ply(mesh, path)

        self._publisher = MeshPublisher(export, interval=1.0 / (self.config.mesh_hz or 1.0))
        self._last_publish = float("-inf")  # the first frame publishes
        return self._publisher

    def render(self, pose: Optional[Pose] = None, stride: int = 1, with_color: bool = True,
               t_init: Optional[torch.Tensor] = None):
        """Raycast depth, normals and color of the current model from
        ``pose`` (default the current pose) over the dense view.
        ``t_init``: the previous render's ``range_t``, to start each ray
        near its surface (RaycastConfig.warm_backoff). Under a mesh the rays
        are sharded over the ranks (parallel.render.sharded_raycast, equal to
        the render of the gathered grid; every rank calls it and gets the
        whole image); a warm start renders the gathered grid on each rank.
        Warns (RuntimeWarning) when rays overflowed the slots of the
        compacted recovery march: they render as misses."""
        from tracking_sdf_tpu_torch.render.raycast import raycast

        p = (pose if pose is not None else self.pose).to(self.device)
        if self.mesh is not None and t_init is None:
            from tracking_sdf_tpu_torch.parallel.render import sharded_raycast

            key = (stride, with_color)
            if key not in self._render_sh:
                self._render_sh[key] = sharded_raycast(
                    self.mesh, params=self.config.grid, cam=self.cam,
                    cfg=self.config.raycast, stride=stride, with_color=with_color)
            result = self._render_sh[key](self._grid_slab(), p)
        else:
            result = raycast(self.grid, p, params=self.config.grid, cam=self.cam,
                             cfg=self.config.raycast, stride=stride,
                             with_color=with_color, t_init=t_init)
        n_dropped = int(result.dropped)
        if n_dropped > 0:
            warnings.warn(
                f"raycast: {n_dropped} rays exceeded the fine-phase recovery capacity and "
                "render as misses; use RaycastConfig(sample='trilinear') for exact coverage",
                RuntimeWarning, stacklevel=2)
        return result

    def run(self, dataset, max_frames: Optional[int] = None, mesh_every: int = 0,
            mesh_path: Optional[str] = None, progress: bool = False,
            checkpoint_every: int = 0, checkpoint_path: Optional[str] = None,
            metrics_log: Optional[str] = None, skip_frames: int = 0,
            chunk: int = 0) -> List[FrameStats]:
        """Consume any iterable of frame-likes (``depth``, ``rgb``,
        ``timestamp``, optionally ``gt_pose``; data.tum.TUMFrame).
        ``skip_frames`` skips that many frames first (pass ``frame_num``
        after restore_checkpoint), ``max_frames`` stops at that frame index;
        ``metrics_log`` appends one JSON line of FrameStats per frame (a
        chunk's traced frame adds ``device_ns``, its step's first and last
        device stamps, and ``gn_steps``, each level's full GN steps, coarse
        to fine: ``chunk_trace``).
        ``chunk`` > 1 hands that many frames at a time to process_chunk
        (frame 0 and an odd tail run per frame; the flat layouts, packed
        and the groundtruth oracle mode, which have no chunked path, warn
        and run per frame). ``checkpoint_every`` saves to
        ``checkpoint_path`` when the newest processed frame's index is a
        multiple of it (a chunk
        saves once, at its last frame, if that index is). ``mesh_every``
        exports the mesh to ``mesh_path`` on every emitted frame whose index
        is a multiple of it (a chunk's frames are emitted after the chunk,
        so each such frame of it exports the chunk's final grid)."""
        cfg = self.config
        if chunk > 1 and not self._chunk_supported():
            warnings.warn("chunked processing needs mode='brickmajor' (not 'packed') "
                          "and tracked (not groundtruth) poses; running per frame",
                          RuntimeWarning, stacklevel=2)
            chunk = 0
        log = open(metrics_log, "a") if metrics_log else None
        pend = []  # frames held for the next chunk

        def emit(stat: FrameStats, traced: Optional[dict] = None) -> None:
            self.emit_times.append(time.perf_counter())
            if progress:
                print(f"frame {stat.index}: track {stat.track_ms:.1f} ms "
                      f"({stat.gn_iterations} GN iters, {stat.num_valid} px), "
                      f"fuse {stat.fuse_ms:.1f} ms", flush=True)
            if log is not None:
                log.write(json.dumps(dict(dataclasses.asdict(stat), **(traced or {}))) + "\n")
                log.flush()
            if mesh_every and mesh_path and stat.index % mesh_every == 0:
                self.export_mesh(mesh_path)
            # a chunk emits its stats after it ran: only its newest frame saves
            if (checkpoint_every and checkpoint_path
                    and stat.index % checkpoint_every == 0
                    and stat.index == self.frame_num):
                self.save_checkpoint(checkpoint_path)

        def flush(final: bool = False) -> None:
            if final and len(pend) < chunk:  # the odd tail runs per frame
                for f in pend:
                    emit(self.process_frame(f.depth, f.rgb, timestamp=f.timestamp))
            elif pend:
                rgbs = None
                if cfg.fusion.fuse_color and all(f.rgb is not None for f in pend):
                    rgbs = _stack([f.rgb for f in pend])
                stats = self.process_chunk(_stack([f.depth for f in pend]), rgbs,
                                           timestamps=[f.timestamp for f in pend])
                tr = self.chunk_trace
                for k, stat in enumerate(stats):
                    emit(stat, None if tr is None else dict(
                        device_ns=tr.stamps[k].tolist(), gn_steps=tr.full_steps[k].tolist()))
            pend.clear()

        try:
            for i, frame in enumerate(dataset):
                if i < skip_frames:
                    continue
                if max_frames is not None and i >= max_frames:
                    break
                if chunk > 1 and self.frame_num >= 1:
                    pend.append(frame)
                    if len(pend) == chunk:
                        flush()
                    continue
                gt = None
                if cfg.use_groundtruth and getattr(frame, "gt_pose", None) is not None:
                    t, q = frame.gt_pose
                    gt = Pose(matrix_from_quaternion(torch.as_tensor(
                        np.asarray(q, np.float32), device=self.device)),
                        torch.as_tensor(np.asarray(t, np.float32), device=self.device))
                emit(self.process_frame(frame.depth, frame.rgb, timestamp=frame.timestamp,
                                        gt_pose=gt))
            flush(final=True)
        finally:
            if log is not None:
                log.close()
        return self.stats

    def save_checkpoint(self, path: str) -> None:
        """Snapshot the dense grid, the pose, the velocity carry and the
        frame counter (pipeline.checkpoint). Under a mesh every rank calls
        it: the grid is gathered, rank 0 writes, and the others wait for it
        at a barrier."""
        from tracking_sdf_tpu_torch.pipeline.checkpoint import save_checkpoint

        grid = self.grid
        if self.mesh is None or self.mesh.rank == 0:
            save_checkpoint(path, grid, self.pose, self.frame_num,
                            pose_prev=self._pose_prev)
        if self.mesh is not None:
            self.mesh.barrier()

    def restore_checkpoint(self, path: str) -> None:
        """Continue from a checkpoint: the run then goes on bit for bit as
        if it had not stopped. The trajectory file, if not yet written to,
        is appended to."""
        from tracking_sdf_tpu_torch.pipeline.checkpoint import load_checkpoint

        grid, pose, frame_num, _, pose_prev = load_checkpoint(path, device=self.device)
        if debug_nans.enabled():  # the grid is checked by its setter
            self._check_invariants(None, pose, f"the checkpoint {path}")
        # under a mesh every rank reads the whole grid and keeps its slab
        if self._writer is not None and not self._writer.started:
            self._writer.set_append(True)
        self.grid = grid  # the setter drops the captured chunk steps
        self.pose = pose
        self._pose_prev = pose_prev
        self.frame_num = frame_num

    def summary(self) -> Dict[str, float]:
        """Frames, mean track and fuse ms, mean GN iterations and frames per
        second (of track + fuse) over the frames after the first, which
        carries first-use costs, and the bricks dropped at a cap in all."""
        if not self.stats:
            return {}
        rest = self.stats[1:]
        track = np.asarray([s.track_ms for s in rest] or [0.0])
        fuse = np.asarray([s.fuse_ms for s in rest] or [s.fuse_ms for s in self.stats])
        return {
            "frames": float(len(self.stats)),
            "track_ms_mean": float(track.mean()),
            "fuse_ms_mean": float(fuse.mean()),
            "gn_iters_mean": float(np.mean([s.gn_iterations for s in rest] or [0])),
            "fps": 1e3 / float(track.mean() + fuse.mean()),
            "overflow_drops": float(self.overflow_drops),
        }

    def close(self) -> None:
        """Stop the mesh publisher (after its final export) and close the
        trajectory file."""
        if self._publisher is not None:
            self._publisher.close()
            self._publisher = None
        if self._writer is not None:
            self._writer.close()
            self._writer = None


def _stack(frames):
    """Frames (tensors or array-likes) as one (N, ...) stack."""
    if all(torch.is_tensor(f) for f in frames):
        return torch.stack(list(frames))
    return np.stack([np.asarray(f) for f in frames])
