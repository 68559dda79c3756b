"""End-to-end frame loop (counterpart of tracking_sdf_tpu.pipeline.runner).

Per frame: preprocess (separable bilateral filter, backprojection, normals),
track from the second frame on (pyramid or flat Gauss-Newton; one K1 step
launch per iteration, the state on the device), read the tracking state
once (its stats and the failure gate's inputs), gate failed tracks, append the pose to the TUM trajectory, and
fuse with brick compaction (K2 in every fused frame). Two single-device
fusion layouts are ported:
  * ``mode="brickmajor"`` (the tum256 and tum512 presets): the grid lives as
    brick rows (fusion.brickmajor), and tracking reads the brick-major masked
    view of the D rows; the dense grid is built only when ``grid`` is read.
  * ``mode="bricked", brick_merge="pallas"``: the flat (m, m, m) grid.
Rendering, meshing, checkpoints and chunked processing are not ported yet.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from tracking_sdf_tpu_torch.config import PipelineConfig
from tracking_sdf_tpu_torch.core.camera import PinholeCamera
from tracking_sdf_tpu_torch.core.lie import Pose, pose_compose, pose_inverse
from tracking_sdf_tpu_torch.fusion.brick import FuseStats, fuse_frame_bricked
from tracking_sdf_tpu_torch.fusion.brickmajor import (
    brick_grid_from_dense, brick_masked_view, dense_from_brick_grid,
    empty_brick_grid, fuse_frame_brickmajor, storage_dtype)
from tracking_sdf_tpu_torch.grid.grid import TSDFGrid, empty_grid
from tracking_sdf_tpu_torch.pipeline.trajectory import TrajectoryWriter
from tracking_sdf_tpu_torch.tracking.gauss_newton import track_frame
from tracking_sdf_tpu_torch.tracking.preprocess import preprocess_frame
from tracking_sdf_tpu_torch.tracking.pyramid import track_frame_pyramid

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


def _check_supported(config: PipelineConfig) -> None:
    f = config.fusion
    unsupported = [
        (f.mode not in ("brickmajor", "bricked"), f"fusion.mode={f.mode!r}"),
        (f.mode == "bricked" and f.brick_merge != "pallas",
         f"fusion.brick_merge={f.brick_merge!r} with mode='bricked'"),
        (f.sat_skip, "fusion.sat_skip=True"),
        (config.tracking.jacobian != "analytic",
         f"tracking.jacobian={config.tracking.jacobian!r}"),
        (config.use_groundtruth, "use_groundtruth=True"),
        (config.bilateral_filter and config.bilateral_mode != "separable",
         f"bilateral_mode={config.bilateral_mode!r}"),
    ]
    bad = [what for cond, what in unsupported if cond]
    if bad:
        raise NotImplementedError(
            "the port runs the single-device mode='brickmajor' path and the "
            "mode='bricked', brick_merge='pallas' path, with the analytic "
            "Jacobian and the separable bilateral filter; unsupported: "
            + ", ".join(bad))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Reconstruction:
    """Stateful frame loop: owns the grid, the pose and the trajectory file."""

    def __init__(self, cam: PinholeCamera, config: PipelineConfig = PipelineConfig(),
                 initial_pose: Optional[Pose] = None, *, device):
        _check_supported(config)
        self.device = torch.device(device)
        self.cam = cam
        self.config = config
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
        if f.mode == "brickmajor":
            self._vdt = storage_dtype(f.storage_dtype)
            self._wdt = storage_dtype(f.weight_dtype)
            self._bgrid = empty_brick_grid(config.grid, self._bs, device=self.device,
                                           value_dtype=self._vdt,
                                           weight_dtype=self._wdt)
            self._dm = brick_masked_view(self._bgrid, config.grid, self._bs)
        else:
            self._grid = empty_grid(config.grid, device=self.device)
        # adaptive FULL cap: the smallest of three levels that covers ~1.3x
        # the previous frame's FULL count (overflow escalates the next frame)
        cap_max = config.fusion.brick_cap
        self._cap_levels = sorted({max(256, cap_max // 4), max(256, cap_max // 2),
                                   cap_max})
        self._cap_idx = len(self._cap_levels) - 1
        self.last_fuse_stats: Optional[FuseStats] = None

    @property
    def grid(self) -> TSDFGrid:
        """The dense (m, m, m) grid. In brick-major mode this materializes it
        from the brick rows (six float32 leaves): for tests and export, not
        for the per-frame path."""
        if self._bgrid is not None:
            return dense_from_brick_grid(self._bgrid, self.config.grid, self._bs)
        return self._grid

    @grid.setter
    def grid(self, g: TSDFGrid) -> None:
        if self._bgrid is not None:
            self._bgrid = brick_grid_from_dense(g, self._bs, value_dtype=self._vdt,
                                                weight_dtype=self._wdt)
            self._dm = brick_masked_view(self._bgrid, self.config.grid, self._bs)
        else:
            self._grid = g

    @property
    def brick_grid(self):
        """The brick-major rows (fusion.brickmajor.BrickGrid), None in the
        flat layout. Fusion updates them in place."""
        return self._bgrid

    def _fuse(self, points, normals, rgb) -> None:
        cfg = self.config
        cap = self._cap_levels[self._cap_idx]
        if self._bgrid is not None:
            _, self._dm, stats = fuse_frame_brickmajor(
                self._bgrid, self.pose, points, normals, rgb, params=cfg.grid,
                cam=self.cam, cfg=cfg.fusion, bs=self._bs, cap=cap,
                cap_free=cfg.fusion.brick_cap_free or None)
        else:
            _, stats = fuse_frame_bricked(
                self._grid, self.pose, points, normals, rgb, params=cfg.grid,
                cam=self.cam, cfg=cfg.fusion, bs=self._bs, cap=cap,
                cap_act=cfg.fusion.brick_cap_active or None)
        self.last_fuse_stats = stats
        need = stats.n_full * 1.3
        self._cap_idx = next((i for i, c in enumerate(self._cap_levels) if c >= need),
                             len(self._cap_levels) - 1)

    def _predict_pose(self) -> Pose:
        """Initial pose of the GN descent: the previous pose, or the
        constant-velocity prediction T_{n-1} ∘ (T_{n-2}^-1 ∘ T_{n-1})."""
        if self.config.pose_init == "velocity" and self._pose_prev is not None:
            return pose_compose(self.pose, pose_compose(pose_inverse(self._pose_prev),
                                                        self.pose))
        return self.pose

    def _as_depth(self, depth) -> torch.Tensor:
        if not torch.is_tensor(depth):
            depth = np.asarray(depth)
            if depth.dtype == np.uint16:  # TUM PNG encoding: 5000 per meter, 0 = hole
                d = depth.astype(np.float32) / 5000.0
                d[depth == 0] = np.nan
                depth = d
        return torch.as_tensor(depth, dtype=torch.float32, device=self.device)

    def _as_rgb(self, rgb) -> Optional[torch.Tensor]:
        if rgb is None:
            return None
        if not torch.is_tensor(rgb):
            rgb = np.asarray(rgb)
            if rgb.dtype == np.uint8:
                rgb = rgb.astype(np.float32) / 255.0
        return torch.as_tensor(rgb, dtype=torch.float32, device=self.device)

    def process_frame(self, depth, rgb=None, timestamp: Optional[float] = None) -> FrameStats:
        """Run the per-frame pipeline on a (H, W) depth image in meters (NaN
        holes; or TUM uint16) and optional (H, W, 3) colors in [0, 1] (or
        uint8). Returns timing and optimizer stats."""
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
        if self.frame_num > 1:
            pose0 = self._predict_pose()
            # brick-major: track against the view of the D rows (grid=None)
            grid = self._grid
            if cfg.pyramid_levels:
                res, _ = track_frame_pyramid(
                    grid, pose0, points, params=cfg.grid, cfg=cfg.tracking,
                    levels=cfg.pyramid_levels, Dm=self._dm)
            else:
                s = cfg.tracking.pixel_stride
                res = track_frame(grid, pose0, points[::s, ::s],
                                  params=cfg.grid, cfg=cfg.tracking, Dm=self._dm)
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

        stat = FrameStats(index=self.frame_num, timestamp=timestamp,
                          track_ms=track_ms, fuse_ms=fuse_ms,
                          gn_iterations=gn_iters, num_valid=nvalid,
                          mean_abs_residual=mean_res, rejected=rejected,
                          preprocess_ms=preprocess_ms)
        self.stats.append(stat)
        return stat

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None
