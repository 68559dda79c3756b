"""Coarse-to-fine Gauss-Newton tracking (counterpart of tracking_sdf_tpu.tracking.pyramid).

Each level decimates the organized point image by ``cfg.pixel_stride * mult``
(a strided view, which the kernel reads in place) and starts from the
previous level's pose, a view of that level's state on the device: on the
card nothing is read back between levels. Coarse levels are capped at
``coarse_iterations`` with no ``min_iterations`` floor; the floor exists to
make the finest level re-optimise past the coarse level's biased optimum.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from tracking_sdf_tpu_torch.config import GridParams, TrackingConfig
from tracking_sdf_tpu_torch.core.lie import Pose
from tracking_sdf_tpu_torch.grid.grid import TSDFGrid
from tracking_sdf_tpu_torch.grid.interp import MaskedView, masked_view
from tracking_sdf_tpu_torch.tracking.gauss_newton import TrackResult, track_frame


def track_frame_pyramid(
    grid: Optional[TSDFGrid],
    pose0: Pose,
    points_img: torch.Tensor,  # (H, W, 3) organized camera-frame points
    *,
    params: GridParams,
    cfg: TrackingConfig = TrackingConfig(),
    levels: Sequence[int] = (4, 2, 1),
    coarse_iterations: int = 10,
    Dm: Optional[MaskedView] = None,  # precomputed masked view
) -> Tuple[TrackResult, Tuple[TrackResult, ...]]:
    """Returns (finest-level result, per-level results). Without ``Dm`` the
    masked view is built once here from ``grid``; with it, ``grid`` may be
    None (the brick-major loop never builds the dense grid). The central
    Jacobian reads ``grid`` at every level."""
    if not levels or levels[-1] != 1:
        raise ValueError("levels must be non-empty and end at 1 "
                         "(finest = cfg.pixel_stride)")
    if Dm is None and cfg.jacobian == "analytic":
        Dm = masked_view(grid.D, grid.W)
    pose = pose0
    results = []
    for mult in levels:
        stride = cfg.pixel_stride * mult
        pts = points_img[::stride, ::stride]
        level_cfg = cfg if mult == 1 else cfg._replace(
            max_iterations=coarse_iterations, min_iterations=0)
        res = track_frame(grid, pose, pts, params=params, cfg=level_cfg, Dm=Dm)
        pose = res.pose
        results.append(res)
    return results[-1], tuple(results)
