"""Pinhole camera model (counterpart of tracking_sdf_tpu.core.camera).

(u, v) = (column, row). The camera is a NamedTuple of Python floats with
the same fields as the JAX package's, so either can be passed here.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class PinholeCamera(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    width: int = 640
    height: int = 480


def tum_fr1_camera() -> PinholeCamera:
    """Calibrated intrinsics of the TUM freiburg1 sequences."""
    return PinholeCamera(fx=517.3, fy=516.5, cx=318.6, cy=255.3)


def ros_default_camera() -> PinholeCamera:
    """The factory Kinect intrinsics ROS publishes on camera_info."""
    return PinholeCamera(fx=525.0, fy=525.0, cx=319.5, cy=239.5)


def project(cam: PinholeCamera, points_cam: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (..., 3) -> continuous pixel coords (..., 2)."""
    x, y, z = points_cam[..., 0], points_cam[..., 1], points_cam[..., 2]
    safe_z = torch.where(z == 0, torch.ones_like(z), z)
    u = (cam.fx * x + cam.cx * z) / safe_z
    v = (cam.fy * y + cam.cy * z) / safe_z
    return torch.stack([u, v], dim=-1)


def backproject(cam: PinholeCamera, depth: torch.Tensor) -> torch.Tensor:
    """Depth image (H, W) -> organized camera-frame points (H, W, 3).

    Pixels with non-finite or <= 0 depth yield NaN points."""
    h, w = depth.shape
    v = torch.arange(h, dtype=depth.dtype, device=depth.device)[:, None]
    u = torch.arange(w, dtype=depth.dtype, device=depth.device)[None, :]
    valid = torch.isfinite(depth) & (depth > 0)
    z = torch.where(valid, depth, torch.full_like(depth, float("nan")))
    x = (u - cam.cx) / cam.fx * z
    y = (v - cam.cy) / cam.fy * z
    return torch.stack([x, y, z], dim=-1)


def pixel_rays(cam: PinholeCamera, stride: int = 1, *,
               device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unit-z ray directions (Hs, Ws, 3) and pixel coords (Hs, Ws, 2) for
    a strided pixel lattice, in the camera frame."""
    v = torch.arange(0, cam.height, stride, dtype=torch.float32,
                     device=device)[:, None]
    u = torch.arange(0, cam.width, stride, dtype=torch.float32,
                     device=device)[None, :]
    x = (u - cam.cx) / cam.fx
    y = (v - cam.cy) / cam.fy
    shape = (v.shape[0], u.shape[1])
    dirs = torch.stack([x.expand(shape), y.expand(shape),
                        torch.ones(shape, device=device)], dim=-1)
    pix = torch.stack([u.expand(shape), v.expand(shape)], dim=-1)
    return dirs, pix
