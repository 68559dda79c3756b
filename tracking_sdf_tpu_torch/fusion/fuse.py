"""Dense TSDF depth + color fusion (counterpart of tracking_sdf_tpu.fusion.fuse).

Every voxel projects into the image, reads its pixel's point, normal and
color, and folds them into running weighted means. This is the port's exact
in-package reference for the bricked path. D is positive in free space.
"""
from __future__ import annotations

from typing import Optional

import torch

from tracking_sdf_tpu_torch.config import FusionConfig, GridParams
from tracking_sdf_tpu_torch.core.camera import PinholeCamera
from tracking_sdf_tpu_torch.core.lie import Pose
from tracking_sdf_tpu_torch.grid.grid import TSDFGrid, voxel_centers_world


def weighting(name: str, d: torch.Tensor, eps: float, delta: float) -> torch.Tensor:
    """Fusion weight of the canonical (+free space) distance d, before the
    d < -delta occlusion cut (paper Table II family)."""
    behind = d <= -eps
    one = torch.ones_like(d)
    if name == "exponential":
        return torch.where(behind, torch.exp(-0.5 * (d + eps) ** 2), one)
    if name == "linear":
        return torch.where(
            behind, torch.clamp((delta + d) / (delta - eps), 0.0, 1.0), one)
    if name == "constant":
        return one
    if name.startswith("narrow_"):
        return weighting(name[len("narrow_"):], d, eps, delta / 10.0)
    raise ValueError(f"unknown weighting: {name}")


def world_to_camera_components(pose: Pose, x, y, z):
    """Rᵀ (p - t), channel by channel."""
    Rt = pose.R.T
    dx, dy, dz = x - pose.t[0], y - pose.t[1], z - pose.t[2]
    px = Rt[0, 0] * dx + Rt[0, 1] * dy + Rt[0, 2] * dz
    py = Rt[1, 0] * dx + Rt[1, 1] * dy + Rt[1, 2] * dz
    pz = Rt[2, 0] * dx + Rt[2, 1] * dy + Rt[2, 2] * dz
    return px, py, pz


def pixel_finite(points_cam: torch.Tensor, normals_cam: torch.Tensor) -> torch.Tensor:
    """The reference's per-pixel validity: point x, y and the normal finite."""
    return (torch.isfinite(points_cam[..., :2]).all(-1)
            & torch.isfinite(normals_cam).all(-1))


def pixel_channels(points_cam, normals_cam, rgb, cfg: FusionConfig) -> torch.Tensor:
    """(H*W, C): [nx, ny, nz, y·n, cos, y_z, finite (, r, g, b)]."""
    h, w_img = points_cam.shape[:2]
    finite = pixel_finite(points_cam, normals_cam)
    zero = torch.zeros((), device=points_cam.device)
    fin3 = finite[..., None]
    s_img = torch.where(fin3, points_cam * normals_cam, zero).sum(-1)
    norm_n = torch.sqrt(torch.where(fin3, normals_cam * normals_cam, zero).sum(-1))
    cos_img = torch.where(
        norm_n > 0,
        torch.abs(torch.where(finite, normals_cam[..., 2], zero))
        / torch.where(norm_n > 0, norm_n, torch.ones_like(norm_n)), zero)
    channels = [torch.where(finite, normals_cam[..., c], zero) for c in range(3)]
    channels += [s_img, cos_img, torch.where(finite, points_cam[..., 2], zero),
                 finite.to(torch.float32)]
    if cfg.fuse_color and rgb is not None:
        channels += [rgb[..., 0], rgb[..., 1], rgb[..., 2]]
    return torch.stack(channels, dim=-1).reshape(h * w_img, -1)


def fuse_voxels(
    grid: TSDFGrid,
    pose: Pose,
    pix: torch.Tensor,  # (H*W, C) from pixel_channels
    image_hw: tuple,
    *,
    params: GridParams,
    cam: PinholeCamera,
    cfg: FusionConfig,
    i_offset: int = 0,
) -> TSDFGrid:
    """The per-voxel fusion pass over a (mi, m, m) grid slab whose first
    plane is global voxel i = ``i_offset``: each voxel projects into the
    image, reads its pixel's row of ``pix`` and folds it into the running
    weighted means. Returns a new grid."""
    h, w_img = image_hw
    x, y, z = voxel_centers_world(params, device=grid.D.device, i_offset=i_offset,
                                  mi=grid.D.shape[0])
    px, py, pz = world_to_camera_components(pose, x, y, z)

    in_front = pz > 0
    safe_z = torch.where(in_front, pz, torch.ones_like(pz))
    u = (cam.fx * px + cam.cx * pz) / safe_z
    v = (cam.fy * py + cam.cy * pz) / safe_z
    iu = torch.trunc(u).to(torch.int64)  # C-style casts: truncation toward zero
    iv = torch.trunc(v).to(torch.int64)
    inside = (iu >= 0) & (iu < w_img) & (iv >= 0) & (iv < h)
    flat = iv.clamp(0, h - 1) * w_img + iu.clamp(0, w_img - 1)
    g = pix[flat]  # (m, m, m, C)
    nx, ny, nz, s, cosv, yz, fin = (g[..., c] for c in range(7))

    if cfg.distance == "point_to_plane":
        d = -(s - (px * nx + py * ny + pz * nz))
    elif cfg.distance == "point_to_point":
        d = yz - pz
    else:
        raise ValueError(f"unknown distance: {cfg.distance}")

    fuse_mask = in_front & inside & (fin > 0) & (d >= -params.delta)
    d = torch.clamp(d, max=params.delta)
    zero = torch.zeros_like(d)
    w_new = torch.where(
        fuse_mask, weighting(cfg.weighting, d, params.epsilon, params.delta), zero)

    # divide by the uncapped sum; clamp only the stored weight
    W_sum = grid.W + w_new
    W_new = W_sum if cfg.max_weight is None else torch.clamp(W_sum, max=cfg.max_weight)
    has = w_new > 0
    D_new = torch.where(
        has, (grid.W * grid.D + w_new * d) / torch.where(has, W_sum, zero + 1.0),
        grid.D)

    if cfg.fuse_color and pix.shape[-1] >= 10:
        wc_new = w_new * cosv
        Wc_sum = grid.Wc + wc_new
        Wc_new = (Wc_sum if cfg.max_weight is None
                  else torch.clamp(Wc_sum, max=cfg.max_weight))
        has_c = wc_new > 0
        safe = torch.where(has_c, Wc_sum, zero + 1.0)
        R_new, G_new, B_new = (
            torch.where(has_c, (grid.Wc * old + wc_new * g[..., c]) / safe, old)
            for old, c in ((grid.R, 7), (grid.G, 8), (grid.B, 9)))
    else:
        Wc_new, R_new, G_new, B_new = grid.Wc, grid.R, grid.G, grid.B
    return TSDFGrid(D=D_new, W=W_new, R=R_new, G=G_new, B=B_new, Wc=Wc_new)


def fuse_frame(
    grid: TSDFGrid,
    pose: Pose,
    points_cam: torch.Tensor,  # (H, W, 3) organized camera-frame points
    normals_cam: torch.Tensor,  # (H, W, 3) normals toward the camera
    rgb: Optional[torch.Tensor],  # (H, W, 3) in [0, 1], or None
    *,
    params: GridParams,
    cam: PinholeCamera,
    cfg: FusionConfig = FusionConfig(),
    i_offset: int = 0,
) -> TSDFGrid:
    """Fuse one frame; returns a new grid. ``grid`` may be an i-slab of
    (mi, m, m) leaves whose first plane is global voxel i = ``i_offset``
    (parallel.sharded)."""
    pix = pixel_channels(points_cam, normals_cam, rgb, cfg)
    return fuse_voxels(grid, pose, pix, points_cam.shape[:2], params=params, cam=cam,
                       cfg=cfg, i_offset=i_offset)


def make_fuse_fn(params: GridParams, cam: PinholeCamera, cfg: FusionConfig):
    """fuse_frame with ``params``, ``cam`` and ``cfg`` bound:
    fn(grid, pose, points_cam, normals_cam, rgb=None) -> grid."""
    def fn(grid, pose, points_cam, normals_cam, rgb=None):
        return fuse_frame(grid, pose, points_cam, normals_cam, rgb, params=params,
                          cam=cam, cfg=cfg)
    return fn
