"""Depth preprocessing: bilateral smoothing and organized normals
(counterpart of tracking_sdf_tpu.tracking.preprocess).

Stencils over shifted copies of the image; invalidity is NaN. Both bilateral
filters are ported: the full 2-D kernel (``bilateral_mode="full"``, the
default and the reference's) and the separable passes that the tum256 and
tum512 presets run.
"""
from __future__ import annotations

import functools
import math
from typing import Tuple

import torch

from tracking_sdf_tpu_torch.core.camera import PinholeCamera, backproject


def _shifted(img: torch.Tensor, dy: int, dx: int, fill: float) -> torch.Tensor:
    """out[y, x] = img[y + dy, x + dx], ``fill`` outside the image."""
    h, w = img.shape[:2]
    out = torch.full_like(img, fill)
    ys, yd = slice(max(dy, 0), h + min(dy, 0)), slice(max(-dy, 0), h + min(-dy, 0))
    xs, xd = slice(max(dx, 0), w + min(dx, 0)), slice(max(-dx, 0), w + min(-dx, 0))
    out[yd, xd] = img[ys, xs]
    return out


@functools.lru_cache(maxsize=None)
def _spatial_weights(radius: int, sigma_spatial: float, device: torch.device) -> torch.Tensor:
    """(2r+1, 2r+1) float32 tap weights exp(-(dy² + dx²) / (2 σs²)), taken in
    double as the JAX package's ``math.exp``, copied to ``device`` once (a
    captured frame step may not copy from the host)."""
    inv2ss = 1.0 / (2.0 * sigma_spatial ** 2)
    taps = range(-radius, radius + 1)
    return torch.tensor([[math.exp(-(dy * dy + dx * dx) * inv2ss) for dx in taps]
                         for dy in taps], dtype=torch.float32, device=device)


def bilateral_filter(
    depth: torch.Tensor,
    radius: int = 5,
    sigma_spatial: float = 3.0,
    sigma_range: float = 0.03,
) -> torch.Tensor:
    """The full 2-D (2r+1)^2 bilateral kernel: edge-preserving depth
    smoothing with NaN neighbours excluded; NaN holes stay NaN.

    All taps are built at once (pad with NaN, two ``unfold``s, one reduction
    over the window): ~10 launches a frame at (2r+1)^2·H·W floats of
    temporaries, where the JAX package's loop over taps sums them one by one
    (the same terms, summed in another order)."""
    k = 2 * radius + 1
    center_valid = torch.isfinite(depth)
    d0 = torch.where(center_valid, depth, 0.0)
    inv2sr = 1.0 / (2.0 * sigma_range ** 2)
    sw = _spatial_weights(radius, sigma_spatial, depth.device)
    padded = torch.nn.functional.pad(depth[None, None], (radius,) * 4,
                                     value=float("nan"))[0, 0]
    dn = padded.unfold(0, k, 1).unfold(1, k, 1)  # (H, W, k, k) view
    ok = torch.isfinite(dn)
    dn0 = torch.where(ok, dn, 0.0)
    w = torch.where(ok, sw * torch.exp(-((dn0 - d0[..., None, None]) ** 2) * inv2sr), 0.0)
    num = (w * dn0).sum(dim=(-2, -1))
    den = w.sum(dim=(-2, -1))
    out = num / torch.clamp(den, min=1e-12)
    return torch.where(center_valid & (den > 0), out, float("nan"))


def bilateral_filter_separable(
    depth: torch.Tensor,
    radius: int = 5,
    sigma_spatial: float = 3.0,
    sigma_range: float = 0.03,
) -> torch.Tensor:
    """Vertical-then-horizontal 1-D bilateral passes; the range weight of
    pass 2 compares against the pass-1 output. NaN holes stay NaN; NaN
    neighbours are excluded per pass."""
    center_valid = torch.isfinite(depth)
    inv2ss = 1.0 / (2.0 * sigma_spatial ** 2)
    inv2sr = 1.0 / (2.0 * sigma_range ** 2)
    zero = torch.zeros((), dtype=depth.dtype, device=depth.device)

    def pass1d(img, axis):
        fin = torch.isfinite(img)
        d0 = torch.where(fin, img, zero)
        num = torch.zeros_like(d0)
        den = torch.zeros_like(d0)
        for d in range(-radius, radius + 1):
            sw = math.exp(-(d * d) * inv2ss)
            dy, dx = (d, 0) if axis == 0 else (0, d)
            dn = _shifted(img, dy, dx, float("nan"))
            ok = torch.isfinite(dn)
            dn0 = torch.where(ok, dn, zero)
            w = torch.where(ok, sw * torch.exp(-((dn0 - d0) ** 2) * inv2sr), zero)
            num = num + w * dn0
            den = den + w
        out = num / torch.clamp(den, min=1e-12)
        return torch.where(fin & (den > 0), out, torch.full_like(out, float("nan")))

    out = pass1d(pass1d(depth, 0), 1)
    return torch.where(center_valid, out, torch.full_like(out, float("nan")))


def _masked_box(img: torch.Tensor, valid: torch.Tensor, radius: int):
    """Separable masked box average; returns (mean, count > 0). img (H, W, C)."""
    x = torch.where(valid, img, torch.zeros_like(img))
    v = valid.to(img.dtype)
    for axis in (0, 1):
        xs = torch.zeros_like(x)
        vs = torch.zeros_like(v)
        for d in range(-radius, radius + 1):
            dy, dx = (d, 0) if axis == 0 else (0, d)
            xs = xs + _shifted(x, dy, dx, 0.0)
            vs = vs + _shifted(v, dy, dx, 0.0)
        x, v = xs, vs
    return x / torch.clamp(v, min=1e-12), v > 0


def estimate_normals(
    points_cam: torch.Tensor,  # (H, W, 3) organized camera-frame points
    max_depth_change_factor: float = 0.02,
    smoothing_radius: int = 4,
) -> torch.Tensor:
    """Organized normals, AVERAGE_3D_GRADIENT style: masked-box-smoothed
    tangents along u and v, n = normalize(t_u x t_v), oriented toward the
    camera (n . p < 0), NaN where invalid."""
    z = points_cam[..., 2]
    z_ok = torch.isfinite(z)

    def tangent(axis):
        dy, dx = (1, 0) if axis == 0 else (0, 1)
        p_p = _shifted(points_cam, dy, dx, float("nan"))
        p_m = _shifted(points_cam, -dy, -dx, float("nan"))
        t = 0.5 * (p_p - p_m)
        dz = torch.abs(p_p[..., 2] - p_m[..., 2])
        ok = (torch.isfinite(p_p).all(-1) & torch.isfinite(p_m).all(-1)
              & (dz < max_depth_change_factor
                 * torch.clamp(torch.abs(z), min=1.0) * 2.0))
        return t, ok

    t_v, ok_v = tangent(0)
    t_u, ok_u = tangent(1)
    tu_s, any_u = _masked_box(t_u, ok_u[..., None], smoothing_radius)
    tv_s, any_v = _masked_box(t_v, ok_v[..., None], smoothing_radius)

    n = torch.linalg.cross(tu_s, tv_s, dim=-1)
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    ok = (z_ok & any_u[..., 0] & any_v[..., 0] & (norm[..., 0] > 1e-12)
          & torch.isfinite(n).all(-1))
    n = n / torch.clamp(norm, min=1e-12)
    flip = torch.sum(torch.where(ok[..., None], n * points_cam,
                                 torch.zeros_like(n)), dim=-1, keepdim=True) > 0
    n = torch.where(flip, -n, n)
    return torch.where(ok[..., None], n, torch.full_like(n, float("nan")))


def preprocess_frame(
    depth: torch.Tensor,
    *,
    cam: PinholeCamera,
    bilateral: bool = True,
    bilateral_mode: str = "full",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """depth (H, W) -> (points_cam, normals_cam), both (H, W, 3).
    ``bilateral_mode``: "full" (the 2-D kernel) or "separable"."""
    if bilateral:
        if bilateral_mode == "full":
            depth = bilateral_filter(depth)
        elif bilateral_mode == "separable":
            depth = bilateral_filter_separable(depth)
        else:
            raise ValueError(f"unknown bilateral_mode: {bilateral_mode}")
    points = backproject(cam, depth)
    return points, estimate_normals(points)
