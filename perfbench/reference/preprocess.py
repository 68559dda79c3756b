"""Plain preprocessing: the TUM wire decode, the separable bilateral filter,
backprojection and organized normals, as the configuration states them
(radius 5, sigma_s 3, sigma_r 0.03 m; normals from central tangents with
the 0.02 depth-change test and a masked 9x9 box, oriented to the camera).
Invalid is NaN throughout."""
from __future__ import annotations

import math

import torch

RADIUS, SIGMA_S, SIGMA_R = 5, 3.0, 0.03
DEPTH_CHANGE, SMOOTHING = 0.02, 4


def decode_depth(bits: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """TUM uint16 depth held as int16 bits -> float32 meters, NaN at 0; a
    true division by the 0-dim tensor ``scale`` (5000)."""
    d16 = (bits.to(torch.int32) & 0xFFFF).to(torch.float32)
    return torch.where(d16 > 0, d16 / scale, float("nan"))


def decode_rgb(rgb: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """uint8 colors -> [0, 1]: a true division by the 0-dim tensor ``scale`` (255)."""
    return rgb.to(torch.float32) / scale


def _shifted(img: torch.Tensor, dy: int, dx: int, fill: float) -> torch.Tensor:
    """out[y, x] = img[y + dy, x + dx], ``fill`` outside the image."""
    h, w = img.shape[:2]
    out = torch.full_like(img, fill)
    if abs(dy) >= h or abs(dx) >= w:
        return out
    ys, yd = slice(max(dy, 0), h + min(dy, 0)), slice(max(-dy, 0), h + min(-dy, 0))
    xs, xd = slice(max(dx, 0), w + min(dx, 0)), slice(max(-dx, 0), w + min(-dx, 0))
    out[yd, xd] = img[ys, xs]
    return out


def bilateral_pass(img: torch.Tensor, axis: int) -> torch.Tensor:
    """One 1-D bilateral pass: NaN taps excluded, NaN where the centre is."""
    inv2ss = 1.0 / (2.0 * SIGMA_S ** 2)
    inv2sr = 1.0 / (2.0 * SIGMA_R ** 2)
    zero = torch.zeros((), dtype=img.dtype, device=img.device)
    fin = torch.isfinite(img)
    d0 = torch.where(fin, img, zero)
    num = torch.zeros_like(d0)
    den = torch.zeros_like(d0)
    for d in range(-RADIUS, RADIUS + 1):
        sw = math.exp(-(d * d) * inv2ss)
        dn = _shifted(img, d if axis == 0 else 0, d if axis == 1 else 0, float("nan"))
        ok = torch.isfinite(dn)
        dn0 = torch.where(ok, dn, zero)
        w = torch.where(ok, sw * torch.exp(-((dn0 - d0) ** 2) * inv2sr), zero)
        num = num + w * dn0
        den = den + w
    out = num / torch.clamp(den, min=1e-12)
    return torch.where(fin & (den > 0), out, torch.full_like(out, float("nan")))


def bilateral_separable(depth: torch.Tensor) -> torch.Tensor:
    out = bilateral_pass(bilateral_pass(depth, 0), 1)
    return torch.where(torch.isfinite(depth), out, torch.full_like(out, float("nan")))


def backproject(cam: dict, depth: torch.Tensor) -> torch.Tensor:
    """(H, W) depth -> (H, W, 3) camera-frame points, NaN where depth is not
    finite and positive."""
    h, w = depth.shape
    v = torch.arange(h, dtype=depth.dtype, device=depth.device)[:, None]
    u = torch.arange(w, dtype=depth.dtype, device=depth.device)[None, :]
    z = torch.where(torch.isfinite(depth) & (depth > 0), depth,
                    torch.full_like(depth, float("nan")))
    return torch.stack([(u - cam["cx"]) / cam["fx"] * z, (v - cam["cy"]) / cam["fy"] * z, z], -1)


def _masked_box(img: torch.Tensor, valid: torch.Tensor, radius: int):
    x = torch.where(valid, img, torch.zeros_like(img))
    v = valid.to(img.dtype)
    for axis in (0, 1):
        xs, vs = torch.zeros_like(x), torch.zeros_like(v)
        for d in range(-radius, radius + 1):
            dy, dx = (d, 0) if axis == 0 else (0, d)
            xs = xs + _shifted(x, dy, dx, 0.0)
            vs = vs + _shifted(v, dy, dx, 0.0)
        x, v = xs, vs
    return x / torch.clamp(v, min=1e-12), v > 0


def normals(points: torch.Tensor) -> torch.Tensor:
    """Organized normals of an (H, W, 3) point image, NaN where undefined."""
    z = points[..., 2]

    def tangent(axis):
        dy, dx = (1, 0) if axis == 0 else (0, 1)
        p_p = _shifted(points, dy, dx, float("nan"))
        p_m = _shifted(points, -dy, -dx, float("nan"))
        dz = torch.abs(p_p[..., 2] - p_m[..., 2])
        ok = (torch.isfinite(p_p).all(-1) & torch.isfinite(p_m).all(-1)
              & (dz < DEPTH_CHANGE * torch.clamp(torch.abs(z), min=1.0) * 2.0))
        return 0.5 * (p_p - p_m), ok

    t_v, ok_v = tangent(0)
    t_u, ok_u = tangent(1)
    tu, any_u = _masked_box(t_u, ok_u[..., None], SMOOTHING)
    tv, any_v = _masked_box(t_v, ok_v[..., None], SMOOTHING)
    n = torch.linalg.cross(tu, tv, dim=-1)
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    ok = (torch.isfinite(z) & any_u[..., 0] & any_v[..., 0] & (norm[..., 0] > 1e-12)
          & torch.isfinite(n).all(-1))
    n = n / torch.clamp(norm, min=1e-12)
    flip = torch.sum(torch.where(ok[..., None], n * points, torch.zeros_like(n)),
                     dim=-1, keepdim=True) > 0
    n = torch.where(flip, -n, n)
    return torch.where(ok[..., None], n, torch.full_like(n, float("nan")))


def preprocess(depth: torch.Tensor, cam: dict):
    """Filtered depth (H, W) -> (points, normals), each (H, W, 3)."""
    points = backproject(cam, bilateral_separable(depth))
    return points, normals(points)
