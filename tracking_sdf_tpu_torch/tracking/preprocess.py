"""Depth preprocessing: bilateral smoothing and organized normals
(counterpart of tracking_sdf_tpu.tracking.preprocess).

Both bilateral filters are ported: the full 2-D kernel
(``bilateral_mode="full"``, the default and the reference's) and the
separable passes that the tum256 and tum512 presets run. Invalidity is NaN.

On a CUDA tensor each public function launches a hand-written kernel
(``csrc/preprocess.cu``): K3 ``tsdf_bilateral_pass`` (the separable filter's
two passes in one launch, or one 1-D pass), K3 ``tsdf_bilateral_2d`` (the 2-D
filter) and K4 ``tsdf_normals`` (backprojection and normals in one launch;
from a point image in ``estimate_normals``). The kernels read and write 16
bytes at a time where the width is a multiple of 4 and their tensors are
16-byte aligned, and one value at a time otherwise, with the same result;
the wrapper looks at the pointers. A CPU tensor takes the plain version, the
``*_reference`` function of the same name: stencils over shifted copies of
the image, in the order the kernels follow.

A CUDA image of the right rank in any floating dtype and layout is taken as
the CPU path takes it: the kernels run on a contiguous float32 copy (none is
made of a contiguous float32 image). Each kernel takes any radius up to the
last whose launch fits the shared memory of an H100 block
(``MAX_RADIUS_2D``, ``MAX_RADIUS_PASS``, ``MAX_BOX_RADIUS``); a larger or a
negative radius raises on the card.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from tracking_sdf_tpu_torch.core.camera import PinholeCamera, backproject
from tracking_sdf_tpu_torch.kernels import _build
from tracking_sdf_tpu_torch.kernels._build import aligned16, card_reciprocal

# kernel launches on CUDA tensors
launches_pass = 0  # K3's separable kernel: the separable filter, or one 1-D pass
launches_2d = 0  # K3, the 2-D bilateral filter
launches_normals = 0  # K4, (backprojection and) normals

# csrc/preprocess.cu's constants: the radii the kernels take (kMaxRadius2d,
# kMaxSepRadius, kMaxBoxRadius: the last whose launch fits the 227 KB of
# shared memory a block may have), the radius each compiles (k2dRadius,
# kSepRadius, kBoxRadius; others run the same code with a runtime radius),
# their tiles, (rows, columns) of output pixels, and the 2-D form's pixels a
# thread
MAX_RADIUS_2D = 102
MAX_RADIUS_PASS = 89
MAX_BOX_RADIUS = 25
RADIUS_2D = 5
SEP_RADIUS = 5
TILE_2D = (8, 64)
PIXELS_2D = 2
SEP_TILE = (4, 128)
NORMALS_TILE = (16, 32)
# estimate_normals' defaults, which preprocess_frame uses (K4 compiles this
# radius)
DEPTH_CHANGE_FACTOR, SMOOTHING_RADIUS = 0.02, 4
_PASS_AXIS0, _PASS_AXIS1, _PASS_SEPARABLE = 0, 1, 2  # tsdf_bilateral_pass's modes


def _shifted(img: torch.Tensor, dy: int, dx: int, fill: float) -> torch.Tensor:
    """out[y, x] = img[y + dy, x + dx], ``fill`` outside the image (all of
    it for a shift past the image's edge)."""
    h, w = img.shape[:2]
    out = torch.full_like(img, fill)
    if abs(dy) >= h or abs(dx) >= w:
        return out
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


@functools.lru_cache(maxsize=None)
def _spatial_weights_1d(radius: int, sigma_spatial: float) -> ctypes.Array:
    """The separable passes' (2r+1,) weights exp(-d² / (2 σs²)) as C floats in
    host memory (K3 takes them by value): the plain pass's Python scalars as
    PyTorch rounds them."""
    inv2ss = 1.0 / (2.0 * sigma_spatial ** 2)
    taps = [math.exp(-(d * d) * inv2ss) for d in range(-radius, radius + 1)]
    return (ctypes.c_float * len(taps))(*taps)


@functools.lru_cache(maxsize=None)
def _spatial_weights_sq(radius: int, sigma_spatial: float) -> ctypes.Array:
    """The 2-D filter's spatial weights as C floats in host memory, one a
    squared tap distance d = dy² + dx² = 0 .. 2r² (K3's 2-D form takes its
    compiled radius's by value): exp(-d / (2 σs²)) in double, each the value
    of ``_spatial_weights`` at every tap of that distance."""
    inv2ss = 1.0 / (2.0 * sigma_spatial ** 2)
    taps = [math.exp(-d * inv2ss) for d in range(2 * radius * radius + 1)]
    return (ctypes.c_float * len(taps))(*taps)


def bilateral_filter_reference(
    depth: torch.Tensor,
    radius: int = 5,
    sigma_spatial: float = 3.0,
    sigma_range: float = 0.03,
) -> torch.Tensor:
    """Plain version of ``bilateral_filter``.

    The taps' weights are built at once (pad with NaN, two ``unfold``s) and
    summed one tap at a time from zero in the JAX package's row-major (dy,
    dx) order, which the kernel follows."""
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
    wd = w * dn0
    num = torch.zeros_like(d0)
    den = torch.zeros_like(d0)
    for i in range(k):
        for j in range(k):
            num = num + wd[..., i, j]
            den = den + w[..., i, j]
    out = num / torch.clamp(den, min=1e-12)
    return torch.where(center_valid & (den > 0), out, float("nan"))


def bilateral_pass_reference(img: torch.Tensor, axis: int, radius: int = 5,
                             sigma_spatial: float = 3.0,
                             sigma_range: float = 0.03) -> torch.Tensor:
    """Plain version of one 1-D bilateral pass along ``axis`` (K3's
    ``tsdf_bilateral_pass``): NaN neighbours excluded, NaN where the centre
    is not finite."""
    inv2ss = 1.0 / (2.0 * sigma_spatial ** 2)
    inv2sr = 1.0 / (2.0 * sigma_range ** 2)
    zero = torch.zeros((), dtype=img.dtype, device=img.device)
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


def bilateral_filter_separable_reference(
    depth: torch.Tensor,
    radius: int = 5,
    sigma_spatial: float = 3.0,
    sigma_range: float = 0.03,
) -> torch.Tensor:
    """Plain version of ``bilateral_filter_separable``."""
    out = bilateral_pass_reference(depth, 0, radius, sigma_spatial, sigma_range)
    out = bilateral_pass_reference(out, 1, radius, sigma_spatial, sigma_range)
    return torch.where(torch.isfinite(depth), out, torch.full_like(out, float("nan")))


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


def estimate_normals_reference(
    points_cam: torch.Tensor,  # (H, W, 3) organized camera-frame points
    max_depth_change_factor: float = DEPTH_CHANGE_FACTOR,
    smoothing_radius: int = SMOOTHING_RADIUS,
) -> torch.Tensor:
    """Plain version of ``estimate_normals``."""
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


# --- the kernels' wrappers -----------------------------------------------------

def _on_card(x: torch.Tensor, what: str) -> bool:
    """False for a CPU tensor (the plain version runs), True for a CUDA one."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    return True


def _card_image(x: torch.Tensor, what: str, channels: int = 0) -> torch.Tensor:
    """``x`` as the kernels take it: a contiguous float32 (H, W) or (H, W,
    channels) tensor, ``x`` itself where it is one, else a copy (float64
    rounds to float32, as the JAX package computes with x64 off). A wrong
    rank, channel count or a dtype that is not floating raises."""
    want = "(H, W)" if not channels else f"(H, W, {channels})"
    if (not x.is_floating_point() or x.dim() != (3 if channels else 2)
            or (channels and x.shape[2] != channels)):
        raise ValueError(f"{what}: needs a floating {want} tensor, got {tuple(x.shape)} "
                         f"{x.dtype}")
    return x.to(torch.float32).contiguous()


def _check_radius(radius: int, limit: int, what: str) -> None:
    if not 0 <= radius <= limit:
        raise ValueError(f"{what}: radius {radius} not in [0, {limit}]")


def _bilateral_pass(img: torch.Tensor, mode: int, radius: int, sigma_spatial: float,
                    sigma_range: float, what: str) -> torch.Tensor:
    """K3's separable kernel on a card tensor: ``mode`` _PASS_AXIS0 or
    _PASS_AXIS1 (one pass) or _PASS_SEPARABLE (both, one launch)."""
    global launches_pass
    _check_radius(radius, MAX_RADIUS_PASS, what)
    h, w = img.shape
    out = torch.empty((h, w), dtype=torch.float32, device=img.device)
    if out.numel() == 0:
        return out
    vec = w % 4 == 0 and aligned16(img, out)
    rc = _build.library().tsdf_bilateral_pass(
        img.data_ptr(), out.data_ptr(), h, w, mode, radius,
        ctypes.addressof(_spatial_weights_1d(radius, sigma_spatial)),
        1.0 / (2.0 * sigma_range ** 2), int(vec), _build.stream_ptr(img.device))
    _build.check(rc, what)
    launches_pass += 1
    return out


def bilateral_pass(img: torch.Tensor, axis: int, radius: int = 5,
                   sigma_spatial: float = 3.0, sigma_range: float = 0.03) -> torch.Tensor:
    """One 1-D bilateral pass along ``axis``. A CPU tensor takes the plain
    version; a CUDA tensor (H, W) launches K3's separable kernel for that
    axis alone (radius up to MAX_RADIUS_PASS)."""
    if not _on_card(img, "bilateral_pass"):
        return bilateral_pass_reference(img, axis, radius, sigma_spatial, sigma_range)
    if axis not in (0, 1):
        raise ValueError(f"bilateral_pass: axis {axis}")
    img = _card_image(img, "bilateral_pass")
    return _bilateral_pass(img, axis, radius, sigma_spatial, sigma_range, "bilateral_pass")


def bilateral_filter(
    depth: torch.Tensor,
    radius: int = 5,
    sigma_spatial: float = 3.0,
    sigma_range: float = 0.03,
) -> torch.Tensor:
    """The full 2-D (2r+1)^2 bilateral kernel: edge-preserving depth
    smoothing with NaN neighbours excluded; NaN holes stay NaN.

    A CPU tensor takes the plain version; a CUDA tensor (H, W) launches
    K3's 2-D form once (radius up to MAX_RADIUS_2D)."""
    global launches_2d
    if not _on_card(depth, "bilateral_filter"):
        return bilateral_filter_reference(depth, radius, sigma_spatial, sigma_range)
    depth = _card_image(depth, "bilateral_filter")
    _check_radius(radius, MAX_RADIUS_2D, "bilateral_filter")
    h, w = depth.shape
    out = torch.empty((h, w), dtype=torch.float32, device=depth.device)
    if out.numel() == 0:
        return out
    vec = w % 4 == 0 and aligned16(depth, out)
    rc = _build.library().tsdf_bilateral_2d(
        depth.data_ptr(), out.data_ptr(), h, w, radius,
        ctypes.addressof(_spatial_weights_sq(RADIUS_2D, sigma_spatial)),
        _spatial_weights(radius, sigma_spatial, depth.device).data_ptr(),
        1.0 / (2.0 * sigma_range ** 2), int(vec), _build.stream_ptr(depth.device))
    _build.check(rc, "bilateral_filter")
    launches_2d += 1
    return out


def bilateral_filter_separable(
    depth: torch.Tensor,
    radius: int = 5,
    sigma_spatial: float = 3.0,
    sigma_range: float = 0.03,
) -> torch.Tensor:
    """Vertical-then-horizontal 1-D bilateral passes; the range weight of
    pass 2 compares against the pass-1 output. NaN holes stay NaN; NaN
    neighbours are excluded per pass.

    A CPU tensor takes the plain version; a CUDA tensor (H, W) launches
    K3's separable kernel once for both passes (radius up to
    MAX_RADIUS_PASS)."""
    what = "bilateral_filter_separable"
    if not _on_card(depth, what):
        return bilateral_filter_separable_reference(depth, radius, sigma_spatial,
                                                    sigma_range)
    depth = _card_image(depth, what)
    # pass 1 is NaN wherever the depth is not finite, so the plain version's
    # last mask changes nothing here
    return _bilateral_pass(depth, _PASS_SEPARABLE, radius, sigma_spatial, sigma_range, what)


def _normals(depth, points, cam, factor: float, radius: int, what: str):
    """K4: from ``depth`` (writing ``points``) or, with depth None, from
    ``points``; returns the normals."""
    global launches_normals
    _check_radius(radius, MAX_BOX_RADIUS, what)
    h, w = points.shape[:2]
    normals = torch.empty((h, w, 3), dtype=torch.float32, device=points.device)
    if normals.numel() == 0:
        return normals
    scalars = ((0.0, 0.0, 0.0, 0.0) if cam is None else
               (card_reciprocal(cam.fx), card_reciprocal(cam.fy), cam.cx, cam.cy))
    vec = w % 4 == 0 and aligned16(depth, points, normals)
    rc = _build.library().tsdf_normals(
        None if depth is None else depth.data_ptr(), points.data_ptr(), normals.data_ptr(),
        h, w, *scalars, factor, radius, int(vec), _build.stream_ptr(points.device))
    _build.check(rc, what)
    launches_normals += 1
    return normals


def estimate_normals(
    points_cam: torch.Tensor,  # (H, W, 3) organized camera-frame points
    max_depth_change_factor: float = DEPTH_CHANGE_FACTOR,
    smoothing_radius: int = SMOOTHING_RADIUS,
) -> torch.Tensor:
    """Organized normals, AVERAGE_3D_GRADIENT style: masked-box-smoothed
    tangents along u and v, n = normalize(t_u x t_v), oriented toward the
    camera (n . p < 0), NaN where invalid.

    A CPU tensor takes the plain version; a CUDA tensor (H, W, 3) launches
    K4 once (smoothing radius up to MAX_BOX_RADIUS)."""
    if not _on_card(points_cam, "estimate_normals"):
        return estimate_normals_reference(points_cam, max_depth_change_factor,
                                          smoothing_radius)
    points_cam = _card_image(points_cam, "estimate_normals", channels=3)
    return _normals(None, points_cam, None, max_depth_change_factor, smoothing_radius,
                    "estimate_normals")


def preprocess_frame(
    depth: torch.Tensor,
    *,
    cam: PinholeCamera,
    bilateral: bool = True,
    bilateral_mode: str = "full",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """depth (H, W) -> (points_cam, normals_cam), both (H, W, 3).
    ``bilateral_mode``: "full" (the 2-D kernel) or "separable".

    A CPU tensor takes the plain versions. A CUDA tensor (H, W) launches K3
    once (either mode), or not at all without ``bilateral``, then K4 once for
    the points and the normals."""
    if bilateral:
        if bilateral_mode == "full":
            depth = bilateral_filter(depth)
        elif bilateral_mode == "separable":
            depth = bilateral_filter_separable(depth)
        else:
            raise ValueError(f"unknown bilateral_mode: {bilateral_mode}")
    if not _on_card(depth, "preprocess_frame"):
        points = backproject(cam, depth)
        return points, estimate_normals_reference(points)
    depth = _card_image(depth, "preprocess_frame")
    points = torch.empty((*depth.shape, 3), dtype=torch.float32, device=depth.device)
    return points, _normals(depth, points, cam, DEPTH_CHANGE_FACTOR, SMOOTHING_RADIUS,
                            "preprocess_frame")
