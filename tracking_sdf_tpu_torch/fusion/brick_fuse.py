"""K2 redesigned for the card: one frame's brick-major fusion in one launch.

``brick_fuse_rows`` computes the FULL bricks' per-voxel update sums and
merges them, with the FREE rows, into the D, W rows and the packed color
lanes C of a BrickGrid, in place (``csrc/brick_fuse.cu``). It equals
``brick._full_brick_updates`` followed by ``brick_merge.brick_merge_rows`` on
the same inputs, bit for bit, without the (channels, cap, BV) update tensor
that the pair passes through device memory. It replaces the Pallas merge
(tracking_sdf_tpu/fusion/pallas_merge.py) in its row form together with the
update math that the JAX package leaves XLA to fuse into its merge.

``brick_fuse_rows_reference`` is the plain version, written in the kernel's
structure: per listed slot, each share group's centre voxel is projected for
the group's pixel row, and each voxel is projected for its own masks and
camera-space position.

Both take the saturated-FREE skip's (NB,) bool bitset ``sat`` (or None):
a listed FULL brick's bit is cleared, a listed FREE brick's bit is set when
its stored D and W after the merge all equal their values before it, and
cleared otherwise (fusion.brickmajor's module docstring).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tracking_sdf_tpu_torch.config import FusionConfig, GridParams
from tracking_sdf_tpu_torch.core.camera import PinholeCamera
from tracking_sdf_tpu_torch.core.lie import Pose
from tracking_sdf_tpu_torch.fusion.fuse import weighting, world_to_camera_components
from tracking_sdf_tpu_torch.kernels import _build

launches = 0  # brick_fuse_rows kernel launches on CUDA tensors, without sat
launches_sat = 0  # ... and with the sat_skip bitset
launches_slab = 0  # ... on an i-slab of the grid (parallel.sharded)

_WEIGHTINGS = {"exponential": 0, "linear": 1, "constant": 2}
_DISTANCES = {"point_to_point": 0, "point_to_plane": 1}


def share_group(cfg: FusionConfig, bs: Tuple[int, int, int]) -> Tuple[int, int]:
    """(sj, sk): the (j, k) extent of a pixel-share group, 1 where the brick
    extent is not a multiple of the configured share (as the bricked paths
    fall back)."""
    _, bj, bk = bs
    sk, sj = cfg.pixel_share, cfg.pixel_share_j
    return (1 if bj % sj else sj), (1 if bk % sk else sk)


def _weighting_scalars(name: str, delta: float, eps: float) -> Tuple[int, float, float]:
    """(mode, delta', 1 / (delta' - eps)) of fusion.fuse.weighting: each
    ``narrow_`` divides delta by 10. The linear weighting divides a tensor by
    the Python scalar delta' - eps, which PyTorch on the card computes as a
    product with the scalar's reciprocal, taken in double and rounded to
    float32; the kernel does the same."""
    while name.startswith("narrow_"):
        name, delta = name[len("narrow_"):], delta / 10.0
    if name not in _WEIGHTINGS:
        raise ValueError(f"unknown weighting: {name}")
    return _WEIGHTINGS[name], delta, float(np.float32(1.0 / (delta - eps)))


def _project(pose: Pose, params: GridParams, cam: PinholeCamera, hw, I, J, K):
    """Camera-space centres of voxels (I, J, K) (broadcast int64 tensors),
    their in-front and inside-image masks and clamped flat pixel index."""
    h, w_img = hw
    m = params.m
    ox, oy, oz = params.origin
    X = (params.width / m) * (I.to(torch.float32) + 0.5) + ox
    Y = (params.height / m) * (J.to(torch.float32) + 0.5) + oy
    Z = (params.depth / m) * (K.to(torch.float32) + 0.5) + oz
    px, py, pz = world_to_camera_components(pose, X, Y, Z)
    in_front = pz > 0
    safe_pz = torch.where(in_front, pz, torch.ones_like(pz))
    iu = torch.trunc((cam.fx * px + cam.cx * pz) / safe_pz).to(torch.int64)
    iv = torch.trunc((cam.fy * py + cam.cy * pz) / safe_pz).to(torch.int64)
    ins = (iu >= 0) & (iu < w_img) & (iv >= 0) & (iv < h)
    flat = iv.clamp(0, h - 1) * w_img + iu.clamp(0, w_img - 1)
    return px, py, pz, in_front, ins, flat


def _brick_origins(rows: torch.Tensor, m: int, bs, i_offset: int = 0):
    """(I0, J0, K0) of each brick id, each (n, 1, 1, 1) int64: global voxel
    indices of the brick's first voxel, the ids local to an i-slab that
    starts at global voxel i = ``i_offset``."""
    bi, bj, bk = bs
    nbj, nbk = m // bj, m // bk
    b = rows.to(torch.int64)[:, None, None, None]
    return (b // (nbj * nbk)) * bi + i_offset, ((b // nbk) % nbj) * bj, (b % nbk) * bk


def group_centre_pixels(rows: torch.Tensor, pose: Pose, *, params: GridParams,
                        cam: PinholeCamera, cfg: FusionConfig, bs, hw,
                        i_offset: int = 0) -> torch.Tensor:
    """Flat pixel index (clamped into the image) of the centre voxel
    (sj // 2, sk // 2) of each share group of the bricks ``rows``:
    (n, bi, bj / sj, bk / sk) int64."""
    bi, bj, bk = bs
    sj, sk = share_group(cfg, bs)
    dev = rows.device
    I0, J0, K0 = _brick_origins(rows, params.m, bs, i_offset)
    di = torch.arange(bi, device=dev)[:, None, None]
    dj = (torch.arange(bj // sj, device=dev) * sj + sj // 2)[None, :, None]
    dk = (torch.arange(bk // sk, device=dev) * sk + sk // 2)[None, None, :]
    return _project(pose, params, cam, hw, I0 + di, J0 + dj, K0 + dk)[5]


def brick_fuse_rows_reference(D: torch.Tensor, W: torch.Tensor, C: torch.Tensor,
                              ids: torch.Tensor, pix: torch.Tensor, pose: Pose, *,
                              cap: int, hw, params: GridParams, cam: PinholeCamera,
                              cfg: FusionConfig, bs, sat=None, i_offset: int = 0) -> None:
    """Plain PyTorch version of ``brick_fuse_rows``; updates D, W, C (and
    ``sat``) in place. It selects the listed rows with a boolean mask (one
    host sync)."""
    # brickmajor imports this module
    from tracking_sdf_tpu_torch.fusion.brickmajor import pack_color, unpack_color

    NB, BV = D.shape
    bi, bj, bk = bs
    sj, sk = share_group(cfg, bs)
    delta = params.delta
    dev = D.device
    slot = torch.nonzero((ids >= 0) & (ids < NB)).reshape(-1)
    rows = ids[slot].to(torch.int64)
    full = (slot < cap)[:, None]
    one = torch.ones((), device=dev)

    # FULL slots: the share groups' pixel rows, then every voxel's own
    # projection (FREE slots compute them too and discard them)
    grow = pix[group_centre_pixels(rows, pose, params=params, cam=cam, cfg=cfg, bs=bs,
                                   hw=hw, i_offset=i_offset)]  # (n, bi, bj/sj, bk/sk, ch)
    grp_j = torch.arange(bj, device=dev) // sj
    grp_k = torch.arange(bk, device=dev) // sk
    g = grow[:, :, grp_j][:, :, :, grp_k].reshape(rows.shape[0], BV, pix.shape[1])
    I0, J0, K0 = _brick_origins(rows, params.m, bs, i_offset)
    px, py, pz, in_front, ins, _ = _project(
        pose, params, cam, hw, I0 + torch.arange(bi, device=dev)[:, None, None],
        J0 + torch.arange(bj, device=dev)[:, None], K0 + torch.arange(bk, device=dev))
    px, py, pz = (x.reshape(-1, BV) for x in (px, py, pz))
    if cfg.distance == "point_to_plane":
        d = -(g[..., 3] - (px * g[..., 0] + py * g[..., 1] + pz * g[..., 2]))
    elif cfg.distance == "point_to_point":
        d = g[..., 3] - pz
    else:
        raise ValueError(f"unknown distance: {cfg.distance}")
    mask = (in_front & ins).reshape(-1, BV) & (d >= -delta)
    zero = torch.zeros_like(d)
    d = torch.where(mask, torch.clamp(d, max=delta), zero)
    w = torch.where(mask, weighting(cfg.weighting, d, params.epsilon, delta), zero)
    w_add = torch.where(full, w, one)
    wd_add = torch.where(full, w * d, one * delta)

    # merge: D sanitised to 0 where W <= 0 (D holds NaN there), divide by the
    # uncapped sum, store the clamped weight, keep D's bits where w_add == 0
    D_raw, W_raw = D[rows], W[rows]
    W_old = W_raw.to(torch.float32)
    D_san = torch.where(W_old > 0, D_raw.to(torch.float32), 0.0 * one)
    W_sum = W_old + w_add
    has = w_add > 0
    D_new = torch.where(
        has, ((W_old * D_san + wd_add) / torch.where(has, W_sum, one)).to(D.dtype), D_raw)
    W_new = (W_sum if cfg.max_weight is None
             else torch.clamp(W_sum, max=cfg.max_weight)).to(W.dtype)
    D[rows], W[rows] = D_new, W_new
    if sat is not None:
        # values compare (NaN never equals): a FREE brick is a no-op when
        # every stored voxel came out as it was
        same = ((D_new.float() == D_raw.float()) & (W_new.float() == W_raw.float())).all(1)
        sat[rows] = ~full[:, 0] & same
    if pix.shape[1] == 8:
        fr = full[:, 0]
        crows, w_c, g_c = rows[fr], w[fr], g[fr]
        stored = unpack_color(C[crows], D.dtype, W.dtype, BV)
        R, G, B, Wc = (x.to(torch.float32) for x in stored)
        wc_add = w_c * g_c[..., 4]
        Wc_sum = Wc + wc_add
        has_c = wc_add > 0
        safe = torch.where(has_c, Wc_sum, one)
        R, G, B = (torch.where(has_c, ((Wc * old + w_c * g_c[..., c]) / safe).to(D.dtype),
                               raw)
                   for old, raw, c in ((R, stored[0], 5), (G, stored[1], 6),
                                       (B, stored[2], 7)))
        Wc = (Wc_sum if cfg.max_weight is None
              else torch.clamp(Wc_sum, max=cfg.max_weight)).to(W.dtype)
        C[crows] = pack_color(R, G, B, Wc)


def _validate(D, W, C, ids, pix, pose, cap, hw, params, cfg, bs, sat, i_offset, nbi):
    """Raise on what the kernel does not take; returns the kernel's scalars."""
    # brickmajor imports this module
    from tracking_sdf_tpu_torch.fusion.brickmajor import color_lane_widths

    bi, bj, bk = bs
    m = params.m
    if m % bi or m % bj or m % bk:
        raise ValueError(f"brick_fuse_rows: grid m={m} not divisible by brick {bs}")
    nbi = m // bi if nbi is None else nbi
    if nbi < 1 or i_offset < 0 or i_offset % bi or i_offset + nbi * bi > m:
        raise ValueError(f"brick_fuse_rows: the slab of {nbi} brick layers at voxel "
                         f"i = {i_offset} does not lie on the m={m} grid's {bs} bricks")
    NB, BV = nbi * (m // bj) * (m // bk), bi * bj * bk
    dtypes = (torch.float32, torch.bfloat16)
    if (D.dtype not in dtypes or W.dtype not in dtypes or tuple(D.shape) != (NB, BV)
            or W.shape != D.shape or bk % 2 or BV % 4 or BV > 1024):
        raise ValueError(f"brick_fuse_rows: D, W must be ({NB}, {BV}) float32/bfloat16 "
                         f"rows with an even k extent, BV % 4 == 0 and BV <= 1024; got "
                         f"{tuple(D.shape)} {D.dtype}, {tuple(W.shape)} {W.dtype}, "
                         f"brick {bs}")
    lv, lw = color_lane_widths(BV, D.dtype, W.dtype)
    if C.dtype != torch.int16 or tuple(C.shape) != (NB, 3 * lv + lw):
        raise ValueError(f"brick_fuse_rows: C {tuple(C.shape)} {C.dtype} is not the "
                         f"({NB}, {3 * lv + lw}) int16 lane leaf")
    if ids.dtype != torch.int32 or ids.dim() != 1 or ids.shape[0] < cap:
        raise ValueError(f"brick_fuse_rows: ids must be int32 (>= {cap},), got "
                         f"{tuple(ids.shape)} {ids.dtype}")
    h, w_img = hw
    if (pix.dtype != torch.float32 or pix.dim() != 2 or pix.shape[0] != h * w_img
            or pix.shape[1] not in (4, 8)):
        raise ValueError(f"brick_fuse_rows: pixel table {tuple(pix.shape)} {pix.dtype} "
                         f"is not ({h * w_img}, 4 or 8) float32")
    for name, x, shape in (("pose.R", pose.R, (3, 3)), ("pose.t", pose.t, (3,))):
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"brick_fuse_rows: {name} must be float32 {shape}")
    if sat is not None and (sat.dtype != torch.bool or tuple(sat.shape) != (NB,)):
        raise ValueError(f"brick_fuse_rows: sat must be bool ({NB},), got "
                         f"{tuple(sat.shape)} {sat.dtype}")
    if cfg.distance not in _DISTANCES:
        raise ValueError(f"unknown distance: {cfg.distance}")
    sj, sk = share_group(cfg, bs)
    return (NB, BV, sj, sk, _DISTANCES[cfg.distance],
            *_weighting_scalars(cfg.weighting, params.delta, params.epsilon))


def brick_fuse_rows(D: torch.Tensor, W: torch.Tensor, C: torch.Tensor,
                    ids: torch.Tensor, pix: torch.Tensor, pose: Pose, *, cap: int, hw,
                    params: GridParams, cam: PinholeCamera, cfg: FusionConfig,
                    bs: Tuple[int, int, int], sat=None, i_offset: int = 0,
                    nbi: Optional[int] = None) -> None:
    """Fuse one frame into the brick rows in place.

    ``D``, ``W`` (NB, BV) float32 or bfloat16 (D NaN where W <= 0); ``C``
    (NB, 3·LV + LW) int16 packed color lanes; ``ids`` (cap + n_free,) int32:
    the FULL slots' brick ids, then the FREE ids, an id >= NB marking a
    padding slot (distinct ids); ``pix`` the (H·W, 4 or 8) float32 pixel
    table of ``brick._pixel_table`` (8 channels fuse color into the FULL
    bricks); ``pose`` float32 on the rows' device, read there (no host copy);
    ``hw`` the image (H, W); ``sat`` the (NB,) bool sat_skip bitset or None
    (module docstring). FusionConfig supplies the distance, weighting, pixel
    share and max_weight.

    Slab form (parallel.sharded, counted in ``launches_slab``): with
    ``nbi`` given, the rows hold an i-slab of ``nbi`` brick layers whose
    first brick starts at global voxel i = ``i_offset``; the ids are local
    to the slab, and brick id b's first voxel is global i_offset +
    (b // (nbj·nbk))·bi. With i_offset 0 and nbi m / bi it computes exactly
    the whole-grid form.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    global launches, launches_sat, launches_slab
    NB, BV, sj, sk, dist, mode, w_delta, w_inv = _validate(
        D, W, C, ids, pix, pose, cap, hw, params, cfg, bs, sat, i_offset, nbi)
    if D.device.type == "cpu":
        return brick_fuse_rows_reference(D, W, C, ids, pix, pose, cap=cap, hw=hw,
                                         params=params, cam=cam, cfg=cfg, bs=bs, sat=sat,
                                         i_offset=i_offset)
    if D.device.type != "cuda":
        raise ValueError(f"brick_fuse_rows: unsupported device {D.device}")
    R, t = pose.R.contiguous(), pose.t.contiguous()
    tensors = (D, W, C, ids, pix, R, t) + (() if sat is None else (sat,))
    if any(x.device != D.device or not x.is_contiguous() for x in tensors):
        raise ValueError("brick_fuse_rows: D, W, C, ids, the pixel table and the pose "
                         "must be contiguous on one device")
    if pix.data_ptr() % 16:
        raise ValueError("brick_fuse_rows: the pixel table must be 16-byte aligned")
    if ids.shape[0] == 0:
        return
    bi, bj, bk = bs
    h, w_img = hw
    m = params.m
    rc = _build.library().tsdf_brick_fuse_rows(
        D.data_ptr(), W.data_ptr(), C.data_ptr(), C.shape[1],
        int(D.dtype == torch.bfloat16), int(W.dtype == torch.bfloat16),
        ids.data_ptr(), ids.shape[0], cap, NB, bi, bj, bk, m, i_offset,
        pix.data_ptr(), pix.shape[1], h, w_img, R.data_ptr(), t.data_ptr(),
        None if sat is None else sat.data_ptr(), sj, sk, dist, mode, params.width / m,
        params.height / m, params.depth / m,
        *params.origin, cam.fx, cam.fy, cam.cx, cam.cy, params.delta, params.epsilon,
        w_delta, w_inv, float("inf") if cfg.max_weight is None else cfg.max_weight,
        _build.stream_ptr(D.device))
    _build.check(rc, "brick_fuse_rows")
    if nbi is not None:
        launches_slab += 1
    elif sat is None:
        launches += 1
    else:
        launches_sat += 1
