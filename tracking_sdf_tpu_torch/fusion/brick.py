"""Brick-compacted TSDF fusion over the flat (m, m, m) layout
(counterpart of tracking_sdf_tpu.fusion.brick, all three merge tails), and
the classification, compaction and per-voxel update pieces that the
brick-major path (fusion.brickmajor) shares with it.

Each brick is classified exactly and conservatively:
  OUT   behind the camera, off the image, or provably occluded (d < -delta
        at every voxel): no update.
  FREE  inside the image and strictly in front of every candidate surface:
        every voxel's update is exactly (w = 1, d = +delta), no pixel reads.
  FULL  everything else: the dense path's per-voxel math on compacted bricks.
The first ``cap`` FULL bricks (in id order) get update rows, which one of
three tails merges into the grid (``FusionConfig.brick_merge``):
  "pallas"  K2 (``brick_merge``) over the first ``cap_act`` active bricks;
  "xla"     K2's plain merge (``brick_merge_reference``) over every active
            brick: the JAX package's merge pass over the whole grid, less the
            voxels that add nothing;
  "rows"    the same plain merge over the FULL bricks and the first
            ``cap_free`` FREE bricks.
Bricks past a cap are dropped for the frame and reported in FuseStats, never
silently.

The zeta / eta mip and the pixel table (``frame_tables``), the classes
(``classify_bricks``) and the hierarchical lists (``classify_compact_hier``)
dispatch on the tensors' device: a CPU tensor takes the plain
``*_reference`` version, a CUDA tensor the hand-written kernels K5, K6 and K7
of ``fusion.brick_classify``, any other device raises.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from tracking_sdf_tpu_torch.config import FusionConfig, GridParams
from tracking_sdf_tpu_torch.core.camera import PinholeCamera
from tracking_sdf_tpu_torch.core.lie import Pose
from tracking_sdf_tpu_torch.fusion import brick_classify as k567
from tracking_sdf_tpu_torch.fusion.brick_classify import ZetaMip
from tracking_sdf_tpu_torch.fusion.brick_merge import (
    FREE, FULL, brick_merge, brick_merge_reference)
from tracking_sdf_tpu_torch.fusion.fuse import (
    pixel_finite, weighting, world_to_camera_components)
from tracking_sdf_tpu_torch.grid.grid import TSDFGrid

_TILE = 8  # zeta mip base tile, pixels
_INF = float("inf")


@dataclasses.dataclass
class FuseStats:
    n_full: int  # bricks classified FULL
    overflow: int  # FULL bricks dropped (cap too small)
    n_free: int  # bricks classified FREE
    # flat path: active bricks dropped (cap_act too small); brick-major:
    # FREE bricks dropped (cap_free too small)
    overflow_active: int = 0
    # hierarchical classification: mixed super-bricks beyond cap_mixed,
    # whose child bricks are dropped for the frame
    overflow_mixed: int = 0
    # brick-major sat_skip: bricks marked saturated after the frame (their
    # FREE update is a proven bitwise no-op; left out of FREE compaction)
    n_sat: int = 0


@functools.lru_cache(maxsize=None)
def _device_const(values: tuple, device: torch.device) -> torch.Tensor:
    """A small int64 table on ``device``, copied there once: a copy from
    the host waits for the device, so the per-frame path must not make one."""
    return torch.tensor(values, dtype=torch.int64, device=device)


def _corner_sel(device) -> torch.Tensor:
    """(8, 3) 0/1 corner offsets in (i, j, k) loop order."""
    return _device_const(tuple((a, b, c) for a in (0, 1) for b in (0, 1) for c in (0, 1)),
                         torch.device(device))


def share_classify_margin(params: GridParams, cfg: FusionConfig) -> float:
    """World-space margin that keeps the FREE/OCCLUDED proofs exact under
    pixel-share semantics: the share group's world radius (point-to-plane;
    point-to-point needs none)."""
    if not cfg.share_safe_classify:
        return 0.0
    if cfg.distance == "point_to_point":
        return 0.0
    sk = max(cfg.pixel_share, 1)
    sj = max(cfg.pixel_share_j, 1)
    if sk <= 1 and sj <= 1:
        return 0.0
    vs = params.voxel_size
    dk = 0.5 * sk * vs[2]
    dj = 0.5 * sj * vs[1]
    return float((dk * dk + dj * dj) ** 0.5)


def _mip_levels(img: torch.Tensor, largest: bool) -> List[torch.Tensor]:
    """Min- or max-mip pyramid over _TILE tiles, padded with the neutral
    element (padding only adds candidates, so queries stay conservative)."""
    neutral = -_INF if largest else _INF

    def red(x):
        return x.amax(dim=(1, 3)) if largest else x.amin(dim=(1, 3))

    h, w = img.shape
    H, W = -(-h // _TILE) * _TILE, -(-w // _TILE) * _TILE
    img = torch.nn.functional.pad(img, (0, W - w, 0, H - h), value=neutral)
    lvl = red(img.reshape(H // _TILE, _TILE, W // _TILE, _TILE))
    levels = [lvl]
    while lvl.shape[0] > 1 or lvl.shape[1] > 1:
        lvl = torch.nn.functional.pad(
            lvl, (0, lvl.shape[1] % 2, 0, lvl.shape[0] % 2), value=neutral)
        lvl = red(lvl.reshape(lvl.shape[0] // 2, 2, lvl.shape[1] // 2, 2))
        levels.append(lvl)
    return levels


def _flatten_pair(levels: List[torch.Tensor], neutral: float):
    downs = [torch.cat([l[1:], torch.full_like(l[:1], neutral)], dim=0)
             for l in levels]
    return (torch.cat([l.reshape(-1) for l in levels]),
            torch.cat([d.reshape(-1) for d in downs]))


def _on_card(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (the kernels), False for a CPU one (the plain
    versions); any other device raises."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    return True


def _zeta_mip(points_cam, normals_cam, cam, delta, distance="point_to_plane",
              share_margin=0.0) -> ZetaMip:
    """The zeta / eta mip of ``_zeta_mip_reference``: on the card one K5
    launch (brick_classify.frame_tables)."""
    if not _on_card(points_cam, "_zeta_mip"):
        return _zeta_mip_reference(points_cam, normals_cam, cam, delta, distance,
                                   share_margin)
    return k567.frame_tables(points_cam, normals_cam, None, cam=cam, delta=delta,
                             distance=distance, share_margin=share_margin, table=False)[0]


def _zeta_mip_reference(points_cam, normals_cam, cam, delta, distance="point_to_plane",
                        share_margin=0.0) -> ZetaMip:
    """Conservative free-space (zeta, min-mip) and occluded-space (eta,
    max-mip) depth bounds per pixel; invalid pixels get -inf for both."""
    h, w = points_cam.shape[:2]
    dev = points_cam.device
    z_y = points_cam[..., 2]
    n = normals_cam
    fin = pixel_finite(points_cam, normals_cam)
    neg_inf = torch.full_like(z_y, -_INF)
    if distance == "point_to_point":
        d_eff = delta + share_margin
        zeta = torch.where(fin, z_y - d_eff, neg_inf)
        eta = torch.where(fin, z_y + d_eff, neg_inf)
    else:
        v = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
        u = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
        rx = (u - cam.cx) / cam.fx
        ry = (v - cam.cy) / cam.fy
        rn = rx * n[..., 0] + ry * n[..., 1] + n[..., 2]
        ok = fin & (rn < 0)
        a = torch.clamp(-rn, min=1e-6)
        e_minus = (torch.clamp(-n[..., 0], min=0.0) / cam.fx
                   + torch.clamp(-n[..., 1], min=0.0) / cam.fy)
        e_plus = (torch.clamp(n[..., 0], min=0.0) / cam.fx
                  + torch.clamp(n[..., 1], min=0.0) / cam.fy)
        if share_margin:
            nrm2 = torch.sqrt(torch.where(fin[..., None], n * n,
                                          torch.zeros_like(n)).sum(-1))
            d_eff = delta + share_margin * nrm2
        else:
            d_eff = delta
        zeta = torch.where(ok, (z_y * a - d_eff) / (a + e_minus), neg_inf)
        eta = torch.where(
            fin & (rn < 0) & (a > e_plus),
            (z_y * a + d_eff) / torch.clamp(a - e_plus, min=1e-9),
            torch.where(fin, torch.full_like(z_y, _INF), neg_inf))
    zl = _mip_levels(zeta, largest=False)
    el = _mip_levels(eta, largest=True)
    dims = [tuple(l.shape) for l in zl]
    offsets = np.concatenate([[0], np.cumsum([dh * dw for dh, dw in dims])])
    zf, zfd = _flatten_pair(zl, _INF)
    ef, efd = _flatten_pair(el, -_INF)
    return ZetaMip(zf, zfd, ef, efd, [int(o) for o in offsets[:-1]], dims)


def _query_zeta(mip: ZetaMip, u0, u1, v0, v1):
    """Conservative (min zeta, max eta) over the pixel bbox [u0,u1]x[v0,v1].

    At the level where 3 cells cover the bbox span, a window of 4 cells per
    row starting at (cv0, cu0), clamped to [0, dim-4], is read for two
    window-row pairs: rows min(cv0 + dv, dh - 1) for dv in (0, 2), each in
    the level array and in its row-below companion. The 4 cells of a row are
    the flat run f0..f0+3, f0 = offs + cv·dw + cu0, read from the flat array
    padded to a multiple of 4 with the neutral value and wrapped at its end
    (the cells the JAX package's overlapped-row table holds). Extra cells can
    only turn FREE/OCCLUDED into FULL, never the reverse."""
    dev = u0.device
    L = len(mip.dims)
    span = torch.maximum(u1 - u0, v1 - v0) / (3.0 * _TILE)
    lvl = torch.ceil(torch.log2(torch.clamp(span, min=1.0))).to(torch.int64)
    lvl = lvl.clamp(0, L - 1)
    offs = _device_const(tuple(mip.offsets), dev)[lvl]
    dh = _device_const(tuple(d[0] for d in mip.dims), dev)[lvl]
    dw = _device_const(tuple(d[1] for d in mip.dims), dev)[lvl]
    cell = (_TILE * 2 ** lvl).to(torch.float32)
    cu0 = torch.minimum((u0 / cell).to(torch.int64).clamp(min=0),
                        torch.clamp(dw - 4, min=0))
    cv0 = torch.minimum((v0 / cell).to(torch.int64).clamp(min=0),
                        torch.clamp(dh - 4, min=0))
    total = mip.zeta.shape[0]
    P = -(-total // 4) * 4
    lane = torch.arange(4, device=dev)

    def padded(x, neutral):
        return torch.nn.functional.pad(x, (0, P - total), value=neutral)

    z, zd = padded(mip.zeta, _INF), padded(mip.zeta_down, _INF)
    e, ed = padded(mip.eta, -_INF), padded(mip.eta_down, -_INF)
    zeta_min = torch.full(u0.shape, _INF, device=dev)
    eta_max = torch.full(u0.shape, -_INF, device=dev)
    for dv in (0, 2):
        cv = torch.minimum(cv0 + dv, dh - 1)
        idx = ((offs + cv * dw + cu0)[..., None] + lane) % P
        zeta_min = torch.minimum(zeta_min, torch.minimum(z[idx], zd[idx]).amin(-1))
        eta_max = torch.maximum(eta_max, torch.maximum(e[idx], ed[idx]).amax(-1))
    return zeta_min, eta_max


def _axis_lohi(nb: int, b: int, extent: float, origin: float, m: int, dev,
               off: int = 0) -> torch.Tensor:
    """(nb, 2) world coordinates of the first and last voxel centre of each
    of nb bricks of extent b along one axis, the first brick starting at
    voxel ``off``."""
    idx = torch.arange(nb, dtype=torch.float32, device=dev) * b + float(off)
    lo = (extent / m) * (idx + 0.5) + origin
    hi = (extent / m) * (idx + b - 0.5) + origin
    return torch.stack([lo, hi], dim=-1)


def _brick_corners_cam(params: GridParams, pose: Pose, bs, nbi: Optional[int] = None,
                       i_offset: int = 0):
    """Camera coords (px, py, pz), each (nbi, nbj, nbk, 8), of every brick's
    voxel-center hull corners. p = Rᵀ(c - t) is separable per world axis.
    ``nbi`` / ``i_offset``: an i-slab of nbi brick layers (default all m/bi)
    whose first brick starts at global voxel i = i_offset."""
    m = params.m
    Rt = pose.R.T
    dev = Rt.device
    bi, bj, bk = bs
    nbi = m // bi if nbi is None else nbi
    Ax = _axis_lohi(nbi, bi, params.width, params.origin[0], m, dev,
                    i_offset)[..., None] * Rt[:, 0]
    Ay = _axis_lohi(m // bj, bj, params.height, params.origin[1], m, dev)[..., None] * Rt[:, 1]
    Az = _axis_lohi(m // bk, bk, params.depth, params.origin[2], m, dev)[..., None] * Rt[:, 2]
    base = -(Rt @ pose.t)
    sel = _corner_sel(dev)
    cx = Ax[:, sel[:, 0], :]  # (nbi, 8, 3)
    cy = Ay[:, sel[:, 1], :]
    cz = Az[:, sel[:, 2], :]
    c = (cx[:, None, None] + cy[None, :, None] + cz[None, None, :]) + base
    return c[..., 0], c[..., 1], c[..., 2]


def _class_from_corners(cx_, cy_, cz_, mip: ZetaMip, cam: PinholeCamera, hw):
    """0 OUT, 1 FREE, 2 FULL from per-brick corner camera coords (..., 8)."""
    h, w_img = hw
    pz_min = cz_.amin(-1)
    pz_max = cz_.amax(-1)
    all_front = pz_min > 0
    safe_z = torch.where(cz_ > 0, cz_, torch.ones_like(cz_))
    u_c = (cam.fx * cx_ + cam.cx * cz_) / safe_z
    v_c = (cam.fy * cy_ + cam.cy * cz_) / safe_z
    u0, u1 = u_c.amin(-1), u_c.amax(-1)
    v0, v1 = v_c.amin(-1), v_c.amax(-1)
    inside = all_front & (u0 >= 0) & (u1 < w_img) & (v0 >= 0) & (v1 < h)
    # left/top bound is <= -1: the per-voxel path truncates toward zero, so
    # u in (-1, 0) is pixel 0 and valid
    out = (pz_max <= 0) | (
        all_front & ((u1 <= -1) | (u0 >= w_img) | (v1 <= -1) | (v0 >= h)))
    zeta_min, eta_max = _query_zeta(
        mip, u0.clamp(0, w_img - 1), u1.clamp(0, w_img - 1),
        v0.clamp(0, h - 1), v1.clamp(0, h - 1))
    free = inside & (pz_max < zeta_min)
    occluded = all_front & (pz_min > eta_max)
    cls = torch.where(free, FREE, FULL)
    return torch.where(out | occluded, 0, cls).to(torch.int32)


def _card_pose(pose: Pose) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R, -(Rᵀ t)) for K6: the base of the corners is the plain version's
    own torch expression."""
    return pose.R.contiguous(), (-(pose.R.T @ pose.t)).contiguous()


def classify_bricks(params, pose, points_cam, normals_cam, cam, bs,
                    distance="point_to_plane", share_margin=0.0,
                    mip: Optional[ZetaMip] = None, nbi: Optional[int] = None,
                    i_offset: int = 0) -> torch.Tensor:
    """Brick classes (nbi, nbj, nbk) int32: 0 OUT, 1 FREE, 2 FULL (``nbi`` /
    ``i_offset``: an i-slab, as _brick_corners_cam). On the card K6's flat
    form (and K5 for the mip unless ``mip`` is given)."""
    if not _on_card(points_cam, "classify_bricks"):
        return classify_bricks_reference(params, pose, points_cam, normals_cam, cam, bs,
                                         distance, share_margin, mip, nbi, i_offset)
    if mip is None:
        mip = _zeta_mip(points_cam, normals_cam, cam, params.delta, distance, share_margin)
    m = params.m
    nb3 = (m // bs[0] if nbi is None else nbi, m // bs[1], m // bs[2])
    cls, _ = k567.classify_bricks(mip, *_card_pose(pose), params=params, cam=cam,
                                  hw=tuple(points_cam.shape[:2]), bs=bs, grid=nb3,
                                  i_offset=i_offset)
    return cls.to(torch.int32).reshape(nb3)


def classify_bricks_reference(params, pose, points_cam, normals_cam, cam, bs,
                              distance="point_to_plane", share_margin=0.0,
                              mip: Optional[ZetaMip] = None, nbi: Optional[int] = None,
                              i_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version of ``classify_bricks``."""
    if mip is None:
        mip = _zeta_mip_reference(points_cam, normals_cam, cam, params.delta, distance,
                                  share_margin)
    cx_, cy_, cz_ = _brick_corners_cam(params, pose, bs, nbi, i_offset)
    return _class_from_corners(cx_, cy_, cz_, mip, cam, points_cam.shape[:2])


def _first_ids(flags: torch.Tensor, cap: int) -> Tuple[torch.Tensor, int]:
    """(first ``cap`` indices of set flags in index order, number set). Reads
    the count on the host: the flat path's merge takes an exact list."""
    ids = torch.nonzero(flags.reshape(-1)).reshape(-1)
    return ids[:cap], ids.shape[0]


def _compact_vals(flags: torch.Tensor, vals: torch.Tensor, cap: int,
                  fill: int) -> torch.Tensor:
    """Stable compaction: the values of the first ``cap`` set flags, in
    order, padded with ``fill`` to length ``cap``. The keep-the-first-cap
    order decides which bricks drop on overflow. No host sync: set flags
    past the cap are scattered to a spare slot that is cut off."""
    f = flags.reshape(-1)
    pos = torch.cumsum(f, 0) - 1
    tgt = torch.where(f & (pos < cap), pos, cap)
    buf = torch.full((cap + 1,), fill, dtype=vals.dtype, device=vals.device)
    return buf.scatter_(0, tgt, vals.reshape(-1))[:cap]


def _compact_ids(flags: torch.Tensor, cap: int, fill: int) -> torch.Tensor:
    """First ``cap`` indices of set flags (sorted), ``fill``-padded."""
    n = flags.numel()
    return _compact_vals(flags, torch.arange(n, device=flags.device), cap, fill)


def classify_compact_card(params, pose, points_cam, normals_cam, cam, bs, distance, cap,
                          cap_free, factor, cap_mixed, share_margin=0.0,
                          sat: Optional[torch.Tensor] = None, nbi: Optional[int] = None,
                          i_offset: int = 0, mip: Optional[ZetaMip] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Classification and FULL / FREE compaction on the card, flat (``factor``
    1: K6 flat, K7 flat) or hierarchical (K6 super, K7 flat over the supers,
    K6 children, K7 hierarchical), after K5 for the mip unless ``mip`` is
    given. Returns (ids, counts) as brickmajor.classify_compact_rows does."""
    h, w_img = points_cam.shape[:2]
    m = params.m
    bi, bj, bk = bs
    nb3 = (m // bi if nbi is None else nbi, m // bj, m // bk)
    NB = nb3[0] * nb3[1] * nb3[2]
    if mip is None:
        mip = _zeta_mip(points_cam, normals_cam, cam, params.delta, distance, share_margin)
    R, base = _card_pose(pose)
    geo = dict(params=params, cam=cam, hw=(h, w_img), i_offset=i_offset)
    if factor <= 1:
        cls, _ = k567.classify_bricks(mip, R, base, bs=bs, grid=nb3, **geo)
        return k567.compact_lists(cls, sat, cap, cap_free, NB)
    f = factor
    ns3 = tuple(n // f for n in nb3)
    scls, sat_super = k567.classify_bricks(mip, R, base, bs=(bi * f, bj * f, bk * f),
                                           grid=ns3, sat=sat, factor=f, **geo)
    sup, sup_counts = k567.compact_lists(scls, sat_super, cap_mixed,
                                         max(cap_free // f ** 3, 1), ns3[0] * ns3[1] * ns3[2])
    fcls, gid = k567.classify_children(mip, R, base, sup[:cap_mixed], bs=bs, grid=nb3,
                                       factor=f, **geo)
    return k567.compact_lists_hier(fcls, gid, sat, sup[cap_mixed:], sup_counts, cap=cap,
                                   cap_free=cap_free, cap_mixed=cap_mixed, grid=nb3, factor=f)


def classify_compact_hier(params, pose, points_cam, normals_cam, cam, bs,
                          distance, cap, cap_free, factor, cap_mixed,
                          share_margin=0.0, sat: Optional[torch.Tensor] = None,
                          nbi: Optional[int] = None, i_offset: int = 0,
                          mip: Optional[ZetaMip] = None):
    """Hierarchical classification and FULL/FREE compaction
    (``classify_compact_hier_reference``). On the card five launches
    (``classify_compact_card``); the ids come back int64, as the plain
    version's."""
    if not _on_card(points_cam, "classify_compact_hier"):
        return classify_compact_hier_reference(
            params, pose, points_cam, normals_cam, cam, bs, distance, cap, cap_free, factor,
            cap_mixed, share_margin, sat, nbi, i_offset, mip)
    ids, counts = classify_compact_card(params, pose, points_cam, normals_cam, cam, bs,
                                        distance, cap, cap_free, factor, cap_mixed,
                                        share_margin, sat, nbi, i_offset, mip)
    ids = ids.to(torch.int64)
    return ids[:cap], ids[cap:], counts[0], counts[1], counts[3], counts[2]


def classify_compact_hier_reference(params, pose, points_cam, normals_cam, cam, bs,
                                    distance, cap, cap_free, factor, cap_mixed,
                                    share_margin=0.0, sat: Optional[torch.Tensor] = None,
                                    nbi: Optional[int] = None, i_offset: int = 0,
                                    mip: Optional[ZetaMip] = None):
    """Hierarchical classification and FULL/FREE compaction, plain PyTorch.

    Super-bricks of ``factor``^3 bricks are classified first; only MIXED
    (class-FULL) supers descend to per-brick proofs, over ``cap_mixed``
    supers; a FREE super makes all its bricks FREE without descent. The
    proofs are monotone, so the classes equal those of classify_bricks.

    Returns (full_ids (cap,), fr_ids (cap_free,), n_full, n_free,
    overflow_mixed, overflow_free), ids padded with NB and counts as 0-dim
    tensors. full_ids come in (mixed-super rank, child) order, not globally
    sorted; fr_ids hold the FREE bricks of mixed supers first, then the
    children of FREE supers, ``cap_free // factor^3`` supers at most.
    Mixed supers past cap_mixed are dropped with their bricks and reported.

    ``sat`` ((NB,) bool, the sat_skip bitset): saturated bricks leave the
    FREE candidates at three levels: FREE bricks of mixed supers, FREE
    supers whose children are all saturated (before compaction, so their
    slot is reclaimed), and saturated children of the FREE supers kept
    (their positions stay NB-padded holes). n_free then counts only the
    candidates kept; overflow_free keeps its count over whole supers.

    ``nbi`` / ``i_offset``: an i-slab of nbi brick layers starting at global
    voxel i = i_offset; the ids are then local to the slab. ``mip``: the
    frame's mip, made here when None."""
    h, w_img = points_cam.shape[:2]
    bi, bj, bk = bs
    m = params.m
    nbi = m // bi if nbi is None else nbi
    nbj, nbk = m // bj, m // bk
    NB = nbi * nbj * nbk
    f = factor
    vol = f * f * f
    nsj, nsk = nbj // f, nbk // f
    NS = (nbi // f) * nsj * nsk
    dev = points_cam.device
    if mip is None:
        mip = _zeta_mip_reference(points_cam, normals_cam, cam, params.delta, distance,
                                  share_margin)

    # ---- level 1: super-bricks
    scls = classify_bricks_reference(params, pose, points_cam, normals_cam, cam,
                                     (bi * f, bj * f, bk * f), distance, mip=mip,
                                     nbi=nbi // f, i_offset=i_offset).reshape(-1)
    n_mixed = (scls == FULL).sum()
    mixed_ids = _compact_ids(scls == FULL, cap_mixed, NS)
    valid_s = mixed_ids < NS
    ms = torch.where(valid_s, mixed_ids, 0)

    # ---- level 2: bricks of the mixed supers, from per-axis corner tables
    Rt = pose.R.T

    def axis_tab(nb, b, extent, origin, col, off=0):  # (nb, 2, 3)
        return _axis_lohi(nb, b, extent, origin, m, dev, off)[..., None] * Rt[:, col]

    sel = _corner_sel(dev)
    la = torch.arange(f, device=dev)

    def children(sid):  # super ids (S,) -> per-axis brick indices, each (S, f)
        return ((sid // (nsj * nsk))[:, None] * f + la,
                ((sid // nsk) % nsj)[:, None] * f + la,
                (sid % nsk)[:, None] * f + la)

    def brick_ids(fi, fj, fk):  # (S, f) each -> global ids (S, f, f, f)
        return (fi[:, :, None, None] * (nbj * nbk) + fj[:, None, :, None] * nbk
                + fk[:, None, None, :])

    fi, fj, fk = children(ms)
    Axg = axis_tab(nbi, bi, params.width, params.origin[0], 0, i_offset)[fi][:, :, sel[:, 0], :]
    Ayg = axis_tab(nbj, bj, params.height, params.origin[1], 1)[fj][:, :, sel[:, 1], :]
    Azg = axis_tab(nbk, bk, params.depth, params.origin[2], 2)[fk][:, :, sel[:, 2], :]
    c = (Axg[:, :, None, None] + Ayg[:, None, :, None]
         + Azg[:, None, None, :]) - Rt @ pose.t  # (S, f, f, f, 8, 3)
    vs = valid_s[:, None, None, None]
    fcls = torch.where(vs, _class_from_corners(c[..., 0], c[..., 1], c[..., 2],
                                               mip, cam, (h, w_img)), 0).reshape(-1)
    gflat = torch.where(vs, brick_ids(fi, fj, fk), NB).reshape(-1)

    n_full = (fcls == FULL).sum()
    full_ids = _compact_vals(fcls == FULL, gflat, cap, NB)

    # ---- FREE ids: FREE bricks of mixed supers, then children of FREE supers
    free_fine = fcls == FREE
    if sat is not None:  # FREE implies a valid id
        free_fine = free_fine & ~sat[gflat.clamp(max=NB - 1)]
    n_free_mixed = free_fine.sum()
    fr_ids = _compact_vals(free_fine, gflat, cap_free, NB)
    cap_sfree = max(cap_free // vol, 1)
    free_super = scls == FREE
    if sat is not None:
        sat_super = (sat.reshape(nbi // f, f, nsj, f, nsk, f).permute(0, 2, 4, 1, 3, 5)
                     .reshape(NS, vol).all(dim=1))
        free_super = free_super & ~sat_super
    n_sf = free_super.sum()
    sf_ids = _compact_ids(free_super, cap_sfree, NS)
    valid_sf = sf_ids < NS
    sf_gid = torch.where(valid_sf[:, None],
                         brick_ids(*children(torch.where(valid_sf, sf_ids, 0)))
                         .reshape(cap_sfree, vol), NB).reshape(-1)
    # appended right after the compacted mixed-super prefix
    pos = n_free_mixed + torch.arange(cap_sfree * vol, device=dev)
    kept = valid_sf[:, None].expand(cap_sfree, vol).reshape(-1)
    keep = kept & (pos < cap_free)
    n_sat_child = 0
    if sat is not None:  # saturated children of kept supers: holes
        sat_child = sat[sf_gid.clamp(max=NB - 1)] & kept
        keep = keep & ~sat_child
        n_sat_child = sat_child.sum()
    fr_ids = torch.cat([fr_ids, fr_ids.new_full((1,), NB)]).scatter_(
        0, torch.where(keep, pos, cap_free), sf_gid)[:cap_free]
    n_free = n_free_mixed + vol * n_sf - n_sat_child
    overflow_free = (
        torch.clamp(n_free_mixed + vol * torch.clamp(n_sf, max=cap_sfree) - cap_free,
                    min=0)
        + vol * torch.clamp(n_sf - cap_sfree, min=0))
    overflow_mixed = torch.clamp(n_mixed - cap_mixed, min=0)
    return full_ids, fr_ids, n_full, n_free, overflow_mixed, overflow_free


def _pixel_table(points_cam, normals_cam, rgb, fuse_color,
                 distance="point_to_plane") -> torch.Tensor:
    """The pixel table of ``_pixel_table_reference``: on the card one K5
    launch (brick_classify.frame_tables)."""
    if not _on_card(points_cam, "_pixel_table"):
        return _pixel_table_reference(points_cam, normals_cam, rgb, fuse_color, distance)
    return k567.frame_tables(points_cam, normals_cam, rgb, distance=distance, mip=False,
                             fuse_color=fuse_color)[1]


def frame_tables(points_cam, normals_cam, rgb, fuse_color, cam, delta,
                 distance="point_to_plane", share_margin=0.0
                 ) -> Tuple[ZetaMip, torch.Tensor]:
    """(``_zeta_mip``, ``_pixel_table``) of one frame: on the card in one K5
    launch."""
    if not _on_card(points_cam, "frame_tables"):
        return (_zeta_mip_reference(points_cam, normals_cam, cam, delta, distance,
                                    share_margin),
                _pixel_table_reference(points_cam, normals_cam, rgb, fuse_color, distance))
    return k567.frame_tables(points_cam, normals_cam, rgb, cam=cam, delta=delta,
                             distance=distance, share_margin=share_margin,
                             fuse_color=fuse_color)


def _pixel_table_reference(points_cam, normals_cam, rgb, fuse_color,
                           distance="point_to_plane") -> torch.Tensor:
    """(H*W, C) rows: [nx, ny, nz, s (, cos, cos·r, cos·g, cos·b)].

    s is y·n (point-to-plane, d = -(s - p·n)) or z_y (point-to-point,
    d = s - p_z). An invalid pixel gets the s that drives d to -inf, so the
    d >= -delta mask rejects it."""
    h, w_img = points_cam.shape[:2]
    n_img, y_img = normals_cam, points_cam
    finite = pixel_finite(points_cam, normals_cam)
    zero = torch.zeros((), device=points_cam.device)
    if distance == "point_to_point":
        s_img = torch.where(finite, y_img[..., 2], zero - _INF)
    else:
        s_img = torch.where(
            finite, torch.where(finite[..., None], y_img * n_img, zero).sum(-1),
            zero + _INF)
    channels = [torch.where(finite, n_img[..., c], zero) for c in range(3)]
    channels.append(s_img)
    if fuse_color:
        norm_n = torch.sqrt(torch.where(finite[..., None], n_img * n_img, zero).sum(-1))
        cos_img = torch.where(
            norm_n > 0,
            torch.abs(torch.where(finite, n_img[..., 2], zero))
            / torch.where(norm_n > 0, norm_n, zero + 1.0), zero)
        channels += [cos_img, cos_img * rgb[..., 0], cos_img * rgb[..., 1],
                     cos_img * rgb[..., 2]]
    return torch.stack(channels, dim=-1).reshape(h * w_img, -1)


def _full_brick_updates(full_ids, pix, pose, params, cam, cfg, bs, hw,
                        fuse_color, nbi: Optional[int] = None,
                        i_offset: int = 0) -> List[torch.Tensor]:
    """Per-voxel update sums of the FULL bricks ``full_ids`` (n,), where an
    id >= NB is a padding slot whose sums are all zero: the channels
    [w, w·d(, w·cos, w·cos·r, w·cos·g, w·cos·b)], each (n, bi, bj, bk). One
    pixel row per voxel, or per share group (its center voxel's row) with
    pixel_share > 1. ``nbi`` / ``i_offset``: the ids are local to an i-slab
    of nbi brick layers starting at global voxel i = i_offset."""
    bi, bj, bk = bs
    h, w_img = hw
    m = params.m
    nbj, nbk = m // bj, m // bk
    NB = (m // bi if nbi is None else nbi) * nbj * nbk
    dev = pix.device
    n = full_ids.shape[0]
    valid_brick = full_ids < NB
    fb = torch.where(valid_brick, full_ids, 0).to(torch.int64)
    ar = lambda k: torch.arange(k, device=dev)  # noqa: E731
    I = (fb // (nbj * nbk))[:, None] * bi + ar(bi) + i_offset  # (n, bi), global
    J = ((fb // nbk) % nbj)[:, None] * bj + ar(bj)
    K = (fb % nbk)[:, None] * bk + ar(bk)
    I, J, K = I[:, :, None, None], J[:, None, :, None], K[:, None, None, :]

    ox, oy, oz = params.origin
    X = (params.width / m) * (I.to(torch.float32) + 0.5) + ox
    Y = (params.height / m) * (J.to(torch.float32) + 0.5) + oy
    Z = (params.depth / m) * (K.to(torch.float32) + 0.5) + oz
    px, py, pz = world_to_camera_components(pose, X, Y, Z)

    in_front = pz > 0
    safe_pz = torch.where(in_front, pz, torch.ones_like(pz))
    u = (cam.fx * px + cam.cx * pz) / safe_pz
    v = (cam.fy * py + cam.cy * pz) / safe_pz
    iu = torch.trunc(u).to(torch.int64)  # truncation toward zero, not floor
    iv = torch.trunc(v).to(torch.int64)
    ins = (iu >= 0) & (iu < w_img) & (iv >= 0) & (iv < h)
    flat_pix = iv.clamp(0, h - 1) * w_img + iu.clamp(0, w_img - 1)  # (n,bi,bj,bk)

    sk = cfg.pixel_share
    sj = cfg.pixel_share_j
    if bk % sk:
        sk = 1
    if bj % sj:
        sj = 1
    if sk > 1 or sj > 1:
        # groups of sj x sk voxels read their center voxel's pixel row
        fp = flat_pix.reshape(n, bi, bj // sj, sj, bk // sk, sk)
        fp = fp[:, :, :, sj // 2, :, sk // 2]
        g = pix[fp]  # (n, bi, bj/sj, bk/sk, C)
        g = g[:, :, :, None, :, None, :].expand(
            n, bi, bj // sj, sj, bk // sk, sk, pix.shape[-1])
        g = g.reshape(n, bi, bj, bk, -1)
    else:
        g = pix[flat_pix]
    nx, ny, nz, s = g[..., 0], g[..., 1], g[..., 2], g[..., 3]

    if cfg.distance == "point_to_plane":
        d = -(s - (px * nx + py * ny + pz * nz))
    elif cfg.distance == "point_to_point":
        d = s - pz
    else:
        raise ValueError(f"unknown distance: {cfg.distance}")

    fuse_mask = (in_front & ins & valid_brick[:, None, None, None]
                 & (d >= -params.delta))
    # sanitize before multiplying: 0 * (-inf) from an invalid pixel is NaN
    zero = torch.zeros_like(d)
    d = torch.where(fuse_mask, torch.clamp(d, max=params.delta), zero)
    w_new = torch.where(
        fuse_mask, weighting(cfg.weighting, d, params.epsilon, params.delta), zero)
    upd = [w_new, w_new * d]
    if fuse_color:
        upd += [w_new * g[..., c] for c in (4, 5, 6, 7)]
    return upd


def fuse_frame_bricked(
    grid: TSDFGrid,
    pose: Pose,
    points_cam: torch.Tensor,  # (H, W, 3)
    normals_cam: torch.Tensor,  # (H, W, 3)
    rgb: Optional[torch.Tensor],  # (H, W, 3) in [0, 1] or None
    *,
    params: GridParams,
    cam: PinholeCamera,
    cfg: FusionConfig = FusionConfig(),
    bs: Tuple[int, int, int] = (8, 8, 8),
    cap: int = 1024,
    merge: str = "pallas",
    cap_act: Optional[int] = None,
    cap_free: Optional[int] = None,
    i_offset: int = 0,
) -> Tuple[TSDFGrid, FuseStats]:
    """Brick-compacted fusion, updating ``grid`` in place through the merge
    tail ``merge`` ("pallas": K2 over the first ``cap_act`` active bricks,
    default 4·cap; "xla": K2's plain version over every active brick; "rows":
    the same over the FULL bricks and the FREE bricks up to ``cap_free``,
    default cap, the rest dropped). Geometry is exactly the dense path's; color is fused in
    FULL bricks only. ``grid`` may be an i-slab of (mi, m, m) leaves whose
    first plane is global voxel i = ``i_offset`` (parallel.sharded); brick
    ids are then local to it. Returns (grid, FuseStats)."""
    h, w_img = points_cam.shape[:2]
    m = params.m
    mi = grid.D.shape[0]
    bi, bj, bk = bs
    if tuple(grid.D.shape) != (mi, m, m) or mi % bi or m % bj or m % bk:
        raise ValueError(f"grid {tuple(grid.D.shape)} not divisible by brick {bs}")
    if merge not in ("pallas", "xla", "rows"):
        raise ValueError(f"unknown brick_merge: {merge}")
    if merge == "pallas" and mi != m:
        raise ValueError("brick_merge='pallas' takes a whole grid, not an i-slab")
    nbi = mi // bi
    NB = nbi * (m // bj) * (m // bk)
    fuse_color = cfg.fuse_color and rgb is not None
    dev = grid.D.device

    share_m = share_classify_margin(params, cfg)
    mip, pix = frame_tables(points_cam, normals_cam, rgb, fuse_color, cam, params.delta,
                            cfg.distance, share_m)
    brick_class = classify_bricks(
        params, pose, points_cam, normals_cam, cam, bs, cfg.distance, share_margin=share_m,
        mip=mip, nbi=nbi, i_offset=i_offset).reshape(-1)
    full_ids, n_full = _first_ids(brick_class == FULL, cap)
    upd = torch.stack(_full_brick_updates(full_ids, pix, pose, params, cam, cfg,
                                          bs, (h, w_img), fuse_color, nbi, i_offset),
                      dim=-1)
    # row ``cap`` stays zero: FULL bricks past the FULL cap merge nothing
    U = torch.zeros((cap + 1, bi, bj, bk, upd.shape[-1]), device=dev)
    U[:full_ids.shape[0]] = upd
    merge_kw = dict(bs=bs, delta=params.delta, max_weight=cfg.max_weight)
    if merge == "rows":
        cap_free = cap if cap_free is None else cap_free
        fr_ids, n_free = _first_ids(brick_class == FREE, cap_free)
        brick_merge_reference(
            grid, U, torch.cat([full_ids, fr_ids]),
            torch.cat([torch.full_like(full_ids, FULL), torch.full_like(fr_ids, FREE)]),
            torch.cat([torch.arange(full_ids.shape[0], device=dev),
                       torch.full_like(fr_ids, cap)]), **merge_kw)
        return grid, FuseStats(n_full=n_full, overflow=max(n_full - cap, 0), n_free=n_free,
                               overflow_active=max(n_free - cap_free, 0))
    # "xla" merges every active brick (a voxel of any other brick adds nothing)
    cap_act = NB if merge == "xla" else 4 * cap if cap_act is None else cap_act
    act_ids, n_active = _first_ids(brick_class > 0, cap_act)
    slot_map = torch.full((NB,), cap, dtype=torch.int32, device=dev)
    slot_map[full_ids] = torch.arange(full_ids.shape[0], dtype=torch.int32,
                                      device=dev)
    cls_act = brick_class[act_ids]
    slot_act = torch.where(cls_act == FULL, slot_map[act_ids], cap).to(torch.int32)
    (brick_merge if merge == "pallas" else brick_merge_reference)(
        grid, U, act_ids.to(torch.int32), cls_act.contiguous(), slot_act.contiguous(),
        **merge_kw)
    stats = FuseStats(n_full=n_full, overflow=max(n_full - cap, 0),
                      n_free=n_active - n_full,
                      overflow_active=max(n_active - cap_act, 0))
    return grid, stats
