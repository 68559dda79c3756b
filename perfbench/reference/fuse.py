"""Plain brick-major TSDF fusion of one frame, as the configuration states it.

The grid is (NB, BV) rows per leaf (D, W, R, G, B, Wc), brick (ib, jb, kb)
row-major over (m/bi, m/bj, m/bk) and its voxels row-major within; D is NaN
where W <= 0. Every value is stored through ``store`` (the configuration's
storage precision) and computed in float32.

A frame: the zeta / eta depth-bound mips and the pixel table; every brick
classified OUT, FREE (provably in front of every surface: w = 1, d = +delta
per voxel, no pixel read) or FULL (the per-voxel update), flat or through
super-bricks of ``hier_classify``^3 bricks; the first ``brick_cap`` FULL and
``brick_cap_free`` FREE bricks kept in id order (super-brick order when
hierarchical), the rest dropped for the frame; then each FULL brick's
voxels read the pixel row of their share group's centre voxel (groups of
pixel_share_j x pixel_share along j, k), d = z_pixel - z_voxel
(point_to_point), kept where d >= -delta, clamped to delta, weighted
exp(-(d + eps)^2 / 2) behind -eps, and merged into running means: D by the
uncapped weight sum, W clamped to max_weight; color merged in FULL bricks
on color frames, weighted by the normal's |cos|.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from reference.lie import Pose

OUT, FREE, FULL = 0, 1, 2
_TILE = 8
_INF = float("inf")
_CORNERS = tuple((a, b, c) for a in (0, 1) for b in (0, 1) for c in (0, 1))


def pixel_finite(points, normals):
    return torch.isfinite(points[..., :2]).all(-1) & torch.isfinite(normals).all(-1)


# --- the frame's tables ---------------------------------------------------------------

def _mip_levels(img, largest: bool) -> List[torch.Tensor]:
    neutral = -_INF if largest else _INF

    def red(x):
        return x.amax(dim=(1, 3)) if largest else x.amin(dim=(1, 3))

    h, w = img.shape
    H, W = -(-h // _TILE) * _TILE, -(-w // _TILE) * _TILE
    img = torch.nn.functional.pad(img, (0, W - w, 0, H - h), value=neutral)
    lvl = red(img.reshape(H // _TILE, _TILE, W // _TILE, _TILE))
    levels = [lvl]
    while lvl.shape[0] > 1 or lvl.shape[1] > 1:
        lvl = torch.nn.functional.pad(lvl, (0, lvl.shape[1] % 2, 0, lvl.shape[0] % 2),
                                      value=neutral)
        lvl = red(lvl.reshape(lvl.shape[0] // 2, 2, lvl.shape[1] // 2, 2))
        levels.append(lvl)
    return levels


class Mip:
    """Flattened min-mip of zeta and max-mip of eta, each with its
    row-below companion, and the levels' offsets and shapes."""

    def __init__(self, points, normals, delta: float):
        fin = pixel_finite(points, normals)
        z = points[..., 2]
        neg = torch.full_like(z, -_INF)
        zl = _mip_levels(torch.where(fin, z - delta, neg), largest=False)
        el = _mip_levels(torch.where(fin, z + delta, neg), largest=True)
        self.dims = [tuple(l.shape) for l in zl]
        self.offsets = [int(o) for o in np.concatenate(
            [[0], np.cumsum([a * b for a, b in self.dims])])[:-1]]

        def flat(levels, neutral):
            downs = [torch.cat([l[1:], torch.full_like(l[:1], neutral)], 0) for l in levels]
            return (torch.cat([l.reshape(-1) for l in levels]),
                    torch.cat([d.reshape(-1) for d in downs]))

        self.zeta, self.zeta_down = flat(zl, _INF)
        self.eta, self.eta_down = flat(el, -_INF)

    def query(self, u0, u1, v0, v1):
        """Conservative (min zeta, max eta) over the pixel boxes [u0,u1] x
        [v0,v1]: at the level where 3 cells cover the span, a window of 4
        cells a row, clamped into the level, for two window-row pairs, each
        row read with its row-below companion."""
        dev = u0.device
        L = len(self.dims)
        span = torch.maximum(u1 - u0, v1 - v0) / (3.0 * _TILE)
        lvl = torch.ceil(torch.log2(torch.clamp(span, min=1.0))).to(torch.int64).clamp(0, L - 1)
        offs = torch.tensor(self.offsets, dtype=torch.int64, device=dev)[lvl]
        dh = torch.tensor([d[0] for d in self.dims], dtype=torch.int64, device=dev)[lvl]
        dw = torch.tensor([d[1] for d in self.dims], dtype=torch.int64, device=dev)[lvl]
        cell = (_TILE * 2 ** lvl).to(torch.float32)
        cu0 = torch.minimum((u0 / cell).to(torch.int64).clamp(min=0), torch.clamp(dw - 4, min=0))
        cv0 = torch.minimum((v0 / cell).to(torch.int64).clamp(min=0), torch.clamp(dh - 4, min=0))
        total = self.zeta.shape[0]
        P = -(-total // 4) * 4
        lane = torch.arange(4, device=dev)

        def padded(x, neutral):
            return torch.nn.functional.pad(x, (0, P - total), value=neutral)

        z, zd = padded(self.zeta, _INF), padded(self.zeta_down, _INF)
        e, ed = padded(self.eta, -_INF), padded(self.eta_down, -_INF)
        zeta_min = torch.full(u0.shape, _INF, device=dev)
        eta_max = torch.full(u0.shape, -_INF, device=dev)
        for dv in (0, 2):
            cv = torch.minimum(cv0 + dv, dh - 1)
            idx = ((offs + cv * dw + cu0)[..., None] + lane) % P
            zeta_min = torch.minimum(zeta_min, torch.minimum(z[idx], zd[idx]).amin(-1))
            eta_max = torch.maximum(eta_max, torch.maximum(e[idx], ed[idx]).amax(-1))
        return zeta_min, eta_max


def pixel_table(points, normals, rgb) -> torch.Tensor:
    """(H*W, C) rows [nx, ny, nz, z (, |cos|, |cos| r, |cos| g, |cos| b)];
    an invalid pixel gets z = -inf, which no voxel keeps."""
    h, w = points.shape[:2]
    finite = pixel_finite(points, normals)
    zero = torch.zeros((), device=points.device)
    ch = [torch.where(finite, normals[..., c], zero) for c in range(3)]
    ch.append(torch.where(finite, points[..., 2], zero - _INF))
    if rgb is not None:
        norm_n = torch.sqrt(torch.where(finite[..., None], normals * normals, zero).sum(-1))
        cos = torch.where(norm_n > 0, torch.abs(torch.where(finite, normals[..., 2], zero))
                          / torch.where(norm_n > 0, norm_n, zero + 1.0), zero)
        ch += [cos, cos * rgb[..., 0], cos * rgb[..., 1], cos * rgb[..., 2]]
    return torch.stack(ch, -1).reshape(h * w, -1)


# --- classification and compaction --------------------------------------------------

def _axis_lohi(nb, b, extent, origin, m, dev):
    """(nb, 2) world coordinates of the first and last voxel centre of each brick."""
    idx = torch.arange(nb, dtype=torch.float32, device=dev) * b
    return torch.stack([(extent / m) * (idx + 0.5) + origin,
                        (extent / m) * (idx + b - 0.5) + origin], -1)


def _class_from_corners(cx, cy, cz, mip: Mip, cam: dict, hw):
    h, w = hw
    pz_min, pz_max = cz.amin(-1), cz.amax(-1)
    all_front = pz_min > 0
    safe_z = torch.where(cz > 0, cz, torch.ones_like(cz))
    u = (cam["fx"] * cx + cam["cx"] * cz) / safe_z
    v = (cam["fy"] * cy + cam["cy"] * cz) / safe_z
    u0, u1, v0, v1 = u.amin(-1), u.amax(-1), v.amin(-1), v.amax(-1)
    inside = all_front & (u0 >= 0) & (u1 < w) & (v0 >= 0) & (v1 < h)
    out = (pz_max <= 0) | (all_front & ((u1 <= -1) | (u0 >= w) | (v1 <= -1) | (v0 >= h)))
    zeta_min, eta_max = mip.query(u0.clamp(0, w - 1), u1.clamp(0, w - 1),
                                  v0.clamp(0, h - 1), v1.clamp(0, h - 1))
    cls = torch.where(inside & (pz_max < zeta_min), FREE, FULL)
    return torch.where(out | (all_front & (pz_min > eta_max)), OUT, cls).to(torch.int32)


def classify(grid: dict, pose: Pose, mip: Mip, cam: dict, hw, bs) -> torch.Tensor:
    """Classes of the bricks of extent ``bs`` over the whole grid, flat."""
    m = grid["m"]
    Rt = pose.R.T
    dev = Rt.device
    ox, oy, oz = grid["origin"]
    sel = torch.tensor(_CORNERS, dtype=torch.int64, device=dev)
    Ax = _axis_lohi(m // bs[0], bs[0], grid["width"], ox, m, dev)[..., None] * Rt[:, 0]
    Ay = _axis_lohi(m // bs[1], bs[1], grid["height"], oy, m, dev)[..., None] * Rt[:, 1]
    Az = _axis_lohi(m // bs[2], bs[2], grid["depth"], oz, m, dev)[..., None] * Rt[:, 2]
    c = (Ax[:, sel[:, 0], :][:, None, None] + Ay[:, sel[:, 1], :][None, :, None]
         + Az[:, sel[:, 2], :][None, None, :]) + (-(Rt @ pose.t))
    return _class_from_corners(c[..., 0], c[..., 1], c[..., 2], mip, cam, hw).reshape(-1)


def compact_vals(flags, vals, cap: int, fill: int):
    """The values of the first ``cap`` set flags in order, ``fill``-padded."""
    f = flags.reshape(-1)
    pos = torch.cumsum(f, 0) - 1
    tgt = torch.where(f & (pos < cap), pos, cap)
    buf = torch.full((cap + 1,), fill, dtype=vals.dtype, device=vals.device)
    return buf.scatter_(0, tgt, vals.reshape(-1))[:cap]


def compact_ids(flags, cap: int, fill: int):
    return compact_vals(flags, torch.arange(flags.numel(), device=flags.device), cap, fill)


def classify_compact(grid: dict, pose: Pose, mip: Mip, cam: dict, hw, fcfg: dict):
    """(FULL ids (cap,), FREE ids (cap_free,), counts [n_full, n_free, FREE
    dropped, mixed supers dropped]), ids padded with NB."""
    m = grid["m"]
    bs = tuple(fcfg["brick_shape"])
    cap, cap_free = fcfg["brick_cap"], fcfg["brick_cap_free"] or fcfg["brick_cap"]
    nb3 = tuple(m // b for b in bs)
    NB = nb3[0] * nb3[1] * nb3[2]
    f = fcfg["hier_classify"]
    if not (f > 1 and all(n % f == 0 for n in nb3)):
        cls = classify(grid, pose, mip, cam, hw, bs)
        n_full, n_free = (cls == FULL).sum(), (cls == FREE).sum()
        return (compact_ids(cls == FULL, cap, NB), compact_ids(cls == FREE, cap_free, NB),
                torch.stack([n_full, n_free, torch.clamp(n_free - cap_free, min=0),
                             torch.zeros_like(n_free)]))
    dev = mip.zeta.device
    nbi, nbj, nbk = nb3
    vol = f ** 3
    nsj, nsk = nbj // f, nbk // f
    NS = (nbi // f) * nsj * nsk
    cap_mixed = fcfg["cap_mixed"]
    scls = classify(grid, pose, mip, cam, hw, tuple(b * f for b in bs))
    n_mixed = (scls == FULL).sum()
    mixed = compact_ids(scls == FULL, cap_mixed, NS)
    valid_s = mixed < NS
    ms = torch.where(valid_s, mixed, 0)
    Rt = pose.R.T
    sel = torch.tensor(_CORNERS, dtype=torch.int64, device=dev)
    la = torch.arange(f, device=dev)
    ox, oy, oz = grid["origin"]

    def children(sid):
        return ((sid // (nsj * nsk))[:, None] * f + la, ((sid // nsk) % nsj)[:, None] * f + la,
                (sid % nsk)[:, None] * f + la)

    def brick_ids(fi, fj, fk):
        return fi[:, :, None, None] * (nbj * nbk) + fj[:, None, :, None] * nbk + fk[:, None, None, :]

    fi, fj, fk = children(ms)
    Ax = (_axis_lohi(nbi, bs[0], grid["width"], ox, m, dev)[..., None] * Rt[:, 0])[fi][:, :, sel[:, 0], :]
    Ay = (_axis_lohi(nbj, bs[1], grid["height"], oy, m, dev)[..., None] * Rt[:, 1])[fj][:, :, sel[:, 1], :]
    Az = (_axis_lohi(nbk, bs[2], grid["depth"], oz, m, dev)[..., None] * Rt[:, 2])[fk][:, :, sel[:, 2], :]
    c = (Ax[:, :, None, None] + Ay[:, None, :, None] + Az[:, None, None, :]) - Rt @ pose.t
    vs = valid_s[:, None, None, None]
    fcls = torch.where(vs, _class_from_corners(c[..., 0], c[..., 1], c[..., 2], mip, cam, hw),
                       0).reshape(-1)
    gflat = torch.where(vs, brick_ids(fi, fj, fk), NB).reshape(-1)
    n_full = (fcls == FULL).sum()
    full_ids = compact_vals(fcls == FULL, gflat, cap, NB)
    free_fine = fcls == FREE
    n_free_mixed = free_fine.sum()
    fr_ids = compact_vals(free_fine, gflat, cap_free, NB)
    cap_sfree = max(cap_free // vol, 1)
    free_super = scls == FREE
    n_sf = free_super.sum()
    sf_ids = compact_ids(free_super, cap_sfree, NS)
    valid_sf = sf_ids < NS
    sf_gid = torch.where(valid_sf[:, None],
                         brick_ids(*children(torch.where(valid_sf, sf_ids, 0))).reshape(cap_sfree, vol),
                         NB).reshape(-1)
    pos = n_free_mixed + torch.arange(cap_sfree * vol, device=dev)
    keep = valid_sf[:, None].expand(cap_sfree, vol).reshape(-1) & (pos < cap_free)
    fr_ids = torch.cat([fr_ids, fr_ids.new_full((1,), NB)]).scatter_(
        0, torch.where(keep, pos, cap_free), sf_gid)[:cap_free]
    n_free = n_free_mixed + vol * n_sf
    ovf_free = (torch.clamp(n_free_mixed + vol * torch.clamp(n_sf, max=cap_sfree) - cap_free, min=0)
                + vol * torch.clamp(n_sf - cap_sfree, min=0))
    return full_ids, fr_ids, torch.stack([n_full, n_free, ovf_free,
                                          torch.clamp(n_mixed - cap_mixed, min=0)])


# --- the per-voxel update and the merge -----------------------------------------------

def _project(pose: Pose, grid: dict, cam: dict, hw, I, J, K):
    h, w = hw
    m = grid["m"]
    ox, oy, oz = grid["origin"]
    X = (grid["width"] / m) * (I.to(torch.float32) + 0.5) + ox
    Y = (grid["height"] / m) * (J.to(torch.float32) + 0.5) + oy
    Z = (grid["depth"] / m) * (K.to(torch.float32) + 0.5) + oz
    Rt = pose.R.T
    dx, dy, dz = X - pose.t[0], Y - pose.t[1], Z - pose.t[2]
    px = Rt[0, 0] * dx + Rt[0, 1] * dy + Rt[0, 2] * dz
    py = Rt[1, 0] * dx + Rt[1, 1] * dy + Rt[1, 2] * dz
    pz = Rt[2, 0] * dx + Rt[2, 1] * dy + Rt[2, 2] * dz
    front = pz > 0
    safe = torch.where(front, pz, torch.ones_like(pz))
    iu = torch.trunc((cam["fx"] * px + cam["cx"] * pz) / safe).to(torch.int64)
    iv = torch.trunc((cam["fy"] * py + cam["cy"] * pz) / safe).to(torch.int64)
    ins = (iu >= 0) & (iu < w) & (iv >= 0) & (iv < h)
    return pz, front, ins, iv.clamp(0, h - 1) * w + iu.clamp(0, w - 1)


def fuse_rows(leaves: dict, ids: torch.Tensor, cap: int, pix: torch.Tensor, pose: Pose,
              grid: dict, cam: dict, hw, fcfg: dict, store) -> None:
    """Merge the listed FULL (slots < cap) and FREE rows into ``leaves`` in place."""
    D, W = leaves["D"], leaves["W"]
    NB, BV = D.shape
    bi, bj, bk = fcfg["brick_shape"]
    sk = fcfg["pixel_share"] if bk % fcfg["pixel_share"] == 0 else 1
    sj = fcfg["pixel_share_j"] if bj % fcfg["pixel_share_j"] == 0 else 1
    delta, eps = grid["delta"], grid["epsilon"]
    dev = D.device
    slot = torch.nonzero((ids >= 0) & (ids < NB)).reshape(-1)
    rows = ids[slot].to(torch.int64)
    full = (slot < cap)[:, None]
    one = torch.ones((), device=dev)
    m = grid["m"]
    nbj, nbk = m // bj, m // bk
    b = rows[:, None, None, None]
    I0, J0, K0 = (b // (nbj * nbk)) * bi, ((b // nbk) % nbj) * bj, (b % nbk) * bk
    di = torch.arange(bi, device=dev)[:, None, None]
    dj = (torch.arange(bj // sj, device=dev) * sj + sj // 2)[None, :, None]
    dk = (torch.arange(bk // sk, device=dev) * sk + sk // 2)[None, None, :]
    grow = pix[_project(pose, grid, cam, hw, I0 + di, J0 + dj, K0 + dk)[3]]
    gj = torch.arange(bj, device=dev) // sj
    gk = torch.arange(bk, device=dev) // sk
    g = grow[:, :, gj][:, :, :, gk].reshape(rows.shape[0], BV, pix.shape[1])
    pz, front, ins, _ = _project(pose, grid, cam, hw, I0 + di,
                                 J0 + torch.arange(bj, device=dev)[:, None],
                                 K0 + torch.arange(bk, device=dev))
    pz = pz.reshape(-1, BV)
    d = g[..., 3] - pz  # point_to_point
    mask = (front & ins).reshape(-1, BV) & (d >= -delta)
    zero = torch.zeros_like(d)
    d = torch.where(mask, torch.clamp(d, max=delta), zero)
    wgt = torch.where(d <= -eps, torch.exp(-0.5 * (d + eps) ** 2), torch.ones_like(d))
    w = torch.where(mask, wgt, zero)
    w_add = torch.where(full, w, one)
    wd_add = torch.where(full, w * d, one * delta)
    D_raw, W_old = D[rows], W[rows]
    D_san = torch.where(W_old > 0, D_raw, 0.0 * one)
    W_sum = W_old + w_add
    has = w_add > 0
    D[rows] = torch.where(has, store((W_old * D_san + wd_add) / torch.where(has, W_sum, one)),
                          D_raw)
    mw = fcfg["max_weight"]
    W[rows] = store(W_sum if mw is None else torch.clamp(W_sum, max=mw))
    if pix.shape[1] == 8:
        fr = full[:, 0]
        cr, w_c, g_c = rows[fr], w[fr], g[fr]
        Wc = leaves["Wc"][cr]
        wc_add = w_c * g_c[..., 4]
        Wc_sum = Wc + wc_add
        has_c = wc_add > 0
        safe = torch.where(has_c, Wc_sum, one)
        for name, c in (("R", 5), ("G", 6), ("B", 7)):
            old = leaves[name][cr]
            leaves[name][cr] = torch.where(has_c, store((Wc * old + w_c * g_c[..., c]) / safe),
                                           old)
        leaves["Wc"][cr] = store(Wc_sum if mw is None else torch.clamp(Wc_sum, max=mw))


def fuse(leaves: dict, pose: Pose, points, normals, rgb: Optional[torch.Tensor], grid: dict,
         cam: dict, fcfg: dict, store) -> torch.Tensor:
    """Fuse one frame into ``leaves`` in place; returns the counts [n_full,
    n_free, FREE dropped, mixed supers dropped, FULL dropped]."""
    hw = tuple(points.shape[:2])
    mip = Mip(points, normals, grid["delta"])
    pix = pixel_table(points, normals, rgb)
    full_ids, fr_ids, counts = classify_compact(grid, pose, mip, cam, hw, fcfg)
    cap = fcfg["brick_cap"]
    fuse_rows(leaves, torch.cat([full_ids, fr_ids]), cap, pix, pose, grid, cam, hw, fcfg, store)
    return torch.cat([counts, torch.clamp(counts[:1] - cap, min=0)])
