"""Plain coarse-to-fine Gauss-Newton tracking against the brick-major rows.

Each level decimates the point image by pixel_stride * mult and starts
from the previous level's pose. An iteration forms A = J^T J and b = J^T r
over the valid queries (by default the masked trilinear value and its
analytic gradient against D, NaN where unobserved; the central scheme's
terms come from reference.track_central), adding the queries' terms in the
tracker's fixed order (``sums``), solves (A + lam diag(A) + 1e-12 I) x = b
by Gaussian elimination with partial pivoting in float64, takes no step on
a non-finite solution, tests max |x| < max_twist_diff and updates the pose
T <- exp(x)^-1 o T in float32, also on the converging iteration. Coarse
levels stop at ``coarse_iterations`` (10).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from reference.lie import Pose

COARSE_ITERATIONS = 10
OFFSETS = ((0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
            (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1))
_SMALL = np.float32(1e-8)
# the fixed order in which a Gauss-Newton step adds its queries' terms:
# blocks of THREADS queries, their partial sums added by LANES lanes
THREADS, LANES = 256, 8


class Level(NamedTuple):
    pose: Pose  # float32 on the device
    iterations: int
    num_valid: float
    sum_abs: float


def corner_index(m: int, bs, base: torch.Tensor):
    """(flat index (..., 8) into (NB, BV) brick-major rows, in-bounds
    (..., 8)) of the 8 corners (in ``OFFSETS`` order) of the integer voxel
    ``base`` (..., 3); an out-of-bounds corner is clipped to the grid, axis
    by axis, and flagged."""
    off = torch.tensor(OFFSETS, dtype=torch.int64, device=base.device)
    ci, cj, ck = (base[..., None, a] + off[:, a] for a in range(3))
    inb = (ci >= 0) & (ci < m) & (cj >= 0) & (cj < m) & (ck >= 0) & (ck < m)
    bi, bj, bk = bs
    nbj, nbk = m // bj, m // bk
    ci, cj, ck = ci.clamp(0, m - 1), cj.clamp(0, m - 1), ck.clamp(0, m - 1)
    F = (((ci // bi) * nbj + cj // bj) * nbk + ck // bk) * (bi * bj * bk) \
        + ((ci % bi) * bj + cj % bj) * bk + ck % bk
    return F, inb


def _corners(rows: torch.Tensor, m: int, bs, coords: torch.Tensor):
    """(corner values (N, 8) float32, in-bounds (N, 8), fraction (N, 3)) of
    continuous voxel coordinates against (NB, BV) brick-major rows."""
    base_f = torch.floor(coords)
    F, inb = corner_index(m, bs, base_f.to(torch.int64))
    return rows.reshape(-1)[F].to(torch.float32), inb, coords - base_f


def trilinear_with_grad(rows, m, bs, coords):
    """Masked trilinear value, its gradient in voxel units, and validity."""
    d_raw, inb, f = _corners(rows, m, bs, coords)
    mask = (inb & torch.isfinite(d_raw)).to(f.dtype)
    d = torch.where(mask > 0, d_raw, torch.zeros_like(d_raw))
    off = torch.tensor(OFFSETS, dtype=f.dtype, device=f.device)
    fax = off * f[..., None, :] + (1.0 - off) * (1.0 - f[..., None, :])
    wm = fax[..., 0] * fax[..., 1] * fax[..., 2] * mask
    Z = torch.sum(wm, dim=-1)
    N = torch.sum(wm * d, dim=-1)
    valid = Z > 1e-12
    safe_Z = torch.where(valid, Z, torch.ones_like(Z))
    value = torch.where(valid, N / safe_Z, torch.zeros_like(N))
    sign = 2.0 * off - 1.0
    prod_other = torch.stack([fax[..., 1] * fax[..., 2], fax[..., 0] * fax[..., 2],
                              fax[..., 0] * fax[..., 1]], dim=-1)
    dw = sign * prod_other * mask[..., None]
    dN = torch.sum(dw * d[..., None], dim=-2)
    dZ = torch.sum(dw, dim=-2)
    grad = torch.where(valid[..., None],
                       (dN * safe_Z[..., None] - N[..., None] * dZ) / (safe_Z ** 2)[..., None],
                       torch.zeros_like(dN))
    return value, grad, valid


def query_terms(rows, grid: dict, bs, pose: Pose, points: torch.Tensor) -> torch.Tensor:
    """(N, 29) terms of each of the (N, 3) camera-frame points (NaN holes) at
    ``pose``: J_i J_j over A's upper triangle (row-major), J_i r, 1 and |r|
    for a valid query, zeros for any other."""
    m = grid["m"]
    valid_in = torch.isfinite(points).all(dim=-1)
    p = torch.where(valid_in[:, None], points, torch.zeros_like(points))
    x = p @ pose.R.T + pose.t
    dev = x.device
    origin = torch.tensor(grid["origin"], dtype=torch.float32, device=dev)
    scale = torch.tensor([m / grid["width"], m / grid["height"], m / grid["depth"]],
                         dtype=torch.float32, device=dev)
    uvw = (x - origin) * scale - 0.5
    in_bounds = ((uvw >= 0) & (uvw < m)).all(dim=-1)
    phi, g_uvw, ok = trilinear_with_grad(rows, m, bs, uvw)
    g = g_uvw * scale
    J = torch.cat([g, torch.linalg.cross(x - pose.t, g, dim=-1)], dim=-1)
    return terms_of(phi, J, valid_in & in_bounds & ok)


def terms_of(phi: torch.Tensor, J: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(N, 29) terms of residuals phi (N,) and Jacobians J (N, 6): J_i J_j
    over A's upper triangle (row-major), J_i r, 1 and |r| where ``mask``,
    zeros elsewhere."""
    iu = torch.triu_indices(6, 6, device=J.device)
    terms = torch.cat([J[:, iu[0]] * J[:, iu[1]], J * phi[:, None], torch.ones_like(phi)[:, None],
                       phi.abs()[:, None]], 1)
    return torch.where(mask[:, None], terms, torch.zeros_like(terms))


def sums(terms: torch.Tensor) -> torch.Tensor:
    """The (29,) sums of the per-query terms in the tracker's fixed order:
    the queries zero-padded to whole blocks of THREADS; in each warp of 32
    the shuffle tree (lanes l and l + o added at o = 16, 8, 4, 2, 1); a
    block's warps in order; lane j of 8 adding blocks j, j + 8, ... in
    order; the 8 lanes in order. Float32 adds only."""
    n = terms.shape[0]
    blocks = max(-(-n // THREADS), 1)
    x = torch.zeros(-(-blocks // LANES) * LANES * THREADS, 29, dtype=torch.float32,
                    device=terms.device)
    x[:n] = terms
    x = x.view(-1, THREADS // 32, 32, 29)
    for o in (16, 8, 4, 2, 1):
        x = x[:, :, :o] + x[:, :, o:2 * o]
    warps = x[:, :, 0]
    part = torch.zeros_like(warps[:, 0])
    for w in range(warps.shape[1]):
        part = part + warps[:, w]
    rounds = part.view(-1, LANES, 29)
    lane = torch.zeros_like(rounds[0])
    for r in range(rounds.shape[0]):
        lane = lane + rounds[r]
    total = torch.zeros_like(lane[0])
    for j in range(LANES):
        total = total + lane[j]
    return total


def _fma32(a, b, c):
    """float32 fused multiply-add, through float64 (a * b is exact there)."""
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def solve(A: np.ndarray, b: np.ndarray, lam: float) -> np.ndarray:
    """The damped system in float64: Gaussian elimination with partial
    pivoting (the first row of the largest |pivot|), then back substitution."""
    M = np.concatenate([A.astype(np.float64), b.astype(np.float64)[:, None]], 1)
    for j in range(6):
        M[j, j] = M[j, j] * np.float64(lam) + M[j, j] + 1e-12
    for c in range(6):
        p, best = c, abs(M[c, c])
        for k in range(c + 1, 6):
            if abs(M[k, c]) > best:
                p, best = k, abs(M[k, c])
        M[[c, p]] = M[[p, c]]
        for r in range(c + 1, 6):
            f = M[r, c] / M[c, c]
            M[r, c + 1:] = M[r, c + 1:] - f * M[c, c + 1:]
    x = np.zeros(6)
    for i in range(5, -1, -1):
        s = M[i, 6]
        for j in range(i + 1, 6):
            s = s - M[i, j] * x[j]
        x[i] = s / M[i, i]
    return x


def update(R: np.ndarray, t: np.ndarray, tw: np.ndarray):
    """T <- exp(tw)^-1 o T in float32 (R <- Re^T R, t <- Re^T (t - te))."""
    v, w = tw[:3], tw[3:]
    sq = w * w
    th2 = np.float32(np.float32(sq[0] + sq[1]) + sq[2])
    small = th2 < _SMALL
    safe = np.float32(1.0) if small else th2
    th = np.float32(np.sqrt(safe))
    sn, cs = np.float32(np.sin(np.float64(th))), np.float32(np.cos(np.float64(th)))
    sinc_l = np.float32(sn / th)
    f32 = np.float32
    sinc = f32(1.0) - th2 / f32(6.0) if small else sinc_l
    mcosc = f32(0.5) - th2 / f32(24.0) if small else (f32(1.0) - cs) / safe
    msinc = f32(1.0) / f32(6.0) - th2 / f32(120.0) if small else (f32(1.0) - sinc_l) / safe
    K = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]], np.float32)
    Re = np.zeros((3, 3), np.float32)
    V = np.zeros((3, 3), np.float32)
    for i in range(3):
        for j in range(3):
            kk = f32(sq[i] - th2) if i == j else f32(w[i] * w[j])
            eye = f32(1.0 if i == j else 0.0)
            Re[i, j] = _fma32(mcosc, kk, _fma32(sinc, K[i, j], eye))
            V[i, j] = _fma32(msinc, kk, _fma32(mcosc, K[i, j], eye))

    def dot3(a, x, b, y, c, z):
        return _fma32(c, z, _fma32(a, x, f32(b * y)))

    te = [dot3(V[i, 0], v[0], V[i, 1], v[1], V[i, 2], v[2]) for i in range(3)]
    Rn = np.array([[dot3(Re[0, i], R[0, j], Re[1, i], R[1, j], Re[2, i], R[2, j])
                    for j in range(3)] for i in range(3)], np.float32)
    d = [f32(t[k] - te[k]) for k in range(3)]
    tn = np.array([dot3(Re[0, i], d[0], Re[1, i], d[1], Re[2, i], d[2]) for i in range(3)],
                  np.float32)
    return Rn, tn


def track_level(rows, grid, bs, pose: Pose, points, tcfg: dict, max_iterations: int,
                min_iterations: int, terms=query_terms) -> Level:
    """One level: iterate until converged or ``max_iterations`` steps.
    ``terms(rows, grid, bs, pose, points)`` gives each query's 29 terms
    (``query_terms``, the analytic scheme, by default)."""
    R = pose.R.detach().cpu().numpy().astype(np.float32)
    t = pose.t.detach().cpu().numpy().astype(np.float32)
    lam = np.float32(tcfg["damping"])
    flat = points.reshape(-1, 3)
    dev = points.device
    count, nvalid, sum_abs = 0, 0.0, 0.0
    iu = np.triu_indices(6)
    for _ in range(max_iterations):
        S = sums(terms(rows, grid, bs, Pose(torch.from_numpy(R).to(dev),
                                            torch.from_numpy(t).to(dev)), flat)).cpu().numpy()
        A = np.zeros((6, 6), np.float32)
        A[iu] = S[:21]
        A[iu[1], iu[0]] = S[:21]
        b, nv, sa = S[21:27], S[27], S[28]
        x = solve(A, b, float(lam))
        tw = x.astype(np.float32)
        if not np.isfinite(tw).all():
            tw = np.zeros(6, np.float32)
        done = bool((np.abs(tw) < np.float32(tcfg["max_twist_diff"])).all()
                    and count + 1 >= min_iterations)
        R, t = update(R, t, tw)
        lam = np.float32(lam * np.float32(tcfg["damping_decay"]))
        count += 1
        nvalid, sum_abs = float(nv), float(sa)
        if done:
            break
    return Level(Pose(torch.from_numpy(R).to(dev), torch.from_numpy(t).to(dev)), count,
                 nvalid, sum_abs)


def track(rows, grid: dict, bs, pose0: Pose, points_img: torch.Tensor, tcfg: dict,
          levels, terms=query_terms) -> Level:
    """The finest level's result of the pyramid ``levels`` (ending at 1),
    each level's queries' terms from ``terms`` (as for ``track_level``)."""
    pose = pose0
    res = None
    for mult in levels:
        s = tcfg["pixel_stride"] * mult
        coarse = mult != 1
        res = track_level(rows, grid, bs, pose, points_img[::s, ::s], tcfg,
                          COARSE_ITERATIONS if coarse else tcfg["max_iterations"],
                          0 if coarse else tcfg["min_iterations"], terms)
        pose = res.pose
    return res
