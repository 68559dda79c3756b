"""Plain central-difference tracking: the 13-probe Shepard-L1 scheme of the
reference node's tracker (Bylow et al., RSS 2013; mees/tracking_sdf
``CameraTracking::get_partial_derivative`` over ``SDF::interpolate_distance``),
against the brick-major leaves D and W as stored.

A query's camera point p (NaN holes give an invalid query) goes to
x = R p + t and to voxel coordinates uvw = (x - origin) * m / extent - 0.5.
Its 13 probes, in this order: uvw; uvw + v_h e_i, then uvw - v_h e_i, for
each grid axis i; the voxel coordinates of x + (w_h e_i) x (x - t), then of
x - (w_h e_i) x (x - t), for each axis i. Each probe is a Shepard-L1 blend
over the 8 corners of trunc(uvw) (toward zero, a C cast): corners out of
the grid or with W <= 0 are skipped, a kept corner weighs 1 / (its L1
distance), one closer than 1e-5 returns its D exactly, and a probe with no
kept corner is invalid. J_c = (v+ - v-) / h_c, with h_c = 2 v_h extent_c / m
metres for the translations and 2 w_h for the rotations, both Python
floats (a tensor divided by a Python float, as the port's plain tracker
divides; on the card that is a product with the reciprocal). A query is
valid when its point is finite, uvw lies in [0, m)^3 and all 13 probes
interpolate; its terms are ``track.terms_of``'s, as the analytic scheme's.

The terms are added by ``track.sums``, K1's launch order: a central kernel
of the port is to reduce through K1's reduce half and end in ``gn_finish``,
so its sums take that order. The solve, the convergence test, the update
and the pyramid are ``track``'s own (``track.track`` with this module's
terms).
"""
from __future__ import annotations

import torch

from reference import track as rt
from reference.lie import Pose

EXACT = 1e-5  # an L1 distance under which a kept corner is returned exactly


def shepard(D: torch.Tensor, W: torch.Tensor, m: int, bs, coords: torch.Tensor):
    """(value, valid) of the Shepard-L1 blend at continuous voxel
    coordinates ``coords`` (..., 3) against (NB, BV) brick-major leaves;
    value 0 where not valid."""
    base = torch.trunc(coords).to(torch.int64)
    F, inb = rt.corner_index(m, bs, base)
    off = torch.tensor(rt.OFFSETS, dtype=torch.int64, device=coords.device)
    kept = inb & (W.reshape(-1)[F] > 0)
    d = torch.where(kept, D.reshape(-1)[F].to(torch.float32), 0.0)  # a select: D is NaN at W <= 0
    l1 = torch.sum(torch.abs((base[..., None, :] + off).to(torch.float32)
                             - coords[..., None, :]), dim=-1)
    exact = kept & (l1 < EXACT)
    w = torch.where(kept & (l1 >= EXACT), 1.0 / torch.where(l1 < EXACT, 1.0, l1), 0.0)
    w_sum = torch.sum(w, dim=-1)
    blend = torch.sum(w * d, dim=-1) / torch.where(w_sum > 0, w_sum, 1.0)
    value = torch.where(exact.any(dim=-1), torch.sum(torch.where(exact, d, 0.0), dim=-1), blend)
    valid = kept.any(dim=-1)
    return torch.where(valid, value, 0.0), valid


def residuals(leaves, grid: dict, bs, pose: Pose, points: torch.Tensor, v_h: float,
              w_h: float):
    """(phi (N,), J (N, 6), valid (N,)) of each of the (N, 3) camera-frame
    points at ``pose`` by the 13-probe scheme; ``leaves`` is (D, W)."""
    D, W = leaves
    m = grid["m"]
    extent = (grid["width"], grid["height"], grid["depth"])
    dev = points.device
    valid_in = torch.isfinite(points).all(dim=-1)
    p = torch.where(valid_in[:, None], points, torch.zeros_like(points))
    x = p @ pose.R.T + pose.t
    origin = torch.tensor(grid["origin"], dtype=torch.float32, device=dev)
    scale = torch.tensor([m / e for e in extent], dtype=torch.float32, device=dev)

    def voxel(y):
        return (y - origin) * scale - 0.5

    uvw = voxel(x)
    in_bounds = ((uvw >= 0) & (uvw < m)).all(dim=-1)
    a = x - pose.t
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    probes = [uvw]
    for i in range(3):
        probes += [uvw + eye[i] * v_h, uvw - eye[i] * v_h]
    for i in range(3):
        turn = torch.linalg.cross((eye[i] * w_h).expand_as(a), a, dim=-1)
        probes += [voxel(x + turn), voxel(x - turn)]
    vals, ok = shepard(D, W, m, bs, torch.stack(probes))
    h = [2.0 * v_h * e / m for e in extent] + [2.0 * w_h] * 3
    J = torch.stack([(vals[1 + 2 * c] - vals[2 + 2 * c]) / h[c] for c in range(6)], dim=-1)
    return vals[0], J, valid_in & in_bounds & ok.all(dim=0)


def track(D: torch.Tensor, W: torch.Tensor, grid: dict, bs, pose0: Pose,
          points_img: torch.Tensor, tcfg: dict, levels) -> rt.Level:
    """``track.track`` with the central scheme's terms (v_h, w_h from ``tcfg``)."""
    v_h, w_h = tcfg["v_h"], tcfg["w_h"]

    def terms(leaves, grid, bs, pose, points):
        return rt.terms_of(*residuals(leaves, grid, bs, pose, points, v_h, w_h))

    return rt.track((D, W), grid, bs, pose0, points_img, tcfg, levels, terms)
