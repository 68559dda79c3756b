"""Rigid motions for the generator and the reference: plain torch, float32
unless the inputs say otherwise.

A pose (R, t) maps camera to world: x_world = R x_cam + t. Twists are
(v1, v2, v3, w1, w2, w3), translation first, and se3_exp is the closed-form
Rodrigues map with a Taylor branch below theta^2 = 1e-8.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_SMALL = 1e-8


class Pose(NamedTuple):
    R: torch.Tensor  # (3, 3)
    t: torch.Tensor  # (3,)

    def to(self, device) -> "Pose":
        return Pose(self.R.to(device), self.t.to(device))


def compose(a: Pose, b: Pose) -> Pose:
    """a o b: apply b first."""
    return Pose(a.R @ b.R, (a.R @ b.t[..., None])[..., 0] + a.t)


def _hat(w: torch.Tensor) -> torch.Tensor:
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([torch.stack([z, -wz, wy], -1), torch.stack([wz, z, -wx], -1),
                        torch.stack([-wy, wx, z], -1)], -2)


def _coeffs(theta_sq: torch.Tensor):
    """(sin th / th, (1 - cos th) / th^2, (th - sin th) / th^3), Taylor near 0."""
    small = theta_sq < _SMALL
    safe = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    th = torch.sqrt(safe)
    sinc = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(th) / th)
    mcosc = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(th)) / safe)
    msinc = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                        (1.0 - torch.sin(th) / th) / safe)
    return sinc, mcosc, msinc


def se3_exp(xi: torch.Tensor) -> Pose:
    v, w = xi[..., :3], xi[..., 3:]
    theta_sq = torch.sum(w * w, dim=-1)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    K = _hat(w)
    KK = w[..., :, None] * w[..., None, :] - theta_sq[..., None, None] * eye
    sinc, mcosc, msinc = _coeffs(theta_sq)
    R = eye + sinc[..., None, None] * K + mcosc[..., None, None] * KK
    V = eye + mcosc[..., None, None] * K + msinc[..., None, None] * KK
    return Pose(R, (V @ v[..., None])[..., 0])


def quaternion_from_matrix(R: np.ndarray) -> np.ndarray:
    """(3, 3) rotation -> quaternion (x, y, z, w) by Shepperd's method (all
    four candidates, the one of the largest squared component kept), the
    conversion TUM trajectory files are written with; float64."""
    m = np.asarray(R, np.float64)
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    sq = [max(1.0 + tr, 0.0), max(1.0 + m[0, 0] - m[1, 1] - m[2, 2], 0.0),
          max(1.0 - m[0, 0] + m[1, 1] - m[2, 2], 0.0), max(1.0 - m[0, 0] - m[1, 1] + m[2, 2], 0.0)]
    abc = [(m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1], 3),
           (m[0, 1] + m[1, 0], m[0, 2] + m[2, 0], m[2, 1] - m[1, 2], 0),
           (m[0, 1] + m[1, 0], m[1, 2] + m[2, 1], m[0, 2] - m[2, 0], 1),
           (m[0, 2] + m[2, 0], m[1, 2] + m[2, 1], m[1, 0] - m[0, 1], 2)]
    i = int(np.argmax(sq))
    s = 2.0 * np.sqrt(sq[i])
    a, b, c, pos = abc[i]
    parts = [a / s, b / s, c / s]
    parts.insert(pos, s / 4.0)
    return np.array(parts)


def quaternion_angle(qa: np.ndarray, qb: np.ndarray) -> float:
    """The rotation angle (rad) between two quaternions, each normalized,
    from their chord (the nearer of q and -q)."""
    qa = np.asarray(qa, np.float64) / np.linalg.norm(qa)
    qb = np.asarray(qb, np.float64) / np.linalg.norm(qb)
    d = min(np.linalg.norm(qa - qb), np.linalg.norm(qa + qb))
    return 4.0 * np.arcsin(min(d / 2.0, 1.0))
