"""SO(3)/SE(3) utilities on torch tensors (counterpart of tracking_sdf_tpu.core.lie).

Twist layout is ``(v1, v2, v3, w1, w2, w3)``, translation first. A camera
pose is ``Pose(R, t)`` mapping CAMERA -> WORLD (x_world = R @ x_cam + t).
The small-angle guards are branchless ``torch.where`` selections with safe
denominators, as in the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

_SMALL = 1e-8


@dataclasses.dataclass(frozen=True)
class Pose:
    """Camera-to-world rigid transform. R: (..., 3, 3), t: (..., 3)."""

    R: torch.Tensor
    t: torch.Tensor

    def to(self, device) -> "Pose":
        return Pose(self.R.to(device), self.t.to(device))


def pose_from_numpy(R, t, *, device) -> Pose:
    """Pose from array-likes (e.g. ``np.asarray`` of the JAX package's Pose)."""
    return Pose(torch.tensor(np.asarray(R, np.float32), device=device),
                torch.tensor(np.asarray(t, np.float32), device=device))


def pose_to_numpy(p: Pose):
    """(R, t) as float32 numpy arrays."""
    return p.R.detach().cpu().numpy(), p.t.detach().cpu().numpy()


def pose_identity(dtype=torch.float32, *, device) -> Pose:
    return Pose(torch.eye(3, dtype=dtype, device=device),
                torch.zeros(3, dtype=dtype, device=device))


def pose_inverse(p: Pose) -> Pose:
    Rt = p.R.transpose(-1, -2)
    return Pose(Rt, -(Rt @ p.t[..., None])[..., 0])


def pose_compose(a: Pose, b: Pose) -> Pose:
    """Returns a ∘ b (apply b first, then a)."""
    return Pose(a.R @ b.R, (a.R @ b.t[..., None])[..., 0] + a.t)


def pose_apply(p: Pose, x: torch.Tensor) -> torch.Tensor:
    """Apply a pose to points of shape (..., 3)."""
    return torch.einsum("...ij,...j->...i", p.R, x) + p.t


def so3_hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix: hat(w) @ x == cross(w, x)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([zero, -wz, wy], dim=-1),
        torch.stack([wz, zero, -wx], dim=-1),
        torch.stack([-wy, wx, zero], dim=-1),
    ], dim=-2)


def _theta_coeffs(theta_sq: torch.Tensor):
    """Branchless (sin/th, (1-cos)/th^2, (th-sin)/th^3), Taylor near zero."""
    small = theta_sq < _SMALL
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(safe_sq)
    sinc = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    mcosc = torch.where(small, 0.5 - theta_sq / 24.0,
                        (1.0 - torch.cos(theta)) / safe_sq)
    msinc = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                        (1.0 - torch.sin(theta) / theta) / safe_sq)
    return sinc, mcosc, msinc


def _hat_and_square(w: torch.Tensor):
    theta_sq = torch.sum(w * w, dim=-1)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    # K @ K == w w^T - theta^2 I
    KK = w[..., :, None] * w[..., None, :] - theta_sq[..., None, None] * eye
    return theta_sq, so3_hat(w), KK, eye


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: exp(hat(w))."""
    theta_sq, K, KK, eye = _hat_and_square(w)
    sinc, mcosc, _ = _theta_coeffs(theta_sq)
    return eye + sinc[..., None, None] * K + mcosc[..., None, None] * KK


def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """V(w) = I + mcosc*K + msinc*K^2; t = V(w) v in se3_exp."""
    theta_sq, K, KK, eye = _hat_and_square(w)
    _, mcosc, msinc = _theta_coeffs(theta_sq)
    return eye + mcosc[..., None, None] * K + msinc[..., None, None] * KK


def se3_exp(xi: torch.Tensor, dt: float = 1.0) -> Pose:
    """exp of twist (v, w) * dt -> Pose(R, t)."""
    xi = xi * dt
    v, w = xi[..., :3], xi[..., 3:]
    return Pose(so3_exp(w), (so3_left_jacobian(w) @ v[..., None])[..., 0])


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Inverse of so3_exp, valid for theta in [0, pi): theta / (2 sin theta)
    times the vee of the antisymmetric part (series 1/2 + theta^2/12 near 0)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0))
    vee = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                       R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    theta_sq = theta * theta
    small = theta_sq < _SMALL
    safe = torch.where(small, torch.ones_like(theta), theta)
    scale = torch.where(small, 0.5 + theta_sq / 12.0, safe / (2.0 * torch.sin(safe)))
    return scale[..., None] * vee


def se3_log(p: Pose) -> torch.Tensor:
    """Inverse of se3_exp: Pose -> twist (v, w), v = V(w)^-1 t with
    V^-1 = I - K/2 + coeff K^2, coeff = (1 - sinc / (2 mcosc)) / theta^2."""
    w = so3_log(p.R)
    theta_sq, K, KK, eye = _hat_and_square(w)
    sinc, mcosc, _ = _theta_coeffs(theta_sq)
    small = theta_sq < _SMALL
    safe_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    coeff = torch.where(small, 1.0 / 12.0 + theta_sq / 720.0,
                        (1.0 - sinc / (2.0 * mcosc)) / safe_sq)
    V_inv = eye - 0.5 * K + coeff[..., None, None] * KK
    return torch.cat([(V_inv @ p.t[..., None])[..., 0], w], dim=-1)


def quaternion_from_matrix(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion (x, y, z, w), TUM trajectory order.

    Shepperd's method: all four candidates are built and the numerically
    best one (largest squared component, always >= 1/4 of the sum) kept."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw_sq = torch.clamp(1.0 + tr, min=0.0)
    qx_sq = torch.clamp(1.0 + m00 - m11 - m22, min=0.0)
    qy_sq = torch.clamp(1.0 - m00 + m11 - m22, min=0.0)
    qz_sq = torch.clamp(1.0 - m00 - m11 + m22, min=0.0)

    def cand(sq, a, b, c, pos):
        s = 2.0 * torch.sqrt(sq)
        safe = torch.where(s > 0, s, torch.ones_like(s))
        parts = [a / safe, b / safe, c / safe]
        parts.insert(pos, s / 4.0)
        return torch.stack(parts, -1)

    cands = torch.stack([
        cand(qw_sq, m21 - m12, m02 - m20, m10 - m01, 3),
        cand(qx_sq, m01 + m10, m02 + m20, m21 - m12, 0),
        cand(qy_sq, m01 + m10, m12 + m21, m02 - m20, 1),
        cand(qz_sq, m02 + m20, m12 + m21, m10 - m01, 2),
    ], dim=-2)  # (..., 4, 4)
    idx = torch.argmax(torch.stack([qw_sq, qx_sq, qy_sq, qz_sq], -1), dim=-1)
    idx = idx[..., None, None].expand(*idx.shape, 1, 4)
    return torch.gather(cands, -2, idx)[..., 0, :]


def matrix_from_quaternion(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (x, y, z, w) -> rotation matrix."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = torch.where(n > 0, 2.0 / torch.where(n > 0, n, torch.ones_like(n)),
                    torch.zeros_like(n))
    xx, yy, zz = x * x * s, y * y * s, z * z * s
    xy, xz, yz = x * y * s, x * z * s, y * z * s
    wx, wy, wz = w * x * s, w * y * s, w * z * s
    return torch.stack([
        torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], -1),
        torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], -1),
        torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], -1),
    ], dim=-2)
