"""Direct Gauss-Newton camera tracking against the TSDF
(counterpart of tracking_sdf_tpu.tracking.gauss_newton, analytic Jacobian).

The twist perturbs the camera-to-world pose on the left in the world frame,
so dphi/dv = g (world-frame SDF gradient) and dphi/dw = a x g with a = R p.
Each iteration's normal equations come from K1 (``gn_reduce``); the 6x6
solve, the damping and the pose update stay in PyTorch. The loop runs on the
host and reads the convergence flag once per iteration.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from tracking_sdf_tpu.config import GridParams, TrackingConfig
from tracking_sdf_tpu_torch.core.lie import Pose, se3_exp
from tracking_sdf_tpu_torch.grid.grid import TSDFGrid, world_to_voxel
from tracking_sdf_tpu_torch.grid.interp import (
    MaskedView, masked_view, trilinear_with_grad_nan)
from tracking_sdf_tpu_torch.tracking.gn_reduce import gn_reduce, unpack


@dataclasses.dataclass
class TrackResult:
    pose: Pose
    iterations: int  # GN iterations executed
    final_twist: torch.Tensor  # (6,) last solved twist step
    num_valid: int  # valid queries in the last iteration
    mean_abs_residual: float  # mean |phi| over valid queries, last iteration


def _sanitize(points_cam: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    valid = torch.isfinite(points_cam).all(dim=-1)
    return torch.where(valid[:, None], points_cam,
                       torch.zeros_like(points_cam)), valid


def pixel_residuals_analytic(
    Dm: MaskedView,  # masked view of the grid, dense or brick-major
    pose: Pose,
    points_cam: torch.Tensor,  # (N, 3), NaN holes allowed
    *,
    params: GridParams,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(phi (N,), J (N, 6), mask (N,)) via trilinear value + analytic gradient."""
    p, valid_in = _sanitize(points_cam)
    x = p @ pose.R.T + pose.t
    uvw = world_to_voxel(params, x)
    in_bounds = ((uvw >= 0) & (uvw < params.m)).all(dim=-1)
    phi, g_uvw, ok = trilinear_with_grad_nan(Dm, uvw)
    scale = torch.tensor([params.m / params.width, params.m / params.height,
                          params.m / params.depth], device=g_uvw.device)
    g_world = g_uvw * scale
    a = x - pose.t
    J = torch.cat([g_world, torch.linalg.cross(a, g_world, dim=-1)], dim=-1)
    return phi, J, valid_in & in_bounds & ok


def normal_equations(phi: torch.Tensor, J: torch.Tensor, mask: torch.Tensor):
    """A = JᵀJ, b = Jᵀphi over valid pixels."""
    Jm = torch.where(mask[:, None], J, torch.zeros_like(J))
    rm = torch.where(mask, phi, torch.zeros_like(phi))
    return Jm.T @ Jm, Jm.T @ rm


def _apply_update(pose: Pose, twist: torch.Tensor, mode: str) -> Pose:
    e = se3_exp(twist)
    Ret = e.R.T
    if mode == "se3":
        # exact left-inverse composition: T <- exp(twist)^-1 ∘ T
        return Pose(Ret @ pose.R, Ret @ (pose.t - e.t))
    if mode == "reference":
        # the reference's quirk: t is not rotated
        return Pose(Ret @ pose.R, pose.t - Ret @ e.t)
    raise ValueError(f"unknown pose_update: {mode}")


def _converged(twist: torch.Tensor, cfg: TrackingConfig) -> torch.Tensor:
    if cfg.convergence == "norm":
        return twist.abs().max() < cfg.max_twist_diff
    if cfg.convergence == "signed":
        # the reference's quirk: a signed comparison
        return (twist < cfg.max_twist_diff).all()
    raise ValueError(f"unknown convergence mode: {cfg.convergence}")


def track_frame(
    grid: Optional[TSDFGrid],
    pose0: Pose,
    points_cam: torch.Tensor,  # (N, 3) strided camera-frame points
    *,
    params: GridParams,
    cfg: TrackingConfig = TrackingConfig(),
    Dm: Optional[MaskedView] = None,  # precomputed masked view
) -> TrackResult:
    """Estimate the camera pose for one frame by damped GN on sum phi^2.
    ``grid`` may be None when ``Dm`` is given (the brick-major loop never
    builds the dense grid)."""
    if cfg.jacobian != "analytic":
        raise NotImplementedError(f"jacobian={cfg.jacobian!r}: only 'analytic' is ported")
    if Dm is None:
        Dm = masked_view(grid.D, grid.W)
    points_cam = points_cam.contiguous()
    eye = torch.eye(6, device=Dm.device)
    pose, lam, i, done = pose0, cfg.damping, 0, False
    twist = torch.zeros(6, device=Dm.device)
    out = None
    while i < cfg.max_iterations and not done:
        out = gn_reduce(Dm, pose, points_cam, params)
        A, b, _, _ = unpack(out)
        # Marquardt damping plus a tiny floor that keeps a degenerate system
        # solvable; a non-finite solve (singular system) takes no step
        A = A + lam * torch.diag(torch.diag(A)) + 1e-12 * eye
        twist = torch.linalg.solve_ex(A, b)[0]
        twist = torch.where(torch.isfinite(twist).all(), twist,
                            torch.zeros_like(twist))
        done = bool(_converged(twist, cfg)) and i + 1 >= cfg.min_iterations
        # the reference updates the pose on the converging iteration too
        pose = _apply_update(pose, twist, cfg.pose_update)
        lam *= cfg.damping_decay
        i += 1
    nvalid, mean_res = 0, 0.0
    if out is not None:
        nv, sum_abs = out[27:29].tolist()
        nvalid = int(nv)
        mean_res = sum_abs / max(nvalid, 1)
    return TrackResult(pose=pose, iterations=i, final_twist=twist,
                       num_valid=nvalid, mean_abs_residual=mean_res)
