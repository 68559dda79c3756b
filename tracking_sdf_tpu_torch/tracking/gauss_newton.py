"""Direct Gauss-Newton camera tracking against the TSDF
(counterpart of tracking_sdf_tpu.tracking.gauss_newton).

The twist perturbs the camera-to-world pose on the left in the world frame,
so dphi/dv = g (world-frame SDF gradient) and dphi/dw = a x g with a = R p.
Two Jacobian schemes (``TrackingConfig.jacobian``):
  * "analytic": trilinear value and exact gradient. Each iteration is one
    ``gn_step`` on a state buffer on the view's device (tracking.gn_reduce):
    on the card one kernel launch forms the normal equations, solves the
    damped 6x6 system, tests convergence and updates the pose.
  * "central": the reference's 13 Shepard-L1 probes per pixel. Against
    the brick-major rows (``BrickRows``, the tum256central preset's path)
    each iteration is one ``gn_reduce.central_stepper`` step: on the card
    one launch of K1's central form, which probes the bf16 D and W rows,
    sums its queries' terms in K1's launch order and finishes the step as
    ``gn_step`` does; on the CPU its plain version
    (``gn_reduce.central_step_reference``). Against a dense grid (the dense
    and flat bricked layouts) the normal equations are PyTorch ops (the JAX
    package has no kernel for them either): on the card they are packed
    into K1's 29 sums on the device and ``gn_finish`` solves, tests and
    updates the state in one launch an iteration; on the CPU
    ``gn_reduce.advance_state``, its plain version, does. Neither builds a
    dense grid from brick rows.
A done flag freezes the state once converged, as the JAX package's
``lax.while_loop`` stops. A level issues ``cfg.max_iterations`` steps and
reads nothing back; on the CPU the loop stops at the done flag.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple, Union

import torch

from tracking_sdf_tpu_torch.config import GridParams, TrackingConfig
from tracking_sdf_tpu_torch.core.lie import Pose
from tracking_sdf_tpu_torch.grid.grid import TSDFGrid, world_to_voxel
from tracking_sdf_tpu_torch.grid.interp import (
    BrickRows, MaskedView, masked_view, shepard_l1, trilinear_with_grad_nan)
from tracking_sdf_tpu_torch.tracking.gn_reduce import (
    S_COUNT, S_DONE, S_NVALID, S_SUMABS, S_TWIST, central_stepper, finisher,
    gn_stepper, init_state, pack, state_pose)


class TrackStats(NamedTuple):
    """A level's result read back to the host."""
    pose: Pose  # on the CPU
    iterations: int  # GN iterations executed
    final_twist: torch.Tensor  # (6,) last solved twist step, on the CPU
    num_valid: int  # valid queries in the last iteration
    mean_abs_residual: float  # mean |phi| over valid queries, last iteration


class DeviceTrackStats(NamedTuple):
    """A level's stats as 0-dim tensors on the state's device: what the
    failure gate needs, with no host read."""
    pose: Pose  # views of the state buffer
    iterations: torch.Tensor  # int32
    num_valid: torch.Tensor  # float32, an exact count
    mean_abs_residual: torch.Tensor  # float32


def _mean_abs_residual(state: torch.Tensor) -> torch.Tensor:
    """Σ|r| / max(num_valid, 1) in float32, as the JAX package computes it
    on the device (tracking_sdf_tpu/tracking/gauss_newton.py)."""
    return state[S_SUMABS] / state[S_NVALID].clamp(min=1.0)


@dataclasses.dataclass(frozen=True)
class TrackResult:
    """One level's Gauss-Newton result, held in its state buffer on the
    view's device. ``pose`` and ``device_stats()`` are views or device ops
    and read nothing; ``read()`` copies the buffer to the host once, and
    each of the other properties reads it again (one wait on the device
    each)."""
    state: torch.Tensor

    @property
    def pose(self) -> Pose:
        return state_pose(self.state)

    def device_stats(self) -> DeviceTrackStats:
        return DeviceTrackStats(pose=self.pose,
                                iterations=self.state.view(torch.int32)[S_COUNT],
                                num_valid=self.state[S_NVALID],
                                mean_abs_residual=_mean_abs_residual(self.state))

    def read(self) -> TrackStats:
        h = self.state.detach().cpu()
        ints = h.view(torch.int32)
        return TrackStats(pose=state_pose(h), iterations=int(ints[S_COUNT]),
                          final_twist=h[S_TWIST:S_TWIST + 6],
                          num_valid=int(h[S_NVALID]),
                          mean_abs_residual=float(_mean_abs_residual(h)))

    @property
    def iterations(self) -> int:
        return self.read().iterations

    @property
    def num_valid(self) -> int:
        return self.read().num_valid

    @property
    def mean_abs_residual(self) -> float:
        return self.read().mean_abs_residual


def strided_points(points_img: torch.Tensor, stride: int) -> torch.Tensor:
    """Flatten an organized (H, W, 3) point image to the reference's strided
    pixel lattice u, v in {0, stride, 2*stride, ...}: (N, 3) with the NaN
    holes kept (masked downstream)."""
    return points_img[::stride, ::stride, :].reshape(-1, 3)


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
    i0: int = 0,
    slab: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(phi (N,), J (N, 6), mask (N,)) via trilinear value + analytic gradient.
    Slab form (``slab`` given): ``Dm`` holds global planes [i0, i0 + mi),
    and the mask also requires the query's base plane floor(u) to lie in
    [i0, i0 + slab) (the JAX package's ``_owned_residuals``)."""
    p, valid_in = _sanitize(points_cam)
    x = p @ pose.R.T + pose.t
    uvw = world_to_voxel(params, x)
    in_bounds = ((uvw >= 0) & (uvw < params.m)).all(dim=-1)
    if slab is not None:
        base_i = torch.floor(uvw[..., 0])
        in_bounds = in_bounds & (base_i >= i0) & (base_i < i0 + slab)
        uvw = uvw - torch.tensor([float(i0), 0.0, 0.0], device=uvw.device)
    phi, g_uvw, ok = trilinear_with_grad_nan(Dm, uvw)
    scale = torch.tensor([params.m / params.width, params.m / params.height,
                          params.m / params.depth], device=g_uvw.device)
    g_world = g_uvw * scale
    a = x - pose.t
    J = torch.cat([g_world, torch.linalg.cross(a, g_world, dim=-1)], dim=-1)
    return phi, J, valid_in & in_bounds & ok


def central_spans(params: GridParams, v_h: float, w_h: float) -> Tuple[float, ...]:
    """The six probe spans h_c of the central Jacobian's columns, Python
    floats: translation over 2·v_h voxel sizes (meters), rotation over
    2·w_h (radians)."""
    return tuple(2.0 * v_h * e / params.m for e in params.extent) + (2.0 * w_h,) * 3


def pixel_residuals_central(
    grid: Union[TSDFGrid, BrickRows],
    pose: Pose,
    points_cam: torch.Tensor,  # (N, 3), NaN holes allowed
    *,
    params: GridParams,
    v_h: float = 1.0,
    w_h: float = 0.01,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's residuals (phi (N,), J (N, 6), mask (N,)): 13
    Shepard-L1 probes per pixel, the value, three ±v_h voxel translation
    probes and three ±w_h rotation probes. A pixel counts only if every
    probe interpolates (the reference's early-outs drop it)."""
    p, valid_in = _sanitize(points_cam)
    x = p @ pose.R.T + pose.t
    uvw = world_to_voxel(params, x)
    in_bounds = ((uvw >= 0) & (uvw < params.m)).all(dim=-1)
    # the 13 probes in one interpolation, (13, N, 3): the value; ±v_h voxels
    # along each grid axis; x ± (w_h e_i) × (x - t), i.e. (I ± w_h hat(e_i))
    # R p + t, for each axis
    eye = torch.eye(3, dtype=uvw.dtype, device=uvw.device)
    step = (eye * v_h)[:, None, :]
    delta = torch.linalg.cross((eye * w_h)[:, None, :], (x - pose.t)[None], dim=-1)
    probes = torch.cat([uvw[None], torch.stack([uvw + step, uvw - step], 1).flatten(0, 1),
                        world_to_voxel(params, torch.stack([x + delta, x - delta], 1)
                                       .flatten(0, 1))])
    vals, ok = shepard_l1(grid.D, grid.W, probes)
    vp, vm = vals[1::2], vals[2::2]  # (6, N): the + and - probe of each column
    denom = central_spans(params, v_h, w_h)
    J = torch.stack([(vp[c] - vm[c]) / denom[c] for c in range(6)], dim=-1)
    return vals[0], J, valid_in & in_bounds & ok.all(dim=0)


def normal_equations(phi: torch.Tensor, J: torch.Tensor, mask: torch.Tensor):
    """A = JᵀJ, b = Jᵀphi over valid pixels."""
    Jm = torch.where(mask[:, None], J, torch.zeros_like(J))
    rm = torch.where(mask, phi, torch.zeros_like(phi))
    return Jm.T @ Jm, Jm.T @ rm


def central_sums(grid: Union[TSDFGrid, BrickRows], pose: Pose, points: torch.Tensor,
                 params: GridParams, cfg: TrackingConfig):
    """(A, b, valid count, Σ|r| over valid pixels) of the central scheme."""
    phi, J, mask = pixel_residuals_central(grid, pose, points, params=params,
                                           v_h=cfg.v_h, w_h=cfg.w_h)
    A, b = normal_equations(phi, J, mask)
    return (A, b, mask.sum().to(torch.float32),
            torch.where(mask, phi.abs(), torch.zeros_like(phi)).sum())


def track_frame(
    grid: Optional[TSDFGrid],
    pose0: Pose,
    points_cam: torch.Tensor,  # (N, 3) or (h, w, 3) strided camera-frame points
    *,
    params: GridParams,
    cfg: TrackingConfig = TrackingConfig(),
    Dm: Optional[MaskedView] = None,  # precomputed masked view
) -> TrackResult:
    """Estimate the camera pose for one frame by damped GN on sum phi^2.
    With the analytic Jacobian ``grid`` may be None when ``Dm`` is given (the
    brick-major loop never builds the dense grid); the central scheme reads
    ``grid``'s D and W: a dense grid, or the brick-major rows as
    ``BrickRows`` (K1's central form). On the card this issues
    ``cfg.max_iterations`` steps and waits on nothing."""
    state = init_state(pose0, cfg.damping)
    if cfg.jacobian == "analytic":
        if Dm is None:
            Dm = masked_view(grid.D, grid.W)
        step = gn_stepper(Dm, state, points_cam, params, cfg)
        device = Dm.device
    elif cfg.jacobian == "central":
        if grid is None:
            raise ValueError("jacobian='central' reads D and W; grid is None")
        device = grid.D.device
        if isinstance(grid, BrickRows):
            step = central_stepper(grid, state, points_cam, params, cfg)
        else:
            flat = points_cam.reshape(-1, 3)
            # the normal equations packed on their device, then the finish: one
            # gn_finish launch on the card, advance_state on the CPU; only A's
            # upper triangle travels (see gn_reduce.pack)
            finish = finisher(state, cfg)

            def step():
                finish(pack(*central_sums(grid, state_pose(state), flat, params, cfg)))
    else:
        raise ValueError(f"unknown jacobian mode: {cfg.jacobian}")
    ints = state.view(torch.int32)
    on_cpu = device.type == "cpu"
    for _ in range(cfg.max_iterations):
        step()
        if on_cpu and bool(ints[S_DONE]):  # reading the flag is free here
            break
    return TrackResult(state)
