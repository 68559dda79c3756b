"""K1: one Gauss-Newton iteration's normal equations (A = JᵀJ, b = Jᵀr).

Counterpart of tracking_sdf_tpu/tracking/pallas_gn.py. The CUDA kernel
(``csrc/gn_reduce.cu``) replaces the Pallas ``_gn_kernel`` together with its
XLA front half ``gather_corner_inputs``: each GPU thread gathers its own
corners from the masked view. Two forms: the dense float32 (m, m, m) view
(the flat bricked loop) and the brick-major ``BrickMaskedView`` of float32 or
bfloat16 D rows (the presets' main path). The source note there says what
bounds it on the card and what the design does about it.

Both versions return 29 float32 values (``unpack`` turns them back into
A (6, 6), b (6,), the valid count and Σ|r| over valid queries).
"""
from __future__ import annotations

import torch

from tracking_sdf_tpu.config import GridParams
from tracking_sdf_tpu_torch.core.lie import Pose
from tracking_sdf_tpu_torch.grid.interp import BrickMaskedView, MaskedView
from tracking_sdf_tpu_torch.kernels import _build

THREADS = 256  # queries per block; must match kThreads in gn_reduce.cu
N_OUT = 29

# kernel launches made by gn_reduce on CUDA tensors, per form of the view
launches = 0  # dense (m, m, m)
launches_brick = 0  # brick-major rows


def _triu(device):
    return torch.triu_indices(6, 6, device=device)


def unpack(out: torch.Tensor):
    """29 values -> (A (6, 6), b (6,), num_valid, sum_abs_residual)."""
    iu = _triu(out.device)
    A = torch.zeros(6, 6, dtype=out.dtype, device=out.device)
    A[iu[0], iu[1]] = out[:21]
    A[iu[1], iu[0]] = out[:21]
    return A, out[21:27], out[27], out[28]


def gn_reduce_reference(Dm: MaskedView, pose: Pose, points: torch.Tensor,
                        params: GridParams) -> torch.Tensor:
    """Plain PyTorch version: pixel_residuals_analytic + normal_equations."""
    # gauss_newton imports this module
    from tracking_sdf_tpu_torch.tracking.gauss_newton import (
        normal_equations, pixel_residuals_analytic)

    phi, J, mask = pixel_residuals_analytic(Dm, pose, points, params=params)
    A, b = normal_equations(phi, J, mask)
    iu = _triu(A.device)
    nvalid = mask.sum().to(torch.float32)
    sum_abs = torch.where(mask, phi.abs(), torch.zeros_like(phi)).sum()
    return torch.cat([A[iu[0], iu[1]], b, nvalid[None], sum_abs[None]])


def gn_reduce(Dm: MaskedView, pose: Pose, points: torch.Tensor,
              params: GridParams) -> torch.Tensor:
    """Normal equations of the queries ``points`` (N, 3) (camera frame, NaN
    holes allowed) at ``pose`` against the masked view ``Dm``: a dense
    float32 (m, m, m) tensor or a BrickMaskedView of float32/bfloat16 rows.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    global launches, launches_brick
    if Dm.device.type == "cpu":
        return gn_reduce_reference(Dm, pose, points, params)
    if Dm.device.type != "cuda":
        raise ValueError(f"gn_reduce: unsupported device {Dm.device}")
    m = params.m
    brick = isinstance(Dm, BrickMaskedView)
    if brick:
        data, (bi, bj, bk), pitch = Dm.rows, Dm.bs, Dm.pitch
        if (Dm.m != m or m % bi or m % bj or m % bk or pitch < bi * bj * bk
                or data.numel() != (m // bi) * (m // bj) * (m // bk) * pitch):
            raise ValueError(f"gn_reduce: view rows {tuple(data.shape)} do not "
                             f"hold an m={m} grid of {Dm.bs} bricks at pitch {pitch}")
        dtypes = (torch.float32, torch.bfloat16)
    else:
        data, (bi, bj, bk), pitch = Dm, (0, 0, 0), 0
        if tuple(Dm.shape) != (m, m, m):
            raise ValueError(f"gn_reduce: Dm shape {tuple(Dm.shape)} != {(m, m, m)}")
        dtypes = (torch.float32,)
    if data.dtype not in dtypes or not data.is_contiguous():
        raise ValueError(f"gn_reduce: the view must be contiguous {dtypes}, "
                         f"got {data.dtype}")
    for name, x, shape in (("points", points, None),
                           ("pose.R", pose.R, (3, 3)), ("pose.t", pose.t, (3,))):
        if x.device != data.device or x.dtype != torch.float32:
            raise ValueError(f"gn_reduce: {name} must be float32 on {data.device}")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"gn_reduce: {name} shape {tuple(x.shape)} != {shape}")
    if points.dim() != 2 or points.shape[1] != 3:
        raise ValueError(f"gn_reduce: points shape {tuple(points.shape)} != (N, 3)")
    if not points.is_contiguous():
        raise ValueError("gn_reduce: points must be contiguous")

    n = points.shape[0]
    blocks = max(-(-n // THREADS), 1)
    pose_buf = torch.cat([pose.R.reshape(9), pose.t])
    partials = torch.empty(blocks * N_OUT, dtype=torch.float32, device=data.device)
    out = torch.empty(N_OUT, dtype=torch.float32, device=data.device)
    lib = _build.library()
    rc = lib.tsdf_gn_reduce(
        data.data_ptr(), int(data.dtype == torch.bfloat16), m, bi, bj, bk, pitch,
        pose_buf.data_ptr(), points.data_ptr(), n,
        *params.origin, m / params.width, m / params.height, m / params.depth,
        partials.data_ptr(), blocks, out.data_ptr(), _build.stream_ptr(data.device))
    _build.check(rc, "gn_reduce")
    if brick:
        launches_brick += 1
    else:
        launches += 1
    return out
