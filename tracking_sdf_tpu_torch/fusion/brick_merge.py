"""K2: fold one frame's FREE/FULL brick updates into the dense grid in place.

Counterpart of tracking_sdf_tpu/fusion/pallas_merge.py. The CUDA kernel
(``csrc/brick_merge.cu``) replaces the Pallas ``_merge_kernel_geo`` /
``_merge_kernel_color``: one thread block per active brick, one thread per
voxel; the source note there says what bounds it on the card. Unlike the
Pallas kernel, both versions apply ``max_weight`` (divide by the uncapped
weight sum, store the clamped one), as the XLA tail of
``tracking_sdf_tpu.fusion.brick.fuse_frame_bricked`` does.

Inputs: ``upd`` (cap + 1, BI, BJ, BK, C) float32 with C = 2 (w, w·d) or
6 (+ wc, wc·r, wc·g, wc·b) and a zero last row; ``bid``/``cls``/``slot``
(n,) int32 — brick id, class (1 FREE, 2 FULL) and update row.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from tracking_sdf_tpu_torch.grid.grid import TSDFGrid
from tracking_sdf_tpu_torch.kernels import _build

FREE, FULL = 1, 2

launches = 0  # kernel launches made by brick_merge on CUDA tensors


def _voxel_index(bid: torch.Tensor, m: int, bs: Tuple[int, int, int]) -> torch.Tensor:
    """Flat (i, j, k) voxel offsets of each brick's voxels: (n, BI*BJ*BK)."""
    bi, bj, bk = bs
    nbj, nbk = m // bj, m // bk
    b = bid.to(torch.int64)
    ib, jb, kb = b // (nbj * nbk), (b // nbk) % nbj, b % nbk
    dev = bid.device
    di = torch.arange(bi, device=dev).view(bi, 1, 1)
    dj = torch.arange(bj, device=dev).view(1, bj, 1)
    dk = torch.arange(bk, device=dev).view(1, 1, bk)
    intra = ((di * m + dj) * m + dk).reshape(-1)
    base = ((ib * bi) * m + jb * bj) * m + kb * bk
    return base[:, None] + intra[None, :]


def brick_merge_reference(grid: TSDFGrid, upd: torch.Tensor, bid: torch.Tensor,
                          cls: torch.Tensor, slot: torch.Tensor, *,
                          bs: Tuple[int, int, int], delta: float,
                          max_weight: Optional[float]) -> None:
    """Plain PyTorch version; updates ``grid`` in place."""
    m = grid.D.shape[1]
    idx = _voxel_index(bid, m, bs)
    C = upd.shape[-1]
    u = upd.reshape(upd.shape[0], -1, C)[slot.to(torch.int64)]  # (n, BV, C)
    full = (cls == FULL)[:, None]
    free = (cls == FREE)[:, None]
    zero = torch.zeros((), device=upd.device)
    w_add = torch.where(full, u[..., 0], torch.where(free, zero + 1.0, zero))
    wd_add = torch.where(full, u[..., 1], torch.where(free, zero + delta, zero))
    mw = float("inf") if max_weight is None else max_weight

    def leaf(name):
        return getattr(grid, name).view(-1)

    W, D = leaf("W")[idx], leaf("D")[idx]
    W_sum = W + w_add
    has = w_add > 0
    leaf("D")[idx] = torch.where(has, (W * D + wd_add) / torch.where(has, W_sum, zero + 1.0), D)
    leaf("W")[idx] = torch.clamp(W_sum, max=mw)
    if C == 6:
        wc_add = torch.where(full, u[..., 2], zero)
        Wc = leaf("Wc")[idx]
        Wc_sum = Wc + wc_add
        has_c = wc_add > 0
        safe = torch.where(has_c, Wc_sum, zero + 1.0)
        for name, c in (("R", 3), ("G", 4), ("B", 5)):
            old = leaf(name)[idx]
            leaf(name)[idx] = torch.where(has_c, (Wc * old + u[..., c]) / safe, old)
        leaf("Wc")[idx] = torch.clamp(Wc_sum, max=mw)


def brick_merge(grid: TSDFGrid, upd: torch.Tensor, bid: torch.Tensor,
                cls: torch.Tensor, slot: torch.Tensor, *,
                bs: Tuple[int, int, int], delta: float,
                max_weight: Optional[float]) -> None:
    """Apply the brick updates to ``grid`` in place.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    global launches
    D = grid.D
    if D.device.type == "cpu":
        return brick_merge_reference(grid, upd, bid, cls, slot, bs=bs,
                                     delta=delta, max_weight=max_weight)
    if D.device.type != "cuda":
        raise ValueError(f"brick_merge: unsupported device {D.device}")
    bi, bj, bk = bs
    m = D.shape[1]
    C = upd.shape[-1]
    leaves = [grid.D, grid.W, grid.R, grid.G, grid.B, grid.Wc]
    if any(x.device != D.device or x.dtype != torch.float32
           or x.shape != D.shape or not x.is_contiguous() for x in leaves):
        raise ValueError("brick_merge: grid leaves must be contiguous float32 "
                         "(m, m, m) on one device")
    if D.shape != (m, m, m) or m % bi or m % bj or m % bk or bi * bj * bk > 1024:
        raise ValueError(f"brick_merge: grid {tuple(D.shape)} vs brick {bs}")
    if (C not in (2, 6) or upd.dim() != 5 or tuple(upd.shape[1:4]) != tuple(bs)
            or upd.dtype != torch.float32 or upd.device != D.device
            or not upd.is_contiguous()):
        raise ValueError(f"brick_merge: upd {tuple(upd.shape)} {upd.dtype}")
    n = bid.shape[0]
    for name, x in (("bid", bid), ("cls", cls), ("slot", slot)):
        if (x.dtype != torch.int32 or x.shape != (n,) or x.device != D.device
                or not x.is_contiguous()):
            raise ValueError(f"brick_merge: {name} must be contiguous int32 ({n},)")
    if n == 0:
        return
    rc = _build.library().tsdf_brick_merge(
        *(x.data_ptr() for x in leaves), upd.data_ptr(), C,
        bid.data_ptr(), cls.data_ptr(), slot.data_ptr(), n, m, bi, bj, bk,
        delta, float("inf") if max_weight is None else max_weight,
        _build.stream_ptr(D.device))
    _build.check(rc, "brick_merge")
    launches += 1
