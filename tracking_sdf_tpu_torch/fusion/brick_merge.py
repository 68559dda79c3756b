"""K2: fold one frame's FREE/FULL brick updates into the grid in place.

Counterpart of tracking_sdf_tpu/fusion/pallas_merge.py. The CUDA kernels
(``csrc/brick_merge.cu``) replace the Pallas ``_merge_kernel_geo`` /
``_merge_kernel_color``: the dense form gives each thread four voxels along
k (float4 loads, all issued before any store) and each block four 8³
bricks, its threads k-major across them; the row form one thread block per
brick and one thread per voxel. The source notes there say what bounds
them on the card. Both forms apply
``max_weight`` (divide by the uncapped weight sum, store the clamped one), as
the JAX package's XLA merges do and its Pallas kernel does not.

Dense form (``brick_merge``, the flat bricked loop): ``upd`` (cap + 1, BI,
BJ, BK, C) float32 with C = 2 (w, w·d) or 6 (+ wc, wc·r, wc·g, wc·b) and a
zero last row; ``bid``/``cls``/``slot`` (n,) int32 — brick id, class
(1 FREE, 2 FULL) and update row.

Row form (``brick_merge_rows``, the brick-major main path): the merge of
``tracking_sdf_tpu.fusion.brickmajor.fuse_frame_brickmajor`` with free_fold,
on the D, W rows and the packed color lanes C of a BrickGrid.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from tracking_sdf_tpu_torch.grid.grid import TSDFGrid
from tracking_sdf_tpu_torch.kernels import _build

FREE, FULL = 1, 2

# kernel launches on CUDA tensors
launches = 0  # brick_merge (dense form)
launches_rows = 0  # brick_merge_rows (row form)


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
    # a block holds at most 512 threads of 4 voxels (1 unless bk % 4 == 0)
    if (D.shape != (m, m, m) or m % bi or m % bj or m % bk
            or bi * bj * bk > 512 * (4 if bk % 4 == 0 else 1)):
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


def brick_merge_rows_reference(D: torch.Tensor, W: torch.Tensor, C: torch.Tensor,
                               upd: torch.Tensor, ids: torch.Tensor, *, cap: int,
                               delta: float, max_weight: Optional[float]) -> None:
    """Plain PyTorch version of ``brick_merge_rows``; updates D, W, C in place.
    It selects the listed rows with a boolean mask (one host sync)."""
    # brickmajor imports this module
    from tracking_sdf_tpu_torch.fusion.brickmajor import pack_color, unpack_color

    NB, BV = D.shape
    slot = torch.nonzero(ids < NB).reshape(-1)
    rows = ids[slot].to(torch.int64)
    full = slot < cap
    fs = slot.clamp(max=cap - 1)  # FREE slots read a row they do not use
    one = torch.ones((), device=D.device)
    w_add = torch.where(full[:, None], upd[0][fs], one)
    wd_add = torch.where(full[:, None], upd[1][fs], one * delta)
    D_old, W_old = D[rows].to(torch.float32), W[rows].to(torch.float32)
    # D holds NaN where W <= 0: sanitise before the W·D product
    D_san = torch.where(W_old > 0, D_old, 0.0 * one)
    W_sum = W_old + w_add
    has = w_add > 0
    D[rows] = torch.where(has, (W_old * D_san + wd_add) / torch.where(has, W_sum, one),
                          D_old).to(D.dtype)
    W[rows] = (W_sum if max_weight is None
               else torch.clamp(W_sum, max=max_weight)).to(W.dtype)
    if upd.shape[0] == 6:
        crows, fs = rows[full], fs[full]
        R, G, B, Wc = (x.to(torch.float32)
                       for x in unpack_color(C[crows], D.dtype, W.dtype, BV))
        wc_add = upd[2][fs]
        Wc_sum = Wc + wc_add
        has_c = wc_add > 0
        safe = torch.where(has_c, Wc_sum, one)
        R, G, B = (torch.where(has_c, (Wc * old + upd[c][fs]) / safe, old).to(D.dtype)
                   for old, c in ((R, 3), (G, 4), (B, 5)))
        Wc = (Wc_sum if max_weight is None
              else torch.clamp(Wc_sum, max=max_weight)).to(W.dtype)
        C[crows] = pack_color(R, G, B, Wc)


def brick_merge_rows(D: torch.Tensor, W: torch.Tensor, C: torch.Tensor,
                     upd: torch.Tensor, ids: torch.Tensor, *, cap: int,
                     delta: float, max_weight: Optional[float]) -> None:
    """Merge one frame into the brick rows in place.

    ``D``, ``W`` (NB, BV) float32 or bfloat16 (D NaN where W <= 0); ``C``
    (NB, 3·LV + LW) int16 packed color lanes; ``upd`` (channels, cap, BV)
    float32 update sums of the FULL slots, channels 2 (geometry) or 6 (and
    color); ``ids`` (cap + n_free,) int32: the FULL slots' brick ids, then
    the FREE ids (w = 1, w·d = +delta), an id >= NB marking a padding slot.
    The listed ids must be distinct.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    global launches_rows
    if D.device.type == "cpu":
        return brick_merge_rows_reference(D, W, C, upd, ids, cap=cap, delta=delta,
                                          max_weight=max_weight)
    if D.device.type != "cuda":
        raise ValueError(f"brick_merge_rows: unsupported device {D.device}")
    from tracking_sdf_tpu_torch.fusion.brickmajor import color_lane_widths

    NB, BV = D.shape
    dtypes = (torch.float32, torch.bfloat16)
    if (D.dtype not in dtypes or W.dtype not in dtypes or W.shape != D.shape
            or BV % 2 or BV > 1024
            or any(x.device != D.device or not x.is_contiguous() for x in (D, W, C))):
        raise ValueError("brick_merge_rows: D and W must be contiguous (NB, BV) "
                         "float32/bfloat16 on one device, BV even and <= 1024")
    lv, lw = color_lane_widths(BV, D.dtype, W.dtype)
    if C.dtype != torch.int16 or tuple(C.shape) != (NB, 3 * lv + lw):
        raise ValueError(f"brick_merge_rows: C {tuple(C.shape)} {C.dtype} is not "
                         f"the ({NB}, {3 * lv + lw}) int16 lane leaf")
    channels = upd.shape[0]
    if (channels not in (2, 6) or tuple(upd.shape) != (channels, cap, BV)
            or upd.dtype != torch.float32 or upd.device != D.device
            or not upd.is_contiguous()):
        raise ValueError(f"brick_merge_rows: upd {tuple(upd.shape)} {upd.dtype}")
    if (ids.dtype != torch.int32 or ids.dim() != 1 or ids.shape[0] < cap
            or ids.device != D.device or not ids.is_contiguous()):
        raise ValueError("brick_merge_rows: ids must be contiguous int32 (>= cap,)")
    if ids.shape[0] == 0:
        return
    rc = _build.library().tsdf_brick_merge_rows(
        D.data_ptr(), W.data_ptr(), C.data_ptr(), C.shape[1],
        int(D.dtype == torch.bfloat16), int(W.dtype == torch.bfloat16),
        upd.data_ptr(), channels, ids.data_ptr(), ids.shape[0], cap, NB, BV,
        delta, float("inf") if max_weight is None else max_weight,
        _build.stream_ptr(D.device))
    _build.check(rc, "brick_merge_rows")
    launches_rows += 1
