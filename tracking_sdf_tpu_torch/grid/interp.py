"""Masked trilinear interpolation with analytic gradient over a masked view
(counterpart of tracking_sdf_tpu.grid.interp).

``masked_view`` folds the observation mask into D (W <= 0 -> NaN) so a
query needs one gather; a corner is observed iff its value is finite. The
view is either a dense (m, m, m) tensor or a ``BrickMaskedView`` of the
brick-major D rows. Coordinates are continuous voxel units
(grid.world_to_voxel).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch

# Corner offsets in the reference's loop order (i, j, k nested).
OFFSETS = (
    (0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
    (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1),
)


def _offsets(device, dtype=torch.int64) -> torch.Tensor:
    return torch.tensor(OFFSETS, dtype=dtype, device=device)


def masked_view(D: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """D with unobserved voxels (W <= 0) replaced by NaN."""
    return torch.where(W > 0, D, torch.full_like(D, float("nan")))


def _corner_indices(base: torch.Tensor):
    """base (..., 3) int -> per-corner indices (..., 8) for each axis."""
    off = _offsets(base.device)
    return (base[..., None, 0] + off[:, 0], base[..., None, 1] + off[:, 1],
            base[..., None, 2] + off[:, 2])


def _in_bounds(ci, cj, ck, shape):
    return ((ci >= 0) & (ci < shape[0]) & (cj >= 0) & (cj < shape[1])
            & (ck >= 0) & (ck < shape[2]))


def _gather_corners(vol: torch.Tensor, ci, cj, ck) -> torch.Tensor:
    """vol[ci, cj, ck] with each corner clipped to the grid on its own
    (out-of-bounds lanes are masked by the caller via _in_bounds)."""
    m0, m1, m2 = vol.shape
    return vol[ci.clamp(0, m0 - 1), cj.clamp(0, m1 - 1), ck.clamp(0, m2 - 1)]


@dataclasses.dataclass
class BrickMaskedView:
    """Masked SDF view (W <= 0 -> NaN) in brick-major storage order.

    ``rows`` is the brick-major D leaf (fusion.brickmajor.BrickGrid.D, which
    holds NaN wherever W <= 0), float32 or bfloat16. Brick (ib, jb, kb) is
    row-major over (m/bi, m/bj, m/bk) and its voxels (di, dj, dk) row-major
    over ``bs``; ``pitch`` is the element stride between consecutive bricks
    (default bi·bj·bk, one brick per row)."""

    rows: torch.Tensor
    m: int
    bs: Tuple[int, int, int]
    pitch: int = 0

    def __post_init__(self):
        self.bs = tuple(self.bs)
        if not self.pitch:
            self.pitch = self.bs[0] * self.bs[1] * self.bs[2]

    @property
    def shape(self):
        return (self.m, self.m, self.m)

    @property
    def dtype(self):
        return self.rows.dtype

    @property
    def device(self):
        return self.rows.device


MaskedView = Union[torch.Tensor, BrickMaskedView]


def _corner_fetch_brick(view: BrickMaskedView, ci, cj, ck) -> torch.Tensor:
    """Corner values from a BrickMaskedView, each corner clipped to the grid
    on its own: flat index F = brick·pitch + (di·bj + dj)·bk + dk."""
    bi, bj, bk = view.bs
    m = view.m
    nbj, nbk = m // bj, m // bk
    ci, cj, ck = ci.clamp(0, m - 1), cj.clamp(0, m - 1), ck.clamp(0, m - 1)
    F = (((ci // bi) * nbj + cj // bj) * nbk + ck // bk) * view.pitch \
        + ((ci % bi) * bj + cj % bj) * bk + ck % bk
    return view.rows.reshape(-1)[F]


def trilinear_from_corners(
    d_raw: torch.Tensor, inb: torch.Tensor, f: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Masked trilinear value + gradient from pre-gathered corner values.

    d_raw (..., 8) in OFFSETS order with NaN = unobserved, inb (..., 8)
    bounds mask, f (..., 3) fractional position. value = N/Z over the
    observed corners; the gradient is the quotient-rule derivative of that
    renormalised form. Returns (value, grad (..., 3), valid)."""
    mask = (inb & torch.isfinite(d_raw)).to(f.dtype)
    # a select, not a multiply: NaN * 0 is NaN
    d = torch.where(mask > 0, d_raw, torch.zeros_like(d_raw))
    off = _offsets(f.device, f.dtype)
    fax = off * f[..., None, :] + (1.0 - off) * (1.0 - f[..., None, :])
    w = fax[..., 0] * fax[..., 1] * fax[..., 2]

    wm = w * mask
    Z = torch.sum(wm, dim=-1)
    N = torch.sum(wm * d, dim=-1)
    valid = Z > 1e-12
    safe_Z = torch.where(valid, Z, torch.ones_like(Z))
    value = torch.where(valid, N / safe_Z, torch.zeros_like(N))

    sign = 2.0 * off - 1.0
    prod_other = torch.stack([fax[..., 1] * fax[..., 2],
                              fax[..., 0] * fax[..., 2],
                              fax[..., 0] * fax[..., 1]], dim=-1)
    dw = sign * prod_other * mask[..., None]
    dN = torch.sum(dw * d[..., None], dim=-2)
    dZ = torch.sum(dw, dim=-2)
    grad = torch.where(
        valid[..., None],
        (dN * safe_Z[..., None] - N[..., None] * dZ) / (safe_Z ** 2)[..., None],
        torch.zeros_like(dN))
    return value, grad, valid


def trilinear_with_grad_nan(
    Dm: MaskedView, coords: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Trilinear value + analytic gradient against a masked view (dense or
    brick-major). bfloat16 corners are upcast right after the gather, so all
    the math runs in float32. Returns (value, grad, valid)."""
    base_f = torch.floor(coords)
    base = base_f.to(torch.int64)
    f = coords - base_f
    ci, cj, ck = _corner_indices(base)
    inb = _in_bounds(ci, cj, ck, Dm.shape)
    if isinstance(Dm, BrickMaskedView):
        d_raw = _corner_fetch_brick(Dm, ci, cj, ck)
    else:
        d_raw = _gather_corners(Dm, ci, cj, ck)
    return trilinear_from_corners(d_raw.to(torch.float32), inb, f)
