"""Grid interpolation (counterpart of tracking_sdf_tpu.grid.interp).

Two families:
  * masked trilinear interpolation with its analytic gradient:
    ``trilinear_with_grad(D, W, coords)`` masks the corners with W <= 0 (or
    out of bounds) and renormalizes; ``trilinear_with_grad_nan`` does the
    same against a masked view, where ``masked_view`` has folded the mask
    into D (W <= 0 -> NaN) so a query needs one gather. The view is either a
    dense (m, m, m) tensor or a ``BrickMaskedView`` of the brick-major D
    rows. Both are plain differentiable torch ops: the raycaster's
    refinement takes gradients through them with respect to the coordinates
    and to D.
  * ``shepard_l1`` and its color form: the reference's inverse-L1 (Shepard)
    weights over the 8 corners around trunc(coords), with an exact-hit
    return, against the dense D and W or (``BrickRows``) straight against
    the brick-major D and W rows.
Coordinates are continuous voxel units (grid.world_to_voxel); all the math
runs in float32 or wider whatever the storage dtype.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Tuple, Union

import torch

# Corner offsets in the reference's loop order (i, j, k nested).
OFFSETS = (
    (0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1),
    (1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1),
)


@functools.lru_cache(maxsize=None)
def _offsets(device, dtype=torch.int64) -> torch.Tensor:
    """The 8 corner offsets on ``device``, copied there once (a copy from
    the host waits for the device)."""
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
    (default bi·bj·bk, one brick per row). ``mi`` is the view's i extent in
    voxels (default m): a slab-local view (parallel.sharded) holds one
    rank's brick layers and a halo layer, addressed by slab-local i in
    [0, mi); j and k stay global."""

    rows: torch.Tensor
    m: int
    bs: Tuple[int, int, int]
    pitch: int = 0
    mi: int = 0

    def __post_init__(self):
        self.bs = tuple(self.bs)
        if not self.pitch:
            self.pitch = self.bs[0] * self.bs[1] * self.bs[2]
        if not self.mi:
            self.mi = self.m

    @property
    def shape(self):
        return (self.mi, self.m, self.m)

    @property
    def dtype(self):
        return self.rows.dtype

    @property
    def device(self):
        return self.rows.device


MaskedView = Union[torch.Tensor, BrickMaskedView]


class BrickRows(NamedTuple):
    """The brick-major D and W rows of a whole grid as two views of one
    layout (D holds NaN wherever W <= 0): what the central Jacobian's
    Shepard probes read in place of the dense D and W."""

    D: BrickMaskedView
    W: BrickMaskedView


def _corner_fetch_brick(view: BrickMaskedView, ci, cj, ck) -> torch.Tensor:
    """Corner values from a BrickMaskedView, each corner clipped to the grid
    on its own: flat index F = brick·pitch + (di·bj + dj)·bk + dk."""
    bi, bj, bk = view.bs
    m = view.m
    nbj, nbk = m // bj, m // bk
    ci, cj, ck = ci.clamp(0, view.mi - 1), cj.clamp(0, m - 1), ck.clamp(0, m - 1)
    F = (((ci // bi) * nbj + cj // bj) * nbk + ck // bk) * view.pitch \
        + ((ci % bi) * bj + cj % bj) * bk + ck % bk
    return view.rows.reshape(-1)[F]


def _axis_factors(f: torch.Tensor) -> torch.Tensor:
    """Per-corner, per-axis trilinear factors (..., 8, 3): f where the
    corner's offset is 1, 1 - f where it is 0."""
    off = _offsets(f.device, f.dtype)
    return off * f[..., None, :] + (1.0 - off) * (1.0 - f[..., None, :])


def _normalized(wm: torch.Tensor, d: torch.Tensor):
    """(value = N/Z where Z > 1e-12 else 0, N, safe Z, valid) with
    N = sum(wm * d) and Z = sum(wm) over the corners."""
    Z = torch.sum(wm, dim=-1)
    N = torch.sum(wm * d, dim=-1)
    valid = Z > 1e-12
    safe_Z = torch.where(valid, Z, torch.ones_like(Z))
    return torch.where(valid, N / safe_Z, torch.zeros_like(N)), N, safe_Z, valid


def _quotient_grad(fax, mask, d, N, safe_Z, valid) -> torch.Tensor:
    """d(N/Z)/df (..., 3) by the quotient rule, 0 where not valid."""
    sign = 2.0 * _offsets(fax.device, fax.dtype) - 1.0
    prod_other = torch.stack([fax[..., 1] * fax[..., 2],
                              fax[..., 0] * fax[..., 2],
                              fax[..., 0] * fax[..., 1]], dim=-1)
    dw = sign * prod_other * mask[..., None]
    dN = torch.sum(dw * d[..., None], dim=-2)
    dZ = torch.sum(dw, dim=-2)
    return torch.where(
        valid[..., None],
        (dN * safe_Z[..., None] - N[..., None] * dZ) / (safe_Z ** 2)[..., None],
        torch.zeros_like(dN))


def _observed(d_raw: torch.Tensor, inb: torch.Tensor, dtype: torch.dtype):
    """(mask, d): corners in bounds and finite, and their values with 0
    elsewhere (a select, not a multiply: NaN * 0 is NaN)."""
    mask = (inb & torch.isfinite(d_raw)).to(dtype)
    return mask, torch.where(mask > 0, d_raw, torch.zeros_like(d_raw))


def trilinear_from_corners(
    d_raw: torch.Tensor, inb: torch.Tensor, f: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Masked trilinear value + gradient from pre-gathered corner values.

    d_raw (..., 8) in OFFSETS order with NaN = unobserved, inb (..., 8)
    bounds mask, f (..., 3) fractional position. value = N/Z over the
    observed corners; the gradient is the quotient-rule derivative of that
    renormalised form. Returns (value, grad (..., 3), valid)."""
    mask, d = _observed(d_raw, inb, f.dtype)
    fax = _axis_factors(f)
    value, N, safe_Z, valid = _normalized(fax[..., 0] * fax[..., 1] * fax[..., 2] * mask, d)
    return value, _quotient_grad(fax, mask, d, N, safe_Z, valid), valid


def _fetch(vol: Union[torch.Tensor, BrickMaskedView], ci, cj, ck) -> torch.Tensor:
    """Corner values of a dense volume or of brick-major rows, each corner
    clipped to the grid on its own."""
    if isinstance(vol, BrickMaskedView):
        return _corner_fetch_brick(vol, ci, cj, ck)
    return _gather_corners(vol, ci, cj, ck)


def _view_corners(Dm: MaskedView, coords: torch.Tensor):
    """(corner values (..., 8) as float32, in-bounds mask, fractional
    position) of a masked view, dense or brick-major."""
    base_f = torch.floor(coords)
    base = base_f.to(torch.int64)
    ci, cj, ck = _corner_indices(base)
    inb = _in_bounds(ci, cj, ck, Dm.shape)
    return _fetch(Dm, ci, cj, ck).to(torch.float32), inb, coords - base_f


def trilinear_with_grad_nan(
    Dm: MaskedView, coords: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Trilinear value + analytic gradient against a masked view (dense or
    brick-major). bfloat16 corners are upcast right after the gather, so all
    the math runs in float32. Returns (value, grad, valid)."""
    return trilinear_from_corners(*_view_corners(Dm, coords))


def trilinear_nan(Dm: MaskedView, coords: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The value of trilinear_with_grad_nan without its gradient (the
    raycaster's march). Returns (value, valid)."""
    d_raw, inb, f = _view_corners(Dm, coords)
    mask, d = _observed(d_raw, inb, f.dtype)
    fax = _axis_factors(f)
    value, _, _, valid = _normalized(fax[..., 0] * fax[..., 1] * fax[..., 2] * mask, d)
    return value, valid


def _math_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _trilinear_weights(W: torch.Tensor, coords: torch.Tensor, dtype: torch.dtype):
    """The masked trilinear corner weights of ``coords`` (corners with
    W <= 0 or out of bounds get 0): (corner indices, per-axis factors
    (..., 8, 3), masked weights (..., 8), mask)."""
    base_f = torch.floor(coords)
    ci, cj, ck = _corner_indices(base_f.to(torch.int64))
    inb = _in_bounds(ci, cj, ck, W.shape)
    mask = (inb & (_gather_corners(W, ci, cj, ck) > 0)).to(dtype)
    fax = _axis_factors((coords - base_f).to(dtype))
    return (ci, cj, ck), fax, fax[..., 0] * fax[..., 1] * fax[..., 2] * mask, mask


def trilinear_with_grad(
    D: torch.Tensor, W: torch.Tensor, coords: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Trilinear value + analytic gradient w.r.t. the voxel coordinates:
    value = N/Z with N = sum_i m_i w_i(f) D_i and Z = sum_i m_i w_i(f), where
    m_i masks unobserved (W <= 0) and out-of-bounds corners; the gradient is
    the quotient-rule derivative of that renormalized form. Differentiable
    with respect to ``coords`` and ``D``. Returns (value, grad (..., 3),
    valid)."""
    idx, fax, wm, mask = _trilinear_weights(W, coords, _math_dtype(D.dtype))
    d = _gather_corners(D, *idx).to(wm.dtype)
    value, N, safe_Z, valid = _normalized(wm, d)
    return value, _quotient_grad(fax, mask, d, N, safe_Z, valid), valid


def trilinear(D: torch.Tensor, W: torch.Tensor,
              coords: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked renormalized trilinear interpolation (the value of
    trilinear_with_grad, without its gradient). Returns (value, valid)."""
    idx, _, wm, _ = _trilinear_weights(W, coords, _math_dtype(D.dtype))
    value, _, _, valid = _normalized(wm, _gather_corners(D, *idx).to(wm.dtype))
    return value, valid


def _shepard_weights(W: Union[torch.Tensor, BrickMaskedView], coords: torch.Tensor,
                     dtype: torch.dtype):
    """Inverse-L1 corner weights around trunc(coords): (corner indices,
    weights (0 on invalid and exact corners), exact-hit mask, valid corners
    (..., 8), valid)."""
    base = torch.trunc(coords).to(torch.int64)
    ci, cj, ck = _corner_indices(base)
    inb = _in_bounds(ci, cj, ck, W.shape)
    valid_corner = inb & (_fetch(W, ci, cj, ck) > 0)
    corner_pos = base[..., None, :] + _offsets(base.device)
    vol = torch.sum(torch.abs(corner_pos.to(dtype) - coords[..., None, :]), dim=-1)
    exact = valid_corner & (vol < 1e-5)
    safe_vol = torch.where(vol < 1e-5, torch.ones_like(vol), vol)
    w = torch.where(valid_corner & (vol >= 1e-5), 1.0 / safe_vol, torch.zeros_like(vol))
    return (ci, cj, ck), w, exact, valid_corner, torch.any(valid_corner, dim=-1)


def _shepard_value(d: torch.Tensor, w: torch.Tensor, exact: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros_like(d)
    exact_val = torch.sum(torch.where(exact, d, zero), dim=-1)  # at most one corner
    w_sum = torch.sum(w, dim=-1)
    blended = torch.sum(w * d, dim=-1) / torch.where(w_sum > 0, w_sum,
                                                     torch.ones_like(w_sum))
    value = torch.where(torch.any(exact, dim=-1), exact_val, blended)
    return torch.where(valid, value, torch.zeros_like(value))


def shepard_l1(D: Union[torch.Tensor, BrickMaskedView], W: Union[torch.Tensor, BrickMaskedView],
               coords: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's inverse-L1 (Shepard) interpolation: corners around
    trunc(coords) (truncation toward zero, as a C cast), weight 1/L1
    distance, out-of-bounds and W <= 0 corners skipped, and a valid corner
    closer than 1e-5 returned exactly. valid is False where no corner is
    valid (value 0 there). Returns (value, valid).

    ``D`` and ``W`` are the dense volumes, or ``BrickRows``' two views of
    the brick-major rows; there a skipped corner's D (NaN where W <= 0)
    enters the blend as 0, by a select."""
    dtype = _math_dtype(D.dtype)
    idx, w, exact, kept, valid = _shepard_weights(W, coords, dtype)
    d = _fetch(D, *idx).to(dtype)
    if isinstance(D, BrickMaskedView):
        d = torch.where(kept, d, torch.zeros_like(d))
    return _shepard_value(d, w, exact, valid), valid


def shepard_color(R: torch.Tensor, G: torch.Tensor, B: torch.Tensor,
                  Wc: torch.Tensor, coords: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's color interpolation: shepard_l1 per channel, gated on
    the color weight Wc (the weights are computed once for the three).
    Returns (rgb (..., 3), valid)."""
    dtype = _math_dtype(R.dtype)
    idx, w, exact, _, valid = _shepard_weights(Wc, coords, dtype)
    rgb = [_shepard_value(_gather_corners(c, *idx).to(dtype), w, exact, valid)
           for c in (R, G, B)]
    return torch.stack(rgb, dim=-1), valid


def interp_color(R: torch.Tensor, G: torch.Tensor, B: torch.Tensor,
                 Wc: torch.Tensor, coords: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trilinear color lookup masked by the color weight Wc (trilinear per
    channel; the weights are computed once for the three). Returns
    (rgb (..., 3), valid)."""
    idx, _, wm, _ = _trilinear_weights(Wc, coords, _math_dtype(R.dtype))
    out = [_normalized(wm, _gather_corners(c, *idx).to(wm.dtype)) for c in (R, G, B)]
    return torch.stack([o[0] for o in out], dim=-1), out[0][3]
