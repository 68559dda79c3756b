"""Brick-major TSDF fusion: the grid stored as one row per brick
(counterpart of tracking_sdf_tpu.fusion.brickmajor), the presets' main path.

Each leaf is an (NB, BV) table: brick b = (ib, jb, kb) row-major over
(m/bi, m/bj, m/bk), and within a row the brick's voxels (di, dj, dk)
row-major over the brick shape. D holds NaN wherever W <= 0, so the D leaf is
itself the masked view that tracking reads (``brick_masked_view``); the dense
export restores the far value there. The four color leaves R, G, B, Wc live
in one uint16-lane leaf ``C`` of shape (NB, 3·LV + LW): per row the blocks
[R | G | B | Wc], each value bitcast to its 16-bit lanes (LV = BV·itemsize/2
of the value dtype, LW likewise for the weight dtype). PyTorch has no uint16
arithmetic, so the port holds those lanes as int16: the bits are the same.

A frame makes its zeta / eta mip and pixel table (``brick.frame_tables``),
classifies the bricks (flat or hierarchical) and compacts the FULL and FREE
ids under their caps (``classify_compact_rows``): on the card K5, K6 and K7
of ``fusion.brick_classify``, 3 launches flat and 5 hierarchical; then one
launch of ``brick_fuse.brick_fuse_rows`` computes the FULL bricks' per-voxel update
sums and merges them and the FREE rows in one pass (the JAX package's
``free_fold``, which is bitwise equal to its unfolded merge). Values and
weights may be stored as bfloat16; all arithmetic is float32, rounded to the
storage dtype only at the store.

Saturated-FREE skip (``FusionConfig.sat_skip``): with a max_weight clamp a
FREE brick's update becomes a bitwise no-op once W saturates. The caller
carries an (NB,) bool bitset ``sat``: saturated bricks leave the FREE
candidates before compaction (their cap_free slots go to other bricks), the
kernel clears the bit of every FULL brick it updates and sets the bit of a
FREE brick whose stored D and W came out equal to what they were. Skipping
a set brick is then invisible: the rows equal those of the run without the
skip, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from tracking_sdf_tpu_torch.config import FusionConfig, GridParams
from tracking_sdf_tpu_torch.core.camera import PinholeCamera
from tracking_sdf_tpu_torch.core.lie import Pose
from tracking_sdf_tpu_torch.fusion.brick import (
    FREE, FULL, FuseStats, ZetaMip, _compact_ids, _on_card, classify_bricks_reference,
    classify_compact_card, classify_compact_hier_reference, frame_tables,
    share_classify_margin)
from tracking_sdf_tpu_torch.fusion.brick_fuse import brick_fuse_rows
from tracking_sdf_tpu_torch.grid.grid import TSDFGrid
from tracking_sdf_tpu_torch.grid.interp import BrickMaskedView, BrickRows
from tracking_sdf_tpu_torch.utils import debug_nans

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class BrickGrid:
    """Brick-major leaves: D, W (NB, BV) and the packed color lanes C
    (NB, 3·LV + LW) int16. Fusion updates them in place."""

    D: torch.Tensor
    W: torch.Tensor
    C: torch.Tensor


def storage_dtype(name: str) -> torch.dtype:
    """FusionConfig.storage_dtype / weight_dtype name -> torch dtype."""
    if name not in _DTYPES:
        raise NotImplementedError(f"storage dtype {name!r}: only {sorted(_DTYPES)}")
    return _DTYPES[name]


def _to_rows(leaf: torch.Tensor, bs: Tuple[int, int, int]) -> torch.Tensor:
    mi, mj, mk = leaf.shape
    bi, bj, bk = bs
    return (leaf.reshape(mi // bi, bi, mj // bj, bj, mk // bk, bk)
            .permute(0, 2, 4, 1, 3, 5).reshape(-1, bi * bj * bk))


def _from_rows(rows: torch.Tensor, shape, bs: Tuple[int, int, int]) -> torch.Tensor:
    mi, mj, mk = shape
    bi, bj, bk = bs
    return (rows.reshape(mi // bi, mj // bj, mk // bk, bi, bj, bk)
            .permute(0, 3, 1, 4, 2, 5).reshape(mi, mj, mk))


def _lanes(x: torch.Tensor) -> torch.Tensor:
    """(..., w) 16/32-bit leaf -> (..., w·itemsize/2) int16 lanes, low half
    of a 32-bit value first (the JAX package's uint16 bitcast order on a
    little-endian host)."""
    return x.contiguous().view(torch.int16)


def _unlanes(u: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of _lanes."""
    return u.contiguous().view(dtype)


def color_lane_widths(bv: int, value_dtype: torch.dtype,
                      weight_dtype: torch.dtype) -> Tuple[int, int]:
    """(LV, LW): 16-bit lanes per R/G/B block and per Wc block."""
    return (bv * (value_dtype.itemsize // 2), bv * (weight_dtype.itemsize // 2))


def pack_color(R, G, B, Wc) -> torch.Tensor:
    """Four color leaves -> one packed lane leaf [R | G | B | Wc]."""
    return torch.cat([_lanes(R), _lanes(G), _lanes(B), _lanes(Wc)], dim=-1)


def unpack_color(C: torch.Tensor, value_dtype, weight_dtype, bv: int):
    """Packed lanes -> (R, G, B, Wc) in their stored dtypes."""
    lv, lw = color_lane_widths(bv, value_dtype, weight_dtype)
    return (_unlanes(C[..., :lv], value_dtype),
            _unlanes(C[..., lv:2 * lv], value_dtype),
            _unlanes(C[..., 2 * lv:3 * lv], value_dtype),
            _unlanes(C[..., 3 * lv:3 * lv + lw], weight_dtype))


def unpack_color_grid(bgrid: BrickGrid):
    """(R, G, B, Wc) rows of a BrickGrid: D's dtype is the value dtype, W's
    the weight dtype."""
    return unpack_color(bgrid.C, bgrid.D.dtype, bgrid.W.dtype, bgrid.D.shape[-1])


def brick_grid_from_dense(grid: TSDFGrid, bs: Tuple[int, int, int],
                          value_dtype=None, weight_dtype=None) -> BrickGrid:
    """value_dtype applies to D, R, G, B and weight_dtype to W, Wc (default:
    the dense leaves' dtype)."""
    vdt = value_dtype or grid.D.dtype
    wdt = weight_dtype or grid.W.dtype
    D = _to_rows(grid.D, bs).to(vdt)
    return BrickGrid(
        D=torch.where(_to_rows(grid.W, bs) > 0, D, torch.full_like(D, float("nan"))),
        W=_to_rows(grid.W, bs).to(wdt),
        C=pack_color(*(_to_rows(x, bs).to(vdt) for x in (grid.R, grid.G, grid.B)),
                     _to_rows(grid.Wc, bs).to(wdt)))


def dense_from_brick_grid(bgrid: BrickGrid, params: GridParams,
                          bs: Tuple[int, int, int]) -> TSDFGrid:
    """The dense float32 grid (the export surface): materializes six
    (m, m, m) leaves, with the far value where W <= 0. Rows of an i-slab
    (fewer rows than the whole grid's) give the slab's (mi, m, m) leaves."""
    m = params.m
    shape = (bgrid.D.shape[0] // ((m // bs[1]) * (m // bs[2])) * bs[0], m, m)
    far = params.width + params.height + params.depth
    W = bgrid.W.to(torch.float32)
    D = torch.where(W > 0, bgrid.D.to(torch.float32), torch.full_like(W, far))
    R, G, B, Wc = unpack_color_grid(bgrid)
    return TSDFGrid(*(_from_rows(x.to(torch.float32), shape, bs)
                      for x in (D, W, R, G, B, Wc)))


def empty_brick_grid(params: GridParams, bs: Tuple[int, int, int], *, device,
                     value_dtype=torch.float32,
                     weight_dtype=torch.float32, nbi: Optional[int] = None) -> BrickGrid:
    """Fresh grid in brick layout: D = NaN (nothing observed), W = 0, grey
    color with Wc = 0. ``nbi``: only the rows of an i-slab of that many
    brick layers (default m / bi)."""
    bi, bj, bk = bs
    m = params.m
    shp = ((m // bi if nbi is None else nbi) * (m // bj) * (m // bk), bi * bj * bk)

    def full(v, dtype):
        return torch.full(shp, v, dtype=dtype, device=device)

    grey = full(0.4, value_dtype)
    return BrickGrid(D=full(float("nan"), value_dtype), W=full(0.0, weight_dtype),
                     C=pack_color(grey, grey, grey, full(0.0, weight_dtype)))


def masked_dense_D(bgrid: BrickGrid, params: GridParams,
                   bs: Tuple[int, int, int]) -> torch.Tensor:
    """Dense (m, m, m) masked view (NaN where W <= 0): a layout transpose."""
    return _from_rows(bgrid.D, (params.m,) * 3, bs)


def brick_masked_view(bgrid: BrickGrid, params: GridParams,
                      bs: Tuple[int, int, int]) -> BrickMaskedView:
    """The masked view that tracking reads straight from the D rows (no copy)."""
    return BrickMaskedView(bgrid.D, params.m, bs)


def brick_rows_view(bgrid: BrickGrid, params: GridParams,
                    bs: Tuple[int, int, int]) -> BrickRows:
    """The D and W rows as the central Jacobian's Shepard probes read them
    in place (no copy)."""
    return BrickRows(BrickMaskedView(bgrid.D, params.m, bs),
                     BrickMaskedView(bgrid.W, params.m, bs))


def brick_grid_from_numpy(arrays: Mapping[str, object], *, device,
                          mesh=None) -> BrickGrid:
    """BrickGrid from the D, W and C leaves as array-likes (for example a JAX
    BrickGrid's ``_asdict()``), bit for bit: float32 or bfloat16 D and W keep
    their dtype, the uint16 C lanes become int16 lanes. The leaves are
    copies. With ``mesh`` (parallel.mesh.Mesh) only this rank's rows of the
    whole grid are kept (an i-slab of bricks)."""
    def rows(x):
        a = np.asarray(x)
        return a[mesh.rows(a.shape[0])] if mesh is not None else a

    def leaf(x):
        a = rows(x)
        if a.dtype.name == "bfloat16":  # numpy has no bfloat16 of its own
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(np.array(a, np.float32))

    C = rows(arrays["C"])
    if C.dtype.itemsize != 2:
        raise ValueError(f"C must hold 16-bit lanes, got {C.dtype}")
    return BrickGrid(D=leaf(arrays["D"]).to(device), W=leaf(arrays["W"]).to(device),
                     C=torch.from_numpy(C.view(np.int16).copy()).to(device))


def brick_grid_to_numpy(bgrid: BrickGrid) -> Dict[str, np.ndarray]:
    """D and W as float32 (exact for bfloat16 storage) and C as uint16 lanes."""
    return {"D": bgrid.D.detach().float().cpu().numpy(),
            "W": bgrid.W.detach().float().cpu().numpy(),
            "C": bgrid.C.detach().cpu().numpy().view(np.uint16)}


def _hier_factor(cfg: FusionConfig, nb3) -> int:
    """The super-brick factor of the hierarchical classification, or 1 (flat)
    where it is off or does not divide the brick grid."""
    hier = cfg.hier_classify
    return hier if hier > 1 and all(n % hier == 0 for n in nb3) else 1


def classify_compact_rows(params: GridParams, pose: Pose, points_cam: torch.Tensor,
                          normals_cam: torch.Tensor, *, cam: PinholeCamera,
                          cfg: FusionConfig, bs: Tuple[int, int, int], cap: int,
                          cap_free: int, sat: Optional[torch.Tensor] = None,
                          nbi: Optional[int] = None, i_offset: int = 0,
                          mip: Optional[ZetaMip] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A frame's FULL and FREE brick lists, classified flat or hierarchically
    (``cfg.hier_classify``), without a host sync. Bricks set in ``sat`` are
    not FREE candidates. ``nbi`` / ``i_offset``: the bricks of an i-slab of
    nbi brick layers starting at global voxel i = i_offset (ids local to it).
    ``mip``: the frame's zeta / eta mip (``brick.frame_tables``), made here
    when None.

    Returns (ids, counts): ids (cap + cap_free,) int32, the first ``cap``
    FULL ids then the first ``cap_free`` FREE ids, each padded with NB;
    counts (4,) int64 on the device: n_full, n_free, FREE bricks dropped,
    mixed super-bricks dropped. On the card K6 and K7 (after K5 for the mip
    unless given): 2 launches flat, 4 hierarchical
    (``brick.classify_compact_card``); a CPU tensor takes
    ``classify_compact_rows_reference``."""
    if not _on_card(points_cam, "classify_compact_rows"):
        return classify_compact_rows_reference(
            params, pose, points_cam, normals_cam, cam=cam, cfg=cfg, bs=bs, cap=cap,
            cap_free=cap_free, sat=sat, nbi=nbi, i_offset=i_offset, mip=mip)
    m = params.m
    nb3 = (m // bs[0] if nbi is None else nbi, m // bs[1], m // bs[2])
    return classify_compact_card(params, pose, points_cam, normals_cam, cam, bs, cfg.distance,
                                 cap, cap_free, _hier_factor(cfg, nb3), cfg.cap_mixed,
                                 share_classify_margin(params, cfg), sat, nb3[0], i_offset, mip)


def classify_compact_rows_reference(params: GridParams, pose: Pose,
                                    points_cam: torch.Tensor, normals_cam: torch.Tensor, *,
                                    cam: PinholeCamera, cfg: FusionConfig,
                                    bs: Tuple[int, int, int], cap: int, cap_free: int,
                                    sat: Optional[torch.Tensor] = None,
                                    nbi: Optional[int] = None, i_offset: int = 0,
                                    mip: Optional[ZetaMip] = None
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``classify_compact_rows``."""
    m = params.m
    bi, bj, bk = bs
    nb3 = (m // bi if nbi is None else nbi, m // bj, m // bk)
    NB = nb3[0] * nb3[1] * nb3[2]
    share_m = share_classify_margin(params, cfg)
    hier = _hier_factor(cfg, nb3)
    if hier > 1:
        full_ids, fr_ids, n_full, n_free, ovf_mixed, ovf_free = classify_compact_hier_reference(
            params, pose, points_cam, normals_cam, cam, bs, cfg.distance, cap,
            cap_free, hier, cfg.cap_mixed, share_margin=share_m, sat=sat,
            nbi=nb3[0], i_offset=i_offset, mip=mip)
    else:
        cls = classify_bricks_reference(params, pose, points_cam, normals_cam, cam, bs,
                                        cfg.distance, share_margin=share_m, mip=mip,
                                        nbi=nb3[0], i_offset=i_offset).reshape(-1)
        free = cls == FREE
        if sat is not None:
            free = free & ~sat
        n_full, n_free = (cls == FULL).sum(), free.sum()
        full_ids = _compact_ids(cls == FULL, cap, NB)
        fr_ids = _compact_ids(free, cap_free, NB)
        ovf_free = torch.clamp(n_free - cap_free, min=0)
        ovf_mixed = torch.zeros_like(n_free)
    ids = torch.cat([full_ids, fr_ids]).to(torch.int32)
    return ids, torch.stack([n_full, n_free, ovf_free, ovf_mixed])


def fuse_frame_brickmajor_core(
    bgrid: BrickGrid,
    pose: Pose,
    points_cam: torch.Tensor,  # (H, W, 3)
    normals_cam: torch.Tensor,  # (H, W, 3)
    rgb: Optional[torch.Tensor],  # (H, W, 3) in [0, 1] or None
    *,
    params: GridParams,
    cam: PinholeCamera,
    cfg: FusionConfig = FusionConfig(),
    bs: Tuple[int, int, int] = (8, 8, 8),
    cap: int = 6144,
    cap_free: Optional[int] = None,
    sat: Optional[torch.Tensor] = None,
    i_offset: int = 0,
    nbi_local: Optional[int] = None,
    debug: bool = False,
) -> torch.Tensor:
    """Fuse one frame into ``bgrid`` in place and read nothing back: the one
    place that owns the sequence frame_tables (the mip and the pixel table)
    -> classify_compact_rows -> brick_fuse_rows, for the per-frame path, the
    chunked one and the sharded one: on the card K5, K6 and K7 (3 launches
    flat, 5 hierarchical), then K2. ``sat``: the (NB,) bool sat_skip
    bitset, updated in place (module docstring). ``nbi_local`` /
    ``i_offset``: ``bgrid`` holds the rows of an i-slab of nbi_local brick
    layers starting at global voxel i = i_offset (parallel.sharded; default
    the whole grid).

    Geometry is exactly the dense path's math; color is fused in FULL bricks
    only. FULL bricks past ``cap`` and FREE bricks past ``cap_free`` (default
    ``cap``) are dropped for the frame, as are mixed super-bricks past
    ``cfg.cap_mixed`` with hierarchical classification. Returns (6,) int64
    counts on the device (COUNTS): those of classify_compact_rows (n_full,
    n_free, FREE bricks dropped, mixed super-bricks dropped), the bricks set
    in ``sat`` after the frame (0 without it) and the FULL bricks dropped;
    ``fuse_stats`` reads them, and a sum of several slabs' counts is the
    counts of their union. ``debug`` (--debug-nans) appends the four
    invariant counts of utils.debug_nans over the rows the frame listed and
    ``pose`` (it only reads). An all-NaN frame leaves the rows bitwise
    unchanged."""
    m = params.m
    bi, bj, bk = bs
    if m % bj or m % bk or (nbi_local is None and m % bi):
        raise ValueError(f"grid m={m} not divisible by brick {bs}")
    nbi = m // bi if nbi_local is None else nbi_local
    NB = nbi * (m // bj) * (m // bk)
    if tuple(bgrid.D.shape) != (NB, bi * bj * bk):
        raise ValueError(f"brick grid {tuple(bgrid.D.shape)} != ({NB}, {bi * bj * bk})")
    if cap_free is None:
        cap_free = cap
    fuse_color = cfg.fuse_color and rgb is not None
    mip, pix = frame_tables(points_cam, normals_cam, rgb, fuse_color, cam, params.delta,
                            cfg.distance, share_classify_margin(params, cfg))
    ids, counts = classify_compact_rows(params, pose, points_cam, normals_cam, cam=cam,
                                        cfg=cfg, bs=bs, cap=cap, cap_free=cap_free, sat=sat,
                                        nbi=nbi, i_offset=i_offset, mip=mip)
    brick_fuse_rows(bgrid.D, bgrid.W, bgrid.C, ids, pix, pose, cap=cap,
                    hw=tuple(points_cam.shape[:2]), params=params, cam=cam, cfg=cfg,
                    bs=bs, sat=sat, i_offset=i_offset, nbi=nbi_local)
    n_sat = counts[:1] * 0 if sat is None else sat.sum()[None]
    out = [counts, n_sat, torch.clamp(counts[:1] - cap, min=0)]
    if debug:  # the FULL and FREE rows are the only ones K2 wrote
        out.append(row_faults(bgrid, ids, pose))
    return torch.cat(out)


def row_faults(bgrid: BrickGrid, ids: torch.Tensor, pose: Pose) -> torch.Tensor:
    """--debug-nans over the rows a frame listed: (4,) int64 on the device,
    utils.debug_nans' leaf counts over the rows ``ids`` (padded with NB)
    then the pose's."""
    NB, BV = bgrid.D.shape
    rows = ids.clamp(max=NB - 1).long()
    R, G, B, Wc = unpack_color(bgrid.C[rows], bgrid.D.dtype, bgrid.W.dtype, BV)
    return torch.cat([debug_nans.leaf_faults(bgrid.D[rows], bgrid.W[rows], R, G, B, Wc,
                                             (ids < NB)[:, None]),
                      debug_nans.pose_faults(pose)])


# fuse_frame_brickmajor_core's counts
COUNTS = ("n_full", "n_free", "overflow_active", "overflow_mixed", "n_sat", "overflow")


def fuse_stats(counts) -> FuseStats:
    """FuseStats of a frame from its six counts (host integers)."""
    return FuseStats(**{k: int(c) for k, c in zip(COUNTS, counts)})


def fuse_frame_brickmajor(
    bgrid: BrickGrid,
    pose: Pose,
    points_cam: torch.Tensor,  # (H, W, 3)
    normals_cam: torch.Tensor,  # (H, W, 3)
    rgb: Optional[torch.Tensor],  # (H, W, 3) in [0, 1] or None
    *,
    params: GridParams,
    cam: PinholeCamera,
    cfg: FusionConfig = FusionConfig(),
    bs: Tuple[int, int, int] = (8, 8, 8),
    cap: int = 6144,
    cap_free: Optional[int] = None,
    sat: Optional[torch.Tensor] = None,
) -> Tuple[BrickGrid, BrickMaskedView, FuseStats]:
    """Fuse one frame into ``bgrid`` (and the sat_skip bitset ``sat``) in
    place (``fuse_frame_brickmajor_core``) and read its stats in one host
    sync.

    Returns (bgrid, view, stats): ``view`` is the masked view of the merged D
    rows for the next frame's tracking; the dropped bricks are reported in
    ``stats``."""
    counts = fuse_frame_brickmajor_core(bgrid, pose, points_cam, normals_cam, rgb,
                                        params=params, cam=cam, cfg=cfg, bs=bs, cap=cap,
                                        cap_free=cap_free, sat=sat)
    return bgrid, brick_masked_view(bgrid, params, bs), fuse_stats(counts.tolist())
