"""K5, K6 and K7: brick classification, compaction and the pixel table on
the card (``csrc/brick_classify.cu``).

The kernels replace the fusion stage that the JAX package leaves to XLA's
fusions before its merge (tracking_sdf_tpu/fusion/brick.py ``_zeta_mip``,
``_query_zeta``, ``classify_bricks``, ``classify_compact_hier``,
``_compact_ids``, ``_pixel_table``); it has no Pallas original. The plain
versions are the ``*_reference`` functions of ``fusion.brick`` and
``fusion.brickmajor``, whose public names dispatch: a CPU tensor takes the
plain version, a CUDA tensor these wrappers, any other device raises.

  ``frame_tables``       K5: the zeta / eta mip and the pixel table of a
                         frame, one launch (either alone, or both);
  ``classify_bricks``    K6 flat and super forms: one class byte a brick
                         (0 OUT, 1 FREE, 2 FULL), and with ``sat`` whether
                         each super's children are all saturated;
  ``classify_children``  K6 children form: the f³ children of the listed
                         mixed supers, their classes and global ids;
  ``compact_lists``      K7 flat form: the stable first-cap FULL and FREE
                         lists and their counts;
  ``compact_lists_hier`` K7 hierarchical form: the final lists and counts
                         after the children form.

Each checks its arguments (dtype, shape, contiguity, one CUDA device) and
raises on what the kernel does not take; each counts its launches. K5 and
K7 read 16 bytes at a time where their inputs are 16-byte aligned (and, for
K5, the width a multiple of 4), and one value at a time otherwise, with the
same result; the wrapper looks at the pointers rather than assuming. Nothing
here reads from the host, so the chunked runner captures them in its CUDA
graphs: the mip's ticket word and K7's scratch (its tickets and a status
word a tile) are made per device outside a capture (the eager warm-up before
a capture makes them, at the same shapes), each launch leaves them as it
found them, and the level table goes to the kernels by value.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from tracking_sdf_tpu_torch.core.camera import PinholeCamera
from tracking_sdf_tpu_torch.kernels import _build
from tracking_sdf_tpu_torch.kernels._build import aligned16, card_reciprocal

TILE = 8  # zeta mip base tile, pixels
MAX_LEVELS = 24  # csrc/brick_classify.cu kMaxLevels
COMPACT_TILE = 2048  # csrc/brick_classify.cu kCompactTile: K7's flags a tile
SCRATCH_HEAD = 2  # csrc/brick_classify.cu kScratchHead: K7's words before the tiles'
CLASSIFY_THREADS = 128  # csrc/brick_classify.cu kClassifyThreads: K6's threads a block
CLASSIFY_LANE_THREADS = 256  # K6 takes 8 lanes a brick while its threads an SM stay within this

# kernel launches on CUDA tensors
launches_tables = 0  # K5 frame_tables
launches_classify = 0  # K6, every form
launches_compact = 0  # K7, both forms

_FLAT, _SUPER, _CHILDREN = 0, 1, 2
_TABLE_MIP, _TABLE_PIX = 1, 2


@dataclasses.dataclass
class ZetaMip:
    """Min-mip of zeta and max-mip of eta, each level flattened row-major and
    concatenated, plus each level's row-below companion (cell (v+1, u); the
    last row holds the neutral value). ``offsets``/``dims`` locate a level."""

    zeta: torch.Tensor
    zeta_down: torch.Tensor
    eta: torch.Tensor
    eta_down: torch.Tensor
    offsets: List[int]
    dims: List[Tuple[int, int]]


@functools.lru_cache(maxsize=None)
def mip_layout(h: int, w: int) -> Tuple[Tuple[int, ...], Tuple[Tuple[int, int], ...]]:
    """(offsets, dims) of the mip levels of an (h, w) image: level 0 holds
    one cell a TILE x TILE tile, each next level halves (rounding up) until
    one cell is left."""
    dh, dw = -(-h // TILE), -(-w // TILE)
    dims = [(dh, dw)]
    while dh > 1 or dw > 1:
        dh, dw = -(-dh // 2), -(-dw // 2)
        dims.append((dh, dw))
    offsets = np.concatenate([[0], np.cumsum([a * b for a, b in dims])])
    return tuple(int(o) for o in offsets[:-1]), tuple(dims)


@functools.lru_cache(maxsize=None)
def _ticket(device: torch.device) -> torch.Tensor:
    """K5's ticket word on ``device``, 0 between launches: made once, before
    any capture (a CUDA graph's replay must not allocate it)."""
    return torch.zeros(1, dtype=torch.int32, device=device)


_SCRATCH = {}  # device -> K7's scratch buffers, the newest last


def _capturing(device: torch.device) -> bool:
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def compact_scratch(device: torch.device, tiles: int) -> torch.Tensor:
    """K7's scratch on ``device`` for ``tiles`` flag tiles: int64 words, 0
    between launches, [tickets, saturated count] then a status word a tile.
    Made or grown to the largest tile count asked for, never inside a CUDA
    graph capture (the capture's eager warm-up asks for the same shapes
    first). Older buffers stay alive: a captured graph holds their
    addresses."""
    bufs = _SCRATCH.setdefault(torch.device(device), [])
    if bufs and bufs[-1].numel() >= SCRATCH_HEAD + tiles:
        return bufs[-1]
    if _capturing(torch.device(device)):
        raise RuntimeError(f"compact_lists: K7's scratch must grow to {tiles} tiles inside a "
                           "CUDA graph capture; run the same shapes eagerly first")
    bufs.append(torch.zeros(SCRATCH_HEAD + tiles, dtype=torch.int64, device=device))
    return bufs[-1]


def compact_tiles(n: int) -> int:
    """K7's flag tiles for n flags (at least one)."""
    return max(-(-n // COMPACT_TILE), 1)


def _level_table(offsets, dims) -> ctypes.Array:
    """[n, total, off[n], dh[n], dw[n]] as C ints, for the kernels' by-value
    level table."""
    n = len(dims)
    if not 1 <= n <= MAX_LEVELS:
        raise ValueError(f"mip of {n} levels: the kernels take 1 to {MAX_LEVELS}")
    total = offsets[-1] + dims[-1][0] * dims[-1][1]
    vals = [n, total, *offsets, *(d[0] for d in dims), *(d[1] for d in dims)]
    return (ctypes.c_int * len(vals))(*vals)


def _check(what: str, device, **tensors) -> None:
    """Every tensor contiguous on ``device``, a CUDA device."""
    if torch.device(device).type != "cuda":
        raise ValueError(f"{what}: unsupported device {device}")
    for name, x in tensors.items():
        if x is None:
            continue
        if x.device != torch.device(device) or not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous on {device}, got "
                             f"{x.device}, contiguous {x.is_contiguous()}")


def _check_dtype(what: str, name: str, x: torch.Tensor, dtype, shape) -> None:
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{what}: {name} must be {dtype} {tuple(shape)}, got "
                         f"{x.dtype} {tuple(x.shape)}")


def frame_tables(points_cam: torch.Tensor, normals_cam: torch.Tensor,
                 rgb: Optional[torch.Tensor], *, cam: Optional[PinholeCamera] = None,
                 delta: float = 0.0,
                 distance: str = "point_to_plane", share_margin: float = 0.0,
                 mip: bool = True, table: bool = True, fuse_color: bool = False
                 ) -> Tuple[Optional[ZetaMip], Optional[torch.Tensor]]:
    """K5: (ZetaMip or None, pixel table or None) of a frame in one launch.

    ``points_cam``, ``normals_cam`` (H, W, 3) float32 on the card; ``rgb``
    (H, W, 3) float32, read with ``fuse_color``; ``cam`` and ``delta`` are
    needed for the mip only. ``mip``: the zeta / eta mip
    as ``brick._zeta_mip`` computes it (its four arrays views of one (4,
    total) buffer); ``table``: the (H·W, 4 or 8) pixel table of
    ``brick._pixel_table``."""
    global launches_tables
    what = "frame_tables"
    if not (mip or table):
        raise ValueError(f"{what}: asks for neither the mip nor the table")
    if mip and cam is None:
        raise ValueError(f"{what}: the mip needs the camera")
    if distance not in ("point_to_plane", "point_to_point"):
        raise ValueError(f"unknown distance: {distance}")
    if points_cam.dim() != 3 or points_cam.shape[-1] != 3:
        raise ValueError(f"{what}: points must be (H, W, 3), got {tuple(points_cam.shape)}")
    h, w = points_cam.shape[:2]
    color = table and fuse_color
    for name, x in (("points", points_cam), ("normals", normals_cam)) + (
            (("rgb", rgb),) if color else ()):
        if x is None:
            raise ValueError(f"{what}: fuse_color needs rgb")
        _check_dtype(what, name, x, torch.float32, (h, w, 3))
    dev = points_cam.device
    _check(what, dev, points=points_cam, normals=normals_cam, rgb=rgb if color else None)
    offsets, dims = mip_layout(h, w)
    levels = _level_table(offsets, dims)
    total = levels[1]
    buf = torch.empty((4, total), dtype=torch.float32, device=dev) if mip else None
    channels = 8 if color else 4
    pix = torch.empty((h * w, channels), dtype=torch.float32, device=dev) if table else None
    p2p = distance == "point_to_point"
    # the camera and delta only shape the mip
    ray = ((cam.cx, cam.cy, card_reciprocal(cam.fx), card_reciprocal(cam.fy)) if mip
           else (0.0,) * 4)
    vec = w % 4 == 0 and aligned16(points_cam, normals_cam, rgb if color else None)
    rc = _build.library().tsdf_frame_tables(
        points_cam.data_ptr(), normals_cam.data_ptr(), rgb.data_ptr() if color else None,
        pix.data_ptr() if table else None, buf.data_ptr() if mip else None,
        _ticket(dev).data_ptr(), ctypes.addressof(levels), h, w,
        (_TABLE_MIP if mip else 0) | (_TABLE_PIX if table else 0), int(not p2p), channels,
        int(vec), *ray, delta + share_margin if p2p else delta, 0.0 if p2p else share_margin,
        _build.stream_ptr(dev))
    _build.check(rc, what)
    launches_tables += 1
    zm = (ZetaMip(buf[0], buf[1], buf[2], buf[3], list(offsets), list(dims)) if mip
          else None)
    return zm, pix


def classify_lanes(n: int, sms: int) -> int:
    """K6's lanes a brick for a launch over ``n`` bricks on a card of ``sms``
    SMs: 8 where the launch's threads stay within CLASSIFY_LANE_THREADS an
    SM (tum512's 4,096 supers on an H100), else 1."""
    return 8 if n * 8 <= sms * CLASSIFY_LANE_THREADS else 1


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _mip_pointers(what: str, zm: ZetaMip, dev):
    total = zm.offsets[-1] + zm.dims[-1][0] * zm.dims[-1][1]
    arrays = (zm.zeta, zm.zeta_down, zm.eta, zm.eta_down)
    for name, x in zip(("zeta", "zeta_down", "eta", "eta_down"), arrays):
        _check_dtype(what, name, x, torch.float32, (total,))
    _check(what, dev, zeta=zm.zeta, zeta_down=zm.zeta_down, eta=zm.eta, eta_down=zm.eta_down)
    return [x.data_ptr() for x in arrays], _level_table(zm.offsets, zm.dims)


def _pose_pointers(what: str, R: torch.Tensor, base: torch.Tensor, dev):
    _check_dtype(what, "pose.R", R, torch.float32, (3, 3))
    _check_dtype(what, "base", base, torch.float32, (3,))
    _check(what, dev, R=R, base=base)
    return R.data_ptr(), base.data_ptr()


def _classify_launch(form, ptrs, *, sat, mixed_ids, cls, sat_super, gid, grid, bs, i_offset,
                     f, n_slots, ns3, nb, hw, params, cam):
    """One K6 launch over cls's bricks, with classify_lanes' lanes a brick."""
    (zp, levels), (rp, bp) = ptrs
    nbi, nbj, nbk = grid
    m = params.m
    h, w = hw
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    rc = _build.library().tsdf_classify_bricks(
        form, *zp, ctypes.addressof(levels), rp, bp, ptr(sat), ptr(mixed_ids), cls.data_ptr(),
        ptr(sat_super), ptr(gid), nbi, nbj, nbk, *bs, i_offset, f, n_slots,
        ns3[0] * ns3[1] * ns3[2], ns3[1], ns3[2], nb, h, w, params.width / m,
        params.height / m, params.depth / m, *params.origin, cam.fx, cam.fy, cam.cx, cam.cy,
        card_reciprocal(3.0 * TILE),
        classify_lanes(cls.numel(), _sm_count(cls.device.index)), _build.stream_ptr(cls.device))
    _build.check(rc, "classify_bricks")


def classify_bricks(zm: ZetaMip, R: torch.Tensor, base: torch.Tensor, *, params,
                    cam: PinholeCamera, hw, bs, grid, i_offset: int = 0,
                    sat: Optional[torch.Tensor] = None, factor: int = 1
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K6, flat form (``factor`` 1) or super form: (classes, sat_super).

    Classes (nbi·nbj·nbk,) uint8 of the bricks of extent ``bs`` over the
    brick grid ``grid`` = (nbi, nbj, nbk), the first brick layer at global
    voxel i = ``i_offset``. ``R`` is the pose's rotation and ``base`` =
    -(Rᵀ t), (3, 3) and (3,) float32 on the card. Super form: ``bs`` and
    ``grid`` are the supers', ``sat`` the (NB,) bool bits of the fine grid
    (grid × factor); sat_super (NS,) says whether all factor³ children of
    each super are set (None without ``sat``)."""
    global launches_classify
    what = "classify_bricks"
    dev = R.device
    nbi, nbj, nbk = grid
    if min(grid) < 1 or min(bs) < 1 or factor < 1 or i_offset < 0:
        raise ValueError(f"{what}: grid {grid}, brick {bs}, factor {factor}, "
                         f"i_offset {i_offset}")
    n = nbi * nbj * nbk
    if sat is not None:
        _check_dtype(what, "sat", sat, torch.bool, (n * factor ** 3,))
    ptrs = (_mip_pointers(what, zm, dev), _pose_pointers(what, R, base, dev))
    _check(what, dev, sat=sat)
    cls = torch.empty(n, dtype=torch.uint8, device=dev)
    sat_super = torch.empty(n, dtype=torch.bool, device=dev) if sat is not None else None
    _classify_launch(_FLAT if factor == 1 else _SUPER, ptrs,
                     sat=sat if factor > 1 else None, mixed_ids=None, cls=cls,
                     sat_super=sat_super, gid=None, grid=grid, bs=bs, i_offset=i_offset,
                     f=factor, n_slots=0, ns3=(0, 0, 0), nb=n, hw=hw, params=params, cam=cam)
    launches_classify += 1
    return cls, sat_super


def classify_children(zm: ZetaMip, R: torch.Tensor, base: torch.Tensor,
                      mixed_ids: torch.Tensor, *, params, cam: PinholeCamera, hw, bs, grid,
                      i_offset: int = 0, factor: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6, children form: (classes, ids) of the factor³ children of each
    listed super of ``mixed_ids`` (S,) int32 (an id >= NS is a padding
    slot), each (S·factor³,) in (slot, child) order: uint8 classes (0 on a
    padding slot) and int32 global brick ids (NB on a padding slot), over
    the fine grid ``grid`` of bricks ``bs``."""
    global launches_classify
    what = "classify_children"
    dev = R.device
    nbi, nbj, nbk = grid
    f = factor
    if f < 2 or nbi % f or nbj % f or nbk % f:
        raise ValueError(f"{what}: the grid {grid} is not a whole number of supers of "
                         f"factor {f}")
    if mixed_ids.dtype != torch.int32 or mixed_ids.dim() != 1:
        raise ValueError(f"{what}: mixed_ids must be int32 (S,), got {mixed_ids.dtype} "
                         f"{tuple(mixed_ids.shape)}")
    ptrs = (_mip_pointers(what, zm, dev), _pose_pointers(what, R, base, dev))
    _check(what, dev, mixed_ids=mixed_ids)
    n = mixed_ids.shape[0] * f ** 3
    cls = torch.empty(n, dtype=torch.uint8, device=dev)
    gid = torch.empty(n, dtype=torch.int32, device=dev)
    _classify_launch(_CHILDREN, ptrs, sat=None, mixed_ids=mixed_ids, cls=cls,
                     sat_super=None, gid=gid, grid=grid, bs=bs, i_offset=i_offset, f=f,
                     n_slots=mixed_ids.shape[0], ns3=(nbi // f, nbj // f, nbk // f),
                     nb=nbi * nbj * nbk, hw=hw, params=params, cam=cam)
    launches_classify += 1
    return cls, gid


def _check_sizes(what: str, n: int, cap_a: int, cap_b: int) -> None:
    """K7 packs two counts of up to n flags in 31 bits each and indexes its
    lists with C ints."""
    if cap_a < 0 or cap_b < 0:
        raise ValueError(f"{what}: caps {cap_a}, {cap_b}")
    if n >= 2 ** 31 or cap_a + cap_b >= 2 ** 31:
        raise ValueError(f"{what}: {n} flags and caps {cap_a} + {cap_b} must each be below "
                         "2^31")


def compact_lists(cls: torch.Tensor, skip: Optional[torch.Tensor], cap_a: int, cap_b: int,
                  fill: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7, flat form: (ids, counts). ids (cap_a + cap_b,) int32: the indices
    of the first ``cap_a`` FULL entries of ``cls`` ((n,) uint8), then of the
    first ``cap_b`` FREE entries not set in ``skip`` ((n,) bool or None),
    each part padded with ``fill``; counts (4,) int64: n_full, n_free,
    max(n_free - cap_b, 0), 0."""
    global launches_compact
    what = "compact_lists"
    if cls.dtype != torch.uint8 or cls.dim() != 1:
        raise ValueError(f"{what}: cls must be uint8 (n,), got {cls.dtype} "
                         f"{tuple(cls.shape)}")
    if skip is not None:
        _check_dtype(what, "skip", skip, torch.bool, cls.shape)
    n = cls.shape[0]
    _check_sizes(what, n, cap_a, cap_b)
    dev = cls.device
    _check(what, dev, cls=cls, skip=skip)
    scratch = compact_scratch(dev, compact_tiles(n))
    ids = torch.empty(cap_a + cap_b, dtype=torch.int32, device=dev)
    counts = torch.empty(4, dtype=torch.int64, device=dev)
    rc = _build.library().tsdf_compact_lists(
        cls.data_ptr(), None if skip is None else skip.data_ptr(), n, cap_a, cap_b, fill,
        ids.data_ptr(), counts.data_ptr(), scratch.data_ptr(), scratch.numel() - SCRATCH_HEAD,
        int(aligned16(cls, skip)), _build.stream_ptr(dev))
    _build.check(rc, what)
    launches_compact += 1
    return ids, counts


def compact_lists_hier(fcls: torch.Tensor, gid: torch.Tensor, sat: Optional[torch.Tensor],
                       sf_ids: torch.Tensor, super_counts: torch.Tensor, *, cap: int,
                       cap_free: int, cap_mixed: int, grid, factor: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7, hierarchical form: (ids (cap + cap_free,) int32, counts (4,)
    int64) as ``brick.classify_compact_hier_reference`` builds them, from
    K6's children form (``fcls``, ``gid``) over ``cap_mixed`` listed supers,
    the kept FREE supers ``sf_ids`` (cap_sfree,) int32 and the supers'
    counts [n_mixed, n_sf, ...] of K7's flat form, and the fine grid's
    ``sat`` (NB,) bool or None."""
    global launches_compact
    what = "compact_lists_hier"
    f = factor
    vol = f ** 3
    nbi, nbj, nbk = grid
    NB = nbi * nbj * nbk
    cap_sfree = sf_ids.shape[0] if sf_ids.dim() == 1 else 0
    if cap_sfree < 1 or sf_ids.dtype != torch.int32:
        raise ValueError(f"{what}: sf_ids must be int32 (cap_sfree >= 1,), got "
                         f"{sf_ids.dtype} {tuple(sf_ids.shape)}")
    _check_dtype(what, "fcls", fcls, torch.uint8, (cap_mixed * vol,))
    _check_dtype(what, "gid", gid, torch.int32, (cap_mixed * vol,))
    _check_dtype(what, "super_counts", super_counts, torch.int64, (4,))
    if sat is not None:
        _check_dtype(what, "sat", sat, torch.bool, (NB,))
    n = cap_mixed * vol
    _check_sizes(what, n, cap, cap_free)
    dev = fcls.device
    _check(what, dev, fcls=fcls, gid=gid, sat=sat, sf_ids=sf_ids, super_counts=super_counts)
    scratch = compact_scratch(dev, compact_tiles(n))
    ids = torch.empty(cap + cap_free, dtype=torch.int32, device=dev)
    counts = torch.empty(4, dtype=torch.int64, device=dev)
    rc = _build.library().tsdf_compact_lists_hier(
        fcls.data_ptr(), gid.data_ptr(), None if sat is None else sat.data_ptr(),
        sf_ids.data_ptr(), super_counts.data_ptr(), ids.data_ptr(), counts.data_ptr(),
        scratch.data_ptr(), n, cap, cap_free, cap_sfree, cap_mixed, f, nbj // f, nbk // f, nbj,
        nbk, NB, (nbi // f) * (nbj // f) * (nbk // f), scratch.numel() - SCRATCH_HEAD,
        int(aligned16(fcls, gid)), _build.stream_ptr(dev))
    _build.check(rc, what)
    launches_compact += 1
    return ids, counts
