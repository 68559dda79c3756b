"""TSDF voxel grid and world<->voxel maps (counterpart of tracking_sdf_tpu.grid.grid).

Six dense (m, m, m) float32 tensors indexed [i=x, j=y, k=z], k fastest —
the reference's row-major layout. D is positive in free space.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from tracking_sdf_tpu_torch.config import GridParams

FIELDS = ("D", "W", "R", "G", "B", "Wc")


@dataclasses.dataclass
class TSDFGrid:
    """Dense (m, m, m) leaves. Fusion updates them in place."""

    D: torch.Tensor  # truncated signed distance, meters, +free space
    W: torch.Tensor  # fusion weight; W == 0 means never observed
    R: torch.Tensor  # color in [0, 1]
    G: torch.Tensor
    B: torch.Tensor
    Wc: torch.Tensor  # color fusion weight


def empty_grid(params: GridParams, *, device, mi: Optional[int] = None) -> TSDFGrid:
    """Fresh grid: D = width+height+depth (far free space), W = 0, grey color.
    ``mi``: only an i-slab of that many planes (default m)."""
    shape = (params.m if mi is None else mi, params.m, params.m)
    far = params.width + params.height + params.depth

    def full(v):
        return torch.full(shape, v, dtype=torch.float32, device=device)

    return TSDFGrid(D=full(far), W=full(0.0), R=full(0.4), G=full(0.4),
                    B=full(0.4), Wc=full(0.0))


def grid_from_numpy(arrays: Mapping[str, object], *, device, mesh=None) -> TSDFGrid:
    """TSDFGrid from a mapping of the six leaves to array-likes (for example
    ``jax_grid._asdict()``). The leaves are copies. With ``mesh``
    (parallel.mesh.Mesh) only this rank's i-slab of the full grid is kept."""
    def leaf(k):
        a = np.asarray(arrays[k], np.float32)
        if mesh is not None:
            a = a[mesh.rows(a.shape[0])]
        return torch.tensor(a, device=device)

    return TSDFGrid(**{k: leaf(k) for k in FIELDS})


def grid_to_numpy(grid: TSDFGrid) -> Dict[str, np.ndarray]:
    return {k: getattr(grid, k).detach().cpu().numpy() for k in FIELDS}


def _axis_consts(values, like: torch.Tensor) -> torch.Tensor:
    return _device_consts(tuple(values), like.device)


@functools.lru_cache(maxsize=None)
def _device_consts(values: tuple, device: torch.device) -> torch.Tensor:
    """A float32 constant on ``device``, copied there once: a copy from the
    host waits for the device, which a loop of small ops must not do."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def world_to_voxel(params: GridParams, x: torch.Tensor) -> torch.Tensor:
    """World points (..., 3) -> continuous voxel coords (..., 3).

    i = (x - origin_x) * m/width - 0.5: voxel centers land on integers."""
    origin = _axis_consts(params.origin, x)
    scale = _axis_consts([params.m / params.width, params.m / params.height,
                          params.m / params.depth], x)
    return (x - origin) * scale - 0.5


def voxel_to_world(params: GridParams, ijk: torch.Tensor) -> torch.Tensor:
    """Voxel coords (..., 3) -> world coords of voxel centers."""
    origin = _axis_consts(params.origin, ijk)
    vsize = _axis_consts([params.width / params.m, params.height / params.m,
                          params.depth / params.m], ijk)
    return vsize * (ijk + 0.5) + origin


def voxel_centers_world(params: GridParams, *, device, i_offset: int = 0,
                        mi: Optional[int] = None):
    """World coordinates of the voxel centers as three tensors broadcastable
    to (mi, m, m): x (mi,1,1), y (1,m,1), z (1,1,m). ``i_offset`` / ``mi``
    address an i-slab (parallel.sharded): local plane 0 is global voxel i =
    i_offset, and the slab holds ``mi`` planes (default m)."""
    m = params.m
    mi = m if mi is None else mi
    idx = torch.arange(m, dtype=torch.float32, device=device)
    ii = torch.arange(mi, dtype=torch.float32, device=device) + float(i_offset)
    ox, oy, oz = params.origin
    x = (params.width / m) * (ii + 0.5) + ox
    y = (params.height / m) * (idx + 0.5) + oy
    z = (params.depth / m) * (idx + 0.5) + oz
    return x.view(mi, 1, 1), y.view(1, m, 1), z.view(1, 1, m)
