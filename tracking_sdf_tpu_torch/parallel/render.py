"""Ray-sharded raycast rendering over a Mesh (counterpart of
tracking_sdf_tpu.parallel.render).

A ray's samples span the whole volume, so the march is not split by slabs:
each render gathers the grid's leaves from every rank once (one all_gather),
every rank marches its share of the rays to completion on the whole grid,
and a second all_gather assembles the image on every rank. Rays are
interleaved (ray i goes to rank i % n): survivors of the compacted recovery
march cluster at silhouettes, in image rows, and interleaving spreads them
over the ranks' slots. ``two_phase`` is pinned to the full image's ray
count, so each ray runs the program it would run on one device, and the
image equals the single-device render of the gathered grid bit for bit
(where no rank drops a ray). The padding rays that even out the split start
dead (a NaN direction misses the grid's box): they never march and never
count as dropped.
"""
from __future__ import annotations

import torch

from tracking_sdf_tpu_torch.config import GridParams, RaycastConfig
from tracking_sdf_tpu_torch.core.camera import PinholeCamera, pixel_rays
from tracking_sdf_tpu_torch.core.lie import Pose
from tracking_sdf_tpu_torch.grid.grid import FIELDS, TSDFGrid
from tracking_sdf_tpu_torch.parallel.mesh import Mesh
from tracking_sdf_tpu_torch.render.raycast import RenderResult, raycast

# a render's per-ray leaves, packed as float32 columns for the gather
_COLS = (("depth", 1), ("range_t", 1), ("hit", 1), ("normal_world", 3),
         ("normal_cam", 3), ("steps", 1))


def sharded_raycast(mesh: Mesh, *, params: GridParams, cam: PinholeCamera,
                    cfg: RaycastConfig = RaycastConfig(), stride: int = 1,
                    with_color: bool = False):
    """fn(grid_slab, pose) -> RenderResult of the whole image on every rank
    (a collective: every rank calls it), from this rank's dense i-slab
    (TSDFGrid of (slab, m, m) leaves). ``dropped`` is the ranks' sum."""
    n = mesh.size
    mesh.slab(params.m)
    dirs_full, _ = pixel_rays(cam, stride, device=mesh.device)
    Hs, Ws = dirs_full.shape[:2]
    N = Hs * Ws
    if cfg.two_phase == "auto":
        cfg = cfg._replace(two_phase="on" if N >= 4096 else "off")
    n_pad = -(-N // n) * n
    dirs = torch.cat([dirs_full.reshape(N, 3),
                      torch.full((n_pad - N, 3), float("nan"), device=mesh.device)])
    mine = dirs[mesh.rank::n].contiguous()  # ray i -> rank i % n
    leaves = FIELDS if with_color else ("D", "W")
    cols = _COLS + ((("rgb", 3),) if with_color else ())
    width = sum(c for _, c in cols)

    def fn(grid: TSDFGrid, pose: Pose) -> RenderResult:
        every = mesh.all_gather(torch.stack([getattr(grid, k) for k in leaves], dim=1))
        full = {k: every[:, c].contiguous() for c, k in enumerate(leaves)}
        for k in FIELDS:
            full.setdefault(k, full["W"])  # color leaves unread without color
        res = raycast(TSDFGrid(**full), pose, params=params, cam=cam, cfg=cfg,
                      with_color=with_color, dirs_cam=mine[None])
        with torch.no_grad():
            packed = torch.cat([getattr(res, k).reshape(-1, c).to(torch.float32)
                                for k, c in cols], dim=1)
            tail = torch.zeros((1, width), device=packed.device)
            tail[0, 0] = res.dropped
            rows = mesh.all_gather(torch.cat([packed, tail]))
        rows = rows.reshape(n, -1, width)
        dropped = rows[:, -1, 0].sum().to(torch.int32)
        # undo the interleave: rank r's j-th ray is ray j * n + r
        rays = rows[:, :-1].transpose(0, 1).reshape(n_pad, width)[:N]
        out, c0 = {}, 0
        for k, c in cols:
            v = rays[:, c0:c0 + c]
            out[k] = v.reshape(Hs, Ws, 3) if c == 3 else v.reshape(Hs, Ws)
            c0 += c
        return RenderResult(depth=out["depth"], range_t=out["range_t"],
                            hit=out["hit"] > 0, normal_world=out["normal_world"],
                            normal_cam=out["normal_cam"], rgb=out.get("rgb"),
                            steps=out["steps"].to(torch.int32), dropped=dropped)

    return fn
