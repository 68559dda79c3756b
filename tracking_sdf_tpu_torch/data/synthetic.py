"""Analytic scenes, exact depth rendering and analytic grids (counterpart of
tracking_sdf_tpu.data.synthetic): frames and grids made on the device from a
pose or a scene, with no dataset. A scene's ``sdf`` is positive outside."""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from tracking_sdf_tpu_torch.config import GridParams
from tracking_sdf_tpu_torch.core.camera import PinholeCamera, pixel_rays
from tracking_sdf_tpu_torch.core.lie import Pose
from tracking_sdf_tpu_torch.grid.grid import TSDFGrid, voxel_centers_world

_NAN = float("nan")


class SphereScene(NamedTuple):
    """Sphere of ``radius`` at ``center``; its color is a blue gradient along x."""

    center: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    radius: float = 0.5

    def sdf(self, x: torch.Tensor) -> torch.Tensor:
        c = torch.tensor(self.center, dtype=x.dtype, device=x.device)
        return torch.linalg.norm(x - c, dim=-1) - self.radius

    def color(self, x: torch.Tensor) -> torch.Tensor:
        b = torch.clamp(x[..., 0] - float(self.center[0]) + 0.5, 0.0, 1.0)
        return torch.stack([torch.full_like(b, 0.2), torch.full_like(b, 0.3), b], dim=-1)

    def intersect(self, origins: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
        """Ray parameter t of the first hit (hit = origins + t * dirs); NaN
        on a miss. From inside the sphere the far root is the hit."""
        c = torch.tensor(self.center, dtype=origins.dtype, device=origins.device)
        oc = origins - c
        a = (dirs * dirs).sum(-1)
        b = 2.0 * (dirs * oc).sum(-1)
        cc = (oc * oc).sum(-1) - self.radius ** 2
        disc = b * b - 4.0 * a * cc
        hit = disc >= 0
        sq = torch.sqrt(torch.where(hit, disc, torch.zeros_like(disc)))
        t_near = (-b - sq) / (2.0 * a)
        t_far = (-b + sq) / (2.0 * a)
        t = torch.where(t_near > 0, t_near, t_far)
        return torch.where(hit & (t > 0), t, torch.full_like(t, _NAN))


class CuboidScene(NamedTuple):
    min_corner: Tuple[float, float, float] = (-0.5, -0.5, -0.5)
    max_corner: Tuple[float, float, float] = (0.5, 0.5, 0.5)

    def _bounds(self, x: torch.Tensor):
        return (torch.tensor(self.min_corner, dtype=x.dtype, device=x.device),
                torch.tensor(self.max_corner, dtype=x.dtype, device=x.device))

    def sdf(self, x: torch.Tensor) -> torch.Tensor:
        """The exact box SDF."""
        lo, hi = self._bounds(x)
        q = torch.abs(x - (lo + hi) / 2.0) - (hi - lo) / 2.0
        outside = torch.linalg.norm(torch.clamp(q, min=0.0), dim=-1)
        inside = torch.clamp(q.amax(dim=-1), max=0.0)
        return outside + inside

    def sdf_reference_style(self, x: torch.Tensor) -> torch.Tensor:
        """The reference fixture's field: the distance to the nearest pair of
        parallel faces, negated inside."""
        lo, hi = self._bounds(x)
        d = torch.minimum(torch.abs(x - lo), torch.abs(x - hi)).amin(dim=-1)
        inside = ((x > lo) & (x < hi)).all(dim=-1)
        return torch.where(inside, -d, d)

    def color(self, x: torch.Tensor) -> torch.Tensor:
        ones = torch.ones_like(x[..., 0])
        return torch.stack([ones, 0.3 * ones, 0.2 * ones], dim=-1)

    def intersect(self, origins: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
        """Slab-method ray-box intersection (NaN on a miss)."""
        lo = torch.tensor(self.min_corner, dtype=origins.dtype, device=origins.device)
        hi = torch.tensor(self.max_corner, dtype=origins.dtype, device=origins.device)
        safe_d = torch.where(dirs == 0, torch.full_like(dirs, 1e-20), dirs)
        t0 = (lo - origins) / safe_d
        t1 = (hi - origins) / safe_d
        tmin = torch.minimum(t0, t1).amax(-1)
        tmax = torch.maximum(t0, t1).amin(-1)
        hit = (tmax >= tmin) & (tmax > 0)
        t = torch.where(tmin > 0, tmin, tmax)
        return torch.where(hit, t, torch.full_like(t, _NAN))


def grid_from_scene(params: GridParams, scene, weight: float = 1.0,
                    reference_style: bool = False, *, device) -> TSDFGrid:
    """A grid holding the scene's full (untruncated) signed distance and its
    color at the voxel centers, with W = Wc = ``weight`` everywhere."""
    x, y, z = voxel_centers_world(params, device=device)
    pts = torch.stack(torch.broadcast_tensors(x, y, z), dim=-1)
    sdf_fn = (scene.sdf_reference_style
              if reference_style and hasattr(scene, "sdf_reference_style") else scene.sdf)
    D = sdf_fn(pts)
    rgb = scene.color(pts)
    W = torch.full(D.shape, weight, dtype=D.dtype, device=device)
    return TSDFGrid(D=D, W=W, R=rgb[..., 0].contiguous(), G=rgb[..., 1].contiguous(),
                    B=rgb[..., 2].contiguous(), Wc=W.clone())


def render_scene_depth(scene, cam: PinholeCamera, pose: Pose) -> torch.Tensor:
    """Exact (H, W) z-depth image of the scene from ``pose``; misses are NaN.
    Rays have camera z = 1, so the ray parameter is the z-depth."""
    dirs_cam, _ = pixel_rays(cam, device=pose.R.device)
    dirs_world = torch.einsum("ij,hwj->hwi", pose.R, dirs_cam)
    origins = pose.t.expand(dirs_world.shape)
    return scene.intersect(origins, dirs_world)


def look_at(eye, target, up=(0.0, 0.0, 1.0), *, device) -> Pose:
    """Camera-to-world pose with the optical axis (+z, y down) toward ``target``."""
    def vec(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    eye, target, up = vec(eye), vec(target), vec(up)
    f = target - eye
    f = f / torch.linalg.norm(f)
    x = torch.linalg.cross(f, up)
    x = x / torch.linalg.norm(x)
    y = torch.linalg.cross(f, x)
    return Pose(torch.stack([x, y, f], dim=-1), eye)


def orbit_poses(n: int, radius: float, height: float, target=(0.0, 0.0, 0.0),
                arc: float = 2.0 * 3.14159265358979, *, device) -> list:
    """``n`` poses orbiting ``target`` on a circle of ``radius`` at ``height``
    above it, each looking at it: a trajectory with exact groundtruth."""
    poses = []
    for ang in np.linspace(0.0, arc, n, endpoint=False):
        eye = (target[0] + radius * np.cos(ang), target[1] + radius * np.sin(ang),
               target[2] + height)
        poses.append(look_at(eye, target, device=device))
    return poses
