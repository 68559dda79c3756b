"""The one traffic generator: a synthetic RGB-D camera over an analytic
scene, read from a traffic file (perfbench/traffic/<name>.json).

A frozen copy of the sequence generator of the PyTorch port
(``data/make_sequence.py``: the desk / tabletop / plant scenes, the
handheld sinusoid path, Kinect-like depth noise sigma = noise_k * z^2 and
random dropout), changed in three ways and importing nothing of the port:

* the path's translation and rotation are each scaled so that the mean
  motion between consecutive frames equals the traffic file's
  ``mean_translation_mm`` and ``mean_rotation_deg``;
* frames are rendered in batches on the device, and the noise and the
  dropout are drawn there from a ``torch.Generator`` seeded with the run's
  seed (the path and the scene do not depend on the seed);
* the frames are staged on the device in the TUM wire formats, uint16 depth
  (1/5000 m, 0 = hole, held as int16 bits) and uint8 color, in the order of
  the traversal, so that every chunk of the run is one contiguous slice.

The traversal ``pingpong`` visits 0..N-1, N-2..1, 0.. so that the camera
path stays continuous; its period is 2 (N - 1) positions.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np
import torch

from reference.lie import Pose, compose, se3_exp

# The frame-0 camera pose the generated scenes are authored around (camera z
# along world -y, 1 m up); the port's default initial pose is the same.
POSE0_R = ((1.0, 0.0, 0.0), (0.0, 0.0, -1.0), (0.0, 1.0, 0.0))
POSE0_T = (0.0, 0.0, 1.0)
DEPTH_SCALE = 5000.0  # TUM depth units per meter
RENDER_BATCH = 16  # frames rendered per batch of device ops


def pose0() -> Pose:
    return Pose(torch.tensor(POSE0_R, dtype=torch.float32),
                torch.tensor(POSE0_T, dtype=torch.float32))


# --- scenes ----------------------------------------------------------------------

@dataclasses.dataclass
class Box:
    lo: Tuple[float, float, float]
    hi: Tuple[float, float, float]

    def intersect(self, o, d):
        """Slab-method ray parameter of the first hit, NaN on a miss."""
        lo = torch.tensor(self.lo, dtype=o.dtype, device=o.device)
        hi = torch.tensor(self.hi, dtype=o.dtype, device=o.device)
        safe = torch.where(d == 0, torch.full_like(d, 1e-20), d)
        t0, t1 = (lo - o) / safe, (hi - o) / safe
        tmin = torch.minimum(t0, t1).amax(-1)
        tmax = torch.maximum(t0, t1).amin(-1)
        t = torch.where(tmin > 0, tmin, tmax)
        return torch.where((tmax >= tmin) & (tmax > 0), t, torch.full_like(t, math.nan))

    def color(self, x):
        one = torch.ones_like(x[..., 0])
        return torch.stack([one, 0.3 * one, 0.2 * one], -1)


@dataclasses.dataclass
class Sphere:
    center: Tuple[float, float, float]
    radius: float

    def intersect(self, o, d):
        c = torch.tensor(self.center, dtype=o.dtype, device=o.device)
        oc = o - c
        a = (d * d).sum(-1)
        b = 2.0 * (d * oc).sum(-1)
        cc = (oc * oc).sum(-1) - self.radius ** 2
        disc = b * b - 4.0 * a * cc
        hit = disc >= 0
        sq = torch.sqrt(torch.where(hit, disc, torch.zeros_like(disc)))
        t_near, t_far = (-b - sq) / (2.0 * a), (-b + sq) / (2.0 * a)
        t = torch.where(t_near > 0, t_near, t_far)
        return torch.where(hit & (t > 0), t, torch.full_like(t, math.nan))

    def color(self, x):
        b = torch.clamp(x[..., 0] - float(self.center[0]) + 0.5, 0.0, 1.0)
        return torch.stack([torch.full_like(b, 0.2), torch.full_like(b, 0.3), b], -1)


def build_scene(family: str, room: bool = False) -> List[object]:
    """The objects of a scene family, authored in frame-0 camera coordinates
    (x right, y down, z forward) and mapped to the world by pose 0."""
    R0, t0 = np.asarray(POSE0_R, np.float32), np.asarray(POSE0_T, np.float32)

    def w(p):
        return R0 @ np.asarray(p, np.float32) + t0

    def box(lo, hi):
        a, b = w(lo), w(hi)
        return Box(tuple(np.minimum(a, b).tolist()), tuple(np.maximum(a, b).tolist()))

    def sph(c, r):
        return Sphere(tuple(w(c).tolist()), r)

    objects = [box((-4.0, 0.85, -0.5), (4.0, 1.05, 4.0)),   # floor
               box((-4.0, -2.0, 2.6), (4.0, 1.05, 2.9))]    # back wall
    if family == "desk":
        objects += [
            box((-0.65, 0.40, 1.25), (0.55, 0.85, 2.00)),   # desk top
            box((-0.45, -0.12, 1.80), (0.15, 0.28, 1.86)),  # monitor panel
            box((-0.20, 0.28, 1.80), (-0.10, 0.40, 1.88)),  # monitor foot
            box((-0.30, 0.355, 1.40), (0.12, 0.40, 1.62)),  # keyboard
            box((0.25, 0.22, 1.70), (0.45, 0.40, 1.92)),    # book stack
            box((0.24, 0.10, 1.72), (0.44, 0.22, 1.90)),    # top book
            sph((-0.50, 0.34, 1.55), 0.06),                 # mug
            sph((0.18, 0.34, 1.48), 0.05),                  # mug 2
            box((-0.58, 0.28, 1.78), (-0.46, 0.40, 1.90)),  # box clutter
            box((0.02, 0.30, 1.94), (0.14, 0.40, 2.00)),    # box clutter 2
            sph((-0.05, 0.30, 1.70), 0.10),                 # ball
        ]
    elif family == "tabletop":
        objects += [box((-0.55, 0.35, 1.30), (0.45, 0.85, 1.95)),
                    box((-0.30, 0.05, 1.45), (0.00, 0.35, 1.75)),
                    sph((0.45, 0.10, 1.60), 0.25), sph((-0.55, 0.45, 1.05), 0.18)]
    else:
        raise ValueError(f"unknown scene family {family!r}")
    if room:
        objects += [box((-2.7, -2.0, -0.5), (-2.5, 1.05, 4.0)),
                    box((2.5, -2.0, -0.5), (2.7, 1.05, 4.0)),
                    box((-4.0, -1.5, -0.5), (4.0, -1.3, 4.0)),
                    box((-4.0, -2.0, -1.4), (4.0, 1.05, -1.2))]
    return objects


# --- the camera path ---------------------------------------------------------------

def sinusoid_twists(n: int) -> np.ndarray:
    """(n - 1, 6) float64 twists between consecutive frames of the port's
    handheld path (several sinusoids; smooth, never of constant velocity)."""
    s = 2.0 * np.pi * np.arange(1, n, dtype=np.float64)
    return np.stack([
        0.009 * np.sin(s / 90) + 0.003 * np.sin(s / 17),
        0.006 * np.cos(s / 70) + 0.002 * np.sin(s / 23),
        0.005 * np.sin(s / 55) + 0.002 * np.cos(s / 13),
        0.004 * np.cos(s / 80) + 0.0015 * np.sin(s / 19),
        -0.006 * np.sin(s / 90) - 0.002 * np.sin(s / 29),
        0.003 * np.sin(s / 60),
    ], axis=-1)


def scaled_twists(n: int, mean_translation_m: float, mean_rotation_rad: float) -> np.ndarray:
    """The path's twists with rotation and translation scaled so that the
    mean angle and the mean translation between consecutive frames (of the
    exact relative motions se3_exp(xi)) equal the targets."""
    xi = sinusoid_twists(n)
    w = xi[:, 3:] * (mean_rotation_rad / np.linalg.norm(xi[:, 3:], axis=1).mean())
    v = xi[:, :3]
    rel = se3_exp(torch.from_numpy(np.concatenate([v, w], 1)))
    v = v * (mean_translation_m / rel.t.norm(dim=-1).mean().item())
    return np.concatenate([v, w], 1)


def camera_path(traffic: dict) -> List[Pose]:
    """The N camera-to-world poses (float32, on the CPU) of a traffic file."""
    m = traffic["motion"]
    if m["path"] != "sinusoid":
        raise ValueError(f"unknown path {m['path']!r}")
    xi = scaled_twists(traffic["frames"], m["mean_translation_mm"] * 1e-3,
                       math.radians(m["mean_rotation_deg"]))
    poses = [pose0()]
    for x in torch.from_numpy(xi.astype(np.float32)):
        poses.append(compose(poses[-1], se3_exp(x)))
    return poses


def traversal(n: int, length: int, kind: str = "pingpong") -> np.ndarray:
    """Frame index at each of ``length`` traversal positions."""
    if kind != "pingpong":
        raise ValueError(f"unknown traversal {kind!r}")
    p = np.arange(length) % (2 * (n - 1))
    return np.where(p < n, p, 2 * (n - 1) - p)


# --- rendering and staging ---------------------------------------------------------

def _intersect(objects, o, d):
    """(t, index of the first object hit); NaN t where every object misses."""
    ts = torch.stack([ob.intersect(o, d) for ob in objects])
    idx = torch.argmin(torch.where(torch.isnan(ts), math.inf, ts), dim=0)
    return torch.gather(ts, 0, idx[None])[0], idx


def _colors(objects, pts, idx):
    cols = torch.stack([ob.color(pts) for ob in objects])
    return torch.gather(cols, 0, idx[None, ..., None].expand(1, *idx.shape, 3))[0]


def render(objects, cam: dict, R: torch.Tensor, t: torch.Tensor):
    """Exact z-depth (B, H, W) and color (B, H, W, 3) of B poses."""
    dev = R.device
    h, w = cam["height"], cam["width"]
    v = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    u = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    dirs = torch.stack([((u - cam["cx"]) / cam["fx"]).expand(h, w),
                        ((v - cam["cy"]) / cam["fy"]).expand(h, w),
                        torch.ones(h, w, device=dev)], -1)  # z == 1: t is the depth
    d = (dirs[None, ..., 0:1] * R[:, None, None, :, 0] + dirs[None, ..., 1:2] * R[:, None, None, :, 1]
         + dirs[None, ..., 2:3] * R[:, None, None, :, 2])
    o = t[:, None, None, :].expand(d.shape)
    z, idx = _intersect(objects, o, d)
    return z, torch.clamp(_colors(objects, o + z[..., None] * d, idx), 0.0, 1.0)


@dataclasses.dataclass
class Sequence:
    """A staged sequence: ``depth`` (T, H, W) int16 bits of TUM uint16 depth
    and ``rgb`` (T, H, W, 3) uint8, both in traversal order on the device;
    ``frame`` (T,) the frame index at each position; ``poses`` the N true
    camera poses; ``period`` 2 (N - 1)."""

    depth: torch.Tensor
    rgb: torch.Tensor
    frame: np.ndarray
    poses: List[Pose]
    period: int

    def chunk(self, j: int, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The n frames from traversal position j on, as contiguous views."""
        s = j % self.period
        return self.depth[s:s + n], self.rgb[s:s + n]


def generate(traffic: dict, cam: dict, seed: int, device, chunk: int) -> Sequence:
    """Render the traffic's N frames on ``device`` with noise drawn there
    from ``seed``, then stage them in traversal order (period + chunk
    positions, so that any chunk is one slice)."""
    dev = torch.device(device)
    n = traffic["frames"]
    objects = build_scene(traffic["scene"], traffic.get("room", False))
    poses = camera_path(traffic)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    noise_k, dropout = traffic["noise_k"], traffic["dropout"]
    depth16 = torch.empty((n, cam["height"], cam["width"]), dtype=torch.int16, device=dev)
    rgb8 = torch.empty((n, cam["height"], cam["width"], 3), dtype=torch.uint8, device=dev)
    R = torch.stack([p.R for p in poses]).to(dev)
    t = torch.stack([p.t for p in poses]).to(dev)
    for b0 in range(0, n, RENDER_BATCH):
        sl = slice(b0, min(b0 + RENDER_BATCH, n))
        z, rgb = render(objects, cam, R[sl], t[sl])
        if noise_k > 0:
            z = z + noise_k * z * z * torch.randn(z.shape, generator=gen, device=dev)
        if dropout > 0:
            z = torch.where(torch.rand(z.shape, generator=gen, device=dev) < dropout,
                            math.nan, z)
        raw = torch.nan_to_num(torch.round(z * DEPTH_SCALE), nan=0.0).clamp(0, 65535)
        depth16[sl] = raw.to(torch.int32).to(torch.int16)  # the low 16 bits
        rgb8[sl] = (rgb * 255.0).clamp(0, 255).to(torch.uint8)  # truncated, as TUM PNGs
    period = 2 * (n - 1)
    frame = traversal(n, period + chunk, traffic.get("traversal", "pingpong"))
    idx = torch.from_numpy(frame).to(dev)
    return Sequence(depth16.index_select(0, idx), rgb8.index_select(0, idx), frame, poses,
                    period)
