"""Generate a TUM-layout RGB-D sequence on disk from a synthetic scene
(counterpart of tracking_sdf_tpu.data.make_sequence).

A multi-object scene is rendered along a handheld-like 6-DoF trajectory to
16-bit depth PNGs (meters * 5000, the TUM convention), 8-bit RGB PNGs, the
depth.txt / rgb.txt listings and groundtruth.txt, and is then replayed
through the real ingestion chain (native PNG loader, TUMDataset, runner,
trajectory writer, ATE) with
``python -m tracking_sdf_tpu_torch.cli --dataset DIR --eval``.

The world frame is chosen so that frame 0's camera pose is the runner's
REFERENCE_INITIAL_POSE: the scene then lies inside the tum256 / tum512 grid
volume as a real fr1 sequence would, with nothing to align.

Depth gets a Kinect-like quadratic noise, sigma = noise_k * z^2 (about 1.5 mm
at 1 m and 9 mm at 2.5 m), and random dropout holes; RGB is the scenes'
analytic color. Rendering runs on ``device``; the trajectory is computed on
the CPU, and every random draw comes from ``np.random.default_rng(seed)`` in
the JAX package's order (the patch walkers, then per frame: flying pixels,
patches, exposure, noise, dropout, burst), so one seed gives one noise field
in both packages and on every device. Usage:

    python -m tracking_sdf_tpu_torch.data.make_sequence --out DIR --frames 120
"""
from __future__ import annotations

import argparse
import sys
from typing import List

import numpy as np
import torch

from tracking_sdf_tpu_torch.core.camera import PinholeCamera, pixel_rays, tum_fr1_camera
from tracking_sdf_tpu_torch.core.lie import (
    Pose, matrix_from_quaternion, pose_compose, pose_inverse, quaternion_from_matrix,
    se3_exp)
from tracking_sdf_tpu_torch.data.synthetic import CuboidScene, SphereScene
from tracking_sdf_tpu_torch.data.tum import write_synthetic_tum
from tracking_sdf_tpu_torch.pipeline.runner import REFERENCE_INITIAL_POSE


class _Scene:
    """Union of objects; the color follows the object hit first."""

    def __init__(self, objects):
        self.objects = objects

    def intersect(self, o, d):
        """Ray parameter of the nearest hit of any object; NaN where all miss."""
        ts = torch.stack([ob.intersect(o, d) for ob in self.objects])
        miss = torch.isnan(ts)
        t = torch.where(miss, float("inf"), ts).amin(dim=0)
        return torch.where(miss.all(dim=0), float("nan"), t)

    def intersect_argmin(self, o, d):
        """(t, index of the object hit first); ties take the first object,
        and where all miss t is NaN."""
        ts = torch.stack([ob.intersect(o, d) for ob in self.objects])
        idx = torch.argmin(torch.where(torch.isnan(ts), float("inf"), ts), dim=0)
        return torch.gather(ts, 0, idx[None])[0], idx

    def color_at(self, pts, idx):
        cols = torch.stack([ob.color(pts) for ob in self.objects])
        return torch.gather(cols, 0, idx[None, ..., None].expand(1, *idx.shape, 3))[0]


def _build(width: int, height: int, room: bool = False,
           cluster_shift=(0.0, 0.0, 0.0), cluster_scale: float = 1.0,
           scene_family: str = "tabletop"):
    """(scene, cam, pose0). The geometry is authored in frame-0 camera
    coordinates (x right, y down, z forward) and mapped to the world with
    REFERENCE_INITIAL_POSE. ``room=True`` closes the box (side walls, ceiling
    and a wall behind the camera, inside the grid volume), so that any
    camera orientation sees geometry: needed when replaying real handheld
    trajectories that look all around. ``cluster_shift`` / ``cluster_scale``
    move and scale the object cluster (not the room) in world coordinates: a
    real orbit circles around its subject, so the cluster must sit at the
    orbit's look-at centre (see _fit_cluster).

    ``scene_family`` selects the cluster:
      * "tabletop": a table, a cube and two spheres;
      * "desk": cluttered desk-scale geometry: monitor slab, book stack,
        keyboard, mugs, small boxes;
      * "plant": thin structure: a potted plant with sphere-chain stems and
        thin-slab leaves (depth shadows at every silhouette)."""
    pose0 = REFERENCE_INITIAL_POSE
    R0 = pose0.R.numpy()
    t0 = pose0.t.numpy()

    def w(p):  # camera-0 point -> world
        return R0 @ np.asarray(p, np.float32) + t0

    def box(lo, hi):
        a, b = w(lo), w(hi)
        return CuboidScene(tuple(np.minimum(a, b)), tuple(np.maximum(a, b)))

    sh = np.asarray(cluster_shift, np.float32)
    sc = float(cluster_scale)
    ctr = w((0.0, 0.45, 1.6))  # cluster reference point (about the table's centre)

    def cbox(lo, hi):  # cluster box: shifted in the world, scaled about ctr
        a = (w(lo) - ctr) * sc + ctr + sh
        b = (w(hi) - ctr) * sc + ctr + sh
        return CuboidScene(tuple(np.minimum(a, b)), tuple(np.maximum(a, b)))

    def csph(c, r):
        return SphereScene(center=tuple((w(c) - ctr) * sc + ctr + sh), radius=r * sc)

    def chain(p0, p1, n, r0_, r1_):
        """n spheres along the segment p0->p1, the radius going r0_->r1_."""
        a, b = np.asarray(p0, np.float32), np.asarray(p1, np.float32)
        return [csph(tuple(a + (b - a) * (i / max(n - 1, 1))),
                     r0_ + (r1_ - r0_) * (i / max(n - 1, 1)))
                for i in range(n)]

    objects = [
        # the floor (camera-down y = +0.85) and the back wall (z = 2.6)
        box((-4.0, 0.85, -0.5), (4.0, 1.05, 4.0)),
        box((-4.0, -2.0, 2.6), (4.0, 1.05, 2.9)),
    ]
    if scene_family == "tabletop":
        objects += [
            cbox((-0.55, 0.35, 1.30), (0.45, 0.85, 1.95)),   # table
            cbox((-0.30, 0.05, 1.45), (0.00, 0.35, 1.75)),   # cube on it
            csph((0.45, 0.10, 1.60), 0.25),
            csph((-0.55, 0.45, 1.05), 0.18),
        ]
    elif scene_family == "desk":
        objects += [
            cbox((-0.65, 0.40, 1.25), (0.55, 0.85, 2.00)),   # desk top
            cbox((-0.45, -0.12, 1.80), (0.15, 0.28, 1.86)),  # monitor panel
            cbox((-0.20, 0.28, 1.80), (-0.10, 0.40, 1.88)),  # monitor foot
            cbox((-0.30, 0.355, 1.40), (0.12, 0.40, 1.62)),  # keyboard
            cbox((0.25, 0.22, 1.70), (0.45, 0.40, 1.92)),    # book stack
            cbox((0.24, 0.10, 1.72), (0.44, 0.22, 1.90)),    # top book
            csph((-0.50, 0.34, 1.55), 0.06),                 # mug
            csph((0.18, 0.34, 1.48), 0.05),                  # mug 2
            cbox((-0.58, 0.28, 1.78), (-0.46, 0.40, 1.90)),  # box clutter
            cbox((0.02, 0.30, 1.94), (0.14, 0.40, 2.00)),    # box clutter 2
            csph((-0.05, 0.30, 1.70), 0.10),                 # ball
        ]
    elif scene_family == "plant":
        objects += [
            cbox((-0.20, 0.55, 1.45), (0.20, 0.85, 1.85)),   # stand
            cbox((-0.14, 0.38, 1.51), (0.14, 0.58, 1.79)),   # pot
        ]
        top = np.asarray((0.0, 0.40, 1.65), np.float32)
        objects += chain(top, (0.0, -0.25, 1.65), 9, 0.035, 0.02)  # trunk
        for (dx, dz, hy) in ((0.28, 0.10, -0.05), (-0.30, 0.05, -0.10),
                             (0.15, -0.22, -0.15), (-0.12, 0.25, -0.02),
                             (0.05, 0.28, -0.18), (-0.25, -0.18, -0.12)):
            tip = (top[0] + dx, hy, top[2] + dz)
            objects += chain((0.0, 0.15, 1.65), tip, 6, 0.022, 0.012)
            # a leaf slab at the stem's tip (axis-aligned thin box)
            objects.append(cbox(
                (tip[0] - 0.09, tip[1] - 0.012, tip[2] - 0.07),
                (tip[0] + 0.09, tip[1] + 0.012, tip[2] + 0.07)))
    else:
        raise ValueError(f"unknown scene family: {scene_family!r}")
    if room:
        objects += [
            box((-2.7, -2.0, -0.5), (-2.5, 1.05, 4.0)),   # left wall
            box((2.5, -2.0, -0.5), (2.7, 1.05, 4.0)),     # right wall
            box((-4.0, -1.5, -0.5), (4.0, -1.3, 4.0)),    # ceiling
            box((-4.0, -2.0, -1.4), (4.0, 1.05, -1.2)),   # wall behind the camera
        ]

    cam = tum_fr1_camera()
    if (width, height) != (cam.width, cam.height):
        s = width / cam.width
        cam = PinholeCamera(fx=cam.fx * s, fy=cam.fy * s, cx=cam.cx * s, cy=cam.cy * s,
                            width=width, height=height)
    return _Scene(objects), cam, pose0


def _trajectory(pose0: Pose, n_frames: int) -> List[Pose]:
    """Handheld-like 6-DoF path: twist increments of several sinusoids (about
    12 mm and 0.5 degrees a frame), smooth but never of constant velocity."""
    poses = [pose0]
    for k in range(1, n_frames):
        s = 2.0 * np.pi * k
        xi = np.asarray([
            0.009 * np.sin(s / 90) + 0.003 * np.sin(s / 17),   # x sweep
            0.006 * np.cos(s / 70) + 0.002 * np.sin(s / 23),   # y bob
            0.005 * np.sin(s / 55) + 0.002 * np.cos(s / 13),   # z push
            0.004 * np.cos(s / 80) + 0.0015 * np.sin(s / 19),  # pitch
            -0.006 * np.sin(s / 90) - 0.002 * np.sin(s / 29),  # yaw (against the sweep)
            0.003 * np.sin(s / 60),                            # roll
        ], np.float32)
        poses.append(pose_compose(poses[-1], se3_exp(torch.from_numpy(xi))))
    return poses


def _trajectory_from_file(pose0: Pose, path: str, n_frames: int, fps: float = 30.0,
                          start_s: float = 0.0) -> List[Pose]:
    """Resample a TUM groundtruth trajectory file (timestamp tx ty tz qx qy
    qz qw) at ``fps`` and re-anchor it so that frame 0 sits at ``pose0``:
    T'_k = pose0 ∘ (T_0^-1 ∘ T_k). Real handheld motion over the synthetic
    scene."""
    with open(path) as f:
        rows = [line.split() for line in f if line.strip() and not line.startswith("#")]
    ts = np.asarray([float(r[0]) for r in rows])
    tr = np.asarray([[float(v) for v in r[1:4]] for r in rows])
    qu = np.asarray([[float(v) for v in r[4:8]] for r in rows])
    want = ts[0] + start_s + np.arange(n_frames) / fps
    if want[-1] > ts[-1]:
        raise SystemExit(
            f"--trajectory-file spans {ts[-1] - ts[0]:.1f} s; {n_frames} frames at "
            f"{fps} fps from +{start_s:.1f} s need {want[-1] - ts[0]:.1f} s")
    raw = [Pose(matrix_from_quaternion(torch.tensor(qu[i], dtype=torch.float32)),
                torch.tensor(tr[i], dtype=torch.float32))
           for i in np.searchsorted(ts, want)]
    anchor = pose_compose(pose0, pose_inverse(raw[0]))
    return [pose_compose(anchor, p) for p in raw]


def _fit_cluster(poses, look_dist: float = 1.0, clearance: float = 0.2):
    """(cluster_shift, cluster_scale) that put the object cluster at the
    trajectory's median look-at point, median(t_k + look_dist * R_k z), and
    shrink it until every camera position keeps ``clearance`` meters from
    its bounding sphere: a cluster ahead of frame 0 would lie on the path
    of a camera that orbits."""
    t = np.stack([p.t.numpy() for p in poses])
    z = np.stack([p.R.numpy()[:, 2] for p in poses])
    target = np.median(t + look_dist * z, axis=0)
    ctr0 = np.asarray([0.0, -1.6, 1.45], np.float32)  # the unshifted centre
    shift = (target - ctr0).astype(np.float32)
    r0 = 0.8  # the cluster's bounding radius (table diagonal about 0.75 m)
    scale = 1.0
    for _ in range(6):
        d = np.linalg.norm(t - target, axis=1).min()
        if d >= r0 * scale + clearance:
            break
        scale *= 0.85
    return tuple(shift), scale


def _ir_shadow_mask(z: np.ndarray, fx: float, baseline: float) -> np.ndarray:
    """Structured-light occlusion shadows (Kinect pathology 1).

    The IR projector sits a stereo baseline to the left of the IR camera (at
    x = -b; Kinect: about 75 mm); surface points hidden from the projector
    get no pattern and no depth. A point at camera column u and depth z maps
    to projector column u_p = u + fx*b/z. Scanning each row left to right, a
    pixel is shadowed when an earlier (smaller u) pixel already claimed a
    projector column >= u_p: for u1 < u2 with u_p1 >= u_p2, c/z1 - c/z2 >=
    u2 - u1 > 0 forces z1 < z2, so the earlier surface is nearer along that
    projector ray. The NaN band lands on the background just right of each
    occluder, fx*b*(1/z_near - 1/z_far) pixels wide."""
    zs = np.where(np.isfinite(z), z, 1e6)
    u = np.arange(z.shape[1], dtype=np.float32)[None, :]
    up = u + fx * baseline / zs
    prior = np.roll(np.maximum.accumulate(up, axis=1), 1, axis=1)
    prior[:, 0] = -np.inf
    return up <= prior - 1e-3


def _flying_pixels(z: np.ndarray, rng, frac: float = 0.6,
                   grad_thresh: float = 0.08) -> np.ndarray:
    """Edge flying pixels (pathology 2): at depth discontinuities the sensor
    returns values interpolated between fore- and background. A random
    ``frac`` of discontinuity pixels get z = a*z_here + (1-a)*z_neighbour,
    a ~ U(0.2, 0.8): points hanging in free space."""
    zf = np.where(np.isfinite(z), z, np.nan)
    out = z.copy()
    for axis, shift in ((1, 1), (1, -1), (0, 1), (0, -1)):
        zn = np.roll(zf, shift, axis=axis)
        # np.roll wraps: mask the line that would compare against the
        # opposite border
        zn_valid = np.ones(z.shape, dtype=bool)
        if axis == 1:
            zn_valid[:, 0 if shift == 1 else -1] = False
        else:
            zn_valid[0 if shift == 1 else -1, :] = False
        edge = zn_valid & (np.abs(zn - zf) > grad_thresh)
        pick = edge & (rng.random(z.shape) < frac / 4.0) \
            & np.isfinite(zf) & np.isfinite(zn)
        a = rng.uniform(0.2, 0.8, size=z.shape).astype(np.float32)
        out = np.where(pick, a * zf + (1.0 - a) * zn, out)
    return out


def _reflective_patches(z: np.ndarray, rng, walkers, step: float = 4.0,
                        radius=(8.0, 26.0)) -> np.ndarray:
    """Reflective or absorbing dropout patches (pathology 3): specular or
    dark materials return no depth over contiguous blobs. ``walkers``
    (changed in place) random-walk the ellipse centres from frame to frame,
    so the patches are coherent in time."""
    H, W = z.shape
    out = z.copy()
    yy, xx = np.mgrid[0:H, 0:W]
    for wk in walkers:
        wk[0] = (wk[0] + rng.normal(0, step)) % H
        wk[1] = (wk[1] + rng.normal(0, step)) % W
        ry = rng.uniform(*radius)
        rx = rng.uniform(*radius)
        mask = (((yy - wk[0]) / ry) ** 2 + ((xx - wk[1]) / rx) ** 2) < 1.0
        out[mask] = np.nan
    return out


def _exposure_rgb(rgb: np.ndarray, k: int, rng) -> np.ndarray:
    """Exposure and white-balance drift (pathology 4): a smoothly varying
    global gain (+-25%) with per-frame flicker and a static vignette."""
    gain = (1.0 + 0.22 * np.sin(k / 19.0) + 0.08 * np.sin(k / 5.3)
            + rng.normal(0, 0.015))
    h, w = rgb.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    r2 = (((yy - h / 2) / (h / 2)) ** 2 + ((xx - w / 2) / (w / 2)) ** 2)
    vignette = (1.0 - 0.18 * r2)[..., None]
    return np.clip(rgb * gain * vignette, 0.0, 1.0).astype(np.float32)


def generate(root: str, n_frames: int = 120, width: int = 640,
             height: int = 480, noise_k: float = 1.5e-3,
             dropout: float = 0.01, seed: int = 0,
             progress: bool = False, trajectory_file: str = None,
             traj_fps: float = 30.0, traj_start: float = 0.0,
             room: bool = False, fit_trajectory: bool = False,
             scene_family: str = "tabletop",
             pathology: bool = False, ir_baseline: float = 0.075,
             n_patches: int = 3, burst=None, *, device) -> dict:
    """Render the sequence on ``device`` and write it under ``root``;
    returns summary stats."""
    device = torch.device(device)
    scene, cam, pose0 = _build(width, height, room=room, scene_family=scene_family)
    if trajectory_file:
        poses = _trajectory_from_file(pose0, trajectory_file, n_frames, traj_fps,
                                      traj_start)
        if fit_trajectory:
            shift, scale = _fit_cluster(poses)
            if progress:
                print(f"  cluster fit: shift {np.round(shift, 2)}, scale {scale:.2f}",
                      file=sys.stderr)
            scene, cam, pose0 = _build(width, height, room=room, cluster_shift=shift,
                                       cluster_scale=scale, scene_family=scene_family)
    else:
        poses = _trajectory(pose0, n_frames)

    dirs_cam, _ = pixel_rays(cam, device=device)  # (H, W, 3), z == 1: t is the z-depth

    def render(pose: Pose):
        R, t = pose.R.to(device), pose.t.to(device)
        # three exact float32 products and sums per component
        d_world = (dirs_cam[..., 0:1] * R[:, 0] + dirs_cam[..., 1:2] * R[:, 1]
                   + dirs_cam[..., 2:3] * R[:, 2])
        origins = t.expand(d_world.shape)
        z, idx = scene.intersect_argmin(origins, d_world)
        pts = origins + z[..., None] * d_world
        return z, scene.color_at(pts, idx)

    rng = np.random.default_rng(seed)
    depths, rgbs, gts = [], [], []
    min_valid = 1.0
    # the reflective patches' centres, coherent over time (pathology mode)
    walkers = [[rng.uniform(0, height), rng.uniform(0, width)] for _ in range(n_patches)]
    for i, pose in enumerate(poses):
        z, rgb = render(pose)
        z = z.cpu().numpy()
        rgb = np.clip(rgb.cpu().numpy(), 0.0, 1.0)
        if pathology:
            z = _flying_pixels(z, rng)
            z[_ir_shadow_mask(z, cam.fx, ir_baseline)] = np.nan
            z = _reflective_patches(z, rng, walkers)
            rgb = _exposure_rgb(rgb, i, rng)
        if noise_k > 0:
            z = z + (noise_k * z * z * rng.standard_normal(z.shape)).astype(np.float32)
        if dropout > 0:
            z[rng.random(z.shape) < dropout] = np.nan
        # a dropout burst: a few frames of near-total depth loss, which the
        # tracker must reject and recover from
        if burst is not None:
            b0, blen, bfrac = burst
            if b0 <= i < b0 + blen:
                z[rng.random(z.shape) < bfrac] = np.nan
        valid = float(np.isfinite(z).mean())
        min_valid = min(min_valid, valid)
        depths.append(z)
        rgbs.append(rgb)
        gts.append((pose.t.numpy(), quaternion_from_matrix(pose.R).numpy()))
        if progress and i % 20 == 0:
            print(f"  frame {i}/{n_frames} valid={valid:.2f}", file=sys.stderr, flush=True)

    write_synthetic_tum(root, depths, rgbs, gts)
    return {"frames": n_frames, "min_valid_frac": min_valid,
            "camera": (cam.fx, cam.fy, cam.cx, cam.cy, width, height)}


def _parse_burst(spec):
    if not spec:
        return None
    parts = spec.split(":")
    return (int(parts[0]), int(parts[1]), float(parts[2]) if len(parts) > 2 else 0.95)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="generate a synthetic TUM-layout RGB-D sequence")
    p.add_argument("--out", required=True)
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--noise-k", type=float, default=1.5e-3,
                   help="depth noise sigma = noise_k * z^2 (0 disables)")
    p.add_argument("--dropout", type=float, default=0.01,
                   help="random NaN-hole fraction")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--trajectory-file", default=None,
                   help="replay a real TUM groundtruth trajectory "
                        "(resampled at --traj-fps, re-anchored to the "
                        "scene) instead of the synthetic sinusoid path")
    p.add_argument("--traj-fps", type=float, default=30.0)
    p.add_argument("--traj-start", type=float, default=0.0,
                   help="seconds into the trajectory file to start at")
    p.add_argument("--room", action="store_true",
                   help="close the room (side/behind walls + ceiling) so "
                        "any orientation sees in-grid geometry")
    p.add_argument("--fit-trajectory", action="store_true",
                   help="center the object cluster at the trajectory's "
                        "median look-at point and keep the camera path "
                        "clear of it (real orbits circle their subject)")
    p.add_argument("--scene", default="tabletop",
                   choices=("tabletop", "desk", "plant"),
                   help="object-cluster family: tabletop (default), desk "
                        "(cluttered close-range), plant (thin structure)")
    p.add_argument("--pathology", action="store_true",
                   help="Kinect sensor pathologies on top of the noise "
                        "model: IR-baseline occlusion shadows, edge flying "
                        "pixels, temporally-coherent reflective dropout "
                        "patches, exposure-varying RGB")
    p.add_argument("--ir-baseline", type=float, default=0.075,
                   help="projector-camera stereo baseline (m) for the "
                        "occlusion-shadow pathology")
    p.add_argument("--patches", type=int, default=3,
                   help="number of reflective dropout patches")
    p.add_argument("--burst", default=None, metavar="START:LEN[:FRAC]",
                   help="dropout burst: NaN FRAC (default 0.95) of pixels "
                        "for LEN frames starting at START (failure-gate "
                        "study)")
    p.add_argument("--cpu", action="store_true",
                   help="render on the CPU (the default is the GPU)")
    args = p.parse_args(argv)

    if not args.cpu and not torch.cuda.is_available():
        print("error: no CUDA GPU found; pass --cpu to render on the CPU",
              file=sys.stderr)
        return 1
    stats = generate(args.out, args.frames, args.width, args.height,
                     args.noise_k, args.dropout, args.seed, progress=True,
                     trajectory_file=args.trajectory_file,
                     traj_fps=args.traj_fps, traj_start=args.traj_start,
                     room=args.room, fit_trajectory=args.fit_trajectory,
                     scene_family=args.scene, pathology=args.pathology,
                     ir_baseline=args.ir_baseline, n_patches=args.patches,
                     burst=_parse_burst(args.burst),
                     device="cpu" if args.cpu else "cuda")
    print(f"wrote {stats['frames']} frames to {args.out} "
          f"(min valid-depth fraction {stats['min_valid_frac']:.2f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
