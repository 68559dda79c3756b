#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tracking_sdf_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the repository root, on a machine with a CUDA GPU

Phases, each of which fails the run (non-zero exit) on a fault:
  1. header: GPU name and power limit, torch / CUDA / nvcc versions;
  2. build: compile the CUDA kernels from csrc/ (timed);
  3. kernels: each hand-written kernel against its plain PyTorch version on
     the card at the main path's shapes (K1 gn_reduce at 34,240 and 8,560
     queries on a 256^3 grid fused from the first frame; K2 brick_merge at
     cap 6144 / cap_act 24,576, geometry and color, max_weight 128 with
     voxels at the clamp), with errors and median CUDA-event times;
  4. small parity: the port's frame loop on the card against the same loop
     on the CPU (plain versions) on a 48^3 grid;
  5. main path: Reconstruction on the slice configuration (tum256 with
     fusion mode "bricked", brick_merge "pallas") over 11 synthetic 640x480
     frames rendered on the card (bench.py's scene and trajectory): frame 0
     bootstraps, 10 are tracked. Both kernels' launch counters must grow, no
     frame may be rejected, and the final |t err| must stay under 2 voxels.
The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import torch

K_FRAMES = 10  # tracked frames after the bootstrap frame
REL_TOL_GN = 1e-4  # K1: max |A - A_ref| / max |A_ref| (and b); sums differ in order
ABS_TOL_MERGE = 1e-5  # K2: same float32 formula per voxel


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of per-call CUDA-event times after warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def make_scene():
    """bench.py's scene: sphere + box + a back wall filling the view."""
    from tracking_sdf_tpu_torch.data.synthetic import CuboidScene, SphereScene

    parts = (SphereScene(center=(0.3, 1.2, 0.9), radius=0.45),
             CuboidScene(min_corner=(-1.0, 1.0, 0.2), max_corner=(-0.3, 1.9, 0.9)),
             CuboidScene(min_corner=(-8.0, 2.6, -8.0), max_corner=(8.0, 3.0, 8.0)))

    class Scene:
        def intersect(self, o, d):
            t = parts[0].intersect(o, d)
            for s in parts[1:]:
                tb = s.intersect(o, d)
                t = torch.where(torch.isnan(t), tb,
                                torch.where(torch.isnan(tb), t, torch.minimum(t, tb)))
            return t

    return Scene()


def make_poses(device):
    """bench.py's trajectory: ~13 mm + ~0.9 deg per frame, ±30% jitter."""
    from tracking_sdf_tpu_torch.core.lie import pose_compose, se3_exp
    from tracking_sdf_tpu_torch.data.synthetic import look_at

    poses = [look_at((0.0, -0.8, 0.8), (0.0, 1.2, 0.7), device=device)]
    xi_base = torch.tensor([0.008, -0.004, 0.007, 0.007, -0.005, 0.006], device=device)
    for k in range(1, K_FRAMES + 1):
        xi_k = xi_base * (1.0 + 0.3 * (1.0 if k % 2 == 0 else -1.0))
        poses.append(pose_compose(poses[-1], se3_exp(xi_k)))
    return poses


def slice_config(trajectory_path):
    from tracking_sdf_tpu.config import preset

    cfg = preset("tum256")
    return dataclasses.replace(
        cfg, trajectory_path=trajectory_path,
        fusion=cfg.fusion._replace(mode="bricked", brick_merge="pallas"))


def kernel_gn(cfg, cam, scene, poses, rgb, dev):
    from tracking_sdf_tpu_torch.data.synthetic import render_scene_depth
    from tracking_sdf_tpu_torch.fusion.brick import fuse_frame_bricked
    from tracking_sdf_tpu_torch.grid.grid import empty_grid
    from tracking_sdf_tpu_torch.grid.interp import masked_view
    from tracking_sdf_tpu_torch.tracking.gn_reduce import gn_reduce, gn_reduce_reference
    from tracking_sdf_tpu_torch.tracking.preprocess import preprocess_frame

    p = cfg.grid
    grid = empty_grid(p, device=dev)
    pts0, nrm0 = preprocess_frame(render_scene_depth(scene, cam, poses[0]), cam=cam,
                                  bilateral_mode=cfg.bilateral_mode)
    fuse_frame_bricked(grid, poses[0], pts0, nrm0, rgb, params=p, cam=cam,
                       cfg=cfg.fusion, bs=cfg.fusion.brick_shape,
                       cap=cfg.fusion.brick_cap)
    Dm = masked_view(grid.D, grid.W)
    pts1, _ = preprocess_frame(render_scene_depth(scene, cam, poses[1]), cam=cam,
                               bilateral_mode=cfg.bilateral_mode)
    rec = {}
    for stride in (3, 6):
        q = pts1[::stride, ::stride].reshape(-1, 3)
        out_k = gn_reduce(Dm, poses[0], q, p)
        out_r = gn_reduce_reference(Dm, poses[0], q, p)
        torch.cuda.synchronize()
        errs = {}
        for part, sl in (("A", slice(0, 21)), ("b", slice(21, 27))):
            diff = (out_k[sl] - out_r[sl]).abs().max().item()
            errs[part] = diff / max(out_r[sl].abs().max().item(), 1e-30)
        nv_k, nv_r = int(out_k[27].item()), int(out_r[27].item())
        max_abs = (out_k[:27] - out_r[:27]).abs().max().item()
        ms = cuda_time_ms(lambda: gn_reduce(Dm, poses[0], q, p))
        plain_ms = cuda_time_ms(lambda: gn_reduce_reference(Dm, poses[0], q, p))
        print(f"K1 gn_reduce N={q.shape[0]}: rel err A {errs['A']:.3e} b {errs['b']:.3e}, "
              f"max abs err {max_abs:.3e}, num_valid {nv_k} (plain {nv_r}), tol rel "
              f"{REL_TOL_GN:g}; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        check(nv_k == nv_r and nv_k > 1000, f"K1 num_valid {nv_k} != {nv_r}")
        check(errs["A"] <= REL_TOL_GN and errs["b"] <= REL_TOL_GN,
              f"K1 disagrees with its plain version at N={q.shape[0]}: {errs}")
        rec[stride] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms)
    return rec[3]


def kernel_merge(dev):
    from tracking_sdf_tpu_torch.fusion.brick_merge import brick_merge, brick_merge_reference
    from tracking_sdf_tpu_torch.grid.grid import FIELDS, TSDFGrid

    m, bs, cap, cap_act, nb = 256, (8, 8, 8), 6144, 24576, 32 ** 3
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(*shape, generator=gen, device=dev)

    base = {k: rand(m, m, m) for k in FIELDS}
    base["D"] = rand(m, m, m, lo=-0.3, hi=0.3)
    base["W"] = rand(m, m, m, lo=0.0, hi=140.0).clamp(max=128.0)  # ~9% at the clamp
    base["Wc"] = rand(m, m, m, lo=0.0, hi=140.0).clamp(max=128.0)
    bid = torch.randperm(nb, generator=gen, device=dev)[:cap_act].sort().values
    cls = torch.where(rand(cap_act) < 0.3, 2, 1).to(torch.int32)
    full_pos = torch.nonzero(cls == 2).reshape(-1)
    slot = torch.full((cap_act,), cap, dtype=torch.int32, device=dev)
    slot[full_pos[:cap]] = torch.arange(min(cap, full_pos.numel()), dtype=torch.int32,
                                        device=dev)
    check(full_pos.numel() > cap, "K2 inputs must hold FULL bricks past the cap")
    rec = {}
    for C in (2, 6):
        upd = rand(cap + 1, *bs, C, lo=0.0, hi=2.0)
        upd[..., 0][rand(cap + 1, *bs) < 0.2] = 0.0
        upd[cap] = 0.0
        args = (upd, bid.to(torch.int32), cls, slot)
        kw = dict(bs=bs, delta=0.3, max_weight=128.0)
        gk = TSDFGrid(**{k: v.clone() for k, v in base.items()})
        gr = TSDFGrid(**{k: v.clone() for k, v in base.items()})
        brick_merge(gk, *args, **kw)
        brick_merge_reference(gr, *args, **kw)
        torch.cuda.synchronize()
        err = max((getattr(gk, k) - getattr(gr, k)).abs().max().item() for k in FIELDS)
        at_clamp = int((gk.W == 128.0).sum().item())
        ms = cuda_time_ms(lambda: brick_merge(gk, *args, **kw))
        plain_ms = cuda_time_ms(lambda: brick_merge_reference(gr, *args, **kw))
        print(f"K2 brick_merge C={C} cap={cap} cap_act={cap_act}: max abs err {err:.3e} "
              f"(tol {ABS_TOL_MERGE:g}), "
              f"{at_clamp} voxels at max_weight; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        check(err <= ABS_TOL_MERGE, f"K2 disagrees with its plain version (C={C}): {err}")
        check(at_clamp > 0, "K2 inputs reached no clamp")
        rec[C] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return rec[6]


def small_parity(dev):
    """The port's loop on the card vs on the CPU (plain versions), 48^3."""
    from tracking_sdf_tpu.config import GridParams
    from tracking_sdf_tpu_torch.core.camera import PinholeCamera
    from tracking_sdf_tpu_torch.data.synthetic import SphereScene, look_at, render_scene_depth
    from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction

    cfg = dataclasses.replace(
        slice_config(None), grid=GridParams(m=48, width=2.0, height=2.0, depth=2.0,
                                            origin=(-1.0, -1.0, -1.0), delta=0.15,
                                            epsilon=0.02))
    cfg = dataclasses.replace(cfg, fusion=cfg.fusion._replace(brick_cap=256))
    cam = PinholeCamera(fx=60.0, fy=60.0, cx=47.5, cy=35.5, width=96, height=72)
    scene = SphereScene(center=(0.0, 0.0, 0.0), radius=0.4)
    eyes = [(0.0, -1.5, 0.2), (0.02, -1.5, 0.21), (0.04, -1.49, 0.22)]
    runs = {}
    for d in ("cpu", dev):
        r = Reconstruction(cam, cfg, device=d,
                           initial_pose=look_at(eyes[0], (0, 0, 0), device=d))
        rgb = torch.full((72, 96, 3), 0.5, device=d)
        for i, e in enumerate(eyes):
            depth = render_scene_depth(scene, cam, look_at(e, (0, 0, 0), device="cpu"))
            r.process_frame(depth.to(d), rgb=rgb, timestamp=i)
        runs[d] = r
    a, b = runs["cpu"], runs[dev]
    dt = (a.pose.t - b.pose.t.cpu()).abs().max().item()
    seen = a.grid.W > 0
    dD = (a.grid.D[seen] - b.grid.D.cpu()[seen]).abs().max().item()
    dW = (a.grid.W - b.grid.W.cpu()).abs().max().item()
    iters = ([s.gn_iterations for s in a.stats], [s.gn_iterations for s in b.stats])
    print(f"small parity (48^3, card vs CPU): |dt| {dt:.3e} m, max |dD| {dD:.3e}, "
          f"max |dW| {dW:.3e}, GN iterations {iters[1]} (CPU {iters[0]})")
    check(dt < 1e-4 and dD < 1e-4 and dW < 1e-4,
          "the port on the card disagrees with the port on the CPU")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke runs "
              "only on a CUDA GPU", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    try:
        from tracking_sdf_tpu_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run it from a checkout "
              "of the repository", file=sys.stderr)
        return 2
    from tracking_sdf_tpu_torch.core.camera import ros_default_camera
    from tracking_sdf_tpu_torch.data.synthetic import render_scene_depth
    from tracking_sdf_tpu_torch.fusion import brick_merge as k2
    from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction
    from tracking_sdf_tpu_torch.tracking import gn_reduce as k1

    gpu = gpu_line()
    dev = "cuda"
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()
    print(f"gpu: {gpu}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc: {nvcc[-1] if nvcc else 'unknown'}, device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{os.path.relpath(_build.library_path(), repo)}")
    for line in _build.build_log().splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling" in line):
            print("  " + line.strip())

    cam = ros_default_camera()
    scene = make_scene()
    poses = make_poses(dev)
    traj_path = os.path.join(repo, "build", "chip_smoke_trajectory.txt")
    os.makedirs(os.path.dirname(traj_path), exist_ok=True)
    cfg = slice_config(traj_path)
    rgb = torch.full((cam.height, cam.width, 3), 0.5, device=dev)

    k1_rec = kernel_gn(cfg, cam, scene, poses, rgb, dev)
    k2_rec = kernel_merge(dev)
    small_parity(dev)

    depths = [render_scene_depth(scene, cam, p) for p in poses]
    torch.cuda.synchronize()
    recon = Reconstruction(cam, cfg, initial_pose=poses[0], device=dev)
    k1.launches = 0
    k2.launches = 0
    wall = []
    for k, depth in enumerate(depths):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = recon.process_frame(depth, rgb=rgb, timestamp=float(k))
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        fs = recon.last_fuse_stats
        print(f"frame {k:2d}: {wall[-1]:8.2f} ms (track {st.track_ms:7.2f}, fuse "
              f"{st.fuse_ms:7.2f}), GN {st.gn_iterations:2d}, valid {st.num_valid}, "
              f"n_full {fs.n_full}, n_free {fs.n_free}, overflow {fs.overflow}, "
              f"overflow_active {fs.overflow_active}, rejected {st.rejected}")
    launches = {"gn_reduce": k1.launches, "brick_merge": k2.launches}
    recon.close()

    tracked = recon.stats[1:]
    t_err = (recon.pose.t - poses[-1].t).norm().item()
    voxel = cfg.grid.width / cfg.grid.m
    print(f"main path ({cfg.grid.m}^3, {cam.width}x{cam.height}, {len(tracked)} tracked "
          f"frames): median {statistics.median(wall[1:]):.2f} ms/frame wall (with "
          f"preprocess), track {statistics.median(s.track_ms for s in tracked):.2f} ms, "
          f"fuse {statistics.median(s.fuse_ms for s in tracked):.2f} ms; GN iterations "
          f"{sum(s.gn_iterations for s in tracked)}; final |t err| {t_err * 1e3:.2f} mm; "
          f"launches {launches}")
    check(all(n > 0 for n in launches.values()), f"a kernel never ran: {launches}")
    check(not any(s.rejected for s in recon.stats), "a frame was rejected")
    check(t_err < 2 * voxel, f"|t err| {t_err:.4f} m >= 2 voxels ({2 * voxel:.4f} m)")
    g = recon.grid
    check(bool(torch.isfinite(g.D).all()) and bool(torch.isfinite(g.W).all()),
          "non-finite grid values")
    check(float(g.W.max()) <= cfg.fusion.max_weight and float(g.W.min()) >= 0.0,
          "weights outside [0, max_weight]")
    with open(traj_path) as f:
        n_lines = sum(1 for _ in f)
    check(n_lines == len(depths), f"trajectory has {n_lines} lines")

    kernels = [
        dict(name="gn_reduce", route="cuda", source="tracking_sdf_tpu_torch/csrc/gn_reduce.cu",
             replaces="tracking_sdf_tpu/tracking/pallas_gn.py:43",
             launches=launches["gn_reduce"], **k1_rec),
        dict(name="brick_merge", route="cuda",
             source="tracking_sdf_tpu_torch/csrc/brick_merge.cu",
             replaces="tracking_sdf_tpu/fusion/pallas_merge.py:44",
             launches=launches["brick_merge"], **k2_rec),
    ]
    print(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
