#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tracking_sdf_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the repository root, on a machine with a CUDA GPU

Phases, each of which fails the run (non-zero exit) on a fault:
  1. header: GPU name and power limit, torch / CUDA / nvcc versions;
  2. build: compile the CUDA kernels from csrc/ (timed);
  3. kernels: each hand-written kernel form against its plain PyTorch version
     on the card at the main paths' shapes, with errors and median CUDA-event
     times:
       K1 gn_reduce, dense form, at 34,240 and 8,560 queries on a 256^3 grid
         fused from the first frame (flat layout);
       K1 gn_reduce, brick-major form, at the same queries on the bf16 D rows
         of a 256^3 brick grid fused from the first frame (tum256);
       K2 brick_merge, dense form, at cap 6144 / cap_act 24,576, geometry and
         color, max_weight 128 with voxels at the clamp;
       K2 brick_merge_rows, row form, at cap 6144 / cap_free 2048 on bf16 rows
         and the packed color leaf, geometry and color, voxels at the clamp
         (bitwise on every stored non-NaN value, equal NaN masks);
  4. small parity: the port's frame loop on the card against the same loop on
     the CPU (plain versions) on a 48^3 grid, flat and brick-major;
  5. main paths, each with every kernel launch count set to 0 just before it
     and read just after, over bench.py's scene and trajectory rendered on
     the card at 640x480 (frame 0 bootstraps, the rest are tracked):
       the flat bricked slice (tum256 with fusion mode "bricked",
         brick_merge "pallas"), 4 tracked frames;
       the tum256 preset as it is, 10 tracked frames;
       the tum512 preset as it is, 5 tracked frames.
     The kernels of each path must have launched, no frame may be rejected,
     and the final |t err| must stay under 46.9 mm (2 voxels at 256^3); for
     the presets also within 0.5 voxel of the JAX package's own final |t err|
     on the same scene and frames. The presets' bf16 leaves must be free of
     NaN wherever W > 0, with weights in [0, 128].
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

K_FRAMES = 10  # tracked frames of the trajectory after the bootstrap frame
TRACKED = {"slice": 4, "tum256": 10, "tum512": 5}  # tracked frames per main path
REL_TOL_GN = 1e-4  # K1: max |A - A_ref| / max |A_ref| (and b); sums differ in order
ABS_TOL_MERGE = 1e-5  # K2 dense form: same float32 formula per voxel
T_ERR_MAX = 0.0469  # m: the absolute |t err| bound, 2 voxels at 256^3
# Final |t err| (mm) of the JAX package on the same scene, trajectory and
# frames (tum256: 11 frames, tum512: 6), unmodified presets at full size, run
# with JAX on the CPU (jax 0.9.0). A preset on the card must land within half
# a voxel of it.
JAX_T_ERR_MM = {"tum256": 35.7974, "tum512": 21.4949}


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


def union(*parts):
    """A scene whose ray hits are the nearest hit of any part."""
    class Scene:
        def intersect(self, o, d):
            t = parts[0].intersect(o, d)
            for s in parts[1:]:
                tb = s.intersect(o, d)
                t = torch.where(torch.isnan(t), tb,
                                torch.where(torch.isnan(tb), t, torch.minimum(t, tb)))
            return t

    return Scene()


def make_scene():
    """bench.py's scene: sphere + box + a back wall filling the view."""
    from tracking_sdf_tpu_torch.data.synthetic import CuboidScene, SphereScene

    return union(SphereScene(center=(0.3, 1.2, 0.9), radius=0.45),
                 CuboidScene(min_corner=(-1.0, 1.0, 0.2), max_corner=(-0.3, 1.9, 0.9)),
                 CuboidScene(min_corner=(-8.0, 2.6, -8.0), max_corner=(8.0, 3.0, 8.0)))


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


def path_config(name, trajectory_path):
    """The presets as they are, or the flat slice (tum256 with the flat
    bricked layout); only the trajectory path changes."""
    from tracking_sdf_tpu.config import preset

    cfg = dataclasses.replace(preset("tum256" if name == "slice" else name),
                              trajectory_path=trajectory_path)
    if name == "slice":
        cfg = dataclasses.replace(
            cfg, fusion=cfg.fusion._replace(mode="bricked", brick_merge="pallas"))
    return cfg


def counters():
    from tracking_sdf_tpu_torch.fusion import brick_merge as k2
    from tracking_sdf_tpu_torch.tracking import gn_reduce as k1

    return {"gn_reduce": k1.launches, "gn_reduce_brick": k1.launches_brick,
            "brick_merge": k2.launches, "brick_merge_rows": k2.launches_rows}


def reset_counters():
    from tracking_sdf_tpu_torch.fusion import brick_merge as k2
    from tracking_sdf_tpu_torch.tracking import gn_reduce as k1

    k1.launches = k1.launches_brick = 0
    k2.launches = k2.launches_rows = 0


def gn_compare(label, Dm, pose, pts1, p):
    """K1 on the card against its plain version at strides 3 and 6."""
    from tracking_sdf_tpu_torch.tracking.gn_reduce import gn_reduce, gn_reduce_reference

    rec = {}
    for stride in (3, 6):
        q = pts1[::stride, ::stride].reshape(-1, 3)
        out_k = gn_reduce(Dm, pose, q, p)
        out_r = gn_reduce_reference(Dm, pose, q, p)
        torch.cuda.synchronize()
        errs = {}
        for part, sl in (("A", slice(0, 21)), ("b", slice(21, 27))):
            diff = (out_k[sl] - out_r[sl]).abs().max().item()
            errs[part] = diff / max(out_r[sl].abs().max().item(), 1e-30)
        nv_k, nv_r = int(out_k[27].item()), int(out_r[27].item())
        max_abs = (out_k[:27] - out_r[:27]).abs().max().item()
        ms = cuda_time_ms(lambda: gn_reduce(Dm, pose, q, p))
        plain_ms = cuda_time_ms(lambda: gn_reduce_reference(Dm, pose, q, p))
        print(f"{label} N={q.shape[0]}: rel err A {errs['A']:.3e} b {errs['b']:.3e}, "
              f"max abs err {max_abs:.3e}, num_valid {nv_k} (plain {nv_r}), tol rel "
              f"{REL_TOL_GN:g}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        check(nv_k == nv_r and nv_k > 1000, f"{label} num_valid {nv_k} != {nv_r}")
        check(errs["A"] <= REL_TOL_GN and errs["b"] <= REL_TOL_GN,
              f"{label} disagrees with its plain version at N={q.shape[0]}: {errs}")
        rec[stride] = dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms)
    return rec[3]


def kernel_gn(cam, scene, poses, rgb, dev):
    """K1's dense form on the flat grid and its brick-major form on the bf16
    D rows, each fused from the first frame and queried with the second."""
    from tracking_sdf_tpu_torch.data.synthetic import render_scene_depth
    from tracking_sdf_tpu_torch.fusion.brick import fuse_frame_bricked
    from tracking_sdf_tpu_torch.fusion.brickmajor import (
        empty_brick_grid, fuse_frame_brickmajor)
    from tracking_sdf_tpu_torch.grid.grid import empty_grid
    from tracking_sdf_tpu_torch.grid.interp import masked_view
    from tracking_sdf_tpu_torch.tracking.preprocess import preprocess_frame

    flat, tum = path_config("slice", None), path_config("tum256", None)
    p = flat.grid
    pts0, nrm0 = preprocess_frame(render_scene_depth(scene, cam, poses[0]), cam=cam,
                                  bilateral_mode=flat.bilateral_mode)
    pts1, _ = preprocess_frame(render_scene_depth(scene, cam, poses[1]), cam=cam,
                               bilateral_mode=flat.bilateral_mode)
    grid = empty_grid(p, device=dev)
    fuse_frame_bricked(grid, poses[0], pts0, nrm0, rgb, params=p, cam=cam,
                       cfg=flat.fusion, bs=flat.fusion.brick_shape,
                       cap=flat.fusion.brick_cap)
    dense = gn_compare("K1 gn_reduce (dense)", masked_view(grid.D, grid.W), poses[0],
                       pts1, p)
    del grid
    f = tum.fusion
    bg = empty_brick_grid(tum.grid, f.brick_shape, device=dev,
                          value_dtype=torch.bfloat16, weight_dtype=torch.bfloat16)
    _, view, _ = fuse_frame_brickmajor(bg, poses[0], pts0, nrm0, rgb, params=tum.grid,
                                       cam=cam, cfg=f, bs=f.brick_shape, cap=f.brick_cap,
                                       cap_free=f.brick_cap_free)
    check(view.rows.dtype == torch.bfloat16, "the tum256 view is not bf16")
    brick = gn_compare("K1 gn_reduce (brick-major bf16)", view, poses[0], pts1, tum.grid)
    return dense, brick


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
        print(f"K2 brick_merge (dense) C={C} cap={cap} cap_act={cap_act}: max abs err "
              f"{err:.3e} (tol {ABS_TOL_MERGE:g}), "
              f"{at_clamp} voxels at max_weight; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        check(err <= ABS_TOL_MERGE, f"K2 disagrees with its plain version (C={C}): {err}")
        check(at_clamp > 0, "K2 inputs reached no clamp")
        rec[C] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return rec[6]


def kernel_merge_rows(dev):
    """K2's row form on bf16 rows of a 256^3 brick grid: FULL slots (some
    padding) then FREE ids (some padding), W up to the 128 clamp, some voxels
    unobserved (W = 0, D = NaN). Stored values must agree bit for bit."""
    from tracking_sdf_tpu_torch.fusion.brick_merge import (
        brick_merge_rows, brick_merge_rows_reference)
    from tracking_sdf_tpu_torch.fusion.brickmajor import pack_color

    nb, bv, cap, cap_free = 32 ** 3, 512, 6144, 2048
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(1)

    def rand(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(*shape, generator=gen, device=dev)

    W = rand(nb, bv, lo=-20.0, hi=140.0).clamp(0.0, 128.0).to(bf)
    D = torch.where(W > 0, rand(nb, bv, lo=-0.3, hi=0.3), float("nan")).to(bf)
    C = pack_color(*(rand(nb, bv).to(bf) for _ in range(3)),
                   rand(nb, bv, lo=0.0, hi=140.0).clamp(max=128.0).to(bf))
    ids = torch.randperm(nb, generator=gen, device=dev)[:cap + cap_free].to(torch.int32)
    ids[5500:cap] = nb  # padded FULL slots
    ids[cap + 1800:] = nb  # padded FREE slots
    rec = {}
    for channels in (2, 6):
        upd = rand(channels, cap, bv, lo=0.0, hi=2.0)
        upd[0][rand(cap, bv) < 0.2] = 0.0
        kw = dict(cap=cap, delta=0.3, max_weight=128.0)
        lk = [D.clone(), W.clone(), C.clone()]
        lr = [x.clone() for x in lk]
        brick_merge_rows(*lk, upd, ids, **kw)
        brick_merge_rows_reference(*lr, upd, ids, **kw)
        torch.cuda.synchronize()
        nan_ok = all(torch.equal(torch.isnan(a), torch.isnan(b)) for a, b in zip(lk[:2], lr[:2]))
        differ = sum(int((a[~torch.isnan(b)].view(torch.int16)
                          != b[~torch.isnan(b)].view(torch.int16)).sum())
                     for a, b in zip(lk[:2], lr[:2]))
        differ += int((lk[2] != lr[2]).sum())
        err = max(float(torch.nan_to_num(a.float() - b.float()).abs().max())
                  for a, b in zip(lk[:2], lr[:2]))
        at_clamp = int((lk[1] == 128.0).sum())
        touched = int((lk[2] != C).any(dim=1).sum())
        ms = cuda_time_ms(lambda: brick_merge_rows(*lk, upd, ids, **kw))
        plain_ms = cuda_time_ms(lambda: brick_merge_rows_reference(*lr, upd, ids, **kw))
        print(f"K2 brick_merge_rows (bf16 rows) channels={channels} cap={cap} "
              f"cap_free={cap_free}: {differ} stored values differ (tol 0), NaN masks "
              f"equal {nan_ok}, max abs err {err:.3e}, {at_clamp} voxels at max_weight, "
              f"{touched} color rows updated; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        check(differ == 0 and nan_ok, f"K2 row form disagrees with its plain version "
              f"(channels={channels}): {differ} values, NaN masks equal {nan_ok}")
        check(at_clamp > 0, "K2 row inputs reached no clamp")
        check((touched > 0) == (channels == 6), "color rows updated on the wrong path")
        rec[channels] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return rec[6]


def small_parity(dev):
    """The port's loop on the card vs on the CPU (plain versions), 48^3: the
    flat bricked slice, and the tum256 preset's brick-major path with its caps
    at NB. Brick-major stores bf16: the update sums come from different float
    kernels on the two devices, so D may differ by a bf16 rounding (~1e-3).
    The scene is a sphere and a box: a lone sphere leaves rotations about its
    centre unobservable, so its tracked pose would be set by float rounding,
    which differs between hosts (the CPU's BLAS code path)."""
    from tracking_sdf_tpu.config import GridParams
    from tracking_sdf_tpu_torch.core.camera import PinholeCamera
    from tracking_sdf_tpu_torch.data.synthetic import (
        CuboidScene, SphereScene, look_at, render_scene_depth)
    from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction

    params = GridParams(m=48, width=2.0, height=2.0, depth=2.0, origin=(-1.0, -1.0, -1.0),
                        delta=0.15, epsilon=0.02)
    cam = PinholeCamera(fx=60.0, fy=60.0, cx=47.5, cy=35.5, width=96, height=72)
    scene = union(SphereScene(center=(0.15, 0.1, 0.0), radius=0.4),
                  CuboidScene(min_corner=(-0.75, -0.4, -0.55), max_corner=(-0.35, 0.4, 0.15)))
    eyes = [(0.0, -1.5, 0.2), (0.02, -1.5, 0.21), (0.04, -1.49, 0.22)]
    for name, fusion, tol_D in (("slice", dict(brick_cap=256), 1e-4),
                                ("tum256", dict(brick_cap=216, brick_cap_free=216), 2e-3)):
        cfg = path_config(name, None)
        cfg = dataclasses.replace(cfg, grid=params,
                                  fusion=cfg.fusion._replace(**fusion))
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
        ga, gb = a.grid, b.grid
        dt = (a.pose.t - b.pose.t.cpu()).abs().max().item()
        seen = ga.W > 0
        dD = (ga.D[seen] - gb.D.cpu()[seen]).abs().max().item()
        dW = ((ga.W - gb.W.cpu()).abs() / ga.W.clamp(min=1.0)).max().item()
        iters = ([s.gn_iterations for s in a.stats], [s.gn_iterations for s in b.stats])
        print(f"small parity {name} (48^3, card vs CPU): |dt| {dt:.3e} m, max |dD| "
              f"{dD:.3e} (tol {tol_D:g}), max |dW|/max(W, 1) {dW:.3e}, GN iterations "
              f"{iters[1]} (CPU {iters[0]})")
        check(dt < 1e-4 and dD < tol_D and dW < 2 ** -7 and iters[0] == iters[1]
              and torch.equal(seen, gb.W.cpu() > 0),
              f"the port on the card disagrees with the port on the CPU ({name})")


def run_path(name, cam, depths, poses, rgb, dev, traj_path):
    """Drive one main path through Reconstruction.process_frame with the
    launch counts set to 0 just before; returns its record."""
    from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction

    cfg = path_config(name, traj_path)
    n = TRACKED[name] + 1
    recon = Reconstruction(cam, cfg, initial_pose=poses[0], device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    wall = []
    for k in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = recon.process_frame(depths[k], rgb=rgb, timestamp=float(k))
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        fs = recon.last_fuse_stats
        print(f"{name} frame {k:2d}: {wall[-1]:8.2f} ms (preprocess {st.preprocess_ms:6.2f}, "
              f"track {st.track_ms:7.2f}, fuse {st.fuse_ms:7.2f}), GN {st.gn_iterations:2d}, "
              f"valid {st.num_valid}, n_full {fs.n_full}, n_free {fs.n_free}, overflow "
              f"{fs.overflow}, overflow_active {fs.overflow_active}, overflow_mixed "
              f"{fs.overflow_mixed}, rejected {st.rejected}")
    launches = counters()
    recon.close()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    tracked = recon.stats[1:]
    t_err = (recon.pose.t - poses[n - 1].t).norm().item()
    voxel = cfg.grid.width / cfg.grid.m
    med = {k: statistics.median(getattr(s, k) for s in tracked)
           for k in ("preprocess_ms", "track_ms", "fuse_ms")}
    rec = dict(ms_per_frame=statistics.median(wall[1:]), t_err_mm=t_err * 1e3,
               gn_iterations=sum(s.gn_iterations for s in tracked), launches=launches, **med)
    print(f"main path {name} ({cfg.grid.m}^3, {cam.width}x{cam.height}, {len(tracked)} "
          f"tracked frames): median {rec['ms_per_frame']:.2f} ms/frame wall, preprocess "
          f"{med['preprocess_ms']:.2f} ms, track {med['track_ms']:.2f} ms, fuse "
          f"{med['fuse_ms']:.2f} ms; GN iterations {rec['gn_iterations']}; final |t err| "
          f"{rec['t_err_mm']:.2f} mm; peak device memory {peak_gb:.2f} GiB; "
          f"launches {launches}")
    kernels = (("gn_reduce", "brick_merge") if name == "slice"
               else ("gn_reduce_brick", "brick_merge_rows"))
    check(all(launches[k] > 0 for k in kernels), f"{name}: a kernel never ran: {launches}")
    check(not any(s.rejected for s in recon.stats), f"{name}: a frame was rejected")
    check(t_err < T_ERR_MAX, f"{name}: |t err| {t_err:.4f} m >= {T_ERR_MAX} m")
    if name in JAX_T_ERR_MM:
        ref = JAX_T_ERR_MM[name]
        print(f"  |t err| {rec['t_err_mm']:.2f} mm vs the JAX package's {ref} mm: "
              f"bound +-{0.5 * voxel * 1e3:.2f} mm (half a voxel)")
        check(abs(rec["t_err_mm"] - ref) <= 0.5 * voxel * 1e3,
              f"{name}: |t err| {rec['t_err_mm']:.2f} mm is not within half a voxel of "
              f"the JAX package's {ref} mm")
        bg = recon.brick_grid
        from tracking_sdf_tpu_torch.fusion.brickmajor import unpack_color_grid

        R, G, B, Wc = unpack_color_grid(bg)
        mw = cfg.fusion.max_weight
        check(bg.D.dtype == torch.bfloat16 and bg.W.dtype == torch.bfloat16,
              f"{name}: leaves are not bf16")
        check(not bool(torch.isnan(bg.D[bg.W > 0]).any()), f"{name}: NaN where W > 0")
        check(float(bg.W.min()) >= 0.0 and float(bg.W.max()) <= mw
              and float(Wc.min()) >= 0.0 and float(Wc.max()) <= mw,
              f"{name}: weights outside [0, {mw}]")
        check(all(bool(torch.isfinite(x).all()) for x in (R, G, B)),
              f"{name}: non-finite color")
        print(f"  leaves: {int((bg.W > 0).sum())} observed voxels, no NaN where W > 0, "
              f"W max {float(bg.W.max())}, Wc max {float(Wc.max())}")
    else:
        g = recon.grid
        check(bool(torch.isfinite(g.D).all()) and bool(torch.isfinite(g.W).all()),
              "non-finite grid values")
        check(float(g.W.max()) <= cfg.fusion.max_weight and float(g.W.min()) >= 0.0,
              "weights outside [0, max_weight]")
    with open(traj_path) as f:
        n_lines = sum(1 for _ in f)
    check(n_lines == n, f"{name}: trajectory has {n_lines} lines, not {n}")
    del recon
    torch.cuda.empty_cache()
    return rec


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
    rgb = torch.full((cam.height, cam.width, 3), 0.5, device=dev)

    k1_dense, k1_brick = kernel_gn(cam, scene, poses, rgb, dev)
    k2_dense = kernel_merge(dev)
    k2_rows = kernel_merge_rows(dev)
    small_parity(dev)

    depths = [render_scene_depth(scene, cam, p) for p in poses]
    torch.cuda.synchronize()
    os.makedirs(os.path.join(repo, "build"), exist_ok=True)
    paths = {name: run_path(name, cam, depths, poses, rgb, dev,
                            os.path.join(repo, "build", f"chip_smoke_{name}.txt"))
             for name in TRACKED}
    presets = [paths["tum256"]["launches"], paths["tum512"]["launches"]]

    def src(f):
        return f"tracking_sdf_tpu_torch/csrc/{f}"

    gn_tpu = "tracking_sdf_tpu/tracking/pallas_gn.py:82"
    merge_tpu = "tracking_sdf_tpu/fusion/pallas_merge.py:94"
    kernels = [
        dict(name="gn_reduce", route="cuda", source=src("gn_reduce.cu"), replaces=gn_tpu,
             launches=paths["slice"]["launches"]["gn_reduce"], **k1_dense),
        dict(name="gn_reduce_brick", route="cuda", source=src("gn_reduce.cu"),
             replaces=gn_tpu, launches=sum(l["gn_reduce_brick"] for l in presets),
             **k1_brick),
        dict(name="brick_merge", route="cuda", source=src("brick_merge.cu"),
             replaces=merge_tpu, launches=paths["slice"]["launches"]["brick_merge"],
             **k2_dense),
        dict(name="brick_merge_rows", route="cuda", source=src("brick_merge.cu"),
             replaces=merge_tpu, launches=sum(l["brick_merge_rows"] for l in presets),
             **k2_rows),
    ]
    print(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
