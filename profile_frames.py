#!/usr/bin/env python3
"""Frame times and a device profile of the port's presets on one GPU.

    python3 profile_frames.py [--presets tum256 tum512] [--label NAME] [--out DIR]

For each preset, as it is, over chip_smoke.py's scene and trajectory at
640x480 (frame 0 bootstraps; chip_smoke.TRACKED tracked frames follow):
  1. a timed run: host clock around each Reconstruction.process_frame,
     ending in torch.cuda.synchronize(); medians over the tracked frames of
     ms/frame and of the FrameStats stage times;
  2. a profiled run of the same frames in a fresh Reconstruction, under
     torch.profiler (CPU and CUDA activities) from the second tracked frame
     on: device time per frame (the CUDA events' self time) and the device
     busy share, device time over the timed run's median ms/frame;
  3. one frame's tracking alone: track_frame_pyramid on the last frame's
     points from the pose before it, through the first read of its
     iteration count, timed unprofiled (median of 5) and profiled once:
     device time, busy share, device kernels and copies, host waits (CUDA
     synchronize calls and device-to-host copies) and the largest device
     operations; then K1 alone at the finest level (a full gn_step launch
     and a launch on a done state, chip_smoke.kernel_device_ms), and K1's
     device ms of that frame as (its GN iterations over all levels x the
     full step) + (its other launches x the done launch) beside the
     profile's gn_step_kernel total;
  4. one frame's fusion alone: fuse_frame_brickmajor on the last frame's
     points and pose, at the cap the runner used, from a copy of the brick
     rows saved before that frame (restored before every call, outside the
     timed window), timed unprofiled (median of 5) and profiled once, with
     the same records as 3. and the peak device memory of one call; then
     its stages alone, each through its public name on the same inputs:
     classify_compact_rows (with the zeta mip it makes), the pixel table
     (_pixel_table) and K2's brick_fuse_rows: host ms, device ms and ops;
  5. the chunked path (where the checkout has Reconstruction.process_chunk)
     over the same frames: frames 1-2 as a first chunk (capture and phase
     calibration), the rest as one chunk of CUDA-graph replays, timed on the
     host clock (its wall time over its frames) and, in a second run,
     profiled: device time, ops and host syncs per frame, the busy share,
     capture and calibration ms, peak device memory above the run's start;
     and K1's split under replay: its launches a frame told apart as full
     steps and done launches by their traced device time (longer or
     shorter than the midpoint of 3.'s two times), (full launches x 3.'s
     full step) + (done launches x 3.'s done launch) beside the profile's
     gn_step_kernel device ms a frame.
Peak device memory is also read over the timed run of 1.
Prints one JSON line per preset and writes them all to OUT/profile_LABEL.json
(OUT defaults to build/profile/ beside this script). It drives public entry
points (Reconstruction, preprocess_frame, brick_masked_view,
track_frame_pyramid, fuse_frame_brickmajor, classify_compact_rows,
_pixel_table, brick_fuse_rows) and two attributes of the
runner (its cap levels and index), so it also times an older checkout of the
port that has a config module.
Without a CUDA device it exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
COPY_CALLS = ("cudaMemcpy", "cudaMemcpyAsync")


def device_events(prof):
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def host_calls(prof, names):
    return sum(e.count for e in prof.key_averages() if e.key in names)


def profile(fn):
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = device_events(prof)
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:8]
    from torch.autograd import DeviceType

    k1_us = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and "gn_step_kernel" in e.name]
    return dict(
        device_ms=sum(e.self_device_time_total for e in dev) / 1e3,
        device_ops=sum(e.count for e in dev),
        syncs=host_calls(prof, SYNC_CALLS), copies=host_calls(prof, COPY_CALLS),
        launches=host_calls(prof, ("cudaLaunchKernel", "cuLaunchKernel")),
        top=[dict(name=e.key[:80], count=e.count, ms=e.self_device_time_total / 1e3)
             for e in top],
        k1_us=k1_us)


def k1_alone(view, pose, pts, cfg):
    """(full step, done launch) device ms of K1 at the finest level's
    stride: a level that never converges, and a state marked done."""
    import chip_smoke as cs
    from tracking_sdf_tpu_torch.tracking import gn_reduce as k1

    t = cfg.tracking
    img = pts[::t.pixel_stride, ::t.pixel_stride]
    never = t._replace(max_iterations=1 << 30, min_iterations=0, max_twist_diff=-1.0)
    full = k1.gn_stepper(view, k1.init_state(pose, t.damping), img, cfg.grid, never)
    done = k1.init_state(pose, t.damping)
    done.view(torch.int32)[k1.S_DONE] = 1
    frozen = k1.gn_stepper(view, done, img, cfg.grid, t)
    times = (cs.kernel_device_ms(full, ("gn_step_kernel",)),
             cs.kernel_device_ms(frozen, ("gn_step_kernel",)))
    if None in times:
        raise RuntimeError("no profile saw a gn_step_kernel launch")
    return times


def k1_split(iterations, launches, full_ms, done_ms, traced_ms):
    """K1's device ms as full steps and done launches, beside the trace."""
    return dict(full_steps=iterations, done_launches=launches - iterations,
                full_step_ms=full_ms, done_launch_ms=done_ms,
                split_ms=iterations * full_ms + (launches - iterations) * done_ms,
                traced_ms=traced_ms)


def run_preset(name, label, gpu):
    import chip_smoke as cs
    from tracking_sdf_tpu_torch.core.camera import ros_default_camera
    from tracking_sdf_tpu_torch.data.synthetic import render_scene_depth
    from tracking_sdf_tpu_torch.fusion.brickmajor import (
        brick_masked_view, fuse_frame_brickmajor)
    from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction
    from tracking_sdf_tpu_torch.tracking.preprocess import preprocess_frame
    from tracking_sdf_tpu_torch.tracking.pyramid import track_frame_pyramid

    dev = "cuda"
    cam = ros_default_camera()
    poses = cs.make_poses(dev)
    scene = cs.make_scene()
    rgb = torch.full((cam.height, cam.width, 3), 0.5, device=dev)
    cfg = cs.path_config(name, None)
    n = cs.TRACKED[name] + 1
    depths = [render_scene_depth(scene, cam, p) for p in poses[:n]]

    # 1. timed run
    recon = Reconstruction(cam, cfg, initial_pose=poses[0], device=dev)
    wall = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in range(n):
        if k == n - 1:  # the state that 3. tracks against and 4. fuses into
            pose_before = recon.pose
            view = brick_masked_view(recon.brick_grid, cfg.grid, cfg.fusion.brick_shape)
            view_rows = view.rows.clone()
            bg = recon.brick_grid
            rows_before = [x.clone() for x in (bg.D, bg.W, bg.C)]
            cap = recon._cap_levels[recon._cap_idx]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recon.process_frame(depths[k], rgb=rgb, timestamp=float(k))
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    pose_fused = recon.pose
    tracked = recon.stats[1:]
    rec = dict(label=label, preset=name, gpu=gpu, tracked_frames=len(tracked),
               ms_per_frame=statistics.median(wall[1:]), peak_mib=peak_mib,
               gn_iterations=[s.gn_iterations for s in tracked],
               rejected=sum(s.rejected for s in recon.stats),
               t_err_mm=(recon.pose.t - poses[n - 1].t).norm().item() * 1e3)
    for key in ("preprocess_ms", "track_ms", "fuse_ms"):
        rec[key] = statistics.median(getattr(s, key) for s in tracked)
    del recon

    # 2. profiled run, frames 2.. (the second tracked frame on)
    recon = Reconstruction(cam, cfg, initial_pose=poses[0], device=dev)
    for k in range(2):
        recon.process_frame(depths[k], rgb=rgb, timestamp=float(k))
    prof = profile(lambda: [recon.process_frame(depths[k], rgb=rgb, timestamp=float(k))
                            for k in range(2, n)])
    frames = n - 2
    rec.update(frame_device_ms=prof["device_ms"] / frames,
               frame_device_ops=prof["device_ops"] / frames,
               frame_host_syncs=prof["syncs"] / frames,
               frame_busy=prof["device_ms"] / frames / rec["ms_per_frame"])
    del recon

    # 3. one frame's tracking alone, against the rows before the last frame
    view.rows.copy_(view_rows)
    pts, nrm = preprocess_frame(depths[n - 1], cam=cam, bilateral=cfg.bilateral_filter,
                              bilateral_mode=cfg.bilateral_mode)

    last = {}

    def track():
        res, last["levels"] = track_frame_pyramid(
            None, pose_before, pts, params=cfg.grid, cfg=cfg.tracking,
            levels=cfg.pyramid_levels, Dm=view)
        return int(res.iterations)

    times = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        track()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    tp = profile(track)
    host_ms = statistics.median(times[1:])
    rec.update(track_alone_ms=host_ms, track_device_ms=tp["device_ms"],
               track_busy=tp["device_ms"] / host_ms, track_device_ops=tp["device_ops"],
               track_host_syncs=tp["syncs"], track_copies=tp["copies"],
               track_launch_calls=tp["launches"], track_top=tp["top"])
    print(f"{label} {name}: {rec['ms_per_frame']:.2f} ms/frame (preprocess "
          f"{rec['preprocess_ms']:.2f}, track {rec['track_ms']:.2f}, fuse "
          f"{rec['fuse_ms']:.2f}), GN iterations {rec['gn_iterations']}, |t err| "
          f"{rec['t_err_mm']:.2f} mm; frame device {rec['frame_device_ms']:.3f} ms in "
          f"{rec['frame_device_ops']:.0f} ops, busy {rec['frame_busy']:.1%}; tracking "
          f"alone {host_ms:.2f} ms, device {tp['device_ms']:.3f} ms in "
          f"{tp['device_ops']} ops, busy {rec['track_busy']:.1%}, host syncs "
          f"{tp['syncs']}, copies {tp['copies']}")
    for t in tp["top"]:
        print(f"    {t['ms']:8.3f} ms {t['count']:5d}x {t['name']}")
    full_ms, done_ms = k1_alone(view, pose_before, pts, cfg)
    split = k1_split(sum(r.iterations for r in last["levels"]), len(tp["k1_us"]), full_ms,
                     done_ms, sum(tp["k1_us"]) / 1e3)
    rec.update(k1_track=split)
    print(f"{label} {name}: K1 alone at stride {cfg.tracking.pixel_stride}: full step "
          f"{full_ms:.5f}, done launch {done_ms:.5f} device ms; this frame's tracking: "
          f"{split['full_steps']} GN iterations x full + {split['done_launches']} other "
          f"launches x done = {split['split_ms']:.4f} ms, the profile's gn_step_kernel "
          f"{split['traced_ms']:.4f} ms")

    # 4. one frame's fusion alone, into the rows saved before the last frame
    f = cfg.fusion
    ce = f.color_every
    rgb_last = rgb if ce <= 1 or n % ce == 0 else None  # the runner's cadence

    def restore():
        for dst, src in zip((bg.D, bg.W, bg.C), rows_before):
            dst.copy_(src)
        torch.cuda.synchronize()

    def fuse():
        fuse_frame_brickmajor(bg, pose_fused, pts, nrm, rgb_last, params=cfg.grid, cam=cam,
                              cfg=f, bs=f.brick_shape, cap=cap,
                              cap_free=f.brick_cap_free or None)

    times = []
    for _ in range(6):
        restore()
        t0 = time.perf_counter()
        fuse()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    restore()
    torch.cuda.reset_peak_memory_stats()
    fuse()
    torch.cuda.synchronize()
    fuse_peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    restore()
    fp = profile(fuse)
    host_ms = statistics.median(times[1:])
    rec.update(fuse_alone_ms=host_ms, fuse_device_ms=fp["device_ms"],
               fuse_busy=fp["device_ms"] / host_ms, fuse_device_ops=fp["device_ops"],
               fuse_host_syncs=fp["syncs"], fuse_copies=fp["copies"],
               fuse_launch_calls=fp["launches"], fuse_peak_mib=fuse_peak_mib,
               fuse_cap=cap, fuse_color=rgb_last is not None, fuse_top=fp["top"])
    print(f"{label} {name}: fusion alone (cap {cap}, color {rgb_last is not None}) "
          f"{host_ms:.2f} ms, device {fp['device_ms']:.3f} ms in {fp['device_ops']} ops, "
          f"host syncs {fp['syncs']}, copies {fp['copies']}, peak {fuse_peak_mib:.0f} MiB "
          f"(the timed run's peak {peak_mib:.0f} MiB)")
    for t in fp["top"]:
        print(f"    {t['ms']:8.3f} ms {t['count']:5d}x {t['name']}")
    rec.update(fuse_stages(cfg, cam, pose_fused, pts, nrm, rgb_last, bg, cap, restore, label,
                           name))
    del bg, rows_before
    torch.cuda.empty_cache()
    if hasattr(Reconstruction, "process_chunk"):
        rec.update(chunked(cfg, cam, depths, poses, rgb, dev, name, label, full_ms, done_ms))
    return rec


def fuse_stages(cfg, cam, pose, pts, nrm, rgb, bg, cap, restore, label, name):
    """4, by stage: classify_compact_rows (with its mip), the pixel table and
    brick_fuse_rows, each called alone through its public name on the inputs
    of 4, timed unprofiled (median of 5) and profiled once: host ms, device
    ms and ops a call. The rows are restored before each K2 call."""
    from tracking_sdf_tpu_torch.fusion.brick import _pixel_table
    from tracking_sdf_tpu_torch.fusion.brick_fuse import brick_fuse_rows
    from tracking_sdf_tpu_torch.fusion.brickmajor import classify_compact_rows

    f = cfg.fusion
    bs, color = f.brick_shape, rgb is not None
    kw = dict(cam=cam, cfg=f, bs=bs, cap=cap, cap_free=f.brick_cap_free or cap)
    ids, _ = classify_compact_rows(cfg.grid, pose, pts, nrm, **kw)
    pix = _pixel_table(pts, nrm, rgb, color, f.distance)
    stages = {
        "classify": (lambda: classify_compact_rows(cfg.grid, pose, pts, nrm, **kw), None),
        "pixel_table": (lambda: _pixel_table(pts, nrm, rgb, color, f.distance), None),
        "brick_fuse_rows": (lambda: brick_fuse_rows(
            bg.D, bg.W, bg.C, ids, pix, pose, cap=cap, hw=tuple(pts.shape[:2]),
            params=cfg.grid, cam=cam, cfg=f, bs=bs), restore)}
    out = {}
    for key, (fn, before) in stages.items():
        times = []
        for _ in range(6):
            if before:
                before()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        if before:
            before()
        sp = profile(fn)
        out.update({f"{key}_alone_ms": statistics.median(times[1:]),
                    f"{key}_device_ms": sp["device_ms"], f"{key}_device_ops": sp["device_ops"]})
        print(f"{label} {name}: {key} alone {out[f'{key}_alone_ms']:.3f} ms, device "
              f"{sp['device_ms']:.4f} ms in {sp['device_ops']} ops")
    return out


def chunked(cfg, cam, depths, poses, rgb, dev, name, label, full_ms, done_ms):
    """5. The chunked path over the same frames, twice in fresh
    Reconstructions: frame 0 by process_frame, frames 1-2 as a first chunk
    (captures both color variants, with the phase calibration), the rest as
    one chunk of replays. In the first run that chunk runs without the
    calibration: its track_ms is its wall time (the replays and the one
    read) over its frames. In the second it runs under torch.profiler:
    device time, ops and host syncs per frame over the replayed chunk, and
    K1's launches told apart as full steps and done launches by their
    traced time against the midpoint of ``full_ms`` and ``done_ms``."""
    from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction

    n = len(depths)

    def run(profiled):
        recon = Reconstruction(cam, cfg, initial_pose=poses[0], device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        recon.process_frame(depths[0], rgb=rgb, timestamp=0.0)
        stats = recon.process_chunk(torch.stack(depths[1:3]), rgb[None].expand(2, -1, -1, -1))
        recon.chunk_phase_metrics = False
        last = lambda: recon.process_chunk(  # noqa: E731
            torch.stack(depths[3:n]), rgb[None].expand(n - 3, -1, -1, -1))
        prof = profile(last) if profiled else None
        stats += last() if not profiled else recon.stats[-(n - 3):]
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        steps = recon._chunk_steps
        out = dict(stats=stats, prof=prof, peak_mib=peak, t_err_mm=(
            recon.pose.t - poses[n - 1].t).norm().item() * 1e3,
            capture_ms=list(steps.capture_ms.values()), calibration_ms=steps.calibration_ms)
        recon.close()
        return out

    timed, profiled = run(False), run(True)
    frames = n - 3
    wall = timed["stats"][-1].track_ms
    prof = profiled["prof"]
    rec = dict(chunk_ms_per_frame=wall, chunk_frames=frames,
               chunk_device_ms=prof["device_ms"] / frames,
               chunk_device_ops=prof["device_ops"] / frames,
               chunk_host_syncs=prof["syncs"] / frames,
               chunk_busy=prof["device_ms"] / frames / wall,
               chunk_capture_ms=timed["capture_ms"], chunk_calibration_ms=timed["calibration_ms"],
               chunk_peak_mib=timed["peak_mib"], chunk_t_err_mm=timed["t_err_mm"],
               chunk_gn_iterations=[s.gn_iterations for s in timed["stats"]],
               chunk_top=prof["top"])
    print(f"{label} {name}: chunked, {frames} frames replayed: {wall:.3f} ms/frame wall, "
          f"device {rec['chunk_device_ms']:.3f} ms/frame in {rec['chunk_device_ops']:.0f} ops, "
          f"busy {rec['chunk_busy']:.1%}, host syncs {prof['syncs']} over the chunk call; "
          f"capture ms {[round(x, 1) for x in rec['chunk_capture_ms']]}, calibration ms "
          f"{[round(x, 1) for x in rec['chunk_calibration_ms']]}, peak {timed['peak_mib']:.0f} "
          f"MiB, GN iterations {rec['chunk_gn_iterations']}, |t err| "
          f"{timed['t_err_mm']:.2f} mm")
    for t in prof["top"]:
        print(f"    {t['ms']:8.3f} ms {t['count']:5d}x {t['name']}")
    cut_us = (full_ms + done_ms) / 2 * 1e3
    k1_us = prof["k1_us"]
    full = sum(us > cut_us for us in k1_us)
    split = k1_split(full / frames, len(k1_us) / frames, full_ms, done_ms,
                     sum(k1_us) / 1e3 / frames)
    rec.update(chunk_k1=dict(split, traced_full_ms=sum(us for us in k1_us if us > cut_us)
                             / 1e3 / frames))
    print(f"{label} {name}: K1 a replayed frame: {split['full_steps']:.2f} full steps "
          f"(traced longer than {cut_us / 1e3:.5f} ms) x {full_ms:.5f} + "
          f"{split['done_launches']:.2f} done launches x {done_ms:.5f} = "
          f"{split['split_ms']:.4f} ms; the profile's gn_step_kernel "
          f"{split['traced_ms']:.4f} ms a frame ({rec['chunk_k1']['traced_full_ms']:.4f} of "
          f"it in the full steps)")
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--presets", nargs="+", default=["tum256", "tum512"])
    ap.add_argument("--label", default="port")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_frames: needs a CUDA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs

    gpu = cs.gpu_line()
    print(f"gpu: {gpu}")
    recs = [run_preset(name, args.label, gpu) for name in args.presets]
    out = args.out or os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                                   "profile")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"profile_{args.label}.json"), "w") as f:
        json.dump(recs, f, indent=1)
    for r in recs:
        print(json.dumps({k: v for k, v in r.items()
                          if k not in ("track_top", "fuse_top", "chunk_top")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
