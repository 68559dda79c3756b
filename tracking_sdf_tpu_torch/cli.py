"""Command-line entry point: `python -m tracking_sdf_tpu_torch.cli ...`
(counterpart of tracking_sdf_tpu.cli, with the same flags).

Replays a TUM sequence (or a synthetic scene), tracks and fuses it, writes
the trajectory and evaluates it against the dataset's groundtruth. It runs
on the GPU; ``--cpu`` asks for the CPU, and without a GPU and without
``--cpu`` it exits with an error instead of carrying on there.

Examples
--------
A generated sequence at the reference's configuration:
    python -m tracking_sdf_tpu_torch.data.make_sequence --out /tmp/seq
    python -m tracking_sdf_tpu_torch.cli --preset tum256 --dataset /tmp/seq \\
        --native-loader --chunk 8 --trajectory trajectory.txt --eval --json

Multi-device runs: ``--distributed`` shards the grid over a process group,
one rank per device (parallel.sharded). Alone it is a one-rank group on this
process's device. With ``--multihost --coordinator HOST:PORT --num-processes
N --process-id R`` each of N processes joins one group over a TCP store
(rank 0 serves it); ``--multihost`` without a coordinator reads the
launcher's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT). NCCL
serves ranks with a GPU each, Gloo the CPU and ranks that share one GPU.
Every rank runs the same command (its own ``--trajectory``); rank 0 writes
the mesh, the render and the checkpoint.

``--debug-nans`` checks the grid's and the pose's invariants after every
frame on the device (utils.debug_nans) and raises FloatingPointError at the
first frame that breaks one.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tracking_sdf_tpu_torch",
        description="TSDF camera tracking and reconstruction in PyTorch and CUDA",
    )
    p.add_argument("--preset", default="tum256",
                   help="config preset: synthetic64|tum128|tum256|tum256central|tum512")
    p.add_argument("--dataset", help="TUM sequence directory (depth.txt, ...)")
    p.add_argument("--camera", default=None,
                   help="dataset intrinsics: 'fr1' (default) | 'kinect' | "
                        "'fx,fy,cx,cy[,width,height]'")
    p.add_argument("--synthetic", action="store_true",
                   help="run on a generated synthetic orbit instead of a dataset")
    p.add_argument("--frames", type=int, default=None, help="max frames")
    p.add_argument("--chunk", type=int, default=0,
                   help="hand N frames at a time to the chunked runner "
                        "(brickmajor only): one host read per chunk, each "
                        "frame a CUDA-graph replay; frame 0 and odd tails "
                        "run per frame")
    p.add_argument("--frame-step", type=int, default=1,
                   help="process every Nth frame (the paper's §V-D "
                        "robustness study runs every 6th)")
    p.add_argument("--realtime", type=float, default=0.0, metavar="HZ",
                   help="paced replay at HZ frames/s wall-clock with "
                        "queue-size-1 drop-stale-when-behind semantics: "
                        "when processing lags the sensor, every frame but "
                        "the newest is dropped and the tracker must bridge "
                        "the gap. The first 2 frames are delivered un-paced "
                        "before the arrival clock starts. Drops are "
                        "reported. Incompatible with --chunk.")
    p.add_argument("--trajectory", default="trajectory.txt",
                   help="output TUM trajectory path ('' disables)")
    p.add_argument("--mesh", help="export a PLY mesh at the end")
    p.add_argument("--render", help="raycast the final model to a PNG (depth, "
                                    "normals, and color unless --no-color)")
    p.add_argument("--mesh-every", type=int, default=0,
                   help="also export the --mesh PLY every N frames")
    p.add_argument("--mesh-async", metavar="PLY",
                   help="live mesh: a background thread re-exports this PLY "
                        "while the frames run")
    p.add_argument("--mesh-hz", type=float, default=0.0,
                   help="--mesh-async export rate (0 = 1 Hz; it degrades, "
                        "with a warning, when an export takes longer)")
    p.add_argument("--mesh-decimate", type=int, default=0,
                   help="--mesh-async voxel decimation (0 = auto: 4 at 512^3, "
                        "2 at 256^3, else 1)")
    p.add_argument("--debug-nans", action="store_true",
                   help="check the grid's and the pose's invariants after every "
                        "frame on the device (no NaN in D where W > 0, finite "
                        "weights, colors and pose) and raise FloatingPointError "
                        "at the first frame that breaks one")
    p.add_argument("--eval", action="store_true",
                   help="print ATE RMSE vs the dataset's groundtruth.txt")
    p.add_argument("--groundtruth-poses", action="store_true",
                   help="fusion-only oracle mode: poses from groundtruth")
    p.add_argument("--no-color", action="store_true", help="skip color fusion")
    p.add_argument("--no-bilateral", action="store_true")
    p.add_argument("--pixel-stride", type=int, default=None)
    p.add_argument("--color-every", type=int, default=0,
                   help="fuse COLOR on every Nth frame only (geometry "
                        "fuses every frame; 1 = reference cadence). "
                        "Presets pick the measured default.")
    p.add_argument("--brick-cap", type=int, default=0,
                   help="override FusionConfig.brick_cap (FULL-brick "
                        "capacity per frame; overflow is reported)")
    p.add_argument("--brick-cap-free", type=int, default=-1,
                   help="override FusionConfig.brick_cap_free (FREE-brick "
                        "row capacity; overflow reported). 0 = follow "
                        "brick_cap; negative = keep preset")
    p.add_argument("--pixel-share", type=int, default=None,
                   help="approximate fast fusion: k-voxel groups of this "
                        "size share one gathered pixel (1 = exact)")
    p.add_argument("--share-safe-classify", choices=("on", "off"), default=None,
                   help="exact-under-share FREE/OCCLUDED proof bounds "
                        "(FusionConfig.share_safe_classify)")
    p.add_argument("--fusion-mode",
                   choices=("dense", "bricked", "brickmajor", "packed"),
                   default=None,
                   help="override the preset's fusion path (packed: "
                        "brick-major on float32 rows, per frame)")
    p.add_argument("--distance", choices=("point_to_plane", "point_to_point"),
                   default=None, help="fusion distance")
    p.add_argument("--storage-dtype", choices=("float32", "bfloat16"), default=None,
                   help="grid value-leaf storage dtype (brickmajor mode)")
    p.add_argument("--weight-dtype", choices=("float32", "bfloat16"), default=None,
                   help="weight-accumulator storage dtype (brickmajor mode); "
                        "pair bfloat16 with --max-weight")
    p.add_argument("--max-weight", type=float, default=-1.0,
                   help="clamp the stored fusion weight. 0 DISABLES the "
                        "clamp; negative = keep preset")
    p.add_argument("--distributed", action="store_true",
                   help="shard the grid over a process group, one rank per "
                        "device (alone: a one-rank group on this device)")
    p.add_argument("--progress", action="store_true")
    p.add_argument("--json", action="store_true", help="print summary as JSON")
    p.add_argument("--profile",
                   help="capture a torch.profiler trace of the run into this "
                        "directory (trace.json, Chrome trace format) and trace "
                        "the port for the run (utils/profiling.py): the chunked "
                        "runner's tsdf.* spans, and each chunked frame's device "
                        "stamps and GN steps a pyramid level in --metrics-log")
    p.add_argument("--checkpoint",
                   help="checkpoint directory; resumes from it when present")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="save the checkpoint every N frames")
    p.add_argument("--metrics-log",
                   help="append per-frame stats as JSON lines to this file")
    p.add_argument("--native-loader", action="store_true",
                   help="stream frames through the C++ prefetching loader "
                        "(an error when it cannot be built)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the default, and the only other "
                        "choice, is the CUDA GPU)")
    p.add_argument("--multihost", action="store_true",
                   help="join a process group of several processes first; "
                        "combine with --distributed to shard over all of them")
    p.add_argument("--coordinator", default=None,
                   help="host:port of the group's TCP store for --multihost "
                        "(with --num-processes/--process-id); omit to read the "
                        "launcher's environment (RANK, WORLD_SIZE, MASTER_ADDR)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="total process count for --multihost --coordinator")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank for --multihost --coordinator")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from tracking_sdf_tpu_torch.utils import debug_nans

    if args.cpu:
        device = "cpu"
    elif torch.cuda.is_available():
        device = "cuda"
    else:
        print("error: no CUDA GPU found; pass --cpu to run on the CPU", file=sys.stderr)
        return 1

    group = None
    if args.multihost or args.distributed:
        from tracking_sdf_tpu_torch.parallel.mesh import init_group, make_mesh

        device = init_group(device=device, coordinator=args.coordinator,
                            num_processes=args.num_processes,
                            process_id=args.process_id, multihost=args.multihost)
        group = make_mesh(device=device)
    try:
        # the JAX flag sets a process-wide switch; this one holds for the run
        with debug_nans.switch(args.debug_nans):
            return _run(args, device, group)
    finally:
        if group is not None:
            import torch.distributed as dist

            dist.destroy_process_group()


def _run(args, device, group) -> int:
    """The run after the device (and, for --multihost / --distributed, the
    process group ``group``, a parallel.mesh.Mesh) is set up."""
    import torch

    from tracking_sdf_tpu_torch import config
    from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction, unsupported
    from tracking_sdf_tpu_torch.pipeline.trajectory import (
        Trajectory, ate_rmse, read_trajectory, rpe_rmse)

    cfg = config.preset(args.preset)
    changes = {}
    fusion = cfg.fusion
    if args.no_color:
        fusion = fusion._replace(fuse_color=False)
    if args.pixel_share:
        fusion = fusion._replace(pixel_share=args.pixel_share)
    if args.share_safe_classify is not None:
        fusion = fusion._replace(share_safe_classify=args.share_safe_classify == "on")
    if args.brick_cap:
        fusion = fusion._replace(brick_cap=args.brick_cap)
    if args.brick_cap_free >= 0:
        fusion = fusion._replace(brick_cap_free=args.brick_cap_free)
    if args.color_every:
        fusion = fusion._replace(color_every=args.color_every)
    if args.fusion_mode:
        switched = args.fusion_mode != cfg.fusion.mode
        fusion = fusion._replace(mode=args.fusion_mode)
        if args.fusion_mode in ("brickmajor", "packed") and switched and cfg.grid.m % 8 == 0:
            # a preset of another layout carries that layout's brick shape
            fusion = fusion._replace(brick_shape=(8, 8, 8))
    if args.storage_dtype:
        fusion = fusion._replace(storage_dtype=args.storage_dtype)
    if args.weight_dtype:
        fusion = fusion._replace(weight_dtype=args.weight_dtype)
    if args.max_weight >= 0:
        # 0 turns the clamp off (None); the presets ship max_weight=128
        fusion = fusion._replace(max_weight=args.max_weight or None)
    if args.distance:
        fusion = fusion._replace(distance=args.distance)
    if fusion is not cfg.fusion:
        changes["fusion"] = fusion
    if args.no_bilateral:
        changes["bilateral_filter"] = False
    if args.pixel_stride:
        changes["tracking"] = cfg.tracking._replace(pixel_stride=args.pixel_stride)
    if args.groundtruth_poses:
        changes["use_groundtruth"] = True
    changes["trajectory_path"] = args.trajectory or None
    if args.mesh_hz:
        changes["mesh_hz"] = args.mesh_hz
    if args.mesh_decimate:
        changes["mesh_decimate"] = args.mesh_decimate
    cfg = dataclasses.replace(cfg, **changes)
    mesh = group if args.distributed else None
    # the modes that the preset and the flags select, ported or not
    refused = unsupported(cfg, sharded=mesh is not None)
    if refused:
        print("error: not ported: " + "; ".join(refused), file=sys.stderr)
        return 2

    if args.synthetic:
        dataset, cam, init_pose = _synthetic_dataset(cfg, args.frames or 20, device)
    elif args.dataset:
        from tracking_sdf_tpu_torch.data.tum import TUMDataset

        dataset = TUMDataset(args.dataset, with_rgb=not args.no_color)
        if args.frame_step > 1:
            dataset = _SubsampledDataset(dataset, args.frame_step)
        cam = _parse_camera(args.camera)
        init_pose = None
        if cfg.use_groundtruth and dataset.groundtruth is None:
            print("error: --groundtruth-poses needs groundtruth.txt", file=sys.stderr)
            return 2
    else:
        print("error: need --dataset DIR or --synthetic", file=sys.stderr)
        return 2

    recon = Reconstruction(cam, cfg, initial_pose=init_pose, device=device, mesh=mesh)
    skip = 0
    if args.checkpoint:
        from tracking_sdf_tpu_torch.pipeline import checkpoint as ckpt

        if ckpt.exists(args.checkpoint):
            recon.restore_checkpoint(args.checkpoint)
            skip = recon.frame_num
            print(f"resumed from {args.checkpoint} at frame {skip}", file=sys.stderr)

    # taken now: the native stream below has no .groundtruth and is used up
    # by run(), which would leave --eval with nothing
    gt_source = getattr(dataset, "groundtruth", None)
    frames = dataset
    pacer = None
    if args.realtime:
        if args.chunk > 1:
            print("warning: --realtime is arrival-driven per-frame; "
                  "ignoring --chunk", file=sys.stderr)
            args.chunk = 0
        from tracking_sdf_tpu_torch.pipeline.realtime import (
            MultihostRealtimePacer, RealtimePacer)

        if args.multihost:
            # rank 0 owns the arrival clock and broadcasts each chosen frame:
            # every rank runs the same frames (the same collectives)
            frames = pacer = MultihostRealtimePacer(dataset, group, hz=args.realtime)
        else:
            frames = pacer = RealtimePacer(dataset, hz=args.realtime)
    elif args.native_loader and hasattr(dataset, "stream"):
        # chunked runs take the raw uint16 / uint8 wire formats (a sixth of
        # the bytes), which process_chunk decodes on the device
        frames = dataset.stream(raw=args.chunk > 1)

    if args.mesh_async:
        recon.start_mesh_publisher(args.mesh_async, with_colors=not args.no_color)

    profile_cm = contextlib.nullcontext()
    if args.profile:
        from tracking_sdf_tpu_torch.utils import profiling

        profiling.enable_tracing(True)
        profile_cm = profiling.trace(args.profile)
    t0 = time.perf_counter()
    try:
        with profile_cm:
            recon.run(frames, max_frames=args.frames, progress=args.progress,
                      mesh_every=args.mesh_every, mesh_path=args.mesh,
                      checkpoint_every=args.checkpoint_every,
                      checkpoint_path=args.checkpoint,
                      metrics_log=args.metrics_log, skip_frames=skip,
                      chunk=args.chunk)
            if device == "cuda":
                torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        # under a mesh every rank meshes and renders (collectives); rank 0 writes
        writer = mesh is None or mesh.rank == 0
        if args.mesh:
            n_tri = recon.export_mesh(args.mesh)
            if writer:
                print(f"mesh: {n_tri} triangles -> {args.mesh}", file=sys.stderr)
        if args.render:
            from tracking_sdf_tpu_torch.render.image_io import save_render_png

            result = recon.render(with_color=not args.no_color)
            if writer:
                save_render_png(result, args.render)
                print(f"render -> {args.render}", file=sys.stderr)
    finally:
        recon.close()
        if args.profile:
            profiling.enable_tracing(False)

    summary = recon.summary()
    # wall clock around run(): loading, decoding and staging included
    summary["run_s"] = run_s
    summary["run_frames"] = float(len(recon.emit_times))
    summary["steady_ms"] = _steady_ms(recon.emit_times, args.chunk)
    if mesh is not None:
        summary["ranks"] = float(mesh.size)
        summary["collectives"] = float(mesh.collectives)
        summary["collective_s"] = mesh.collective_s
    if pacer is not None:
        summary["realtime_dropped"] = float(pacer.dropped)
        summary["realtime_yielded"] = float(pacer.yielded)
        print(f"realtime: {pacer.yielded} frames processed, "
              f"{pacer.dropped} dropped stale at {args.realtime:g} Hz",
              file=sys.stderr)
    if args.eval and args.trajectory:
        gt = gt_source
        if gt is None:
            # synthetic mode: the groundtruth is the frames' own poses
            import numpy as np

            with_gt = [f for f in dataset if getattr(f, "gt_pose", None) is not None]
            if with_gt:
                gt = Trajectory(np.asarray([f.timestamp for f in with_gt]),
                                np.stack([f.gt_pose[0] for f in with_gt]),
                                np.stack([f.gt_pose[1] for f in with_gt]))
        if gt is not None:
            est = read_trajectory(args.trajectory)
            rmse, n = ate_rmse(est, gt)
            summary["ate_rmse_m"] = rmse
            summary["ate_pairs"] = float(n)
            summary["rpe_trans_m"], summary["rpe_rot_rad"] = rpe_rmse(est, gt, delta=1)

    if args.json:
        # a non-finite value (ATE with fewer than 2 pairs) is not valid JSON
        print(json.dumps({
            k: (None if isinstance(v, float) and not math.isfinite(v) else v)
            for k, v in summary.items()}))
    else:
        for k, v in summary.items():
            print(f"{k}: {v:.4f}")
    return 0


def _steady_ms(emit_times, chunk: int) -> float:
    """Median host ms a frame between the ends of consecutive chunks of
    ``chunk`` frames after frame 0 (between frames when per frame): run()
    stamps each frame as it emits it, a chunk's frames together."""
    import statistics

    step = max(chunk, 1)
    ends = emit_times[step::step] if chunk > 1 else emit_times
    gaps = [(b - a) * 1e3 / step for a, b in zip(ends, ends[1:])]
    return statistics.median(gaps) if gaps else float("nan")


class _SubsampledDataset:
    """Every-Nth-frame view of a TUMDataset (the paper's §V-D robustness
    study: the tracker must survive N times the motion between frames)."""

    def __init__(self, ds, step: int):
        self._ds = ds
        self._idx = list(range(0, len(ds), step))
        self.groundtruth = ds.groundtruth

    def __len__(self):
        return len(self._idx)

    def __getitem__(self, i):
        return self._ds[self._idx[i]]

    def __iter__(self):
        for i in self._idx:
            yield self._ds[i]

    def stream(self, **kw):
        return self._ds.stream(indices=self._idx, **kw)


def _parse_camera(spec):
    """'fr1' | 'kinect' | 'fx,fy,cx,cy[,width,height]' -> PinholeCamera."""
    from tracking_sdf_tpu_torch.core.camera import (
        PinholeCamera, ros_default_camera, tum_fr1_camera)

    if spec in (None, "fr1"):
        return tum_fr1_camera()
    if spec == "kinect":
        return ros_default_camera()
    vals = [float(v) for v in spec.split(",")]
    if len(vals) not in (4, 6):
        raise SystemExit(f"--camera: expected 4 or 6 comma-separated values, "
                         f"got {len(vals)}")
    kw = dict(zip(("fx", "fy", "cx", "cy"), vals[:4]))
    if len(vals) == 6:
        kw.update(width=int(vals[4]), height=int(vals[5]))
    return PinholeCamera(**kw)


def _synthetic_dataset(cfg, n_frames, device):
    """A gentle orbit around a sphere and a box placed in the preset's grid
    volume, rendered on ``device``: (frames, camera, first pose)."""
    import numpy as np
    import torch

    from tracking_sdf_tpu_torch.core.camera import PinholeCamera
    from tracking_sdf_tpu_torch.core.lie import quaternion_from_matrix
    from tracking_sdf_tpu_torch.data.make_sequence import _Scene
    from tracking_sdf_tpu_torch.data.synthetic import (
        CuboidScene, SphereScene, look_at, render_scene_depth)
    from tracking_sdf_tpu_torch.data.tum import TUMFrame

    g = cfg.grid
    cx = g.origin[0] + g.width / 2
    cy = g.origin[1] + g.height / 2
    cz = g.origin[2] + g.depth / 2
    r = min(g.width, g.height, g.depth)
    scene = _Scene([
        SphereScene(center=(cx + 0.1 * r, cy + 0.05 * r, cz), radius=0.2 * r),
        CuboidScene(min_corner=(cx - 0.35 * r, cy - 0.2 * r, cz - 0.25 * r),
                    max_corner=(cx - 0.15 * r, cy + 0.2 * r, cz + 0.1 * r))])
    cam = PinholeCamera(fx=220.0, fy=220.0, cx=127.5, cy=95.5, width=256, height=192)
    rgb = np.broadcast_to(np.asarray([0.6, 0.5, 0.4], np.float32),
                          (cam.height, cam.width, 3))

    frames, first = [], None
    for i in range(n_frames):
        # inter-frame motion of a few cm, trackable frame to model
        a = 0.08 * np.sin(2 * np.pi * i / max(n_frames, 2))
        eye = (cx + 0.45 * r * np.sin(a), cy - 0.45 * r * np.cos(a), cz + 0.1 * r)
        pose = look_at(eye, (cx, cy, cz), device=device)
        first = pose if first is None else first
        depth = render_scene_depth(scene, cam, pose)
        frames.append(TUMFrame(
            timestamp=1000.0 + i / 30.0, depth=depth.cpu().numpy(), rgb=rgb,
            gt_pose=(pose.t.cpu().numpy(), quaternion_from_matrix(pose.R).cpu().numpy())))
    return frames, cam, first


if __name__ == "__main__":
    sys.exit(main())
