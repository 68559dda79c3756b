"""One rank of a multi-process run of the sharded pipeline, for checks that
need real processes (a Gloo group on the CPU, or ranks on the card).

    python -m tracking_sdf_tpu_torch.parallel.worker SPEC.json RANK

SPEC.json (written by the launcher):
  coordinator   "host:port" of the group's TCP store; ranks   the group size
  device        "cpu" or "cuda"; out   the output directory
  inputs        an .npz: depths (F, H, W) float32 meters, optional rgbs
                (F, H, W, 3), poses_R (F, 3, 3) and poses_t (F, 3), the
                frames' true poses (frame 0 bootstraps from its own)
  cam           PinholeCamera fields
  runs          a list of runs, each {"name", "config": {"preset": name or
                null, "grid" / "fusion" / "tracking": field overrides, other
                PipelineConfig fields}, "frames": F, "chunk": [sizes] or
                absent, "fuse_check": bool, "track_check": {"xi": twist,
                "stride": s} or absent, "render": {"stride", "with_color"}
                or absent, "mesh": bool, "checkpoint": bool}
Every rank writes OUT/{name}_{rank}.npz and its trajectory OUT/{name}_traj_{rank}.txt:
the tracked poses, per-frame stats and times, the collectives (count,
seconds), the preprocessing kernels' launches, with rank 0 also writing the gathered brick rows, the sharded and
the single-device render of the gathered grid, and every rank its own mesh
slab. It imports no JAX.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch


def _config(spec: dict):
    from tracking_sdf_tpu_torch import config as C

    def tup(d):
        return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}

    spec = dict(spec)
    cfg = C.preset(spec.pop("preset")) if spec.get("preset") else C.PipelineConfig()
    spec.pop("preset", None)
    changes = {}
    for key in ("grid", "fusion", "tracking", "raycast"):
        if key in spec:
            changes[key] = getattr(cfg, key)._replace(**tup(spec.pop(key)))
    return dataclasses.replace(cfg, **changes, **tup(spec))


def _lanes(t: torch.Tensor) -> np.ndarray:
    return t.detach().contiguous().view(torch.int16).cpu().numpy().view(np.uint16)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit, every NaN alike (a NaN's payload depends on how it was
    made: a float32 NaN cast to bfloat16 on the CPU comes out as 0xffff)."""
    if not a.is_floating_point():
        return torch.equal(a, b)
    nan = torch.isnan(a)
    bits = torch.int16 if a.element_size() == 2 else torch.int32
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(a[~nan].view(bits), b[~nan].view(bits)))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_one(run: dict, mesh, cam, inputs, out_dir: str) -> dict:
    from tracking_sdf_tpu_torch.core.lie import Pose, pose_compose, se3_exp
    from tracking_sdf_tpu_torch.fusion import brick_classify
    from tracking_sdf_tpu_torch.fusion import brickmajor as tbm
    from tracking_sdf_tpu_torch.parallel import sharded
    from tracking_sdf_tpu_torch.parallel.mesh import gather_brick_grid
    from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction
    from tracking_sdf_tpu_torch.render.marching_cubes import marching_cubes_sharded
    from tracking_sdf_tpu_torch.render.raycast import raycast
    from tracking_sdf_tpu_torch.tracking import preprocess
    from tracking_sdf_tpu_torch.tracking.preprocess import preprocess_frame

    dev, name, rank = mesh.device, run["name"], mesh.rank
    cfg = _config(run["config"])
    traj = os.path.join(out_dir, f"{name}_traj_{rank}.txt")
    cfg = dataclasses.replace(cfg, trajectory_path=traj)
    n = run["frames"]
    depths = torch.from_numpy(inputs["depths"][:n]).to(dev)
    rgbs = (torch.from_numpy(inputs["rgbs"][:n]).to(dev) if "rgbs" in inputs.files
            else [None] * n)
    poses = [Pose(torch.from_numpy(inputs["poses_R"][k]).to(dev),
                  torch.from_numpy(inputs["poses_t"][k]).to(dev)) for k in range(n)]
    rec = {}

    if run.get("fuse_check") or run.get("track_check"):
        # one frame fused from empty at its true pose by the slab form, and
        # tracking straight off the rows from a perturbed pose
        pts, nrm = preprocess_frame(depths[0], cam=cam, bilateral=cfg.bilateral_filter,
                                    bilateral_mode=cfg.bilateral_mode)
        bs = cfg.fusion.brick_shape
        fuse = sharded.sharded_fuse_frame_brickmajor(
            mesh, params=cfg.grid, cam=cam, cfg=cfg.fusion, bs=bs,
            cap=run.get("cap"))
        bg = tbm.empty_brick_grid(cfg.grid, bs, device=dev,
                                  value_dtype=tbm.storage_dtype(cfg.fusion.storage_dtype),
                                  weight_dtype=tbm.storage_dtype(cfg.fusion.weight_dtype),
                                  nbi=mesh.slab(cfg.grid.m) // bs[0])
        _, _, st = fuse(bg, poses[0], pts, nrm, rgbs[0])
        rec["fuse_counts"] = np.asarray([st.n_full, st.overflow, st.n_free,
                                         st.overflow_active, st.overflow_mixed])
        whole = gather_brick_grid(bg, mesh)
        if rank == 0:
            rec.update(fuse_D=whole.D.float().cpu().numpy(),
                       fuse_W=whole.W.float().cpu().numpy(), fuse_C=_lanes(whole.C))
        tc = run.get("track_check")
        if tc:
            xi = torch.tensor(tc["xi"], dtype=torch.float32, device=dev)
            pose0 = pose_compose(se3_exp(xi), poses[0])
            tcfg = cfg.tracking._replace(pixel_stride=tc["stride"])
            res = sharded.sharded_track_frame_brickmajor(
                mesh, params=cfg.grid, cfg=tcfg, bs=bs)(bg.D, pose0, pts).read()
            rec.update(track_R=res.pose.R.numpy(), track_t=res.pose.t.numpy(),
                       track_valid=np.int64(res.num_valid))

    recon = Reconstruction(cam, cfg, initial_pose=poses[0], mesh=mesh)
    c0, s0 = mesh.collectives, mesh.collective_s
    counts = ("launches_pass", "launches_2d", "launches_normals")
    k567_counts = ("launches_tables", "launches_classify", "launches_compact")
    p0 = [getattr(preprocess, c) for c in counts]
    c0_k567 = [getattr(brick_classify, c) for c in k567_counts]
    chunks = run.get("chunk")
    wall = []
    t_start = time.perf_counter()
    if chunks:
        recon.process_frame(depths[0], rgbs[0], timestamp=0.0)
        k = 1
        for size in chunks:
            t0 = time.perf_counter()
            recon.process_chunk(depths[k:k + size],
                                None if rgbs[0] is None else rgbs[k:k + size],
                                timestamps=[float(i) for i in range(k, k + size)])
            _sync(dev)
            wall.append((time.perf_counter() - t0) * 1e3 / size)
            k += size
    else:
        for k in range(n):
            t0 = time.perf_counter()
            recon.process_frame(depths[k], rgbs[k], timestamp=float(k))
            _sync(dev)
            wall.append((time.perf_counter() - t0) * 1e3)
    run_s = time.perf_counter() - t_start
    stats = recon.stats
    rec.update(
        pose_R=recon.pose.R.cpu().numpy(), pose_t=recon.pose.t.cpu().numpy(),
        num_valid=np.asarray([s.num_valid for s in stats]),
        iterations=np.asarray([s.gn_iterations for s in stats]),
        rejected=np.asarray([s.rejected for s in stats]),
        ms_per_frame=np.asarray(wall), run_s=np.float64(run_s),
        collectives=np.int64(mesh.collectives - c0),
        collective_s=np.float64(mesh.collective_s - s0),
        overflow=np.int64(recon.overflow_drops),
        # K3's 1-D pass, its 2-D form and K4 over the run's frames
        preprocess_launches=np.asarray([getattr(preprocess, c) - b
                                        for c, b in zip(counts, p0)]),
        # K5, K6 and K7 over the run's fused frames
        classify_launches=np.asarray([getattr(brick_classify, c) - b
                                      for c, b in zip(k567_counts, c0_k567)]))
    whole = gather_brick_grid(recon.brick_grid, mesh)
    if rank == 0:
        rec.update(D=whole.D.float().cpu().numpy(), W=whole.W.float().cpu().numpy(),
                   C=_lanes(whole.C))

    r = run.get("render")
    if r:
        grid = recon.grid  # gathered: every rank
        _sync(dev)
        t0 = time.perf_counter()
        sh = recon.render(stride=r["stride"], with_color=r["with_color"])
        _sync(dev)
        rec["render_ms"] = np.float64((time.perf_counter() - t0) * 1e3)
        one = raycast(grid, recon.pose, params=cfg.grid, cam=cam, cfg=cfg.raycast,
                      stride=r["stride"], with_color=r["with_color"])
        same = True
        for field in ("depth", "range_t", "hit", "normal_world", "normal_cam", "rgb",
                      "steps"):
            a, b = getattr(sh, field), getattr(one, field)
            if a is None:
                continue
            same = same and same_bits(a, b)
        rec.update(render_equal=np.bool_(same), render_hits=np.int64(int(sh.hit.sum())),
                   render_dropped=np.int64(int(sh.dropped)))
        del grid
    if run.get("mesh"):
        _sync(dev)
        t0 = time.perf_counter()
        part = marching_cubes_sharded(recon._grid_slab(), mesh, params=cfg.grid,
                                      with_colors=True)
        _sync(dev)
        rec.update(mesh_ms=np.float64((time.perf_counter() - t0) * 1e3),
                   tris=part.vertices, cols=part.colors,
                   dropped_cells=np.int64(part.dropped_cells))
    if run.get("checkpoint"):
        ck = os.path.join(out_dir, f"{name}_ckpt")
        recon.save_checkpoint(ck)
        back = Reconstruction(cam, cfg, initial_pose=poses[0], mesh=mesh)
        back.restore_checkpoint(ck)
        rec["restore_equal"] = np.bool_(all(
            same_bits(getattr(back.brick_grid, k), getattr(recon.brick_grid, k))
            for k in "DWC"))
        if rank == 0:
            one = Reconstruction(cam, _config(run["config"]), initial_pose=poses[0],
                                 device=dev)
            one.restore_checkpoint(ck)
            rec["restore_single_equal"] = np.bool_(all(
                same_bits(getattr(one.brick_grid, k), getattr(whole, k)) for k in "DWC"))
            del one
        del back
    recon.close()
    np.savez(os.path.join(out_dir, f"{name}_{rank}.npz"), **rec)
    return rec


def main(argv=None) -> int:
    import torch.distributed as dist

    from tracking_sdf_tpu_torch.core.camera import PinholeCamera
    from tracking_sdf_tpu_torch.parallel.mesh import init_group, make_mesh

    spec_path, rank = (argv or sys.argv[1:])[:2]
    with open(spec_path) as f:
        spec = json.load(f)
    torch.set_num_threads(int(spec.get("threads", 1)))
    dev = init_group(device=spec["device"], coordinator=spec["coordinator"],
                     num_processes=spec["ranks"], process_id=int(rank), multihost=True)
    try:
        mesh = make_mesh(device=dev)
        cam = PinholeCamera(**spec["cam"])
        inputs = np.load(spec["inputs"])
        for run in spec["runs"]:
            run_one(run, mesh, cam, inputs, spec["out"])
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
