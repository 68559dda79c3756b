#!/usr/bin/env python3
"""Host cost of the sharded Gauss-Newton iteration on one CUDA GPU.

    python3 tools/sharded_gn_host_cost.py

Times `torch.linalg.solve_ex` on a 6x6 system, `gn_reduce.unpack` and
`gn_reduce.advance_state` (the step every rank runs after the all_reduce of
K1's slab sums), and a one-rank NCCL all_reduce of the 29 sums; then profiles
one tracked tum256 frame of a one-rank mesh (Reconstruction(mesh=...)) on
chip_smoke.py's scene, CPU and CUDA activities, sorted by host time. Needs a
CUDA GPU; imports no JAX.
"""
from __future__ import annotations

import os
import sys
import time

import torch


def timed_ms(fn, n: int = 50) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile
    from tracking_sdf_tpu_torch.config import TrackingConfig
    from tracking_sdf_tpu_torch.core.camera import ros_default_camera
    from tracking_sdf_tpu_torch.core.lie import Pose
    from tracking_sdf_tpu_torch.data.synthetic import render_scene_depth
    from tracking_sdf_tpu_torch.parallel.mesh import init_group, make_mesh
    from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction
    from tracking_sdf_tpu_torch.tracking.gn_reduce import advance_state, init_state, unpack

    import torch.distributed as dist

    dev = "cuda"
    print(cs.gpu_line())
    cfg = TrackingConfig()
    state = init_state(Pose(torch.eye(3, device=dev), torch.zeros(3, device=dev)),
                       cfg.damping)
    out = torch.randn(29, device=dev)
    out[27] = 100.0
    A = torch.randn(6, 6, device=dev)
    A = A @ A.T + torch.eye(6, device=dev)
    b = torch.randn(6, device=dev)
    print(f"solve_ex {timed_ms(lambda: torch.linalg.solve_ex(A, b)):.4f} ms, unpack "
          f"{timed_ms(lambda: unpack(out)):.4f} ms, advance_state "
          f"{timed_ms(lambda: advance_state(state, *unpack(out), cfg)):.4f} ms a call")
    mesh = make_mesh(device=init_group(device=dev))
    try:
        x = torch.zeros(29, device=dev)
        print(f"all_reduce (one-rank NCCL group) {timed_ms(lambda: mesh.all_reduce_(x)):.4f} "
              "ms a call")
        cam, scene, poses = ros_default_camera(), cs.make_scene(), cs.make_poses(dev)
        rgb = torch.full((cam.height, cam.width, 3), 0.5, device=dev)
        depths = [render_scene_depth(scene, cam, p) for p in poses]
        r = Reconstruction(cam, cs.path_config("tum256", None), initial_pose=poses[0],
                           mesh=mesh)
        for k in range(3):
            r.process_frame(depths[k], rgb=rgb)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            st = r.process_frame(depths[3], rgb=rgb)
            torch.cuda.synchronize()
        print(st)
        print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=25))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
