#!/usr/bin/env python3
"""Host cost of the sharded Gauss-Newton iteration on one CUDA GPU.

    python3 tools/sharded_gn_host_cost.py

Times `torch.linalg.solve_ex` on a 6x6 system, `gn_reduce.unpack`,
`gn_reduce.advance_state` (the eager step that ran after the all_reduce of
K1's slab sums before `gn_finish` took it over) and a one-rank NCCL
all_reduce of the 29 sums; then one sharded iteration as the tracker runs it
(the slab reduce, the all_reduce, `gn_finish`) beside the same iteration
finished by `advance_state`, on the rows of a one-rank tum256 mesh after
three frames of chip_smoke.py's scene (host ms an iteration, ended by a
synchronize); then profiles one tracked frame of that mesh, CPU and CUDA
activities, sorted by host time. Needs a CUDA GPU; imports no JAX.
"""
from __future__ import annotations

import os
import sys

import torch


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
    from tracking_sdf_tpu_torch.fusion.brickmajor import brick_masked_view
    from tracking_sdf_tpu_torch.parallel.mesh import init_group, make_mesh
    from tracking_sdf_tpu_torch.pipeline.runner import Reconstruction
    from tracking_sdf_tpu_torch.tracking.gn_reduce import (
        advance_state, init_state, slab_stepper, unpack)
    from tracking_sdf_tpu_torch.tracking.preprocess import preprocess_frame

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
    print(f"solve_ex {cs.host_ms(lambda: torch.linalg.solve_ex(A, b)):.4f} ms, unpack "
          f"{cs.host_ms(lambda: unpack(out)):.4f} ms, advance_state "
          f"{cs.host_ms(lambda: advance_state(state, *unpack(out), cfg)):.4f} ms a call")
    mesh = make_mesh(device=init_group(device=dev))
    try:
        x = torch.zeros(29, device=dev)
        print(f"all_reduce (one-rank NCCL group) {cs.host_ms(lambda: mesh.all_reduce_(x)):.4f} "
              "ms a call")
        cam, scene, poses = ros_default_camera(), cs.make_scene(), cs.make_poses(dev)
        rgb = torch.full((cam.height, cam.width, 3), 0.5, device=dev)
        depths = [render_scene_depth(scene, cam, p) for p in poses]
        r = Reconstruction(cam, cs.path_config("tum256", None), initial_pose=poses[0],
                           mesh=mesh)
        for k in range(3):
            r.process_frame(depths[k], rgb=rgb)
        torch.cuda.synchronize()
        tum = cs.path_config("tum256", None)
        never = tum.tracking._replace(max_iterations=1 << 30, min_iterations=0,
                                      max_twist_diff=-1.0)
        view = brick_masked_view(r.brick_grid, tum.grid, tum.fusion.brick_shape)
        pts = preprocess_frame(depths[3], cam=cam)[0][::3, ::3].reshape(-1, 3).contiguous()
        sa, sb = init_state(r.pose, never.damping), init_state(r.pose, never.damping)
        reduce_a, finish = slab_stepper(view, sa, pts, tum.grid, never)
        reduce_b, _ = slab_stepper(view, sb, pts, tum.grid, never)
        new_ms = cs.host_ms(lambda: finish(mesh.all_reduce_(reduce_a())))
        old_ms = cs.host_ms(lambda: advance_state(sb, *unpack(mesh.all_reduce_(reduce_b())),
                                                never))
        print(f"one sharded iteration at tum256 ({pts.shape[0]} queries, one-rank NCCL): "
              f"slab reduce + all_reduce + gn_finish {new_ms:.4f} ms a call; the same "
              f"finished by advance_state {old_ms:.4f} ms a call")
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
