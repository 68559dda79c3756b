#!/usr/bin/env python3
"""chip_smoke.py's phase 10 (multi-device) alone, on one CUDA GPU.

    python3 tools/run_phase10.py

Builds the kernels and the native loader, renders the smoke's scene,
generates the 120-frame sequence on the card into a temporary directory
under build/, runs chip_smoke.multi_device_phase and prints its JSON
records. Imports no JAX.
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    import chip_smoke as cs
    from tracking_sdf_tpu_torch.core.camera import ros_default_camera
    from tracking_sdf_tpu_torch.data import native
    from tracking_sdf_tpu_torch.data.make_sequence import generate
    from tracking_sdf_tpu_torch.data.synthetic import render_scene_depth
    from tracking_sdf_tpu_torch.kernels import _build

    _build.library()
    native.load_library(force_build=True)
    cam, scene, poses = ros_default_camera(), cs.make_scene(), cs.make_poses("cuda")
    rgb = torch.full((cam.height, cam.width, 3), 0.5, device="cuda")
    depths = [render_scene_depth(scene, cam, p) for p in poses]
    os.makedirs(os.path.join(repo, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="phase10_", dir=os.path.join(repo, "build"))
    t0 = time.perf_counter()
    try:
        generate(os.path.join(work, "seq"), n_frames=cs.DATASET_FRAMES, device="cuda")
        record, slab, path = cs.multi_device_phase(cam, scene, depths, poses, rgb, "cuda",
                                                   work)
        print(json.dumps({"phase10": record}))
        print(json.dumps({"slab": slab, "path": path}))
    finally:
        shutil.rmtree(work, ignore_errors=True)
        print(f"phase 10: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
