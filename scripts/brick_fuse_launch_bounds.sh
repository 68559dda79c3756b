#!/bin/bash
# Device time of brick_fuse_rows under three register budgets, on one GPU.
#
#   bash scripts/brick_fuse_launch_bounds.sh      # from the repository root
#
# For each minimum-blocks value of __launch_bounds__(kMaxThreads, N) in
# csrc/brick_fuse.cu (N = 2, 3, 4: at most 64, 42 and 32 registers a
# thread), copies the port and chip_smoke.py into build/launch_bounds/vN,
# sets the bound there, builds, and runs chip_smoke.fuse_rows_compare on the
# second frame's real lists at tum256 and tum512 (geometry and color), which
# also checks the kernel bit for bit against its plain version. Prints the
# registers ptxas used and the kernel lines of each run.
set -eu
cd "$(dirname "$0")/.."
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for n in 2 3 4; do
  d=build/launch_bounds/v$n
  rm -rf "$d"
  mkdir -p "$d"
  cp -r tracking_sdf_tpu_torch chip_smoke.py "$d"/
  sed -i -E "s/__launch_bounds__\(kMaxThreads(, [0-9]+)?\)/__launch_bounds__(kMaxThreads, $n)/" \
    "$d"/tracking_sdf_tpu_torch/csrc/brick_fuse.cu
  (cd "$d" && python3 - <<'PY'
import torch

import chip_smoke as cs
from tracking_sdf_tpu_torch.core.camera import ros_default_camera
from tracking_sdf_tpu_torch.kernels import _build

_build.library()
log = _build.build_log().splitlines()
for i, line in enumerate(log):
    if "brick_fuse_rows_kernel" in line and "Compiling" in line:
        used = next(x for x in log[i + 1:] if "Used" in x)
        print(line.split("brick_fuse_rows_kernel")[1][:24], used.strip())
cam = ros_default_camera()
poses = cs.make_poses("cuda")
rgb = torch.full((cam.height, cam.width, 3), 0.5, device="cuda")
for name in ("tum256", "tum512"):
    cs.fuse_rows_compare(name, cam, cs.make_scene(), poses, rgb, "cuda")
PY
  ) 2>&1 | grep -E "Used|^K2" | sed -E 's/; the unfused chain.*//' | sed "s/^/bound N=$n: /"
done
