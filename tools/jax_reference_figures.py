#!/usr/bin/env python3
"""The JAX package's figures that chip_smoke.py holds the port to.

Runs the JAX package (tracking_sdf_tpu) with JAX on the CPU and prints one
JSON line per figure. It imports JAX and, for the 120-frame sequence only,
the port's sequence generator (tracking_sdf_tpu_torch.data.make_sequence,
run on the CPU), so that both packages read the same files.

    python3 tools/jax_reference_figures.py [FIGURE ...] [--work DIR] [--frames N]

Figures (all but tum512_packed by default):
  synthetic64     the JAX README's first command, --preset synthetic64
                  --synthetic --frames 20 --mesh P --eval --json: ATE (mm)
  tum128_bench    the tum128 preset per frame on bench.py's scene and
                  trajectory (640x480, frame 0 bootstraps, 10 tracked
                  frames): final |t err| (mm)
  central_bench   the same with TrackingConfig(jacobian="central")
  tum128_dataset  --preset tum128 --dataset D --native-loader --eval over
                  the generated tabletop sequence: ATE (mm)
  tum256_dense    --preset tum256 --fusion-mode dense over the same
                  sequence (its first --frames frames): ATE (mm)
  tum256_packed, tum512_packed
                  --preset P --fusion-mode packed over the same sequence,
                  per frame: ATE (mm). tum512_packed holds a 3.2 GB float32
                  grid (and XLA's copies of it): run it only where the CPU
                  has the memory
  tum256_sharded_bench, tum512_sharded_bench
                  the preset on a 2-device mesh (Reconstruction(mesh=...),
                  the JAX package's sharded path: no pyramid, caps per
                  device) on bench.py's scene and trajectory: final |t err|
                  (mm) after 10 / 5 tracked frames
  tum256_sharded_dataset
                  --preset tum256 --distributed --native-loader --eval over
                  the generated sequence on 2 devices: ATE (mm)
The sharded figures run on 2 virtual CPU devices
(--xla_force_host_platform_device_count=2, set before JAX starts).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIGURES = ("synthetic64", "tum128_bench", "central_bench", "tum128_dataset", "tum256_dense",
           "tum256_sharded_bench", "tum512_sharded_bench", "tum256_sharded_dataset",
           "tum256_packed", "tum512_packed")
DEFAULT_FIGURES = FIGURES[:-1]  # all but tum512_packed
SHARDED_DEVICES = 2


def _jax_cpu():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def _cli(argv):
    """The JAX CLI in this process: its JSON summary."""
    from tracking_sdf_tpu import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv + ["--json", "--eval", "--cpu"])
    if rc != 0:
        raise RuntimeError(f"the JAX CLI exited with {rc}: {argv}")
    return json.loads(out.getvalue().strip().splitlines()[-1])


def bench_t_err_mm(jacobian: str, name: str = "tum128", tracked: int = 10,
                   sharded: bool = False) -> float:
    """A preset per frame on bench.py's scene and trajectory (chip_smoke's
    phase 5 scene): the final |t err| after ``tracked`` frames; ``sharded``
    on a mesh of SHARDED_DEVICES devices."""
    jax = _jax_cpu()
    import jax.numpy as jnp

    from tracking_sdf_tpu.config import preset
    from tracking_sdf_tpu.core.camera import ros_default_camera
    from tracking_sdf_tpu.core.lie import pose_compose, se3_exp
    from tracking_sdf_tpu.data.synthetic import (
        CuboidScene, SphereScene, look_at, render_scene_depth)
    from tracking_sdf_tpu.pipeline.runner import Reconstruction

    parts = (SphereScene(center=(0.3, 1.2, 0.9), radius=0.45),
             CuboidScene(min_corner=(-1.0, 1.0, 0.2), max_corner=(-0.3, 1.9, 0.9)),
             CuboidScene(min_corner=(-8.0, 2.6, -8.0), max_corner=(8.0, 3.0, 8.0)))

    class Scene:
        def intersect(self, o, d):
            t = parts[0].intersect(o, d)
            for s in parts[1:]:
                tb = s.intersect(o, d)
                t = jnp.where(jnp.isnan(t), tb,
                              jnp.where(jnp.isnan(tb), t, jnp.minimum(t, tb)))
            return t

    cam = ros_default_camera()
    poses = [look_at((0.0, -0.8, 0.8), (0.0, 1.2, 0.7))]
    xi_base = jnp.asarray([0.008, -0.004, 0.007, 0.007, -0.005, 0.006], jnp.float32)
    for k in range(1, 11):
        xi_k = xi_base * (1.0 + 0.3 * (1.0 if k % 2 == 0 else -1.0))
        poses.append(pose_compose(poses[-1], se3_exp(xi_k)))
    cfg = preset(name)
    cfg = dataclasses.replace(cfg, trajectory_path=None,
                              tracking=cfg.tracking._replace(jacobian=jacobian))
    mesh = None
    if sharded:
        from tracking_sdf_tpu.parallel import make_mesh

        mesh = make_mesh(jax.devices()[:SHARDED_DEVICES])
    recon = Reconstruction(cam, cfg, initial_pose=poses[0], mesh=mesh)
    rgb = jnp.full((cam.height, cam.width, 3), 0.5, jnp.float32)
    render = jax.jit(lambda p: render_scene_depth(Scene(), cam, p))
    for k in range(tracked + 1):
        st = recon.process_frame(render(poses[k]), rgb=rgb, timestamp=float(k))
        if st.rejected:
            raise RuntimeError(f"frame {k} rejected")
    return float(jnp.linalg.norm(recon.pose.t - poses[tracked].t)) * 1e3


def sequence(work: str) -> str:
    """The port's default 120-frame tabletop sequence, generated on the CPU."""
    root = os.path.join(work, "seq")
    if not os.path.exists(os.path.join(root, "groundtruth.txt")):
        subprocess.run([sys.executable, "-m", "tracking_sdf_tpu_torch.data.make_sequence",
                        "--out", root, "--cpu"], check=True, cwd=REPO)
    return root


def figure(name: str, work: str, frames: int) -> dict:
    t0 = time.perf_counter()
    if name == "synthetic64":
        _jax_cpu()
        s = _cli(["--preset", "synthetic64", "--synthetic", "--frames", "20", "--mesh",
                  os.path.join(work, "synthetic64.ply"), "--trajectory",
                  os.path.join(work, "synthetic64.txt")])
        out = dict(ate_mm=s["ate_rmse_m"] * 1e3, frames=s["frames"])
    elif name in ("tum128_bench", "central_bench"):
        out = dict(t_err_mm=bench_t_err_mm("analytic" if name == "tum128_bench"
                                           else "central"))
    elif name in ("tum256_sharded_bench", "tum512_sharded_bench"):
        preset_name = name.split("_")[0]
        tracked = 10 if preset_name == "tum256" else 5
        out = dict(t_err_mm=bench_t_err_mm("analytic", preset_name, tracked, sharded=True),
                   devices=SHARDED_DEVICES, tracked=tracked)
    else:
        root = sequence(work)
        _jax_cpu()
        argv = ["--preset", name.split("_")[0], "--dataset", root, "--native-loader",
                "--frames", str(frames), "--trajectory", os.path.join(work, f"{name}.txt")]
        if name in ("tum256_dense", "tum256_packed", "tum512_packed"):
            argv += ["--fusion-mode", name.split("_")[1]]
        if name == "tum256_sharded_dataset":
            argv += ["--distributed"]
        s = _cli(argv)
        out = dict(ate_mm=s["ate_rmse_m"] * 1e3, frames=s["frames"],
                   ate_pairs=s["ate_pairs"])
    return dict(figure=name, seconds=time.perf_counter() - t0, **out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("figures", nargs="*", help=f"any of {', '.join(FIGURES)} (default: all "
                                                  "but tum512_packed)")
    ap.add_argument("--work", default=os.path.join(REPO, "build", "jax_figures"))
    ap.add_argument("--frames", type=int, default=120,
                    help="frames of the generated sequence the dataset figures run")
    args = ap.parse_args()
    bad = set(args.figures) - set(FIGURES)
    if bad:
        ap.error(f"unknown figures {sorted(bad)}")
    os.makedirs(args.work, exist_ok=True)
    sys.path.insert(0, REPO)
    if any("sharded" in f for f in args.figures or DEFAULT_FIGURES):
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_force_host_"
                                   f"platform_device_count={SHARDED_DEVICES}").strip()
    import jax

    for name in args.figures or DEFAULT_FIGURES:
        print(json.dumps(dict(figure(name, args.work, args.frames), jax=jax.__version__)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
