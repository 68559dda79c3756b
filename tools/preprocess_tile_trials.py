"""Tile trials for K3 (both forms) and K4 (csrc/preprocess.cu) on a CUDA card.

Builds csrc/preprocess.cu once for each candidate (K3's separable tile
kSepW x kSepH, pass-1 strip kSepStrip and pass-2 pixels a thread kSepPx;
K3's 2-D tile k2dW x k2dH and pixels a thread k2dPx; K4's tile kNormW x
kNormH, threads, column strip and resident blocks; one nvcc a candidate,
all started together), then, on chip_smoke.py's phase 12 inputs (the
scene's second frame at 640x480 and its speckled copy), runs K3's separable
filter (one launch), its 2-D filter at the compiled radius and K4 from depth
in each build: every output bit against the plain versions, and each
kernel's device time from torch.profiler over 200 launches
(chip_smoke.kernel_device_ms; the run fails if no profile saw a kernel).
Prints one line a candidate with the registers nvcc reports, the card's
name, power limit and SM clock, and writes the records as JSON into --out.

    python3 tools/preprocess_tile_trials.py [--out DIR]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from tracking_sdf_tpu_torch.core.camera import backproject, ros_default_camera  # noqa: E402
from tracking_sdf_tpu_torch.data.synthetic import render_scene_depth  # noqa: E402
from tracking_sdf_tpu_torch.kernels import _build  # noqa: E402
from tracking_sdf_tpu_torch.tracking import preprocess as pre  # noqa: E402

# csrc/preprocess.cu's constants a candidate sets; the first candidate is
# the committed source's. K3: (kSepW, kSepH, kSepStrip, kSepPx); K3's 2-D
# form: (k2dW, k2dH, k2dPx); K4: (kNormW, kNormH, kNormBlocks, kNormThreads,
# kNormStrip)
K3_CANDIDATES = [(128, 4, 2, 2), (64, 8, 2, 4), (64, 8, 2, 2), (64, 8, 1, 2), (128, 4, 2, 4),
                 (64, 16, 2, 2), (32, 16, 2, 2), (128, 8, 2, 2)]
K2D_CANDIDATES = [(64, 8, 2), (32, 8, 2), (128, 4, 2), (32, 16, 2), (64, 4, 2), (64, 8, 4),
                  (32, 8, 4), (128, 8, 2)]
K4_CANDIDATES = [(32, 16, 5, 128, 8), (32, 16, 4, 128, 8), (32, 16, 6, 128, 8),
                 (32, 8, 10, 64, 8), (64, 8, 5, 128, 8), (16, 16, 10, 64, 8),
                 (32, 16, 4, 192, 4), (64, 16, 3, 256, 8)]
CANDIDATES = [dict(kSepW=a[0], kSepH=a[1], kSepStrip=a[2], kSepPx=a[3], k2dW=c[0], k2dH=c[1],
                   k2dPx=c[2], kNormW=b[0], kNormH=b[1], kNormBlocks=b[2], kNormThreads=b[3],
                   kNormStrip=b[4])
              for a, c, b in zip(K3_CANDIDATES, K2D_CANDIDATES, K4_CANDIDATES)]
LAUNCHES = 200


def variant_source(consts) -> str:
    src = (_build.CSRC / "preprocess.cu").read_text()
    for name, value in consts.items():
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                         src)
        assert n == 1, name
    return src


def build_all(out_dir: Path):
    """One shared library a candidate, the nvcc processes started together;
    returns [(library path, nvcc's -Xptxas -v lines for the two kernels)]."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, consts in enumerate(CANDIDATES):
        cu = out_dir / f"preprocess_{i}.cu"
        cu.write_text(variant_source(consts))
        so = out_dir / f"libpreprocess_{i}.so"
        procs.append((so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    built = []
    for so, p in procs:
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {so.name}:\n{log}")
        built.append((so, _ptxas_lines(log)))
    return built


def _ptxas_lines(log: str):
    """'kernel: N registers' for the bilateral and normals kernels."""
    out, fn = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and fn and ("bilateral" in fn or "normals" in fn):
            out.append(f"{fn[-40:]}: {m.group(1)} regs")
    return out


def load(so: Path):
    lib = ctypes.CDLL(str(so))
    for name in ("tsdf_bilateral_pass", "tsdf_bilateral_2d", "tsdf_normals"):
        fn = getattr(lib, name)
        fn.argtypes = _build._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def frames(dev):
    """chip_smoke.py phase 12's inputs: the scene's second frame and its
    speckled copy."""
    cam = ros_default_camera()
    depth = render_scene_depth(smoke.make_scene(), cam, smoke.make_poses(dev)[1]).contiguous()
    return cam, {"scene": depth, "speckled": smoke.speckled(depth, 12)}


def bits_differ(got, want) -> int:
    """Finite values that differ bit for bit, plus pixels whose NaN mask differs."""
    _, mismatch, bits = smoke.image_compare(got, want)
    return mismatch + bits


def device_ms(fn, key: str) -> float:
    ms = smoke.kernel_device_ms(fn, (key,), n=LAUNCHES, tries=3)
    if ms is None:
        raise RuntimeError(f"no profile saw a launch of {key}")
    return ms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "profile"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = smoke.gpu_line()
    print(smi)
    smoke.max_sm_clock_hz()
    t0 = time.perf_counter()
    built = build_all(ROOT / "build" / "tile_trials")
    print(f"built {len(built)} candidates in {time.perf_counter() - t0:.1f} s")
    cam, imgs = frames(dev)
    stream = _build.stream_ptr(dev)
    sw = pre._spatial_weights_1d(5, 3.0)
    sw2 = pre._spatial_weights_sq(pre.RADIUS_2D, 3.0)
    table2 = pre._spatial_weights(pre.RADIUS_2D, 3.0, dev).data_ptr()
    inv2sr = 1.0 / (2.0 * 0.03 ** 2)
    scalars = (_build.card_reciprocal(cam.fx), _build.card_reciprocal(cam.fy), cam.cx, cam.cy,
               pre.DEPTH_CHANGE_FACTOR, pre.SMOOTHING_RADIUS)
    want = {}
    for label, d in imgs.items():
        p = backproject(cam, pre.bilateral_filter_separable_reference(d))
        want[label] = (pre.bilateral_filter_separable_reference(d), p,
                       pre.estimate_normals_reference(p), pre.bilateral_filter_reference(d))
    smoke.all_device_ms(lambda: torch.ones(1, device=dev).add_(1))  # the profiler's first cycle
    records = []
    for consts, (so, regs) in zip(CANDIDATES, built):
        lib = load(so)
        h, w = imgs["scene"].shape
        rec = dict(consts, ptxas=regs, bits_differ={})
        for label, d in imgs.items():
            out = torch.empty_like(d)
            full = torch.empty_like(d)
            pts = torch.empty(h, w, 3, device=dev)
            nrm = torch.empty(h, w, 3, device=dev)

            def k3(d=d, out=out):
                _build.check(lib.tsdf_bilateral_pass(d.data_ptr(), out.data_ptr(), h, w, 2, 5,
                                                     ctypes.addressof(sw), inv2sr, 1, stream),
                             "k3")

            def k3_2d(d=d, full=full):
                _build.check(lib.tsdf_bilateral_2d(d.data_ptr(), full.data_ptr(), h, w,
                                                   pre.RADIUS_2D, ctypes.addressof(sw2), table2,
                                                   inv2sr, 1, stream), "k3 2-D")

            def k4(out=out, pts=pts, nrm=nrm):
                _build.check(lib.tsdf_normals(out.data_ptr(), pts.data_ptr(), nrm.data_ptr(),
                                              h, w, *scalars, 1, stream), "k4")

            k3()
            k4()
            k3_2d()
            torch.cuda.synchronize()
            rec["bits_differ"][label] = [bits_differ(a, b) for a, b in
                                         zip((out, pts, nrm, full), want[label])]
            if label == "scene":
                rec["k3_device_ms"] = device_ms(k3, "bilateral_pass_kernel")
                rec["k3_2d_device_ms"] = device_ms(k3_2d, "bilateral_2d_kernel")
                rec["k4_device_ms"] = device_ms(k4, "normals_kernel")
        c = consts
        print(f"K3 {c['kSepW']}x{c['kSepH']} strip {c['kSepStrip']} px {c['kSepPx']}: "
              f"{rec['k3_device_ms']:.5f} ms; K3 2-D {c['k2dW']}x{c['k2dH']} px {c['k2dPx']}: "
              f"{rec['k3_2d_device_ms']:.5f} ms; K4 {c['kNormW']}x{c['kNormH']} "
              f"{c['kNormThreads']} threads strip {c['kNormStrip']} blocks {c['kNormBlocks']}: "
              f"{rec['k4_device_ms']:.5f} ms; bits differing (filtered, points, normals, 2-D) "
              f"{rec['bits_differ']}; {'; '.join(regs)}")
        records.append(rec)
    ok = all(not any(v) for r in records for v in r["bits_differ"].values())
    Path(args.out).mkdir(parents=True, exist_ok=True)
    (Path(args.out) / "preprocess_tile_trials.json").write_text(
        json.dumps(dict(gpu=smi, records=records), indent=1))
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
