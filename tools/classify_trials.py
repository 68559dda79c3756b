"""Lanes-a-brick and block-size trials for K6 (csrc/brick_classify.cu) on a CUDA card.

Each candidate is a pair (CLASSIFY_LANE_THREADS, the threads an SM up to
which fusion/brick_classify.py's classify_lanes gives a launch 8 lanes a
brick rather than 1: 0 gives every launch one lane a brick, the
one-thread-a-brick design, and 2^20 every launch 8; kClassifyThreads,
threads a block). Builds csrc/brick_classify.cu once for each block size
(one nvcc each, all started together), then, on
chip_smoke.py's phase 13 inputs (the scene's second frame at 640x480 seen
from its true pose, preprocessed as each preset does), runs K6's three forms
through the wrapper in each build: tum256's flat form over its 32,768
bricks, tum512's super form over its 4,096 supers with and without a sat
bitset, and its children form over the cap_mixed listed supers. Every class
byte, sat_super byte and global id is held against the plain versions, and
each form's device time comes from torch.profiler over 200 launches
(chip_smoke.kernel_device_ms; the run fails if no profile saw a launch).
Prints one line a candidate with the registers nvcc reports, the card's
name, power limit and SM clock, and writes the records as JSON into --out.

    python3 tools/classify_trials.py [--out DIR]
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
from tracking_sdf_tpu_torch.config import preset  # noqa: E402
from tracking_sdf_tpu_torch.core.camera import ros_default_camera  # noqa: E402
from tracking_sdf_tpu_torch.data.synthetic import render_scene_depth  # noqa: E402
from tracking_sdf_tpu_torch.fusion import brick  # noqa: E402
from tracking_sdf_tpu_torch.fusion import brick_classify as k567  # noqa: E402
from tracking_sdf_tpu_torch.kernels import _build  # noqa: E402
from tracking_sdf_tpu_torch.tracking.preprocess import preprocess_frame  # noqa: E402

# (CLASSIFY_LANE_THREADS, kClassifyThreads); the first candidate is the
# committed source's
CANDIDATES = [(256, 128), (256, 256), (128, 128), (512, 128), (0, 128), (1 << 20, 128),
              (256, 64), (0, 256)]
LAUNCHES = 200


def variant_source(threads: int) -> str:
    src = (_build.CSRC / "brick_classify.cu").read_text()
    src, n = re.subn(r"constexpr int kClassifyThreads = \d+;",
                     f"constexpr int kClassifyThreads = {threads};", src)
    assert n == 1
    return src


def build_all(out_dir: Path):
    """One shared library a block size, the nvcc processes started together;
    returns {threads: (library path, K6's registers by lanes a brick from
    nvcc's -Xptxas -v)}."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for threads in sorted({t for _, t in CANDIDATES}):
        cu = out_dir / f"brick_classify_{threads}.cu"
        cu.write_text(variant_source(threads))
        so = out_dir / f"libbrick_classify_{threads}.so"
        procs.append((threads, so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    built = {}
    for threads, so, p in procs:
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {so.name}:\n{log}")
        regs, fn = {}, None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            fn = m.group(1) if m else fn
            m = re.search(r"Used (\d+) registers", line)
            k = re.search(r"classify_bricks_kernelILi(\d)E", fn or "")
            if m and k:
                regs[int(k.group(1))] = int(m.group(1))
        built[threads] = (so, regs)
    return built


class _Swap:
    """The kernel library with K6's entry point taken from a candidate build."""

    def __init__(self, main, candidate):
        self.main, self.candidate = main, candidate

    def __getattr__(self, name):
        return getattr(self.candidate if name == "tsdf_classify_bricks" else self.main, name)


def load(so: Path):
    lib = ctypes.CDLL(str(so))
    lib.tsdf_classify_bricks.argtypes = _build._SIGNATURES["tsdf_classify_bricks"]
    lib.tsdf_classify_bricks.restype = ctypes.c_int
    return lib


def inputs(dev):
    """Per preset: the K6 calls of phase 13's timed forms, their plain
    outputs and brick counts, {form: (call, want, n)}, each call returning
    its outputs in the order of want."""
    cam = ros_default_camera()
    poses = smoke.make_poses(dev)
    depth = render_scene_depth(smoke.make_scene(), cam, poses[1]).contiguous()
    forms = {}
    for name in ("tum256", "tum512"):
        cfg = preset(name)
        f, p = cfg.fusion, cfg.grid
        pts, nrm = preprocess_frame(depth, cam=cam, bilateral=cfg.bilateral_filter,
                                    bilateral_mode=cfg.bilateral_mode)
        share = brick.share_classify_margin(p, f)
        mip = brick._zeta_mip_reference(pts, nrm, cam, p.delta, f.distance, share)
        R, base = brick._card_pose(poses[1])
        geo = dict(params=p, cam=cam, hw=tuple(pts.shape[:2]))
        bs, fac = f.brick_shape, f.hier_classify
        nb3 = tuple(p.m // b for b in bs)
        flat_ref = brick.classify_bricks_reference(p, poses[1], pts, nrm, cam, bs, f.distance,
                                                   mip=mip).reshape(-1).to(torch.uint8)
        if fac <= 1:
            forms[f"{name} flat"] = (
                lambda mip=mip, R=R, base=base, bs=bs, nb3=nb3, geo=geo:
                k567.classify_bricks(mip, R, base, bs=bs, grid=nb3, **geo)[:1], (flat_ref,),
                flat_ref.numel())
            continue
        ns3 = tuple(n // fac for n in nb3)
        sbs = tuple(b * fac for b in bs)
        sref = brick.classify_bricks_reference(p, poses[1], pts, nrm, cam, sbs, f.distance,
                                               mip=mip).reshape(-1).to(torch.uint8)
        gen = torch.Generator(device=dev).manual_seed(5)
        sat = torch.rand(flat_ref.numel(), generator=gen, device=dev) < 0.9
        sat.view(ns3[0], fac, ns3[1], fac, ns3[2], fac)[::3, :, ::2, :, :, :] = True
        sat_ref = (sat.view(ns3[0], fac, ns3[1], fac, ns3[2], fac).permute(0, 2, 4, 1, 3, 5)
                   .reshape(-1, fac ** 3).all(1))
        # the listed mixed supers as the stage lists them, padded to cap_mixed
        mixed = brick._compact_ids(sref == 2, f.cap_mixed, sref.numel()).int()
        ok = mixed < sref.numel()
        s = mixed.long().clamp(max=sref.numel() - 1)[:, None]
        c = torch.arange(fac ** 3, device=dev)
        gid = ((((s // (ns3[1] * ns3[2])) * fac + c // (fac * fac)) * nb3[1]
                + ((s // ns3[2]) % ns3[1]) * fac + (c // fac) % fac) * nb3[2]
               + (s % ns3[2]) * fac + c % fac)
        gid = torch.where(ok[:, None], gid, flat_ref.numel()).reshape(-1).int()
        fcls_ref = torch.where(gid < flat_ref.numel(), flat_ref[gid.long().clamp(
            max=flat_ref.numel() - 1)], 0).to(torch.uint8)
        kw = dict(bs=sbs, grid=ns3, factor=fac, **geo)
        forms[f"{name} super"] = (
            lambda mip=mip, R=R, base=base, kw=kw: k567.classify_bricks(mip, R, base, **kw)[:1],
            (sref,), sref.numel())
        forms[f"{name} super, sat"] = (
            lambda mip=mip, R=R, base=base, kw=kw, sat=sat:
            k567.classify_bricks(mip, R, base, sat=sat, **kw), (sref, sat_ref), sref.numel())
        forms[f"{name} children"] = (
            lambda mip=mip, R=R, base=base, mixed=mixed, bs=bs, nb3=nb3, fac=fac, geo=geo:
            k567.classify_children(mip, R, base, mixed, bs=bs, grid=nb3, factor=fac, **geo),
            (fcls_ref, gid), gid.numel())
        print(f"{name}: {int(ok.sum())} mixed supers listed of cap_mixed {f.cap_mixed}, "
              f"{int((sref == 1).sum())} FREE supers, {int(sat_ref.sum())} saturated")
    return forms


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
    main_lib = _build.library()
    t0 = time.perf_counter()
    built = build_all(ROOT / "build" / "classify_trials")
    print(f"built {len(built)} block sizes in {time.perf_counter() - t0:.1f} s")
    forms = inputs(dev)
    smoke.all_device_ms(lambda: torch.ones(1, device=dev).add_(1))  # the profiler's first cycle
    records = []
    lane_threads0 = k567.CLASSIFY_LANE_THREADS
    try:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        libs = {threads: load(so) for threads, (so, _) in built.items()}
        for lane_threads, threads in CANDIDATES:
            _build._lib = _Swap(main_lib, libs[threads])
            k567.CLASSIFY_LANE_THREADS = lane_threads
            rec = dict(CLASSIFY_LANE_THREADS=lane_threads, kClassifyThreads=threads,
                       registers=built[threads][1], differ={}, device_ms={}, lanes={})
            for form, (call, want, n) in forms.items():
                rec["lanes"][form] = k567.classify_lanes(n, sms)
                got = call()
                torch.cuda.synchronize()
                rec["differ"][form] = [int((a.view(torch.uint8) != b.view(torch.uint8)).sum())
                                       if a.dtype != torch.int32 else int((a != b).sum())
                                       for a, b in zip(got, want)]
                ms = smoke.kernel_device_ms(call, ("classify_bricks_kernel",), n=LAUNCHES,
                                            tries=3)
                if ms is None:
                    raise RuntimeError(f"no profile saw a launch of K6 ({form})")
                rec["device_ms"][form] = ms
            print(f"K6 up to {lane_threads} threads an SM, {threads} threads a block "
                  f"(registers by lanes {rec['registers']}): "
                  + "; ".join(f"{k} {v:.5f} ms ({rec['lanes'][k]} lanes)"
                              for k, v in rec["device_ms"].items())
                  + f"; values differing {rec['differ']}")
            records.append(rec)
    finally:
        _build._lib = main_lib
        k567.CLASSIFY_LANE_THREADS = lane_threads0
    ok = all(not any(v) for r in records for v in r["differ"].values())
    Path(args.out).mkdir(parents=True, exist_ok=True)
    (Path(args.out) / "classify_trials.json").write_text(
        json.dumps(dict(gpu=smi, records=records), indent=1))
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
