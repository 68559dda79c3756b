"""One-warp against one-thread finish for K1 (csrc/gn_reduce.cu) on a CUDA card.

Builds csrc/gn_reduce.cu three times, one nvcc each, started together:
as committed (``finish_step`` on one warp), as the one-thread candidate,
the same source with ``finish_step`` replaced by the one-thread design it
had before (ONE_THREAD below: the matrix in local memory, indexed by the
runtime pivot), and as the one-warp finish with libdevice's sinf / cosf in
place of the source's written-out ``sincos_rn`` (whose Payne-Hanek table
then takes a stack frame). In each build ``gn_step`` and ``gn_finish``
share the finish. Then, on chip_smoke.py's scene, it holds the builds bit
for bit against the one-thread candidate:
  * levels: every launch of ``gn_step`` over each pyramid level of tum256
    and tum512 (bf16 rows fused from the first frame), tum128 (its dense
    float32 view) and tum256 --fusion-mode packed (float32 rows), from the
    first pose with the second frame's points, at each level's stride and
    iteration cap; at each iteration also ``gn_finish`` on that
    iteration's sums (the slab reduce over the whole grid) from the same
    state, which must equal that ``gn_step`` launch as well;
  * ``gn_finish`` on sums made from a seed: no queries (zeros), a NaN in A,
    an infinite b, a rank-3 A, a NaN first pivot, and random systems whose
    solutions span the small-angle branch, ordinary steps and rotations of
    up to 1e19 rad (sinf's Payne-Hanek reduction past 105615, and an
    overflowing theta^2), under both convergence tests and pose updates.
Times ``gn_finish`` (on a level that never converges), a full ``gn_step``
and a done launch at tum256 and tum512 in each build, in two rounds (the
builds in turn, then in reverse), through
chip_smoke.kernel_device_ms (the run fails when no profile sees a launch),
prints nvcc's registers and stack frame of each kernel and the float
operation counts of each build's ``gn_finish_kernel`` SASS (cuobjdump), the
card's name and power limit, and writes the records as JSON into --out.
Exits non-zero when any state differs by a bit.

    python3 tools/gn_finish_trials.py [--out DIR]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from tracking_sdf_tpu_torch.core.camera import ros_default_camera  # noqa: E402
from tracking_sdf_tpu_torch.core.lie import se3_exp  # noqa: E402
from tracking_sdf_tpu_torch.kernels import _build  # noqa: E402
from tracking_sdf_tpu_torch.tracking import gn_reduce as k1  # noqa: E402

ENTRY_POINTS = ("tsdf_gn_step", "tsdf_gn_reduce_slab", "tsdf_gn_finish")
FINISH_OPS = ("DFMA", "DMUL", "DADD", "FFMA", "FMUL", "FADD", "MUFU.RCP64H", "LDL", "STL")
RANDOM_SYSTEMS = 4096
# rotation magnitudes (rad) of the random systems' solutions
ROTATIONS = (0.0, 1e-7, 5e-5, 1e-4, 2e-4, 1e-3, 1e-2, 0.1, 1.0, 3.0, 30.0, 1e3, 1e5,
             2e5, 3e7, 1e12, 1e19)
STEP_CFGS = [  # max_iterations, min_iterations, signed_conv, reference_update,
               # max_twist_diff, damping_decay
    (1 << 30, 0, 0, 0, 1e-3, 1.0), (1 << 30, 3, 1, 0, 1e-3, 0.5),
    (1 << 30, 0, 0, 1, 1e-2, 1.0), (1 << 30, 2, 1, 1, 1e-4, 0.9)]

ONE_THREAD = r'''
// One thread (lane 0 of the calling warp): solve, test, update and store
// the state from the 29 sums.
__device__ __noinline__ void finish_step(const float* __restrict__ sums, float* state,
                                         const StepCfg& cfg) {
  if ((threadIdx.x & 31) != 0) return;
  int* si = reinterpret_cast<int*>(state);
  const float lam = state[kSLam];
  // [A + lam*diag(A) + 1e-12*I | b] in float64
  double M[6][7];
  int k = 0;
  for (int i = 0; i < 6; ++i) {
    for (int j = i; j < 6; ++j) {
      M[i][j] = M[j][i] = static_cast<double>(sums[k++]);
    }
    M[i][6] = static_cast<double>(sums[21 + i]);
  }
  for (int i = 0; i < 6; ++i) {
    M[i][i] = M[i][i] + static_cast<double>(lam) * M[i][i] + 1e-12;
  }
  // Gaussian elimination with partial pivoting; a zero pivot gives a
  // non-finite solution, which the guard below turns into no step
  for (int c = 0; c < 6; ++c) {
    int p = c;
    for (int r = c + 1; r < 6; ++r) {
      if (fabs(M[r][c]) > fabs(M[p][c])) p = r;
    }
    if (p != c) {
      for (int j = c; j < 7; ++j) {
        const double tmp = M[c][j];
        M[c][j] = M[p][j];
        M[p][j] = tmp;
      }
    }
    for (int r = c + 1; r < 6; ++r) {
      const double f = M[r][c] / M[c][c];
      for (int j = c; j < 7; ++j) M[r][j] -= f * M[c][j];
    }
  }
  double x[6];
  for (int i = 5; i >= 0; --i) {
    double s = M[i][6];
    for (int j = i + 1; j < 6; ++j) s -= M[i][j] * x[j];
    x[i] = s / M[i][i];
  }
  float tw[6];
  bool finite = true;
  for (int i = 0; i < 6; ++i) {
    tw[i] = static_cast<float>(x[i]);
    finite = finite && isfinite(tw[i]);
  }
  if (!finite) {
    for (int i = 0; i < 6; ++i) tw[i] = 0.f;
  }
  bool conv = true;
  for (int i = 0; i < 6; ++i) {
    conv = conv && (cfg.signed_conv ? tw[i] < cfg.max_twist_diff
                                    : fabsf(tw[i]) < cfg.max_twist_diff);
  }
  const int count = si[kSCount];
  const bool done = conv && (count + 1 >= cfg.min_iterations);

  // se3_exp(tw) as core/lie.py: R = I + sinc K + mcosc KK, te = V v with
  // V = I + mcosc K + msinc KK, KK = w w^T - theta^2 I
  const float v[3] = {tw[0], tw[1], tw[2]};
  const float w[3] = {tw[3], tw[4], tw[5]};
  const float th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const bool small = th2 < kSmall;
  const float safe = small ? 1.f : th2;
  const float th = sqrtf(safe);
  const float sn = sinf(th), cs = cosf(th);
  const float sinc = small ? 1.f - th2 / 6.f : sn / th;
  const float mcosc = small ? 0.5f - th2 / 24.f : (1.f - cs) / safe;
  const float msinc = small ? 1.f / 6.f - th2 / 120.f : (1.f - sn / th) / safe;
  const float K[3][3] = {{0.f, -w[2], w[1]}, {w[2], 0.f, -w[0]}, {-w[1], w[0], 0.f}};
  float Re[3][3], V[3][3];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      const float kk = w[i] * w[j] - (i == j ? th2 : 0.f);
      const float eye = i == j ? 1.f : 0.f;
      Re[i][j] = eye + sinc * K[i][j] + mcosc * kk;
      V[i][j] = eye + mcosc * K[i][j] + msinc * kk;
    }
  }
  float te[3];
  for (int i = 0; i < 3; ++i) te[i] = V[i][0] * v[0] + V[i][1] * v[1] + V[i][2] * v[2];

  // T <- exp(tw)^-1 o T: R <- Re^T R; t <- Re^T (t - te) (se3) or
  // t - Re^T te (reference: t is not rotated)
  float R[9], t[3], Rn[9], tn[3];
  for (int i = 0; i < 9; ++i) R[i] = state[kSR + i];
  for (int i = 0; i < 3; ++i) t[i] = state[kST + i];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      Rn[3 * i + j] = Re[0][i] * R[j] + Re[1][i] * R[3 + j] + Re[2][i] * R[6 + j];
    }
    tn[i] = cfg.reference_update
                ? t[i] - (Re[0][i] * te[0] + Re[1][i] * te[1] + Re[2][i] * te[2])
                : Re[0][i] * (t[0] - te[0]) + Re[1][i] * (t[1] - te[1])
                      + Re[2][i] * (t[2] - te[2]);
  }
  for (int i = 0; i < 9; ++i) state[kSR + i] = Rn[i];
  for (int i = 0; i < 3; ++i) state[kST + i] = tn[i];
  state[kSLam] = lam * cfg.damping_decay;
  for (int i = 0; i < 6; ++i) state[kSTwist + i] = tw[i];
  state[kSNvalid] = sums[27];
  state[kSSumAbs] = sums[28];
  si[kSCount] = count + 1;
  si[kSDone] = done ? 1 : 0;
  si[kSTicket] = 0;
}
'''


def variant_source() -> str:
    """csrc/gn_reduce.cu with ONE_THREAD in place of the committed
    ``finish_step`` (its call sites are warp 0's in both)."""
    src = (_build.CSRC / "gn_reduce.cu").read_text()
    start = src.index("__device__ __noinline__ void finish_step(")
    start = src.rindex("\n\n", 0, start) + 2  # with the comment above it
    end = src.index("\n}\n", start) + 3
    return src[:start] + ONE_THREAD.strip() + "\n" + src[end:]


def libdevice_source(src: str) -> str:
    """The committed source with sinf / cosf in place of sincos_rn."""
    call = "sincos_rn(th, sn, cs);"
    if src.count(call) != 1:
        raise RuntimeError(f"expected one '{call}' in gn_reduce.cu")
    return src.replace(call, "sn = sinf(th);\n  cs = cosf(th);")


def build_all(out_dir: Path):
    """{form: (library, {kernel: (registers, stack bytes)})}: the three
    builds, their nvcc processes started together."""
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "gn_reduce.cu").read_text()
    sources = {"one_warp": src, "one_thread": variant_source(),
               "one_warp_libdevice": libdevice_source(src)}
    procs = []
    for form, src in sources.items():
        cu = out_dir / f"gn_reduce_{form}.cu"
        cu.write_text(src)
        so = out_dir / f"libgn_{form}.so"
        procs.append((form, so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    built = {}
    for form, so, p in procs:
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {so.name}:\n{log}")
        built[form] = (so, ptxas_report(log))
    return built


def _kernel_key(mangled: str) -> str:
    """gn_step_kernel<bf16, brick> and the like from a mangled name."""
    m = re.search(r"(gn_[a-z_]+?_kernel|finish_step)(?:I(\w)Lb(\d)E)?", mangled)
    if m.group(2) is None:
        return m.group(1)
    return (f"{m.group(1)}<{'bf16' if m.group(2) == 't' else 'f32'}, "
            f"{'brick' if m.group(3) == '1' else 'dense'}>")


def ptxas_report(log: str) -> dict:
    """{kernel or finish_step: [registers, stack frame bytes]} from nvcc's
    -Xptxas -v output (a function's first report)."""
    report, current = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            current = _kernel_key(m.group(1))
            report.setdefault(current, [None, None])
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and current and report[current][1] is None:
            report[current][1] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and current and report[current][0] is None:
            report[current][0] = int(m.group(1))
    return report


def finish_sass_ops(so: Path) -> dict:
    """Counts of FINISH_OPS in the SASS of the build's gn_finish_kernel."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    sections = re.split(r"\n\s*Function : ", sass)
    body = next(s for s in sections if s.startswith("_Z") and "gn_finish_kernel" in
                s.split("\n", 1)[0])
    ops = Counter()
    for line in body.splitlines():
        m = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+(?:\.[A-Z0-9]+)*)", line)
        if m:
            for op in FINISH_OPS:
                name = m.group(1)
                if name == op or name.startswith(op + "."):
                    ops[op] += 1
    return dict(ops)


class _Swap:
    """The kernel library with K1's entry points taken from a trial build."""

    def __init__(self, main, trial):
        self.main, self.trial = main, trial

    def __getattr__(self, name):
        return getattr(self.trial if name in ENTRY_POINTS else self.main, name)


def load(so: Path):
    lib = ctypes.CDLL(str(so))
    for name in ENTRY_POINTS:
        fn = getattr(lib, name)
        fn.argtypes = _build._SIGNATURES[name]
        fn.restype = ctypes.c_int
    return lib


def finish_call(lib, sums: torch.Tensor, state: torch.Tensor, cfg):
    """One gn_finish launch of ``lib`` on (29,) sums and a (24,) state (any
    rows of larger buffers: pointers taken at the rows)."""
    _build.check(lib.tsdf_gn_finish(sums.data_ptr(), state.data_ptr(), *cfg,
                                    _build.stream_ptr(sums.device)), "gn_finish")


def bits_differ(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.view(torch.int32) != b.view(torch.int32)).sum())


def level_inputs(dev):
    """[(label, view, points image, first pose, cfg)]: the views the presets
    track against, fused from the scene's first frame, and the second
    frame's points."""
    from tracking_sdf_tpu_torch.data.synthetic import render_scene_depth
    from tracking_sdf_tpu_torch.fusion.brickmajor import empty_brick_grid, fuse_frame_brickmajor
    from tracking_sdf_tpu_torch.fusion.fuse import fuse_frame
    from tracking_sdf_tpu_torch.grid.grid import empty_grid
    from tracking_sdf_tpu_torch.grid.interp import masked_view
    from tracking_sdf_tpu_torch.tracking.preprocess import preprocess_frame

    cam = ros_default_camera()
    scene, poses = smoke.make_scene(), smoke.make_poses(dev)
    rgb = torch.full((cam.height, cam.width, 3), 0.5, device=dev)
    depths = [render_scene_depth(scene, cam, poses[k]) for k in (0, 1)]
    out = []
    for label, cfg in (("tum256 bf16", smoke.path_config("tum256", None)),
                       ("tum512 bf16", smoke.path_config("tum512", None)),
                       ("tum128 dense", smoke.path_config("tum128", None)),
                       ("tum256 packed f32", smoke.packed_config("tum256"))):
        f, p = cfg.fusion, cfg.grid
        (pts0, nrm0), (pts1, _) = [
            preprocess_frame(d, cam=cam, bilateral=cfg.bilateral_filter,
                             bilateral_mode=cfg.bilateral_mode) for d in depths]
        if f.mode in ("brickmajor", "packed"):
            kw = (dict(value_dtype=torch.bfloat16, weight_dtype=torch.bfloat16)
                  if f.storage_dtype == "bfloat16" else {})
            bg = empty_brick_grid(p, f.brick_shape, device=dev, **kw)
            _, view, _ = fuse_frame_brickmajor(bg, poses[0], pts0, nrm0, rgb, params=p,
                                               cam=cam, cfg=f, bs=f.brick_shape,
                                               cap=f.brick_cap, cap_free=f.brick_cap_free)
        else:
            g = fuse_frame(empty_grid(p, device=dev), poses[0], pts0, nrm0, rgb, params=p,
                           cam=cam, cfg=f)
            view = masked_view(g.D, g.W).contiguous()
        out.append((label, view, pts1, poses[0], cfg))
    return out


def compare_levels(inputs, libs, main):
    """Every gn_step launch of each pyramid level in every build, and
    gn_finish on each iteration's sums: {label: record}, the state bits
    that differ from the one-thread build's summed over the other builds."""
    recs = {}
    for label, view, pts, pose, cfg in inputs:
        rec = dict(levels=[], step_differ=0, finish_differ=0, finish_vs_step_differ=0,
                   launches=0)
        p = cfg.grid
        for mult in cfg.pyramid_levels or (1,):
            t = cfg.tracking
            lcfg = t if mult == 1 else t._replace(max_iterations=smoke.COARSE_ITERATIONS,
                                                  min_iterations=0)
            s = t.pixel_stride * mult
            img = pts[::s, ::s]
            states, steps = {}, {}
            for form, lib in libs.items():
                _build._lib = _Swap(main, lib)
                states[form] = k1.init_state(pose, lcfg.damping)
                steps[form] = k1.gn_stepper(view, states[form], img, p, lcfg)
            _build._lib = main
            probe = k1.init_state(pose, lcfg.damping)
            reduce = k1.slab_stepper(view, probe, img, p, lcfg)[0]
            step_cfg = k1._step_cfg(lcfg)
            for _ in range(lcfg.max_iterations):
                probe.copy_(states["one_warp"])
                sums = reduce().clone()
                fins = {}
                for form, lib in libs.items():
                    fins[form] = states["one_warp"].clone()
                    finish_call(lib, sums, fins[form], step_cfg)
                for form in libs:
                    steps[form]()
                rec["launches"] += 1
                for form in libs:
                    rec["step_differ"] += bits_differ(states[form], states["one_thread"])
                    rec["finish_differ"] += bits_differ(fins[form], fins["one_thread"])
                rec["finish_vs_step_differ"] += bits_differ(
                    fins["one_warp"][:k1.S_TICKET], states["one_warp"][:k1.S_TICKET])
            torch.cuda.synchronize()
            rec["levels"].append(dict(stride=s, launches=lcfg.max_iterations, steps=int(
                states["one_warp"].view(torch.int32)[k1.S_COUNT])))
            # the next level starts where this one ended, as the pyramid does
            pose = k1.state_pose(states["one_warp"].clone())
        recs[label] = rec
        print(f"{label}: levels {rec['levels']}; state bits differing from the one-"
              f"thread build's over {rec['launches']} gn_step launches {rec['step_differ']}, "
              f"gn_finish on each iteration's sums {rec['finish_differ']}; gn_finish vs "
              f"the gn_step launch {rec['finish_vs_step_differ']}")
    return recs


def random_systems(dev, n: int = RANDOM_SYSTEMS, seed: int = 0):
    """(sums (n, 29), states (n, 24), step cfg index (n,), case names): the
    degenerate cases, then random SPD systems whose solution's rotation has
    a norm from ROTATIONS (its translation a random scale), damping in
    [0, 1), poses and step counts from the seed."""
    rng = np.random.default_rng(seed)
    sums = np.zeros((n, k1.N_OUT), np.float32)
    names = []
    for i in range(n):
        X = rng.normal(size=(10, 6))
        A = X.T @ X * 10.0 ** rng.uniform(-2, 4)
        lam = rng.uniform(0, 1)
        w = rng.normal(size=3)
        w *= ROTATIONS[i % len(ROTATIONS)] / max(np.linalg.norm(w), 1e-300)
        v = rng.normal(size=3) * 10.0 ** rng.uniform(-6, 1)
        x = np.concatenate([v, w])
        M = A + lam * np.diag(np.diag(A)) + 1e-12 * np.eye(6)
        b = M @ x
        case = f"rotation {ROTATIONS[i % len(ROTATIONS)]:g}"
        if i < 6:
            case = ("zeros", "nan in A", "inf in b", "rank-3 A", "nan first pivot",
                    "huge b")[i]
            if case == "zeros":
                A, b = A * 0, b * 0
            elif case == "nan in A":
                A[1, 4] = A[4, 1] = np.nan
            elif case == "inf in b":
                b[2] = np.inf
            elif case == "rank-3 A":
                X[:, 3:] = X[:, :3]
                A, b = X.T @ X, X.T @ rng.normal(size=10)
            elif case == "nan first pivot":
                A[0, 0] = np.nan
            else:
                b = b * 1e30
        names.append(case)
        iu = np.triu_indices(6)
        sums[i, :21] = A[iu]
        sums[i, 21:27] = b
        sums[i, 27] = rng.integers(0, 40000)
        sums[i, 28] = rng.uniform(0, 100)
    tw = torch.from_numpy(rng.normal(size=(n, 6)).astype(np.float32) * 0.3)
    states = torch.zeros(n, k1.N_STATE)
    for i in range(n):
        pose = se3_exp(tw[i])
        states[i, k1.S_R:k1.S_T] = pose.R.reshape(9)
        states[i, k1.S_T:k1.S_LAM] = pose.t * 3.0
    states[:, k1.S_LAM] = torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32))
    states.view(torch.int32)[:, k1.S_COUNT] = torch.from_numpy(
        rng.integers(0, 6, n).astype(np.int32))
    cfg_idx = rng.integers(0, len(STEP_CFGS), n)
    return (torch.from_numpy(sums).to(dev), states.to(dev), cfg_idx, names)


def compare_random(dev, libs):
    """gn_finish of every build on random_systems(): states differing from
    the one-thread build's by a bit, by case."""
    sums, states, cfg_idx, names = random_systems(dev)
    out = {}
    for form, lib in libs.items():
        out[form] = states.clone()
        for i in range(sums.shape[0]):
            finish_call(lib, sums[i], out[form][i], STEP_CFGS[cfg_idx[i]])
    torch.cuda.synchronize()
    ref = out["one_thread"].view(torch.int32)
    diff = torch.stack([(o.view(torch.int32) != ref).any(1) for o in out.values()]).any(0)
    by_case = Counter(names[i] for i in diff.nonzero().flatten().tolist())
    stepped = int((out["one_warp"].view(torch.int32)[:, k1.S_COUNT]
                   != states.view(torch.int32)[:, k1.S_COUNT]).sum())
    tw = out["one_warp"][:, k1.S_TWIST:k1.S_TWIST + 6]
    rec = dict(systems=sums.shape[0], differ=int(diff.sum()), differ_by_case=dict(by_case),
               stepped=stepped, zero_twists=int((tw == 0).all(1).sum()),
               nonfinite_poses=int((~torch.isfinite(out["one_warp"][:, :k1.S_LAM])).any(1)
                                   .sum()))
    print(f"random and degenerate systems: {rec}")
    return rec


def timings(inputs, libs, main, rounds: int = 2):
    """Device ms of gn_finish on a level that never converges, and of a full
    gn_step and a done launch at tum256 and tum512 (their finest stride),
    per build: {form: {what: [ms of each round]}}, the builds in turn and
    then in reverse."""
    never = (1 << 30, 0, 0, 0, -1.0, 1.0)
    _, view, pts, pose, cfg = inputs[0]
    s = cfg.tracking.pixel_stride
    state0 = k1.init_state(pose, cfg.tracking.damping)
    sums = k1.slab_stepper(view, state0.clone(), pts[::s, ::s], cfg.grid, cfg.tracking)[0]()
    sums = sums.clone()
    recs = {form: {} for form in libs}
    order = list(libs)
    for r in range(rounds):
        for form in order if r % 2 == 0 else order[::-1]:
            lib, rec = libs[form], recs[form]
            st = state0.clone()
            times = dict(gn_finish=smoke.kernel_device_ms(
                lambda: finish_call(lib, sums, st, never), ("gn_finish_kernel",), tries=3))
            times["gn_finish_events"] = smoke.events_ms(
                lambda: finish_call(lib, sums, st, never))
            for name, v, q, p0, c in inputs[:2]:
                tcfg = c.tracking._replace(max_iterations=1 << 30, min_iterations=0,
                                           max_twist_diff=-1.0)
                done = k1.init_state(p0, tcfg.damping)
                done.view(torch.int32)[k1.S_DONE] = 1
                _build._lib = _Swap(main, lib)
                full = k1.gn_stepper(v, k1.init_state(p0, tcfg.damping), q[::s, ::s], c.grid,
                                     tcfg)
                frozen = k1.gn_stepper(v, done, q[::s, ::s], c.grid, tcfg)
                _build._lib = main
                times[f"gn_step full {name}"] = smoke.kernel_device_ms(
                    full, ("gn_step_kernel",), tries=3)
                times[f"gn_step done {name}"] = smoke.kernel_device_ms(
                    frozen, ("gn_step_kernel",), tries=3)
            if any(v is None for v in times.values()):
                raise RuntimeError(f"no profile saw a launch ({form}: {times})")
            for k, v in times.items():
                rec.setdefault(k, []).append(v)
    for form, rec in recs.items():
        print(f"{form}: device ms (rounds) " + ", ".join(
            f"{k} {' / '.join(f'{v:.5f}' for v in vs)}" for k, vs in rec.items()))
    return recs


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
    main_lib = _build.library()
    t0 = time.perf_counter()
    built = build_all(ROOT / "build" / "gn_finish_trials")
    print(f"built {len(built)} forms in {time.perf_counter() - t0:.1f} s")
    sass = {}
    for form, (so, report) in built.items():
        sass[form] = finish_sass_ops(so)
        print(f"{form}: registers and stack frame bytes {report}; gn_finish_kernel SASS "
              f"ops {sass[form]}")
    libs = {form: load(so) for form, (so, _) in built.items()}
    smoke.all_device_ms(lambda: torch.ones(1, device=dev).add_(1))  # the profiler's first cycle
    try:
        inputs = level_inputs(dev)
        levels = compare_levels(inputs, libs, main_lib)
        rand = compare_random(dev, libs)
        times = timings(inputs, libs, main_lib)
    finally:
        _build._lib = main_lib
    ok = (rand["differ"] == 0 and all(
        r["step_differ"] == r["finish_differ"] == r["finish_vs_step_differ"] == 0
        for r in levels.values()))
    Path(args.out).mkdir(parents=True, exist_ok=True)
    (Path(args.out) / "gn_finish_trials.json").write_text(json.dumps(dict(
        gpu=smi, ptxas={f: r for f, (_, r) in built.items()}, sass_ops=sass, levels=levels,
        random=rand, device_ms=times), indent=1))
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
