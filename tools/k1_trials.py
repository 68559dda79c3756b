"""K1 (csrc/gn_reduce.cu) trial builds on a CUDA card: the reduce half as
committed against the design it replaced and against candidate designs,
bit for bit, with a stage split and device times.

Builds csrc/gn_reduce.cu in these forms, one nvcc each, started together:
  * ``new``: as committed;
  * ``before``: the same source with the reduce half (the region from
    ``load_f32`` to the kernels: the per-query gather and terms, the block
    sums, the ticket and the last block's sum of the partials) replaced by
    the text it replaced (BEFORE_REDUCE below); the finish, one warp, is
    the same code in both;
  * candidates, the committed source with one design changed (PIECES and
    PREFETCH_LOAD below): ``new_prefetch`` (the point load ahead of the
    done test, which every done launch then pays too), ``new_shuffle_down``
    (the replaced block sums), ``new_butterfly_loop`` (the butterfly as a
    loop nest), ``new_shared_sums`` (the block sums through shared memory),
    ``new_fences`` (the replaced ticket), ``new_staged`` (the last block's
    partials staged in shared memory by 16-byte loads), ``new_regs`` (a
    lane's partials in registers before any add), ``new_per_corner`` (no
    16-byte gather) and ``new_divides`` (that and the replaced runtime
    divisions);
  * ``before_stamped`` and ``new_stamped``: ``before`` and ``new`` with clock
    stamps (STAMPS below) that the package never compiles: each thread
    records %clock at the block's entry, after the done test, after its
    point load, after its 8 corner loads and after its per-query
    arithmetic; thread 0 after the block sums, after the ticket, and in
    the last block after the partials are summed and after the finish (or
    the store of the slab form's sums); thread 0 also %globaltimer at
    entry, after the ticket and at the end.
Then, on chip_smoke.py's scene:
  * bitwise: every ``gn_step`` launch over each pyramid level of tum256 and
    tum512 (bf16 rows fused from the first frame), tum128 (its dense
    float32 view) and tum256 --fusion-mode packed (float32 rows), from the
    first pose with the second frame's points, at each level's stride and
    iteration cap, in each unstamped build, and at each iteration the slab
    form over the whole grid (``gn_reduce``) from the same state: state and
    sums bits that differ from the before build's; the slab form at a rank's
    real inputs (tum256's bf16 rows and tum128's dense view split in two
    ranks, both ranks, at stride 3); and ``gn_finish`` on 4,096 random and
    degenerate systems;
  * the stage split in the stamped builds of a full step at tum256 and
    tum512, strides 3, 6 and 12, and of ``gn_reduce`` at stride 3: medians
    over STAMP_LAUNCHES launches of each stage's µs (the last thread's end,
    for the per-thread stages) in block 0, in the median block and in the
    last block, at the SM clock the run measured (clock ticks over
    %globaltimer ns in the last block); the spread of the blocks' entries
    and tickets on %globaltimer, and its resolution (the least step between
    two readings);
  * device ms (chip_smoke.kernel_device_ms; the run fails when no profile
    sees a launch) of a full step, a done launch and ``gn_reduce`` at tum256
    and tum512 (stride 3) and of full steps at strides 6 and 12, per
    unstamped build, in two rounds (the builds in turn, then in reverse);
  * nvcc's registers and stack frame of each kernel, and the counts of
    SHFL, LDG, LDS, STS, BAR, MEMBAR, FENCE, ATOM and ERRBAR in the SASS of
    each build's bf16 brick-major ``gn_step`` kernel (cuobjdump; the SASS
    goes to OUT/sass_FORM.txt).
Prints the card's name and power limit and writes the records as JSON into
--out. Exits non-zero when any state or sum differs by a bit.

    python3 tools/k1_trials.py [--out DIR]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
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
from tracking_sdf_tpu_torch.grid.interp import BrickMaskedView  # noqa: E402
from tracking_sdf_tpu_torch.kernels import _build  # noqa: E402
from tracking_sdf_tpu_torch.tracking import gn_reduce as k1  # noqa: E402

ENTRY_POINTS = ("tsdf_gn_step", "tsdf_gn_reduce_slab", "tsdf_gn_finish")
SASS_OPS = ("SHFL", "LDG", "LDS", "STS", "BAR", "MEMBAR", "FENCE", "ATOM", "ERRBAR")
RANDOM_SYSTEMS = 4096
STAMP_LAUNCHES = 21
STRIDE_MULTS = (1, 2, 4)  # of the preset's pixel stride: strides 3, 6, 12
# rotation magnitudes (rad) of the random systems' solutions
ROTATIONS = (0.0, 1e-7, 5e-5, 1e-4, 2e-4, 1e-3, 1e-2, 0.1, 1.0, 3.0, 30.0, 1e3, 1e5,
             2e5, 3e7, 1e12, 1e19)
STEP_CFGS = [  # max_iterations, min_iterations, signed_conv, reference_update,
               # max_twist_diff, damping_decay
    (1 << 30, 0, 0, 0, 1e-3, 1.0), (1 << 30, 3, 1, 0, 1e-3, 0.5),
    (1 << 30, 0, 0, 1, 1e-2, 1.0), (1 << 30, 2, 1, 1, 1e-4, 0.9)]

REGION_START = "__device__ __forceinline__ float load_f32(const float* p)"
REGION_END = ("template <typename T, bool kBrick>\n__global__ void __launch_bounds__(kThreads)\n"
              "gn_step_kernel")

# The reduce half this design replaced (csrc/gn_reduce.cu from load_f32 to
# gn_iteration): one thread a query with runtime divisions for every corner,
# a shuffle-down tree for each of the 29 sums, a fence in every thread
# around the ticket
BEFORE_REDUCE = r'''
__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load_f32(const uint16_t* p) {
  // bfloat16 bits -> float32: the upper half of the float, exact
  return __uint_as_float(static_cast<uint32_t>(__ldg(p)) << 16);
}

template <bool kBrick>
__device__ __forceinline__ size_t view_index(const ViewGeom& g, int i, int j, int k) {
  if (!kBrick) return (static_cast<size_t>(i) * g.m + j) * g.m + k;
  const int nbj = g.m / g.bj, nbk = g.m / g.bk;
  const int ib = i / g.bi, di = i - ib * g.bi;
  const int jb = j / g.bj, dj = j - jb * g.bj;
  const int kb = k / g.bk, dk = k - kb * g.bk;
  return (static_cast<size_t>(ib) * nbj + jb) * nbk * g.pitch
         + static_cast<size_t>(kb) * g.pitch + (di * g.bj + dj) * g.bk + dk;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// The per-query arithmetic rounds as the plain version's eager ops do on the
// card (pixel_residuals_analytic, trilinear_from_corners), so that a query's
// terms are the plain version's bit for bit and only the order of the sums
// over queries differs: a coordinate of the world point as p @ R.T + t
// rounds it (a k-ordered FMA chain, then the add); torch.sum over the 8
// corners (a tree over strides 4, 2, 1) and over the corners' axis of an
// (n, 8, 3) tensor (four pairs at stride 4, added in order); the cross
// product as torch.linalg.cross. A rounding that differs here moves a voxel
// coordinate by an ulp of u, which the gradient carries into J.
__device__ __forceinline__ float world_coord(const float* row, float p0, float p1, float p2,
                                             float t) {
  return __fadd_rn(__fmaf_rn(row[2], p2, __fmaf_rn(row[1], p1, __fmul_rn(row[0], p0))), t);
}

__device__ __forceinline__ float corner_sum(const float (&x)[8]) {
  return __fadd_rn(__fadd_rn(__fadd_rn(x[0], x[4]), __fadd_rn(x[2], x[6])),
                   __fadd_rn(__fadd_rn(x[1], x[5]), __fadd_rn(x[3], x[7])));
}

__device__ __forceinline__ float axis_sum(const float (&x)[8]) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(x[0], x[4]), __fadd_rn(x[1], x[5])),
                             __fadd_rn(x[2], x[6])),
                   __fadd_rn(x[3], x[7]));
}

// a * b - c * d
__device__ __forceinline__ float cross_term(float a, float b, float c, float d) {
  return __fmaf_rn(a, b, -__fmul_rn(c, d));
}

// This thread's query: its 29 terms into acc (all zero for an invalid query).
// pose: R row-major (9), t (3).
template <typename T, bool kBrick>
__device__ __forceinline__ void query_terms(const T* __restrict__ dm,
                                            const ViewGeom& geom,
                                            const float* pose, const Points& pts,
                                            const GridMap& gm, int q,
                                            float (&acc)[kOut]) {
#pragma unroll
  for (int k = 0; k < kOut; ++k) acc[k] = 0.f;
  if (q >= pts.n) return;
  const int row = q / pts.w, col = q - row * pts.w;
  const float* pp = pts.p + static_cast<size_t>(row) * pts.sh
                    + static_cast<size_t>(col) * pts.sw;
  const float p0 = pp[0], p1 = pp[1], p2 = pp[2];
  if (!(isfinite(p0) && isfinite(p1) && isfinite(p2))) return;
  const int m = geom.m;
  const float t0 = pose[9], t1 = pose[10], t2 = pose[11];
  const float x0 = world_coord(pose, p0, p1, p2, t0);
  const float x1 = world_coord(pose + 3, p0, p1, p2, t1);
  const float x2 = world_coord(pose + 6, p0, p1, p2, t2);
  // world_to_voxel: (x - origin) * scale - 0.5, each step rounded
  const float u = __fsub_rn(__fmul_rn(__fsub_rn(x0, gm.ox), gm.sx), 0.5f);
  const float v = __fsub_rn(__fmul_rn(__fsub_rn(x1, gm.oy), gm.sy), 0.5f);
  const float w = __fsub_rn(__fmul_rn(__fsub_rn(x2, gm.oz), gm.sz), 0.5f);
  const float fm = static_cast<float>(m);
  if (!(u >= 0.f && u < fm && v >= 0.f && v < fm && w >= 0.f && w < fm)) return;
  const float bu = floorf(u), bv = floorf(v), bw = floorf(w);
  const int i0 = static_cast<int>(bu), j0 = static_cast<int>(bv),
            k0 = static_cast<int>(bw);
  if (i0 < geom.i0 || i0 >= geom.i0 + geom.slab) return;  // another slab's query
  const float f0 = u - bu, f1 = v - bv, f2 = w - bw;  // exact
  // per corner: the masked weight, its value term and the weight's and the
  // value's derivatives along each axis
  float wm[8], wd[8], dw[3][8], dwd[3][8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int oi = c >> 2, oj = (c >> 1) & 1, ok = c & 1;
    const int ci = i0 + oi, cj = j0 + oj, ck = k0 + ok;
    // the base is >= 0 because u, v, w >= 0; only the +1 side can leave
    const bool inb = ci < m && cj < m && ck < m;
    const float val = load_f32(dm + view_index<kBrick>(
        geom, min(ci - geom.i0, geom.mi - 1), min(cj, m - 1), min(ck, m - 1)));
    const bool obs = inb && isfinite(val);
    const float d = obs ? val : 0.f;
    const float mk = obs ? 1.f : 0.f;
    const float a0 = oi ? f0 : 1.f - f0;
    const float a1 = oj ? f1 : 1.f - f1;
    const float a2 = ok ? f2 : 1.f - f2;
    wm[c] = __fmul_rn(__fmul_rn(__fmul_rn(a0, a1), a2), mk);
    wd[c] = __fmul_rn(wm[c], d);
    dw[0][c] = __fmul_rn((oi ? 1.f : -1.f) * __fmul_rn(a1, a2), mk);
    dw[1][c] = __fmul_rn((oj ? 1.f : -1.f) * __fmul_rn(a0, a2), mk);
    dw[2][c] = __fmul_rn((ok ? 1.f : -1.f) * __fmul_rn(a0, a1), mk);
#pragma unroll
    for (int a = 0; a < 3; ++a) dwd[a][c] = __fmul_rn(dw[a][c], d);
  }
  const float Z = corner_sum(wm), N = corner_sum(wd);
  if (!(Z > 1e-12f)) return;
  const float r = __fdiv_rn(N, Z);
  const float z2 = __fmul_rn(Z, Z);
  const float scale[3] = {gm.sx, gm.sy, gm.sz};
  float g[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    // the quotient rule (dN Z - N dZ) / Z^2, then voxel -> world units
    const float num = __fsub_rn(__fmul_rn(axis_sum(dwd[a]), Z), __fmul_rn(N, axis_sum(dw[a])));
    g[a] = __fmul_rn(__fdiv_rn(num, z2), scale[a]);
  }
  const float ax = __fsub_rn(x0, t0), ay = __fsub_rn(x1, t1), az = __fsub_rn(x2, t2);
  const float J[6] = {g[0], g[1], g[2], cross_term(ay, g[2], az, g[1]),
                      cross_term(az, g[0], ax, g[2]), cross_term(ax, g[1], ay, g[0])};
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) acc[k++] = __fmul_rn(J[i], J[j]);
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) acc[21 + i] = __fmul_rn(J[i], r);
  acc[27] = 1.f;
  acc[28] = fabsf(r);
}

// The block's sums of acc into partials[blockIdx.x * kOut + k].
__device__ __forceinline__ void block_partials(const float (&acc)[kOut],
                                               float* __restrict__ partials) {
  __shared__ float red[kThreads / 32][kOut];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    const float s = warp_sum(acc[k]);
    if (lane == 0) red[warp][k] = s;
  }
  __syncthreads();
  if (threadIdx.x < kOut) {
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < kThreads / 32; ++wi) s += red[wi][threadIdx.x];
    partials[static_cast<size_t>(blockIdx.x) * kOut + threadIdx.x] = s;
  }
}

// The level is done (converged, or max_iterations steps run).
__device__ __forceinline__ bool level_done(const float* state, const StepCfg& cfg) {
  const int* si = reinterpret_cast<const int*>(state);
  return si[kSDone] != 0 || si[kSCount] >= cfg.max_iterations;
}

// One iteration's normal equations at the state's pose, summed over the
// grid's blocks by the block that draws the last ticket; then, with
// kFinish, the whole step on the state (gn_step), else the 29 sums into
// `out` and the ticket reset (gn_reduce_slab).
template <typename T, bool kBrick, bool kFinish>
__device__ __forceinline__ void gn_iteration(const T* __restrict__ dm,
                                             const ViewGeom& geom, const Points& pts,
                                             const GridMap& gm,
                                             float* __restrict__ partials, int blocks,
                                             float* state, const StepCfg& cfg,
                                             float* __restrict__ out) {
  // a done level: every block leaves before touching anything else (the
  // slab reduce's block 0 zeroes its sums first, see the note above)
  if (level_done(state, cfg)) {
    if (!kFinish && blockIdx.x == 0 && threadIdx.x < kOut) out[threadIdx.x] = 0.f;
    return;
  }
  int* si = reinterpret_cast<int*>(state);
  float acc[kOut];
  query_terms<T, kBrick>(dm, geom, state + kSR, pts, gm,
                         blockIdx.x * kThreads + threadIdx.x, acc);
  block_partials(acc, partials);

  // the last block to finish its partials sums them
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(si + kSTicket, 1) == blocks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  __shared__ float lane_sums[kOut][kLanes];
  __shared__ float sums[kOut];
  if (threadIdx.x < kOut * kLanes) {
    const int k = threadIdx.x / kLanes, j = threadIdx.x % kLanes;
    float s = 0.f;
    for (int b = j; b < blocks; b += kLanes) {
      s += __ldcg(partials + static_cast<size_t>(b) * kOut + k);
    }
    lane_sums[k][j] = s;
  }
  __syncthreads();
  if (threadIdx.x < kOut) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kLanes; ++j) s += lane_sums[threadIdx.x][j];
    sums[threadIdx.x] = s;
    if (!kFinish) out[threadIdx.x] = s;
  }
  if (kFinish) {
    __syncthreads();
    if (threadIdx.x < 32) finish_step(sums, state, cfg);
  } else if (threadIdx.x == 0) {
    si[kSTicket] = 0;
  }
}
'''

# Per-thread stamp slots: 0 entry, 1 done test, 2 point, 3 corners, 4
# arithmetic; thread 0's: 5 block sums, 6 ticket, 7 partials summed (last
# block), 8 finish (last block). Globaltimer (thread 0): entry, ticket,
# finish.
STAMP_SLOTS = 9
STAMP_STAGES = ("done test", "point", "corners", "arithmetic", "block sums", "ticket",
                "partials", "finish")
STAMP_STRIDE = STAMP_SLOTS * 256 + 8  # 32-bit words a block
STAMPS = r'''
#include <cstdint>
__device__ unsigned* k1_buf;
__shared__ unsigned k1_t[9][256];
__shared__ unsigned long long k1_g[3];
__shared__ float k1_sink[256];
__device__ __forceinline__ unsigned k1_clock() {
  unsigned t;
  asm volatile("mov.u32 %0, %%clock;" : "=r"(t) :: "memory");
  return t;
}
__device__ __forceinline__ unsigned long long k1_gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t) :: "memory");
  return t;
}
#define K1_STAMP(s) (k1_t[s][threadIdx.x] = k1_clock())
#define K1_ENTRY { const unsigned t0_ = k1_clock(); \
  for (int s_ = 1; s_ < 9; ++s_) k1_t[s_][threadIdx.x] = 0u; \
  k1_t[0][threadIdx.x] = t0_; if (threadIdx.x == 0) k1_g[0] = k1_gtime(); }
#define K1_CONSUME(v_) (*reinterpret_cast<volatile float*>(&k1_sink[threadIdx.x]) = (v_))
#define K1_FLUSH if (k1_buf) { \
  unsigned* d_ = k1_buf + static_cast<size_t>(blockIdx.x) * (9 * 256 + 8); \
  for (int s_ = 0; s_ < 9; ++s_) d_[s_ * 256 + threadIdx.x] = k1_t[s_][threadIdx.x]; \
  if (threadIdx.x == 0) for (int g_ = 0; g_ < 3; ++g_) { \
    d_[9 * 256 + 2 * g_] = static_cast<unsigned>(k1_g[g_]); \
    d_[9 * 256 + 2 * g_ + 1] = static_cast<unsigned>(k1_g[g_] >> 32); } }
'''
STAMPS_TAIL = r'''
extern "C" int k1_set_stamp_buffer(void* p) {
  return static_cast<int>(cudaMemcpyToSymbol(k1_buf, &p, sizeof(p)));
}
'''
# (anchor, text inserted after it) in both forms; each anchor occurs once
STAMP_AT = [
    ("  if (!(isfinite(p0) && isfinite(p1) && isfinite(p2))) return;\n", "  K1_STAMP(2);\n"),
    ("  if (!(Z > 1e-12f)) return;\n", "  K1_STAMP(3);\n"),
    ("  acc[28] = fabsf(r);\n", "  K1_CONSUME(acc[20] + acc[26] + acc[28]);\n  K1_STAMP(4);\n"),
    ("out[threadIdx.x] = 0.f;\n    return;\n  }\n", "  K1_STAMP(1);\n"),
    ("  block_partials(acc, partials);\n", "  if (threadIdx.x == 0) K1_STAMP(5);\n"),
    ("    if (threadIdx.x < 32) finish_step(sums, state, cfg);\n",
     "    if (threadIdx.x == 0) {\n      K1_STAMP(8);\n      k1_g[2] = k1_gtime();\n    }\n"
     "    K1_FLUSH\n"),
]
STAMP_ENTRY = "  // a done level: every block leaves before touching anything else"
STAMP_TICKET = ("  if (!last) return;\n",
                "  if (threadIdx.x == 0) {\n    K1_STAMP(6);\n    k1_g[1] = k1_gtime();\n  }\n"
                "  if (!last) {\n    K1_FLUSH\n    return;\n  }\n")
# where the last block has summed the partials, by form
STAMP_PARTIALS = {"before": "    lane_sums[k][j] = s;\n  }\n  __syncthreads();\n",
                  "new": "  sum_partials(partials, blocks, sums);\n"}
PREFETCH_LOAD = "  float p[3];\n  load_point(pts, q, p);\n"
# the slab form's end, where its stamps end too, by form
STAMP_SLAB_END = {"before": "    si[kSTicket] = 0;\n  }\n",
                  "new": "    if (threadIdx.x == 0) reinterpret_cast<int*>(state)[kSTicket] = 0;\n  }\n"}
STAMP_SLAB_FLUSH = ("  if (!kFinish) {\n    if (threadIdx.x == 0) {\n      K1_STAMP(8);\n"
                    "      k1_g[2] = k1_gtime();\n    }\n    K1_FLUSH\n  }\n")

# Candidates, each the committed source with some of its text replaced
# ((committed text, replacement) pairs): one piece of the reduce half as
# the replaced design had it, or a design the trials measured and the source does not use.
# The block's butterfly as one loop nest, whose inner bound is the outer
# variable: nvcc leaves v in local memory (a 128-byte stack frame)
BUTTERFLY = """  float v[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) v[k] = k < kOut ? acc[k] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const bool hi = lane & o;
#pragma unroll
    for (int j = 0; j < o; ++j) {
      const float send = hi ? v[j] : v[j + o];
      const float keep = hi ? v[j + o] : v[j];
      v[j] = keep + __shfl_xor_sync(kFull, send, o);
    }
  }
  if (lane < kOut) red[warp][lane] = v[0];
"""
# the replaced block sums: a shuffle-down tree for each of the 29 values
SHUFFLE_DOWN = """#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    float v = acc[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
    if (lane == 0) red[warp][k] = v;
  }
"""
# the ticket as committed, and as the replaced design drew it: a fence in every thread
TICKET = """  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) last = draw_ticket(state) == blocks - 1;
  __syncthreads();
  if (!last) return;
"""
TICKET_FENCES = """  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(reinterpret_cast<int*>(state) + kSTicket, 1) == blocks - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
"""
# a lane's walk over its partials as committed (the replaced design's), and with its
# partials loaded into registers, 32 at a time, before any add
WALK_LOOP = """    float s = 0.f;
    for (int b = j; b < blocks; b += kLanes) {
      s += __ldcg(partials + static_cast<size_t>(b) * kOut + k);
    }
"""
REGS_LOOP = """    // each lane's partials into registers, 32 a round, all loads first
    float s = 0.f;
    for (int b0 = j; b0 < blocks; b0 += 32 * kLanes) {
      float x[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int b = b0 + i * kLanes;
        x[i] = b < blocks ? __ldcg(partials + static_cast<size_t>(b) * kOut + k) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (b0 + i * kLanes < blocks) s += x[i];
      }
    }
"""
# sum_partials as committed, and staged: every partial of a chunk loaded at
# once, coalesced with 16-byte loads, into shared memory
SUM_WALK = """// The last block's sum of every block's partials into sums (shared): lane j
// of 8 sums blocks j, j + 8, ... in order, then the lane sums add in lane
// order. nvcc unrolls a lane's loop 16 deep, so its loads go out together:
// one round trip to L2 for up to 128 blocks.
__device__ __forceinline__ void sum_partials(const float* __restrict__ partials, int blocks,
                                             float* sums) {
  __shared__ float lane_sums[kOut][kLanes];
  if (threadIdx.x < kOut * kLanes) {
    const int k = threadIdx.x / kLanes, j = threadIdx.x % kLanes;
    float s = 0.f;
    for (int b = j; b < blocks; b += kLanes) {
      s += __ldcg(partials + static_cast<size_t>(b) * kOut + k);
    }
    lane_sums[k][j] = s;
  }
  __syncthreads();
  if (threadIdx.x < kOut) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kLanes; ++j) s += lane_sums[threadIdx.x][j];
    sums[threadIdx.x] = s;
  }
  __syncthreads();
}

"""
SUM_STAGED = """constexpr int kChunk = 256;  // blocks of partials staged at once

// The last block's sum of every block's partials into sums (shared): lane j
// of 8 sums blocks j, j + 8, ... in order, then the lane sums add in lane
// order. The partials come in chunks of kChunk blocks, all of a chunk's
// loads (coalesced, 16 bytes where aligned) issued before the first add, so
// a chunk costs one round trip to L2; the lanes then add from shared memory.
__device__ __forceinline__ void sum_partials(const float* __restrict__ partials, int blocks,
                                             float* sums) {
  __shared__ __align__(16) float buf[kChunk * kOut];
  __shared__ float lane_sums[kOut][kLanes];
  constexpr int kVec = (kChunk * kOut / 4 + kThreads - 1) / kThreads;
  const int t = threadIdx.x, k = t / kLanes, j = t % kLanes;
  const bool vec = (reinterpret_cast<uintptr_t>(partials) & 15) == 0;
  float s = 0.f;
  for (int b0 = 0; b0 < blocks; b0 += kChunk) {
    const int nb = min(kChunk, blocks - b0), nf = nb * kOut;
    const float* src = partials + static_cast<size_t>(b0) * kOut;  // 16 B-aligned too
    if (vec) {
      const int n4 = nf / 4;
      float4 x[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        if (t + i * kThreads < n4) x[i] = __ldcg(reinterpret_cast<const float4*>(src) + t + i * kThreads);
      }
      const float tail = t < nf - 4 * n4 ? __ldcg(src + 4 * n4 + t) : 0.f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        if (t + i * kThreads < n4) reinterpret_cast<float4*>(buf)[t + i * kThreads] = x[i];
      }
      if (t < nf - 4 * n4) buf[4 * n4 + t] = tail;
    } else {
      for (int f = t; f < nf; f += kThreads) buf[f] = __ldcg(src + f);
    }
    __syncthreads();
    if (t < kOut * kLanes) {
      for (int b = j; b < nb; b += kLanes) s += buf[b * kOut + k];
    }
    __syncthreads();
  }
  if (t < kOut * kLanes) lane_sums[k][j] = s;
  __syncthreads();
  if (t < kOut) {
    float u = 0.f;
#pragma unroll
    for (int l = 0; l < kLanes; ++l) u += lane_sums[t][l];
    sums[t] = u;
  }
  __syncthreads();
}

"""
# the block's butterfly as committed
BUTTERFLY_T = """  float v[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) v[k] = k < kOut ? acc[k] : 0.f;
  butterfly_step<16>(v, lane);
  butterfly_step<8>(v, lane);
  butterfly_step<4>(v, lane);
  butterfly_step<2>(v, lane);
  butterfly_step<1>(v, lane);
  if (lane < kOut) red[warp][lane] = v[0];
"""
# the block's sums through shared memory: each thread stores its 29 terms,
# then thread (w, k) runs warp w's shuffle-down tree for output k in
# registers
SHARED_SUMS = """  __shared__ float tr[kThreads * kOut];
#pragma unroll
  for (int k = 0; k < kOut; ++k) tr[threadIdx.x * kOut + k] = acc[k];
  __syncthreads();
  if (threadIdx.x < kWarps * kOut) {
    const int w = threadIdx.x / kOut, k = threadIdx.x - w * kOut;
    float v[32];
#pragma unroll
    for (int l = 0; l < 32; ++l) v[l] = tr[(w * 32 + l) * kOut + k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int l = 0; l < o; ++l) v[l] += v[l + o];
    }
    red[w][k] = v[0];
  }
"""
# the bf16 gather by 16-byte k-rows, off (a load a corner)
ROWS16_ON = "    g.rows16 = bf16 && g.bk == 8"
ROWS16_OFF = "    g.rows16 = false && g.bk == 8"
# the replaced indexing: view_index's runtime divisions for every corner, and
# q / w by a division
CORNERS = "    corner_indices<kBrick>(geom, i0 - geom.i0, j0, k0, idx);\n"
CORNERS_DIVIDED = """#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int oi = c >> 2, oj = (c >> 1) & 1, ok = c & 1;
      idx[c] = view_index<kBrick>(geom, min(i0 + oi - geom.i0, geom.mi - 1), min(j0 + oj, m - 1),
                                  min(k0 + ok, m - 1));
    }
"""
QUERY = "// This thread's query at camera point p"
VIEW_INDEX = """template <bool kBrick>
__device__ __forceinline__ size_t view_index(const ViewGeom& g, int i, int j, int k) {
  if (!kBrick) return (static_cast<size_t>(i) * g.m + j) * g.m + k;
  const int nbj = g.m / g.bj, nbk = g.m / g.bk;
  const int ib = i / g.bi, di = i - ib * g.bi;
  const int jb = j / g.bj, dj = j - jb * g.bj;
  const int kb = k / g.bk, dk = k - kb * g.bk;
  return (static_cast<size_t>(ib) * nbj + jb) * nbk * g.pitch
         + static_cast<size_t>(kb) * g.pitch + (di * g.bj + dj) * g.bk + dk;
}

// This thread's query at camera point p"""
ROW_MUL = "                  : pts.wmul ? static_cast<int>"
ROW_DIV = "                  : false ? static_cast<int>"
PIECES = {"new_shuffle_down": [(BUTTERFLY_T, SHUFFLE_DOWN)],
          "new_butterfly_loop": [(BUTTERFLY_T, BUTTERFLY)],
          "new_shared_sums": [(BUTTERFLY_T, SHARED_SUMS)],
          "new_fences": [(TICKET, TICKET_FENCES)],
          "new_staged": [(SUM_WALK, SUM_STAGED)], "new_regs": [(WALK_LOOP, REGS_LOOP)],
          "new_per_corner": [(ROWS16_ON, ROWS16_OFF)],
          "new_divides": [(ROWS16_ON, ROWS16_OFF), (CORNERS, CORNERS_DIVIDED),
                          (QUERY, VIEW_INDEX), (ROW_MUL, ROW_DIV)]}


def _once(src: str, anchor: str) -> int:
    if src.count(anchor) != 1:
        raise RuntimeError(f"expected one {anchor!r} in the source")
    return src.index(anchor)


def before_source(src: str) -> str:
    """The committed source with the replaced reduce half in place of its
    own."""
    start, end = _once(src, REGION_START), _once(src, REGION_END)
    return src[:start] + BEFORE_REDUCE.strip() + "\n\n" + src[end:]


def prefetch_source(src: str) -> str:
    """The committed source with the point load ahead of the done test."""
    _once(src, PREFETCH_LOAD)
    src = src.replace(PREFETCH_LOAD, "")
    at = _once(src, STAMP_ENTRY)
    return src[:at] + PREFETCH_LOAD + src[at:]


def piece_source(src: str, name: str) -> str:
    """The committed source with PIECES[name]'s replacements."""
    for old, new in PIECES[name]:
        _once(src, old)
        src = src.replace(old, new)
    return src


def stamped_source(src: str, form: str) -> str:
    """``src`` (form "before" or "new") with the clock stamps."""
    for anchor, text in [*STAMP_AT, (STAMP_PARTIALS[form],
                                     "  if (threadIdx.x == 0) K1_STAMP(7);\n"),
                         (STAMP_SLAB_END[form], STAMP_SLAB_FLUSH)]:
        at = _once(src, anchor) + len(anchor)
        src = src[:at] + text + src[at:]
    at = _once(src, STAMP_ENTRY)
    src = src[:at] + "  K1_ENTRY\n" + src[at:]
    _once(src, STAMP_TICKET[0])
    src = src.replace(STAMP_TICKET[0], STAMP_TICKET[1])
    ns = _once(src, "namespace {\n")
    return src[:ns] + STAMPS + "\n" + src[ns:] + STAMPS_TAIL


def build_all(out_dir: Path):
    """{form: (library path, {kernel: [registers, stack bytes]})}: the
    builds, their nvcc processes started together."""
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "gn_reduce.cu").read_text()
    old = before_source(src)
    sources = {"before": old, "new": src, "new_prefetch": prefetch_source(src),
               **{name: piece_source(src, name) for name in PIECES},
               "before_stamped": stamped_source(old, "before"),
               "new_stamped": stamped_source(src, "new")}
    procs = []
    for form, text in sources.items():
        cu = out_dir / f"gn_reduce_{form}.cu"
        cu.write_text(text)
        so = out_dir / f"libk1_{form}.so"
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
    if m is None:
        return mangled
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


def sass_ops(so: Path, dump: Path) -> dict:
    """Counts of SASS_OPS in the SASS of the build's bf16 brick-major
    gn_step kernel, whose SASS goes to ``dump``."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    sections = re.split(r"\n\s*Function : ", sass)
    body = next(s for s in sections
                if _kernel_key(s.split("\n", 1)[0]) == "gn_step_kernel<bf16, brick>")
    dump.write_text(body)
    ops = Counter()
    for line in body.splitlines():
        m = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+(?:\.[A-Z0-9]+)*)", line)
        if m:
            name = m.group(1).split(".")[0]
            for op in SASS_OPS:
                if name == op or (op == "ATOM" and name in ("ATOMG", "RED", "REDG")):
                    ops[op] += 1
            ops["all"] += 1
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
    if hasattr(lib, "k1_set_stamp_buffer"):
        lib.k1_set_stamp_buffer.argtypes = [ctypes.c_void_p]
        lib.k1_set_stamp_buffer.restype = ctypes.c_int
    return lib


def using(main, lib, make):
    """``make()`` with the package's K1 entry points taken from ``lib``."""
    _build._lib = _Swap(main, lib)
    try:
        return make()
    finally:
        _build._lib = main


def finish_call(lib, sums: torch.Tensor, state: torch.Tensor, cfg):
    """One gn_finish launch of ``lib`` on (29,) sums and a (24,) state (any
    rows of larger buffers: pointers taken at the rows)."""
    _build.check(lib.tsdf_gn_finish(sums.data_ptr(), state.data_ptr(), *cfg,
                                    _build.stream_ptr(sums.device)), "gn_finish")


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
    """Every gn_step launch of each pyramid level in every build, and the
    slab form over the whole grid (gn_reduce) from the same state at each
    iteration: {label: record}, the state and sum bits that differ from the
    before build's, summed over the other builds."""
    recs = {}
    for label, view, pts, pose, cfg in inputs:
        rec = dict(levels=[], step_differ=0, sums_differ=0, launches=0)
        p = cfg.grid
        for mult in cfg.pyramid_levels or (1,):
            t = cfg.tracking
            lcfg = t if mult == 1 else t._replace(max_iterations=smoke.COARSE_ITERATIONS,
                                                  min_iterations=0)
            s = t.pixel_stride * mult
            img = pts[::s, ::s]
            states, steps, reducers = {}, {}, {}
            probe = k1.init_state(pose, lcfg.damping)
            for form, lib in libs.items():
                states[form] = k1.init_state(pose, lcfg.damping)
                steps[form] = using(main, lib, lambda: k1.gn_stepper(view, states[form], img,
                                                                     p, lcfg))
                reducers[form] = using(main, lib, lambda: k1.slab_stepper(view, probe, img, p,
                                                                          lcfg)[0])
            for _ in range(lcfg.max_iterations):
                sums = {}
                for form in libs:
                    probe.copy_(states["before"])
                    sums[form] = reducers[form]().clone()
                for form in libs:
                    steps[form]()
                rec["launches"] += 1
                for form in libs:
                    rec["step_differ"] += smoke.bits_differ(states[form], states["before"])
                    rec["sums_differ"] += smoke.bits_differ(sums[form], sums["before"])
            torch.cuda.synchronize()
            rec["levels"].append(dict(stride=s, launches=lcfg.max_iterations, steps=int(
                states["new"].view(torch.int32)[k1.S_COUNT]), queries=img.shape[0] * img.shape[1]))
            # the next level starts where this one ended, as the pyramid does
            pose = k1.state_pose(states["before"].clone())
        recs[label] = rec
        print(f"{label}: levels {rec['levels']}; bits differing from the before build's over "
              f"{rec['launches']} gn_step launches: states {rec['step_differ']}, gn_reduce "
              f"sums {rec['sums_differ']}")
    return recs


def _two_ranks(view, m):
    """Rank r's view of a two-way i-split: its slab and the next rank's
    first plane (dense) or brick layer (brick-major); (view, i0, slab)."""
    s = m // 2
    if not isinstance(view, BrickMaskedView):
        return [(view[:s + 1].contiguous(), 0, s), (view[s:].contiguous(), s, s)]
    rows, bs = view.rows, view.bs
    per, layer = rows.shape[0] // 2, (m // bs[1]) * (m // bs[2])
    return [(BrickMaskedView(rows[:per + layer].contiguous(), m, bs, mi=s + bs[0]), 0, s),
            (BrickMaskedView(rows[per:].contiguous(), m, bs, mi=s), s, s)]


def compare_slabs(inputs, libs, main):
    """The slab form at a rank's real inputs: tum256's bf16 rows and
    tum128's dense view split in two ranks, each rank's sums at stride 3 in
    every build; the bits that differ from the before build's."""
    rec = {}
    for label, view, pts, pose, cfg in (inputs[0], inputs[2]):
        img = pts[::cfg.tracking.pixel_stride, ::cfg.tracking.pixel_stride]
        state = k1.init_state(pose, 0.0)
        differ, owned = 0, []
        for v, i0, s in _two_ranks(view, cfg.grid.m):
            outs = {form: using(main, lib, lambda: k1.slab_stepper(
                v, state, img, cfg.grid, cfg.tracking, i0=i0, slab=s)[0])().clone()
                for form, lib in libs.items()}
            differ += sum(smoke.bits_differ(o, outs["before"]) for o in outs.values())
            owned.append(int(outs["new"][27].item()))
        rec[label] = dict(differ=differ, owned=owned)
    print(f"slab form, two ranks at stride 3: {rec}")
    return rec


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
    the before build's by a bit, by case."""
    sums, states, cfg_idx, names = random_systems(dev)
    out = {}
    for form, lib in libs.items():
        out[form] = states.clone()
        for i in range(sums.shape[0]):
            finish_call(lib, sums[i], out[form][i], STEP_CFGS[cfg_idx[i]])
    torch.cuda.synchronize()
    ref = out["before"].view(torch.int32)
    diff = torch.stack([(o.view(torch.int32) != ref).any(1) for o in out.values()]).any(0)
    by_case = Counter(names[i] for i in diff.nonzero().flatten().tolist())
    stepped = int((out["new"].view(torch.int32)[:, k1.S_COUNT]
                   != states.view(torch.int32)[:, k1.S_COUNT]).sum())
    rec = dict(systems=sums.shape[0], differ=int(diff.sum()), differ_by_case=dict(by_case),
               stepped=stepped)
    print(f"random and degenerate systems: {rec}")
    return rec


def never_cfg(tcfg):
    """The level's cfg with a twist bound no step meets: every launch is a
    full step."""
    return tcfg._replace(max_iterations=1 << 30, min_iterations=0, max_twist_diff=-1.0)


def _stage_ends(t) -> list:
    """One block's stamps (STAMP_SLOTS, 256) -> the end of each stage in
    ticks from the block's first entry (the last thread's end for the
    per-thread stages; a stage no thread reached ends with the one before)."""
    d = (t - t[0, 0] + (1 << 31)) % (1 << 32) - (1 << 31)  # signed, mod 2^32
    entry = d[0].min()
    ends = [0.0]
    for s in range(1, STAMP_SLOTS):
        sel = slice(None) if s < 5 else slice(0, 1)
        v = d[s, sel][t[s, sel] != 0]
        ends.append(ends[-1] if v.size == 0 else max(ends[-1], float(v.max() - entry)))
    return ends


def stage_split(inputs, libs, main):
    """The stamped builds' stage split of a full step at tum256 and tum512,
    strides 3, 6 and 12, and of ``gn_reduce`` (the slab form over the whole
    grid; its last stage is the store of the sums) at stride 3:
    {form: {label: record}}."""
    recs = {}
    for form in ("before_stamped", "new_stamped"):
        lib = libs[form]
        recs[form] = {}
        for name, view, pts, pose, cfg in inputs[:2]:
            for mult, kind in [(m, "gn_step") for m in STRIDE_MULTS] + [(1, "gn_reduce")]:
                s = cfg.tracking.pixel_stride * mult
                img = pts[::s, ::s]
                n = img.shape[0] * img.shape[1]
                blocks = -(-n // k1.THREADS)
                buf = torch.zeros(blocks * STAMP_STRIDE, dtype=torch.int32, device=view.device)
                _build.check(lib.k1_set_stamp_buffer(buf.data_ptr()), "k1_set_stamp_buffer")
                state = k1.init_state(pose, cfg.tracking.damping)
                if kind == "gn_step":
                    run = using(main, lib, lambda: k1.gn_stepper(view, state, img, cfg.grid,
                                                                  never_cfg(cfg.tracking)))
                else:
                    run = using(main, lib, lambda: k1.gn_reducer(view, pose, img, cfg.grid))
                for _ in range(3):  # warm: the points and corners in L2, as on a level
                    run()
                rows = []
                for _ in range(STAMP_LAUNCHES):
                    buf.zero_()
                    run()
                    torch.cuda.synchronize()
                    rows.append(buf.view(blocks, STAMP_STRIDE).cpu().numpy().view(np.uint32)
                                .astype(np.int64))
                _build.check(lib.k1_set_stamp_buffer(0), "k1_set_stamp_buffer")
                recs[form][f"{kind} {name} stride {s}"] = split_record(rows, blocks, n)
        for label, r in recs[form].items():
            print(f"{form} {label}: " + json.dumps(r))
    return recs


def split_record(rows, blocks: int, n: int) -> dict:
    """Medians over the stamped launches ``rows`` ((blocks, STAMP_STRIDE)
    words each) of each stage's µs in block 0, in the median block (each
    stage's median over the blocks, to the ticket) and in the last block,
    and the blocks' spread on %globaltimer."""
    per = {"block 0": [], "median block": [], "last block": []}
    ghz, steps, last_ids = [], [], []
    cross = {"entry spread": [], "last block entry": [], "ticket spread": [],
             "first entry to finish": []}
    for a in rows:
        t = a[:, :STAMP_SLOTS * 256].reshape(blocks, STAMP_SLOTS, 256)
        g = a[:, STAMP_SLOTS * 256:STAMP_SLOTS * 256 + 6].reshape(blocks, 3, 2)
        g = g[:, :, 0] + (g[:, :, 1] << 32)
        last = int(np.nonzero(t[:, 7, 0])[0][0])
        last_ids.append(last)
        ends = [_stage_ends(t[b]) for b in range(blocks)]
        # the SM clock: the last block's ticks over its %globaltimer ns
        ghz.append(ends[last][8] / max(g[last, 2] - g[last, 0], 1))
        per["block 0"].append(ends[0])
        per["last block"].append(ends[last])
        per["median block"].append(list(np.median(np.diff(np.array(ends), axis=1), axis=0)))
        cross["entry spread"].append(float(g[:, 0].max() - g[:, 0].min()))
        cross["last block entry"].append(float(g[last, 0] - g[:, 0].min()))
        cross["ticket spread"].append(float(g[:, 1].max() - g[:, 1].min()))
        cross["first entry to finish"].append(float(g[last, 2] - g[:, 0].min()))
        steps.extend(np.diff(np.unique(g[:, 0])).tolist())
    clock = statistics.median(ghz)
    out = dict(queries=n, blocks=blocks, sm_ghz=round(clock, 4),
               globaltimer_resolution_ns=int(min(steps)) if steps else None,
               last_block_ids=sorted(set(last_ids))[:5])
    for key, vals in per.items():
        med = np.median(np.array(vals), axis=0) / clock / 1e3  # ticks -> µs
        inc = med if key == "median block" else np.diff(med)
        keep = len(STAMP_STAGES) if key == "last block" else 6
        out[key] = {stage: round(float(inc[i]), 4) for i, stage in enumerate(STAMP_STAGES[:keep])}
        out[key]["total"] = round(float(sum(inc[:keep])), 4)
    out["across blocks µs"] = {k: round(statistics.median(v) / 1e3, 4) for k, v in cross.items()}
    return out


def timings(inputs, libs, main, rounds: int = 2):
    """Device ms per build of a full step, a done launch and gn_reduce at
    tum256 and tum512 (stride 3) and of full steps at strides 6 and 12:
    {form: {what: [ms of each round]}}, the builds in turn and then in
    reverse."""
    forms = [f for f in libs if not f.endswith("_stamped")]
    recs = {form: {} for form in forms}
    for r in range(rounds):
        for form in forms if r % 2 == 0 else forms[::-1]:
            lib, rec = libs[form], recs[form]
            times = {}
            for name, v, q, p0, c in inputs[:2]:
                s = c.tracking.pixel_stride
                tcfg = never_cfg(c.tracking)
                done = k1.init_state(p0, tcfg.damping)
                done.view(torch.int32)[k1.S_DONE] = 1
                for mult in STRIDE_MULTS:
                    full = using(main, lib, lambda: k1.gn_stepper(
                        v, k1.init_state(p0, tcfg.damping), q[::s * mult, ::s * mult],
                        c.grid, tcfg))
                    times[f"gn_step full {name} stride {s * mult}"] = smoke.kernel_device_ms(
                        full, ("gn_step_kernel",), tries=3)
                frozen = using(main, lib, lambda: k1.gn_stepper(v, done, q[::s, ::s], c.grid,
                                                                 tcfg))
                reduce = using(main, lib, lambda: k1.gn_reducer(v, p0, q[::s, ::s].reshape(-1, 3),
                                                                 c.grid))
                times[f"gn_step done {name}"] = smoke.kernel_device_ms(
                    frozen, ("gn_step_kernel",), tries=3)
                times[f"gn_reduce {name}"] = smoke.kernel_device_ms(
                    reduce, ("gn_reduce_slab_kernel",), tries=3)
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
    Path(args.out).mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    built = build_all(ROOT / "build" / "k1_trials")
    print(f"built {len(built)} forms in {time.perf_counter() - t0:.1f} s")
    sass = {}
    for form, (so, report) in built.items():
        sass[form] = sass_ops(so, Path(args.out) / f"sass_{form}.txt")
        print(f"{form}: registers and stack frame bytes {report}; gn_step_kernel<bf16, "
              f"brick> SASS ops {sass[form]}")
    libs = {form: load(so) for form, (so, _) in built.items()}
    plain = {f: lib for f, lib in libs.items() if not f.endswith("_stamped")}
    smoke.all_device_ms(lambda: torch.ones(1, device=dev).add_(1))  # the profiler's first cycle
    inputs = level_inputs(dev)
    levels = compare_levels(inputs, plain, main_lib)
    slabs = compare_slabs(inputs, plain, main_lib)
    rand = compare_random(dev, plain)
    split = stage_split(inputs, libs, main_lib)
    times = timings(inputs, plain, main_lib)
    ok = (rand["differ"] == 0 and all(r["differ"] == 0 for r in slabs.values())
          and all(r["step_differ"] == r["sums_differ"] == 0 for r in levels.values()))
    Path(args.out).mkdir(parents=True, exist_ok=True)
    (Path(args.out) / "k1_trials.json").write_text(json.dumps(dict(
        gpu=smi, ptxas={f: r for f, (_, r) in built.items()}, sass_ops=sass, levels=levels,
        slabs=slabs, random=rand, split=split, device_ms=times), indent=1))
    print(smi)
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
