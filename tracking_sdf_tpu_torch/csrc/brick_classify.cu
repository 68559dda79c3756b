// K5, K6 and K7: a frame's brick classification, the compaction of its FULL
// and FREE lists, and its pixel table, the fusion stage before K2.
//   tsdf_frame_tables       K5: one thread a pixel. The pixel-table row and
//                           the zeta (min) / eta (max) depth bounds; each
//                           8x8 tile's bounds are level 0 of the mip, and
//                           the last block to finish reduces the upper
//                           levels from it;
//   tsdf_classify_bricks    K6: one thread a brick. OUT 0 / FREE 1 / FULL 2
//                           from the 8 voxel-centre hull corners and a
//                           4-cell window query of the mip; three forms:
//                           flat (every brick of a slab), super (bricks x
//                           factor, and "all children saturated"), children
//                           (the factor^3 children of each listed super);
//   tsdf_compact_lists      K7, flat form: one block; the stable first-cap
//                           compaction of the FULL and FREE flags (bricks,
//                           or mixed and FREE supers) and their counts;
//   tsdf_compact_lists_hier K7, hierarchical form: one block; the FULL and
//                           FREE children of the mixed supers, then the
//                           children of the kept FREE supers, and the counts.
//
// No Pallas original: the JAX package leaves all of this to XLA's fusions
// (tracking_sdf_tpu/fusion/brick.py: _zeta_mip :187, _query_zeta :282,
// _brick_corners_cam :336, classify_compact_hier :377, _class_from_corners
// :537, classify_bricks :587, _compact_vals / _compact_ids :123,
// _pixel_table :625; called from fusion/brickmajor.py:350-413). The plain
// PyTorch versions are fusion/brick.py's *_reference functions and
// fusion/brickmajor.py's classify_compact_rows_reference: some 315 eager ops
// a frame flat, 560 hierarchical.
//
// Arithmetic: bitwise equal to the plain versions on the card, which are
// eager PyTorch rounding after every operation. So sums and products are
// __fadd_rn / __fsub_rn / __fmul_rn / __fdiv_rn in the plain ops' order (nvcc
// may not contract them into FMAs): the world corner (s * (i + 0.5)) + o, the
// camera corner ((x R0 + y R1) + z R2) + base with base = -(Rᵀ t) computed by
// the same torch expression and passed in, u = (fx px + cx pz) / z. PyTorch on
// the card divides a tensor by a Python scalar as a product with a reciprocal
// (the wrapper passes 1/fx, 1/fy and 1/24 as PyTorch forms them), but a tensor
// by a tensor as a true division (u0 / cell). A sum over 3 channels adds
// (x0 + x2) + x1, as torch.sum does there on the card. log2f is libdevice's, as
// torch.log2 calls it (no fast math): one ulp picks another mip level at a
// power of two. Masks select, never multiply. min and max let a NaN win, and
// clamp keeps a NaN, as torch.amin / torch.clamp do. Host scalars arrive
// rounded to float32 as PyTorch rounds a Python scalar.
//
// What bounds them on the card. K5: bytes (points and normals, 3.7 MB each at
// 640x480, and rgb with color; the table 4.9 / 9.8 MB out); the 6,409-cell mip
// is 0.1 MB. It reads each pixel's 3-float point and normal as they lie, and
// writes its table row as one or two 16-byte stores. The upper levels (1,609
// cells at 640x480) are done by the last block to finish, counted by a ticket
// (atomicInc wraps it back to 0, so a CUDA graph replays), rather than by a
// second launch: one launch less on every frame, and the reduction is too
// small to fill more than one block anyway. K6 and K7: a few hundred KB
// (32,768 bricks flat at 256^3; 4,096 supers and at most 98,304 children at
// 512^3), so latency: one thread a brick, and K7 as one block of 1024
// threads, each a contiguous run of flags, with one block-wide exclusive scan
// of the two counts packed in a 64-bit word. No atomics but the ticket, no
// library kernels; the lists are a fixed function of the flags.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kTile = 8;         // mip base tile, pixels (brick._TILE)
constexpr int kTablesX = 32;     // K5 block: 32 x 8 pixels, four tiles side by side
constexpr int kTablesY = kTile;
constexpr int kMaxLevels = 24;
constexpr int kClassifyThreads = 256;
constexpr int kCompactThreads = 1024;
constexpr uint8_t kFree = 1, kFull = 2;
constexpr int kModeMip = 1, kModeTable = 2;
constexpr int kFlat = 0, kSuper = 1, kChildren = 2;

// The mip's levels, flattened row-major and concatenated: level l holds
// dh[l] x dw[l] cells from off[l]; total cells over all levels.
struct Levels {
  int n, total;
  int off[kMaxLevels], dh[kMaxLevels], dw[kMaxLevels];
};

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// torch.minimum / amin and torch.maximum / amax: a NaN wins
__device__ __forceinline__ float min_nan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// torch.clamp: a NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// x0 + x1 + x2 as torch.sum over 3 floats rounds it on the card
__device__ __forceinline__ float sum3(float x0, float x1, float x2) {
  return __fadd_rn(__fadd_rn(x0, x2), x1);
}

// ---- K5 -------------------------------------------------------------------

struct TableArgs {
  int h, w, mode, point_to_plane, channels, blocks;
  float cx, cy, inv_fx, inv_fy;  // inv_*: PyTorch's reciprocal of fx, fy
  float delta;                   // point-to-point: delta + share margin
  float share_margin;            // point-to-plane: 0 for none
};

// Cell (r, c) of a level from `off` of dh x dw cells: the cell in the zeta
// and eta planes, the row-below companion of (r - 1, c), and the neutral
// companion of a last-row cell. `mip` holds four planes of `total` cells:
// zeta, zeta's row below, eta, eta's row below.
__device__ __forceinline__ void put_cell(float* mip, int total, int off, int r, int c,
                                         int dh, int dw, float z, float e) {
  const int i = off + r * dw + c;
  mip[i] = z;
  mip[2 * total + i] = e;
  if (r > 0) {
    mip[total + i - dw] = z;
    mip[3 * total + i - dw] = e;
  }
  if (r == dh - 1) {
    mip[total + i] = inf_f();
    mip[3 * total + i] = -inf_f();
  }
}

__global__ void __launch_bounds__(kTablesX * kTablesY)
frame_tables_kernel(const float* __restrict__ pts, const float* __restrict__ nrm,
                    const float* __restrict__ rgb, float* __restrict__ pix,
                    float* __restrict__ mip, unsigned int* __restrict__ ticket, TableArgs a,
                    Levels L) {
  const int x = blockIdx.x * kTablesX + threadIdx.x;
  const int y = blockIdx.y * kTablesY + threadIdx.y;
  float zeta = inf_f(), eta = -inf_f();  // the neutral values pad the image
  if (x < a.w && y < a.h) {
    const int g = y * a.w + x;
    const float p0 = pts[3 * g], p1 = pts[3 * g + 1], p2 = pts[3 * g + 2];
    const float n0 = nrm[3 * g], n1 = nrm[3 * g + 1], n2 = nrm[3 * g + 2];
    const bool fin = isfinite(p0) && isfinite(p1) && isfinite(n0) && isfinite(n1)
                     && isfinite(n2);
    // |n| of a valid pixel, 0 otherwise (the masked squares' sum)
    const float norm =
        fin ? __fsqrt_rn(sum3(__fmul_rn(n0, n0), __fmul_rn(n1, n1), __fmul_rn(n2, n2))) : 0.f;
    if (a.mode & kModeTable) {
      // [nx, ny, nz, s (, cos, cos r, cos g, cos b)]; an invalid pixel's s
      // drives the distance to -inf
      float s;
      if (a.point_to_plane)
        s = fin ? sum3(__fmul_rn(p0, n0), __fmul_rn(p1, n1), __fmul_rn(p2, n2)) : inf_f();
      else
        s = fin ? p2 : -inf_f();
      float4* row = reinterpret_cast<float4*>(pix + static_cast<size_t>(g) * a.channels);
      row[0] = make_float4(fin ? n0 : 0.f, fin ? n1 : 0.f, fin ? n2 : 0.f, s);
      if (a.channels == 8) {
        const float cosv = norm > 0.f ? __fdiv_rn(fabsf(fin ? n2 : 0.f), norm) : 0.f;
        row[1] = make_float4(cosv, __fmul_rn(cosv, rgb[3 * g]), __fmul_rn(cosv, rgb[3 * g + 1]),
                             __fmul_rn(cosv, rgb[3 * g + 2]));
      }
    }
    if (a.mode & kModeMip) {
      if (!a.point_to_plane) {
        zeta = fin ? __fsub_rn(p2, a.delta) : -inf_f();
        eta = fin ? __fadd_rn(p2, a.delta) : -inf_f();
      } else {
        // the unit-z ray r = ((u - cx) / fx, (v - cy) / fy, 1)
        const float rx = __fmul_rn(__fsub_rn(static_cast<float>(x), a.cx), a.inv_fx);
        const float ry = __fmul_rn(__fsub_rn(static_cast<float>(y), a.cy), a.inv_fy);
        const float rn = __fadd_rn(__fadd_rn(__fmul_rn(rx, n0), __fmul_rn(ry, n1)), n2);
        const bool toward = fin && rn < 0.f;
        const float am = clamp_min(-rn, 1e-6f);
        const float e_minus = __fadd_rn(__fmul_rn(clamp_min(-n0, 0.f), a.inv_fx),
                                        __fmul_rn(clamp_min(-n1, 0.f), a.inv_fy));
        const float e_plus = __fadd_rn(__fmul_rn(clamp_min(n0, 0.f), a.inv_fx),
                                       __fmul_rn(clamp_min(n1, 0.f), a.inv_fy));
        const float d_eff = a.share_margin != 0.f
                                ? __fadd_rn(a.delta, __fmul_rn(a.share_margin, norm))
                                : a.delta;
        const float za = __fmul_rn(p2, am);
        zeta = toward ? __fdiv_rn(__fsub_rn(za, d_eff), __fadd_rn(am, e_minus)) : -inf_f();
        eta = toward && am > e_plus
                  ? __fdiv_rn(__fadd_rn(za, d_eff), clamp_min(__fsub_rn(am, e_plus), 1e-9f))
                  : (fin ? inf_f() : -inf_f());
      }
    }
  }
  if (!(a.mode & kModeMip)) return;  // uniform over the grid

  // level 0: lanes 8q..8q+7 of a warp hold one row of tile q
#pragma unroll
  for (int s = 1; s < kTile; s <<= 1) {
    zeta = min_nan(zeta, __shfl_xor_sync(0xffffffffu, zeta, s));
    eta = max_nan(eta, __shfl_xor_sync(0xffffffffu, eta, s));
  }
  __shared__ float zs[kTablesY][kTablesX / kTile], es[kTablesY][kTablesX / kTile];
  __shared__ bool last;
  if ((threadIdx.x & (kTile - 1)) == 0) {
    zs[threadIdx.y][threadIdx.x / kTile] = zeta;
    es[threadIdx.y][threadIdx.x / kTile] = eta;
  }
  __syncthreads();
  const int tid = threadIdx.y * kTablesX + threadIdx.x;
  if (tid < kTablesX / kTile) {
    float z = zs[0][tid], e = es[0][tid];
    for (int r = 1; r < kTablesY; ++r) {
      z = min_nan(z, zs[r][tid]);
      e = max_nan(e, es[r][tid]);
    }
    const int c = blockIdx.x * (kTablesX / kTile) + tid;
    if (c < L.dw[0]) put_cell(mip, L.total, 0, blockIdx.y, c, L.dh[0], L.dw[0], z, e);
  }

  // the last block to finish reduces levels 1.. from level 0
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicInc(ticket, static_cast<unsigned int>(a.blocks - 1))
           == static_cast<unsigned int>(a.blocks - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int l = 1; l < L.n; ++l) {
    const int pdh = L.dh[l - 1], pdw = L.dw[l - 1], poff = L.off[l - 1];
    const int dh = L.dh[l], dw = L.dw[l];
    for (int i = tid; i < dh * dw; i += kTablesX * kTablesY) {
      const int r = i / dw, c = i % dw;
      float z = inf_f(), e = -inf_f();  // cells past an odd edge pad neutral
#pragma unroll
      for (int dr = 0; dr < 2; ++dr)
#pragma unroll
        for (int dc = 0; dc < 2; ++dc) {
          const int rr = 2 * r + dr, cc = 2 * c + dc;
          if (rr < pdh && cc < pdw) {
            const int j = poff + rr * pdw + cc;
            z = min_nan(z, __ldcg(mip + j));
            e = max_nan(e, __ldcg(mip + 2 * L.total + j));
          }
        }
      put_cell(mip, L.total, L.off[l], r, c, dh, dw, z, e);
    }
    __syncthreads();
  }
}

// ---- K6 -------------------------------------------------------------------

struct ClassifyArgs {
  int form;
  int nbi, nbj, nbk;  // the bricks classified (flat, super), or the fine grid (children)
  int bi, bj, bk;     // their extent in voxels
  int i_offset;       // global voxel i of the slab's first layer
  int f;              // super: factor (sat); children: factor
  int n_slots;        // children: listed supers
  int ns, nsj, nsk;   // children: the super grid (padding id ns)
  int nb;             // children: the fine grid's bricks (padding id)
  int img_h, img_w;
  float si, sj, sk, ox, oy, oz;  // voxel size per axis (extent / m) and grid origin
  float fx, fy, cx, cy;
  float inv_span;                // PyTorch's reciprocal of 3 * kTile
};

struct Mip {
  const float *zeta, *zeta_down, *eta, *eta_down;
};

// World coordinates of the first and last voxel centre of brick b of extent
// `ext` along one axis, the first brick starting at voxel `off`:
// (s * (idx + 0.5)) + o and (s * ((idx + ext) - 0.5)) + o, idx = b * ext + off.
__device__ __forceinline__ void axis_lohi(int b, int ext, int off, float s, float o, float& lo,
                                          float& hi) {
  const float fe = static_cast<float>(ext);
  const float idx = __fadd_rn(__fmul_rn(static_cast<float>(b), fe), static_cast<float>(off));
  lo = __fadd_rn(__fmul_rn(s, __fadd_rn(idx, 0.5f)), o);
  hi = __fadd_rn(__fmul_rn(s, __fsub_rn(__fadd_rn(idx, fe), 0.5f)), o);
}

// (min zeta, max eta) over the window of 4 cells a row for two row pairs at
// the level where 3 cells cover the clamped bbox's span (brick._query_zeta);
// flat indices past the end wrap modulo the total padded to a multiple of 4,
// whose pad cells are neutral.
__device__ __forceinline__ void query(const Mip& mip, const Levels& L, float inv_span, float u0,
                                      float u1, float v0, float v1, float& zmin, float& emax) {
  const float span = __fmul_rn(max_nan(__fsub_rn(u1, u0), __fsub_rn(v1, v0)), inv_span);
  const float lf = ceilf(log2f(clamp_min(span, 1.f)));
  // the int64 cast of a NaN is INT64_MIN, which the clamp takes to 0
  const int lvl = isnan(lf) ? 0 : static_cast<int>(fminf(fmaxf(lf, 0.f), L.n - 1.f));
  const int off = L.off[lvl], dh = L.dh[lvl], dw = L.dw[lvl];
  const float cell = static_cast<float>(kTile << lvl);
  const float qu = __fdiv_rn(u0, cell), qv = __fdiv_rn(v0, cell);
  const int cu0 = min(isnan(qu) ? 0 : max(static_cast<int>(qu), 0), max(dw - 4, 0));
  const int cv0 = min(isnan(qv) ? 0 : max(static_cast<int>(qv), 0), max(dh - 4, 0));
  const int P = (L.total + 3) & ~3;
  zmin = inf_f();
  emax = -inf_f();
#pragma unroll
  for (int dv = 0; dv <= 2; dv += 2) {
    const int f0 = off + min(cv0 + dv, dh - 1) * dw + cu0;
#pragma unroll
    for (int lane = 0; lane < 4; ++lane) {
      const int i = (f0 + lane) % P;
      if (i < L.total) {
        zmin = min_nan(zmin, min_nan(__ldg(mip.zeta + i), __ldg(mip.zeta_down + i)));
        emax = max_nan(emax, max_nan(__ldg(mip.eta + i), __ldg(mip.eta_down + i)));
      }
    }
  }
}

// 0 OUT, 1 FREE, 2 FULL of brick (ib, jb, kb) (brick._class_from_corners)
__device__ uint8_t classify_brick(const ClassifyArgs& a, const Levels& L, const Mip& mip,
                                  const float* R, const float* base, int ib, int jb, int kb) {
  float xs[2], ys[2], zs[2];
  axis_lohi(ib, a.bi, a.i_offset, a.si, a.ox, xs[0], xs[1]);
  axis_lohi(jb, a.bj, 0, a.sj, a.oy, ys[0], ys[1]);
  axis_lohi(kb, a.bk, 0, a.sk, a.oz, zs[0], zs[1]);
  float ax[2][3], ay[2][3], az[2][3];  // each axis' part of Rᵀ p: R's row per axis
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      ax[s][c] = __fmul_rn(xs[s], R[c]);
      ay[s][c] = __fmul_rn(ys[s], R[3 + c]);
      az[s][c] = __fmul_rn(zs[s], R[6 + c]);
    }
  float pz_min = inf_f(), pz_max = -inf_f();
  float u0 = inf_f(), u1 = -inf_f(), v0 = inf_f(), v1 = -inf_f();
#pragma unroll
  for (int k = 0; k < 8; ++k) {  // corners in (i, j, k) loop order
    const int ci = k >> 2, cj = (k >> 1) & 1, ck = k & 1;
    float p[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      p[c] = __fadd_rn(__fadd_rn(__fadd_rn(ax[ci][c], ay[cj][c]), az[ck][c]), base[c]);
    pz_min = min_nan(pz_min, p[2]);
    pz_max = max_nan(pz_max, p[2]);
    const float safe = p[2] > 0.f ? p[2] : 1.f;
    const float u = __fdiv_rn(__fadd_rn(__fmul_rn(a.fx, p[0]), __fmul_rn(a.cx, p[2])), safe);
    const float v = __fdiv_rn(__fadd_rn(__fmul_rn(a.fy, p[1]), __fmul_rn(a.cy, p[2])), safe);
    u0 = min_nan(u0, u);
    u1 = max_nan(u1, u);
    v0 = min_nan(v0, v);
    v1 = max_nan(v1, v);
  }
  const float w = static_cast<float>(a.img_w), h = static_cast<float>(a.img_h);
  const bool all_front = pz_min > 0.f;
  const bool inside = all_front && u0 >= 0.f && u1 < w && v0 >= 0.f && v1 < h;
  // left / top bound <= -1: the per-voxel path truncates toward zero
  const bool out =
      pz_max <= 0.f || (all_front && (u1 <= -1.f || u0 >= w || v1 <= -1.f || v0 >= h));
  float zmin, emax;
  query(mip, L, a.inv_span, clamp(u0, 0.f, w - 1.f), clamp(u1, 0.f, w - 1.f),
        clamp(v0, 0.f, h - 1.f), clamp(v1, 0.f, h - 1.f), zmin, emax);
  const bool free = inside && pz_max < zmin;
  const bool occluded = all_front && pz_min > emax;
  return out || occluded ? 0 : (free ? kFree : kFull);
}

__global__ void __launch_bounds__(kClassifyThreads)
classify_bricks_kernel(Mip mip, const float* __restrict__ pose_R, const float* __restrict__ base,
                       const uint8_t* __restrict__ sat, const int* __restrict__ mixed_ids,
                       uint8_t* __restrict__ cls, uint8_t* __restrict__ sat_super,
                       int* __restrict__ gid, ClassifyArgs a, Levels L) {
  const int i = blockIdx.x * kClassifyThreads + threadIdx.x;
  float R[9], t[3];
#pragma unroll
  for (int c = 0; c < 9; ++c) R[c] = __ldg(pose_R + c);
#pragma unroll
  for (int c = 0; c < 3; ++c) t[c] = __ldg(base + c);
  if (a.form != kChildren) {
    if (i >= a.nbi * a.nbj * a.nbk) return;
    const int ib = i / (a.nbj * a.nbk), jb = (i / a.nbk) % a.nbj, kb = i % a.nbk;
    cls[i] = classify_brick(a, L, mip, R, t, ib, jb, kb);
    if (a.form == kSuper && sat != nullptr) {  // are all f^3 children saturated?
      const int f = a.f, fj = a.nbj * f, fk = a.nbk * f;
      bool all = true;
      for (int c = 0; c < f * f * f && all; ++c)
        all = sat[(ib * f + c / (f * f)) * fj * fk + (jb * f + (c / f) % f) * fk + kb * f + c % f];
      sat_super[i] = all;
    }
    return;
  }
  const int vol = a.f * a.f * a.f;
  if (i >= a.n_slots * vol) return;
  const int sid = mixed_ids[i / vol], c = i % vol;
  if (sid >= a.ns) {  // a padding slot
    cls[i] = 0;
    gid[i] = a.nb;
    return;
  }
  const int ib = (sid / (a.nsj * a.nsk)) * a.f + c / (a.f * a.f);
  const int jb = ((sid / a.nsk) % a.nsj) * a.f + (c / a.f) % a.f;
  const int kb = (sid % a.nsk) * a.f + c % a.f;
  cls[i] = classify_brick(a, L, mip, R, t, ib, jb, kb);
  gid[i] = (ib * a.nbj + jb) * a.nbk + kb;
}

// ---- K7 -------------------------------------------------------------------

// Block-wide exclusive scan of v; *total gets the sum over the block.
__device__ unsigned long long block_scan(unsigned long long v, unsigned long long* total) {
  __shared__ unsigned long long warp_sums[kCompactThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long incl = v;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const unsigned long long o = __shfl_up_sync(0xffffffffu, incl, s);
    if (lane >= s) incl += o;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    unsigned long long w = warp_sums[lane];
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const unsigned long long o = __shfl_up_sync(0xffffffffu, w, s);
      if (lane >= s) w += o;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  const unsigned long long before = (warp > 0 ? warp_sums[warp - 1] : 0ull) + incl - v;
  *total = warp_sums[kCompactThreads / 32 - 1];
  __syncthreads();  // warp_sums is read before the next scan writes it
  return before;
}

constexpr unsigned long long kHigh = 1ull << 32;  // the second count's unit

// Stable compaction of two disjoint flag sets of one list: set A's values
// in order to ids[0, cap_a), set B's to ids[cap_a, cap_a + cap_b), the first
// ones under each cap, the rest of each part `fill`. Thread t takes the
// contiguous run [lo, hi) of the list. flag(i) is 1 for A, 2 for B, else 0.
template <typename Flag, typename Value>
__device__ void compact_two(int n, int cap_a, int cap_b, int fill, int* ids, Flag flag,
                            Value value, unsigned int* n_a, unsigned int* n_b) {
  const int chunk = (n + kCompactThreads - 1) / kCompactThreads;
  const int lo = min(static_cast<int>(threadIdx.x) * chunk, n), hi = min(lo + chunk, n);
  unsigned long long mine = 0;
  for (int i = lo; i < hi; ++i) {
    const int k = flag(i);
    mine += k == 1 ? 1ull : (k == 2 ? kHigh : 0ull);
  }
  unsigned long long total;
  const unsigned long long before = block_scan(mine, &total);
  unsigned int pa = static_cast<unsigned int>(before);
  unsigned int pb = static_cast<unsigned int>(before >> 32);
  for (int i = lo; i < hi; ++i) {
    const int k = flag(i);
    if (k == 1) {
      if (pa < static_cast<unsigned int>(cap_a)) ids[pa] = value(i);
      ++pa;
    } else if (k == 2) {
      if (pb < static_cast<unsigned int>(cap_b)) ids[cap_a + pb] = value(i);
      ++pb;
    }
  }
  *n_a = static_cast<unsigned int>(total);
  *n_b = static_cast<unsigned int>(total >> 32);
  for (int p = min(*n_a, static_cast<unsigned int>(cap_a)) + threadIdx.x; p < cap_a;
       p += kCompactThreads)
    ids[p] = fill;
  for (int p = min(*n_b, static_cast<unsigned int>(cap_b)) + threadIdx.x; p < cap_b;
       p += kCompactThreads)
    ids[cap_a + p] = fill;
}

// Flat form: FULL ids under cap_a, then FREE ids not set in `skip` under
// cap_b; counts [n_full, n_free, max(n_free - cap_b, 0), 0].
__global__ void __launch_bounds__(kCompactThreads)
compact_lists_kernel(const uint8_t* __restrict__ cls, const uint8_t* __restrict__ skip, int n,
                     int cap_a, int cap_b, int fill, int* __restrict__ ids,
                     long long* __restrict__ counts) {
  unsigned int n_a, n_b;
  compact_two(
      n, cap_a, cap_b, fill, ids,
      [&](int i) {
        const uint8_t c = cls[i];
        return c == kFull ? 1 : (c == kFree && !(skip != nullptr && skip[i]) ? 2 : 0);
      },
      [](int i) { return i; }, &n_a, &n_b);
  if (threadIdx.x == 0) {
    counts[0] = n_a;
    counts[1] = n_b;
    counts[2] = max(static_cast<long long>(n_b) - cap_b, 0ll);
    counts[3] = 0;
  }
}

struct HierArgs {
  int n;  // listed children: cap_mixed * f^3
  int cap, cap_free, cap_sfree, cap_mixed;
  int f, nsj, nsk, nbj, nbk, nb, ns;
};

// Hierarchical form, after K6's children form: the FULL children in
// (mixed-super rank, child) order under cap; the FREE children of mixed
// supers (not saturated) first, then the children of the kept FREE supers at
// n_free_mixed + k with saturated children left as `nb` holes, all under
// cap_free; counts [n_full, n_free, overflow_free, overflow_mixed] from the
// supers' counts [n_mixed, n_sf] (brick.classify_compact_hier_reference).
__global__ void __launch_bounds__(kCompactThreads)
compact_lists_hier_kernel(const uint8_t* __restrict__ fcls, const int* __restrict__ gid,
                          const uint8_t* __restrict__ sat, const int* __restrict__ sf_ids,
                          const long long* __restrict__ super_counts, int* __restrict__ ids,
                          long long* __restrict__ counts, HierArgs a) {
  unsigned int n_full, n_free_mixed;
  compact_two(
      a.n, a.cap, a.cap_free, a.nb, ids,
      [&](int i) {
        const uint8_t c = fcls[i];
        if (c == kFull) return 1;
        return c == kFree && !(sat != nullptr && sat[min(gid[i], a.nb - 1)]) ? 2 : 0;
      },
      [&](int i) { return gid[i]; }, &n_full, &n_free_mixed);
  __syncthreads();  // the padding above is written before the holes below
  const int vol = a.f * a.f * a.f;
  unsigned long long n_sat = 0;
  for (int k = threadIdx.x; k < a.cap_sfree * vol; k += kCompactThreads) {
    const int sid = sf_ids[k / vol], c = k % vol;
    if (sid >= a.ns) continue;  // padding: not kept
    const int g = (((sid / (a.nsj * a.nsk)) * a.f + c / (a.f * a.f)) * a.nbj
                   + ((sid / a.nsk) % a.nsj) * a.f + (c / a.f) % a.f) * a.nbk
                  + (sid % a.nsk) * a.f + c % a.f;
    if (sat != nullptr && sat[g]) {
      ++n_sat;
      continue;
    }
    const long long pos = static_cast<long long>(n_free_mixed) + k;
    if (pos < a.cap_free) ids[a.cap + pos] = g;
  }
  unsigned long long n_sat_total;
  block_scan(n_sat, &n_sat_total);
  if (threadIdx.x == 0) {
    const long long n_mixed = super_counts[0], n_sf = super_counts[1];
    const long long nfm = n_free_mixed;
    counts[0] = n_full;
    counts[1] = nfm + vol * n_sf - static_cast<long long>(n_sat_total);
    counts[2] = max(nfm + vol * min(n_sf, static_cast<long long>(a.cap_sfree)) - a.cap_free, 0ll)
                + vol * max(n_sf - a.cap_sfree, 0ll);
    counts[3] = max(n_mixed - a.cap_mixed, 0ll);
  }
}

Levels levels_from(const int* table) {
  Levels L{};
  L.n = table[0];
  L.total = table[1];
  for (int l = 0; l < L.n && l < kMaxLevels; ++l) {
    L.off[l] = table[2 + l];
    L.dh[l] = table[2 + L.n + l];
    L.dw[l] = table[2 + 2 * L.n + l];
  }
  return L;
}

}  // namespace

// K5. mode: 1 the mip (into `mip`, four planes of the levels' total cells),
// 2 the pixel table (into `pix`, `channels` 4 or 8 floats a pixel; rgb read
// with 8), 3 both. levels: host ints [n, total, off[n], dh[n], dw[n]].
// ticket: one device word, 0 between launches (the last block leaves it so).
extern "C" int tsdf_frame_tables(const float* pts, const float* nrm, const float* rgb, float* pix,
                                 float* mip, unsigned int* ticket, const int* levels, int h, int w,
                                 int mode, int point_to_plane, int channels, float cx, float cy,
                                 float inv_fx, float inv_fy, float delta, float share_margin,
                                 cudaStream_t stream) {
  const Levels L = levels_from(levels);
  if (mode < 1 || mode > 3 || ((mode & kModeTable) && channels != 4 && channels != 8)
      || L.n < 1 || L.n > kMaxLevels || L.dh[0] != (h + kTile - 1) / kTile
      || L.dw[0] != (w + kTile - 1) / kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  if (h <= 0 || w <= 0) return 0;
  const dim3 grid((w + kTablesX - 1) / kTablesX, (h + kTablesY - 1) / kTablesY);
  const TableArgs a{h,  w,  mode,   point_to_plane, channels, static_cast<int>(grid.x * grid.y),
                    cx, cy, inv_fx, inv_fy,         delta,    share_margin};
  frame_tables_kernel<<<grid, dim3(kTablesX, kTablesY), 0, stream>>>(pts, nrm, rgb, pix, mip,
                                                                    ticket, a, L);
  return static_cast<int>(cudaGetLastError());
}

// K6. form 0 flat / 1 super: cls (nbi nbj nbk) over the grid of bricks of
// extent (bi, bj, bk); super with sat (the fine grid's bits) also writes
// sat_super. form 2 children: the f^3 children of each of the n_slots
// mixed_ids (an id >= ns is padding) on the fine grid (nbi, nbj, nbk), into
// cls and gid (n_slots f^3). R: the pose's rotation (row-major), base:
// -(Rᵀ t), both float32 on the device.
extern "C" int tsdf_classify_bricks(int form, const float* zeta, const float* zeta_down,
                                    const float* eta, const float* eta_down, const int* levels,
                                    const float* R, const float* base, const uint8_t* sat,
                                    const int* mixed_ids, uint8_t* cls, uint8_t* sat_super,
                                    int* gid, int nbi, int nbj, int nbk, int bi, int bj, int bk,
                                    int i_offset, int f, int n_slots, int ns, int nsj, int nsk,
                                    int nb, int img_h, int img_w, float si, float sj, float sk,
                                    float ox, float oy, float oz, float fx, float fy, float cx,
                                    float cy, float inv_span, cudaStream_t stream) {
  const Levels L = levels_from(levels);
  if (form < kFlat || form > kChildren || L.n < 1 || L.n > kMaxLevels || f < 1
      || (form == kChildren && (mixed_ids == nullptr || gid == nullptr))
      || (form == kSuper && sat != nullptr && sat_super == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = form == kChildren ? n_slots * f * f * f : nbi * nbj * nbk;
  if (n <= 0) return 0;
  const ClassifyArgs a{form, nbi,   nbj,   nbk,   bi, bj, bk, i_offset, f,  n_slots,
                       ns,   nsj,   nsk,   nb,    img_h, img_w, si, sj, sk, ox,
                       oy,   oz,    fx,    fy,    cx, cy,       inv_span};
  classify_bricks_kernel<<<(n + kClassifyThreads - 1) / kClassifyThreads, kClassifyThreads, 0,
                           stream>>>(Mip{zeta, zeta_down, eta, eta_down}, R, base, sat,
                                     mixed_ids, cls, sat_super, gid, a, L);
  return static_cast<int>(cudaGetLastError());
}

// K7, flat form: ids (cap_a + cap_b) int32, counts (4,) int64.
extern "C" int tsdf_compact_lists(const uint8_t* cls, const uint8_t* skip, int n, int cap_a,
                                  int cap_b, int fill, int* ids, long long* counts,
                                  cudaStream_t stream) {
  if (n < 0 || cap_a < 0 || cap_b < 0) return static_cast<int>(cudaErrorInvalidValue);
  compact_lists_kernel<<<1, kCompactThreads, 0, stream>>>(cls, skip, n, cap_a, cap_b, fill, ids,
                                                          counts);
  return static_cast<int>(cudaGetLastError());
}

// K7, hierarchical form: fcls and gid (n) from K6's children form, sat (nb)
// or NULL, sf_ids (cap_sfree) and super_counts [n_mixed, n_sf, ...] from the
// flat form over the supers; ids (cap + cap_free) int32, counts (4,) int64.
extern "C" int tsdf_compact_lists_hier(const uint8_t* fcls, const int* gid, const uint8_t* sat,
                                       const int* sf_ids, const long long* super_counts, int* ids,
                                       long long* counts, int n, int cap, int cap_free,
                                       int cap_sfree, int cap_mixed, int f, int nsj, int nsk,
                                       int nbj, int nbk, int nb, int ns, cudaStream_t stream) {
  if (n < 0 || cap < 0 || cap_free < 0 || cap_sfree < 1 || f < 1 || nb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const HierArgs a{n, cap, cap_free, cap_sfree, cap_mixed, f, nsj, nsk, nbj, nbk, nb, ns};
  compact_lists_hier_kernel<<<1, kCompactThreads, 0, stream>>>(fcls, gid, sat, sf_ids,
                                                               super_counts, ids, counts, a);
  return static_cast<int>(cudaGetLastError());
}
