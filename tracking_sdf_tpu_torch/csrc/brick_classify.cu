// K5, K6 and K7: a frame's brick classification, the compaction of its FULL
// and FREE lists, and its pixel table, the fusion stage before K2.
//   tsdf_frame_tables       K5: a 32x32-pixel region a block, 4 consecutive
//                           pixels a thread. The pixel-table rows and the
//                           zeta (min) / eta (max) depth bounds; the block
//                           reduces its 4x4 tiles to mip levels 0, 1 and 2,
//                           and the last block to finish reduces levels 3..
//                           from level 2 in shared memory;
//   tsdf_classify_bricks    K6: 1 or 8 lanes a brick, as the caller asks.
//                           OUT 0 / FREE 1 / FULL 2 from the 8 voxel-centre
//                           hull corners and a 4-cell window query of the
//                           mip; three forms:
//                           flat (every brick of a slab), super (bricks x
//                           factor, and "all children saturated"), children
//                           (the factor^3 children of each listed super);
//   tsdf_compact_lists      K7, flat form: the stable first-cap compaction of
//                           the FULL and FREE flags (bricks, or mixed and
//                           FREE supers) and their counts;
//   tsdf_compact_lists_hier K7, hierarchical form: the FULL and FREE children
//                           of the mixed supers, then the children of the
//                           kept FREE supers, and the counts.
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
// clamp keeps a NaN, as torch.amin / torch.clamp do; each mip cell is the
// min / max of its own 2x2 children (level 0: of its 8x8 pixels). Host
// scalars arrive rounded to float32 as PyTorch rounds a Python scalar.
//
// What bounds them on the card, and what the design does about it.
// K5: bytes (points and normals, 3.7 MB each at 640x480, and rgb with color;
// the table 4.9 / 9.8 MB out; the 6,409-cell mip 0.1 MB). A thread reads its
// 4 pixels' points, normals and rgb as three 16-byte loads each (w % 4 == 0
// and 16-byte-aligned bases, else the same values one float at a time), and
// stages its table rows in shared memory, so that each warp stores 512
// contiguous bytes of a region row (as 16-byte chunks). The block's own 16
// level-0, 4 level-1 and 1 level-2 cells come from warp shuffles, so the
// 1,609 upper cells at 640x480 shrink to the 300 of level 2, which the last
// block to finish (an atomicInc ticket that wraps back to 0, so a CUDA graph
// replays) loads into shared memory once to reduce levels 3.. there: no
// level makes its own L2 round trip, and no second launch.
// K6 and K7: a few hundred KB (32,768 bricks flat at 256^3; 4,096 supers and
// at most 98,304 children at 512^3), so latency. K6: a brick's class is a
// chain of ~900 instructions (8 corners with 16 divisions, a log2f, the
// window's 8 mip cells). One thread a brick issues the fewest instructions,
// but 4,096 supers are 1 warp an SM; a group of lanes a brick shortens the
// chain (lane c projects corners c, c + lanes, ..., and loads its share of
// the window's cells; the group reduces the bounds by shuffles, and the
// super form's sat test spreads the f^3 child bytes over the lanes and
// votes), at the cost of the brick's other work repeated in every lane. So
// the caller picks 8 lanes where a launch's threads stay within 256 an SM
// (tum512's supers), else 1 (tum256's bricks and the children):
// fusion/brick_classify.py's classify_lanes, which
// tools/classify_trials.py's candidates chose. Every form loads the window's cells unconditionally (a padding
// cell from cell 0, then a select), so a thread's mip loads are in flight
// together. K7:
// a single-pass stable compaction over many blocks, a decoupled look-back
// scan: each block takes a ticket; the first tickets are tiles of 2,048
// flags (16 a thread, one 16-byte load, and the hierarchical form's ids as
// four), ranked in the block by a scan of the two counts packed in 64 bits,
// staged in shared memory in list order, then written out coalesced after
// the tile has looked back over its predecessors' status words for its
// prefix; the later tickets pad the lists past the counts (and place the
// kept FREE supers' children), and the last block to finish writes the
// counts and zeroes the status words. Integer atomics only (the tickets, the
// status words, the saturated-children count), so the lists stay a fixed
// function of the flags.

#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kTile = 8;         // mip base tile, pixels (brick._TILE)
constexpr int kRegion = 32;      // K5 block: a 32 x 32-pixel region, 4 x 4 tiles
constexpr int kPixels = 4;       // K5: consecutive pixels a thread
constexpr int kTablesX = kRegion / kPixels;
constexpr int kTablesY = kRegion;
constexpr int kMaxLevels = 24;
constexpr int kClassifyThreads = 128;
constexpr int kCompactThreads = 128;
constexpr int kFlagsPerThread = 16;
constexpr int kCompactTile = kCompactThreads * kFlagsPerThread;  // flags a tile
constexpr int kFinishSpan = kCompactThreads * 4;  // list positions a padding block
constexpr int kScratchHead = 2;  // K7 scratch: [ticket, done], [n_sat, 0], then a status word a tile
constexpr uint8_t kFree = 1, kFull = 2;
constexpr int kModeMip = 1, kModeTable = 2;
constexpr int kFlat = 0, kSuper = 1, kChildren = 2;

static_assert(kClassifyThreads % 32 == 0, "K6: a brick's lanes lie in one warp");

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

// K6's min and max, whose results meet only comparisons: a NaN wins (PTX
// min.NaN / max.NaN, one instruction), as in min_nan / max_nan up to the
// NaN's payload and a zero's sign, which no comparison sees
__device__ __forceinline__ float min_cmp(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float max_cmp(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
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

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// ---- K5 -------------------------------------------------------------------

struct TableArgs {
  int h, w, mode, point_to_plane, channels, blocks;
  int vec;                       // 16-byte loads: w % 4 == 0, aligned bases
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

// Level l's cell (r, c) where that level exists, with put_cell.
__device__ __forceinline__ void put_level(float* mip, const Levels& L, int l, int r, int c,
                                          float z, float e) {
  if (l < L.n && r < L.dh[l] && c < L.dw[l])
    put_cell(mip, L.total, L.off[l], r, c, L.dh[l], L.dw[l], z, e);
}

// The 3 floats of each of a thread's 4 pixels from `src` + 3 g (of which
// `valid` lie in the image): three 16-byte loads, or one float at a time.
__device__ __forceinline__ void load_pixels(const float* __restrict__ src, size_t g, bool vec,
                                            int valid, float (&v)[3 * kPixels]) {
  if (vec) {
    const float4* q = reinterpret_cast<const float4*>(src + 3 * g);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float4 f = __ldg(q + k);
      v[4 * k] = f.x;
      v[4 * k + 1] = f.y;
      v[4 * k + 2] = f.z;
      v[4 * k + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 3 * kPixels; ++k) v[k] = k < 3 * valid ? __ldg(src + 3 * g + k) : 0.f;
  }
}

// The staged table: 16-byte chunk c of a region row at chunk c ^ ((c / 8) %
// 8), so that 8 threads storing one chunk each of their own pixels, or
// reading 8 consecutive chunks, hit 8 different bank groups.
__device__ __forceinline__ int swizzle(int c) { return c ^ ((c >> 3) & 7); }

// One pixel (column x, row y): its table row (1 or 2 chunks), and its zeta /
// eta.: its table row, and its zeta / eta.
__device__ __forceinline__ void pixel(const TableArgs& a, float4* row, int x, int y,
                                      const float* p, const float* n, const float* rgb,
                                      float& zeta, float& eta) {
  const float p0 = p[0], p1 = p[1], p2 = p[2];
  const float n0 = n[0], n1 = n[1], n2 = n[2];
  const bool fin = isfinite(p0) && isfinite(p1) && isfinite(n0) && isfinite(n1) && isfinite(n2);
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
    row[0] = make_float4(fin ? n0 : 0.f, fin ? n1 : 0.f, fin ? n2 : 0.f, s);
    if (a.channels == 8) {
      const float cosv = norm > 0.f ? __fdiv_rn(fabsf(fin ? n2 : 0.f), norm) : 0.f;
      row[1] = make_float4(cosv, __fmul_rn(cosv, rgb[0]), __fmul_rn(cosv, rgb[1]),
                           __fmul_rn(cosv, rgb[2]));
    }
  }
  if (!(a.mode & kModeMip)) return;
  if (!a.point_to_plane) {
    zeta = fin ? __fsub_rn(p2, a.delta) : -inf_f();
    eta = fin ? __fadd_rn(p2, a.delta) : -inf_f();
    return;
  }
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
  const float d_eff =
      a.share_margin != 0.f ? __fadd_rn(a.delta, __fmul_rn(a.share_margin, norm)) : a.delta;
  const float za = __fmul_rn(p2, am);
  zeta = toward ? __fdiv_rn(__fsub_rn(za, d_eff), __fadd_rn(am, e_minus)) : -inf_f();
  eta = toward && am > e_plus
            ? __fdiv_rn(__fadd_rn(za, d_eff), clamp_min(__fsub_rn(am, e_plus), 1e-9f))
            : (fin ? inf_f() : -inf_f());
}

// blockDim (8, 32): thread (tx, ty) takes pixels 4 tx .. 4 tx + 3 of row ty
// of the block's region; a warp holds 4 rows. The table rows are staged in
// shared memory and stored a region row at a time, 32 consecutive chunks a
// warp. Dynamic shared memory: the last block's levels 2 and 3 (zeta and eta
// each), for levels 3.. .
__global__ void __launch_bounds__(kTablesX * kTablesY)
frame_tables_kernel(const float* __restrict__ pts, const float* __restrict__ nrm,
                    const float* __restrict__ rgb, float* __restrict__ pix,
                    float* __restrict__ mip, unsigned int* __restrict__ ticket, TableArgs a,
                    Levels L) {
  const int x0 = blockIdx.x * kRegion + kPixels * threadIdx.x;
  const int y = blockIdx.y * kRegion + threadIdx.y;
  __shared__ float4 rows[kTablesY][kRegion * 2];  // the region's table, 1 or 2 chunks a pixel
  const int cpp = a.channels / 4;
  float zeta = inf_f(), eta = -inf_f();  // the neutral values pad the image
  if (x0 < a.w && y < a.h) {
    const int valid = min(kPixels, a.w - x0);
    const size_t g = static_cast<size_t>(y) * a.w + x0;
    const bool vec = a.vec;  // then valid == 4
    float p[3 * kPixels], n[3 * kPixels], c[3 * kPixels];
    load_pixels(pts, g, vec, valid, p);
    load_pixels(nrm, g, vec, valid, n);
    if ((a.mode & kModeTable) && a.channels == 8) load_pixels(rgb, g, vec, valid, c);
#pragma unroll
    for (int k = 0; k < kPixels; ++k) {
      if (k >= valid) break;
      float z = inf_f(), e = -inf_f();
      float4 row[2];
      pixel(a, row, x0 + k, y, p + 3 * k, n + 3 * k, c + 3 * k, z, e);
      if (a.mode & kModeTable)
        for (int j = 0; j < cpp; ++j)
          rows[threadIdx.y][swizzle((kPixels * threadIdx.x + k) * cpp + j)] = row[j];
      zeta = min_nan(zeta, z);
      eta = max_nan(eta, e);
    }
  }
  const int tid = threadIdx.y * kTablesX + threadIdx.x;
  if (a.mode & kModeTable) {  // uniform over the grid
    __syncthreads();
    float4* out = reinterpret_cast<float4*>(pix);
    for (int q = tid; q < kTablesY * kRegion * cpp; q += kTablesX * kTablesY) {
      const int r = q / (kRegion * cpp), cc = q % (kRegion * cpp);
      const int x = blockIdx.x * kRegion + cc / cpp, yr = blockIdx.y * kRegion + r;
      if (x < a.w && yr < a.h)
        out[(static_cast<size_t>(yr) * a.w + blockIdx.x * kRegion) * cpp + cc] =
            rows[r][swizzle(cc)];
    }
  }
  if (!(a.mode & kModeMip)) return;  // uniform over the grid

  // level 0: a tile row is 2 threads, a warp 4 of a tile's 8 rows
  const int lane = (threadIdx.y & 3) * kTablesX + threadIdx.x, warp = threadIdx.y >> 2;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    if (s == 2 || s == 4) continue;  // xor 1 (the pair), then 8 and 16 (the rows)
    zeta = min_nan(zeta, __shfl_xor_sync(0xffffffffu, zeta, s));
    eta = max_nan(eta, __shfl_xor_sync(0xffffffffu, eta, s));
  }
  constexpr int kTiles = kRegion / kTile;  // a side
  __shared__ float zs[kTablesY / 4][kTiles], es[kTablesY / 4][kTiles];
  __shared__ bool last;
  if (lane < kTablesX && !(lane & 1)) {
    zs[warp][lane >> 1] = zeta;
    es[warp][lane >> 1] = eta;
  }
  __syncthreads();
  if (tid < 32) {
    // lane 4 tr + tc holds level-0 cell (tr, tc) of the region, the two
    // warps of its rows; then levels 1 and 2 from each cell's 2x2 children
    const int tr = tid >> 2, tc = tid & 3;
    float z = tid < kTiles * kTiles ? min_nan(zs[2 * tr][tc], zs[2 * tr + 1][tc]) : inf_f();
    float e = tid < kTiles * kTiles ? max_nan(es[2 * tr][tc], es[2 * tr + 1][tc]) : -inf_f();
    if (tid < kTiles * kTiles)
      put_level(mip, L, 0, blockIdx.y * kTiles + tr, blockIdx.x * kTiles + tc, z, e);
    z = min_nan(z, __shfl_xor_sync(0xffffffffu, z, 1));
    e = max_nan(e, __shfl_xor_sync(0xffffffffu, e, 1));
    z = min_nan(z, __shfl_xor_sync(0xffffffffu, z, 4));
    e = max_nan(e, __shfl_xor_sync(0xffffffffu, e, 4));
    if (tid < kTiles * kTiles && !(tr & 1) && !(tc & 1))
      put_level(mip, L, 1, blockIdx.y * 2 + (tr >> 1), blockIdx.x * 2 + (tc >> 1), z, e);
    z = min_nan(z, __shfl_xor_sync(0xffffffffu, z, 2));
    e = max_nan(e, __shfl_xor_sync(0xffffffffu, e, 2));
    z = min_nan(z, __shfl_xor_sync(0xffffffffu, z, 8));
    e = max_nan(e, __shfl_xor_sync(0xffffffffu, e, 8));
    if (tid == 0) put_level(mip, L, 2, blockIdx.y, blockIdx.x, z, e);
  }

  // the last block to finish reduces levels 3.. from level 2
  if (tid < 32) __threadfence();  // the cells above, before the ticket
  __syncthreads();
  if (tid == 0)
    last = atomicInc(ticket, static_cast<unsigned int>(a.blocks - 1))
           == static_cast<unsigned int>(a.blocks - 1);
  __syncthreads();
  if (!last || L.n <= 3) return;
  __threadfence();
  extern __shared__ float tail[];
  // even levels' zeta and eta at tail, tail + c2; odd levels' after them
  const int c2 = L.dh[2] * L.dw[2], c3 = L.dh[3] * L.dw[3];
  float* even = tail;
  float* odd = tail + 2 * c2;
  for (int i = tid; i < c2; i += kTablesX * kTablesY) {
    even[i] = __ldcg(mip + L.off[2] + i);
    even[c2 + i] = __ldcg(mip + 2 * L.total + L.off[2] + i);
  }
  __syncthreads();
  for (int l = 3; l < L.n; ++l) {
    const int pdw = L.dw[l - 1], pdh = L.dh[l - 1], dw = L.dw[l], dh = L.dh[l];
    const float* pz = l & 1 ? even : odd;
    const float* pe = l & 1 ? even + c2 : odd + c3;
    float* oz = l & 1 ? odd : even;
    float* oe = l & 1 ? odd + c3 : even + c2;
    for (int i = tid; i < dh * dw; i += kTablesX * kTablesY) {
      const int r = i / dw, c = i % dw;
      float z = inf_f(), e = -inf_f();  // cells past an odd edge pad neutral
#pragma unroll
      for (int dr = 0; dr < 2; ++dr)
#pragma unroll
        for (int dc = 0; dc < 2; ++dc) {
          const int rr = 2 * r + dr, cc = 2 * c + dc;
          if (rr < pdh && cc < pdw) {
            z = min_nan(z, pz[rr * pdw + cc]);
            e = max_nan(e, pe[rr * pdw + cc]);
          }
        }
      oz[i] = z;
      oe[i] = e;
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

// World coordinate of the first (hi 0) or last (hi 1) voxel centre of brick
// b of extent `ext` along one axis, the first brick starting at voxel `off`:
// (s * (idx + 0.5)) + o or (s * ((idx + ext) - 0.5)) + o, idx = b * ext + off.
__device__ __forceinline__ float axis_end(int b, int ext, int off, float s, float o, int hi) {
  const float fe = static_cast<float>(ext);
  const float idx = __fadd_rn(__fmul_rn(static_cast<float>(b), fe), static_cast<float>(off));
  return __fadd_rn(__fmul_rn(s, hi ? __fsub_rn(__fadd_rn(idx, fe), 0.5f) : __fadd_rn(idx, 0.5f)),
                   o);
}

// The min / max of v over the kLanes lanes of a brick's group (mask: the
// group's lanes). min_cmp and max_cmp let a NaN win and are otherwise exact,
// so any order gives the classes the plain version's sequence gives (a
// NaN's payload and a zero's sign reach only comparisons, the clamps and the
// level's and the window's integer casts, where neither changes a result).
template <int kLanes>
__device__ __forceinline__ float group_min(unsigned mask, float v) {
#pragma unroll
  for (int s = 1; s < kLanes; s <<= 1) v = min_cmp(v, __shfl_xor_sync(mask, v, s));
  return v;
}
template <int kLanes>
__device__ __forceinline__ float group_max(unsigned mask, float v) {
#pragma unroll
  for (int s = 1; s < kLanes; s <<= 1) v = max_cmp(v, __shfl_xor_sync(mask, v, s));
  return v;
}

// (min zeta, max eta) over the window of 4 cells a row for two row pairs at
// the level where 3 cells cover the clamped bbox's span (brick._query_zeta);
// flat indices past the end wrap modulo the total padded to a multiple of 4
// (an index is below twice that), whose pad cells are neutral. Every lane of
// the group computes the level and the window (the same in each) and loads
// 8 / kLanes of its 8 cells (cell q: row pair q / 4, column q % 4), all at
// once; the group reduces them.
template <int kLanes>
__device__ __forceinline__ void query(const Mip& mip, const Levels& L, float inv_span, float u0,
                                      float u1, float v0, float v1, int lane, unsigned mask,
                                      float& zmin, float& emax) {
  const float span = __fmul_rn(max_cmp(__fsub_rn(u1, u0), __fsub_rn(v1, v0)), inv_span);
  const float lf = ceilf(log2f(clamp_min(span, 1.f)));
  // the int64 cast of a NaN is INT64_MIN, which the clamp takes to 0
  const int lvl = isnan(lf) ? 0 : static_cast<int>(fminf(fmaxf(lf, 0.f), L.n - 1.f));
  const int off = L.off[lvl], dh = L.dh[lvl], dw = L.dw[lvl];
  const float cell = static_cast<float>(kTile << lvl);
  const float qu = __fdiv_rn(u0, cell), qv = __fdiv_rn(v0, cell);
  const int cu0 = min(isnan(qu) ? 0 : max(static_cast<int>(qu), 0), max(dw - 4, 0));
  const int cv0 = min(isnan(qv) ? 0 : max(static_cast<int>(qv), 0), max(dh - 4, 0));
  const int P = (L.total + 3) & ~3;
  constexpr int kCells = 8 / kLanes;
  float z[kCells], zd[kCells], e[kCells], ed[kCells];
  bool in[kCells];
#pragma unroll
  for (int k = 0; k < kCells; ++k) {
    const int q = lane + k * kLanes;
    int i = off + min(cv0 + 2 * (q >> 2), dh - 1) * dw + cu0 + (q & 3);
    i = i >= P ? i - P : i;
    in[k] = i < L.total;
    const int c = in[k] ? i : 0;
    z[k] = __ldg(mip.zeta + c);
    zd[k] = __ldg(mip.zeta_down + c);
    e[k] = __ldg(mip.eta + c);
    ed[k] = __ldg(mip.eta_down + c);
  }
  zmin = inf_f();
  emax = -inf_f();
#pragma unroll
  for (int k = 0; k < kCells; ++k) {
    zmin = in[k] ? min_cmp(zmin, min_cmp(z[k], zd[k])) : zmin;
    emax = in[k] ? max_cmp(emax, max_cmp(e[k], ed[k])) : emax;
  }
  zmin = group_min<kLanes>(mask, zmin);
  emax = group_max<kLanes>(mask, emax);
}

// 0 OUT, 1 FREE, 2 FULL of brick (ib, jb, kb) (brick._class_from_corners),
// the same in every lane of its group: lane `lane` projects corners lane,
// lane + kLanes, ... of the 8 in (i, j, k) loop order (corner c: ci = c >>
// 2, cj = (c >> 1) & 1, ck = c & 1) with the plain ops' rounding, and the
// group reduces the depth and image bounds.
template <int kLanes>
__device__ __forceinline__ uint8_t classify_brick(const ClassifyArgs& a, const Levels& L,
                                                  const Mip& mip, const float* R,
                                                  const float* base, int ib, int jb, int kb,
                                                  int lane, unsigned mask) {
  float pz_min = inf_f(), pz_max = -inf_f();
  float u0 = inf_f(), u1 = -inf_f(), v0 = inf_f(), v1 = -inf_f();
#pragma unroll
  for (int k = 0; k < 8 / kLanes; ++k) {
    const int c = lane + k * kLanes;
    const float x = axis_end(ib, a.bi, a.i_offset, a.si, a.ox, c >> 2);
    const float y = axis_end(jb, a.bj, 0, a.sj, a.oy, (c >> 1) & 1);
    const float z = axis_end(kb, a.bk, 0, a.sk, a.oz, c & 1);
    float p[3];  // ((x R0 + y R1) + z R2) + base: each axis' part of Rᵀ p is R's row
#pragma unroll
    for (int e = 0; e < 3; ++e)
      p[e] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(x, R[e]), __fmul_rn(y, R[3 + e])),
                                 __fmul_rn(z, R[6 + e])),
                       base[e]);
    pz_min = min_cmp(pz_min, p[2]);
    pz_max = max_cmp(pz_max, p[2]);
    const float safe = p[2] > 0.f ? p[2] : 1.f;
    const float u = __fdiv_rn(__fadd_rn(__fmul_rn(a.fx, p[0]), __fmul_rn(a.cx, p[2])), safe);
    const float v = __fdiv_rn(__fadd_rn(__fmul_rn(a.fy, p[1]), __fmul_rn(a.cy, p[2])), safe);
    u0 = min_cmp(u0, u);
    u1 = max_cmp(u1, u);
    v0 = min_cmp(v0, v);
    v1 = max_cmp(v1, v);
  }
  pz_min = group_min<kLanes>(mask, pz_min);
  pz_max = group_max<kLanes>(mask, pz_max);
  u0 = group_min<kLanes>(mask, u0);
  u1 = group_max<kLanes>(mask, u1);
  v0 = group_min<kLanes>(mask, v0);
  v1 = group_max<kLanes>(mask, v1);
  const float w = static_cast<float>(a.img_w), h = static_cast<float>(a.img_h);
  const bool all_front = pz_min > 0.f;
  const bool inside = all_front && u0 >= 0.f && u1 < w && v0 >= 0.f && v1 < h;
  // left / top bound <= -1: the per-voxel path truncates toward zero
  const bool out =
      pz_max <= 0.f || (all_front && (u1 <= -1.f || u0 >= w || v1 <= -1.f || v0 >= h));
  float zmin, emax;
  query<kLanes>(mip, L, a.inv_span, clamp(u0, 0.f, w - 1.f), clamp(u1, 0.f, w - 1.f),
                clamp(v0, 0.f, h - 1.f), clamp(v1, 0.f, h - 1.f), lane, mask, zmin, emax);
  const bool free = inside && pz_max < zmin;
  const bool occluded = all_front && pz_min > emax;
  return out || occluded ? 0 : (free ? kFree : kFull);
}

// kLanes consecutive lanes a brick; the group's lane 0 writes.
template <int kLanes>
__global__ void __launch_bounds__(kClassifyThreads)
classify_bricks_kernel(Mip mip, const float* __restrict__ pose_R, const float* __restrict__ base,
                       const uint8_t* __restrict__ sat, const int* __restrict__ mixed_ids,
                       uint8_t* __restrict__ cls, uint8_t* __restrict__ sat_super,
                       int* __restrict__ gid, ClassifyArgs a, Levels L) {
  const int t = blockIdx.x * kClassifyThreads + threadIdx.x;
  const int i = t / kLanes, lane = t % kLanes;
  // the group's lanes of the warp (a group lies in one warp; groups of one
  // warp may part ways)
  const unsigned mask = ((1u << kLanes) - 1) << ((threadIdx.x & 31) & ~(kLanes - 1));
  float R[9], b[3];
#pragma unroll
  for (int c = 0; c < 9; ++c) R[c] = __ldg(pose_R + c);
#pragma unroll
  for (int c = 0; c < 3; ++c) b[c] = __ldg(base + c);
  if (a.form != kChildren) {
    if (i >= a.nbi * a.nbj * a.nbk) return;  // the whole group
    const int ib = i / (a.nbj * a.nbk), jb = (i / a.nbk) % a.nbj, kb = i % a.nbk;
    const uint8_t c = classify_brick<kLanes>(a, L, mip, R, b, ib, jb, kb, lane, mask);
    if (lane == 0) cls[i] = c;
    if (a.form == kSuper && sat != nullptr) {
      // are all f^3 children saturated? The group reads the f^2 runs of f
      // contiguous bytes (a child's k), lane `lane` runs lane, lane + kLanes,
      // ..., every byte (no early exit), and votes
      const int f = a.f, fj = a.nbj * f, fk = a.nbk * f;
      bool all = true;
      for (int run = lane; run < f * f; run += kLanes) {
        const uint8_t* s = sat + (ib * f + run / f) * fj * fk + (jb * f + run % f) * fk + kb * f;
        for (int k = 0; k < f; ++k) all &= s[k] != 0;
      }
      all = __all_sync(mask, all);
      if (lane == 0) sat_super[i] = all;
    }
    return;
  }
  const int vol = a.f * a.f * a.f;
  if (i >= a.n_slots * vol) return;  // the whole group
  const int sid = mixed_ids[i / vol], c = i % vol;
  if (sid >= a.ns) {  // a padding slot: the whole group
    if (lane == 0) {
      cls[i] = 0;
      gid[i] = a.nb;
    }
    return;
  }
  const int ib = (sid / (a.nsj * a.nsk)) * a.f + c / (a.f * a.f);
  const int jb = ((sid / a.nsk) % a.nsj) * a.f + (c / a.f) % a.f;
  const int kb = (sid % a.nsk) * a.f + c % a.f;
  const uint8_t k = classify_brick<kLanes>(a, L, mip, R, b, ib, jb, kb, lane, mask);
  if (lane == 0) {
    cls[i] = k;
    gid[i] = (ib * a.nbj + jb) * a.nbk + kb;
  }
}

// ---- K7 -------------------------------------------------------------------

// Two counts packed in one word: A in bits 0-30, B in bits 31-61 (each at
// most n < 2^31); a status word adds its state in bits 62-63.
constexpr unsigned long long kHigh = 1ull << 31;  // the B count's unit
constexpr unsigned long long kCounts = (1ull << 62) - 1;
constexpr unsigned long long kAggregate = 1ull << 62;  // the tile's own counts
constexpr unsigned long long kInclusive = 2ull << 62;  // the counts up to and with the tile

__device__ __forceinline__ unsigned long long count_a(unsigned long long v) {
  return v & (kHigh - 1);
}
__device__ __forceinline__ unsigned long long count_b(unsigned long long v) {
  return (v & kCounts) >> 31;
}

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

// Block-wide exclusive scan of v; *total gets the sum over the block.
__device__ unsigned long long block_scan(unsigned long long v, unsigned long long* total) {
  constexpr int kWarps = kCompactThreads / 32;
  __shared__ unsigned long long warp_sums[kWarps];
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
    unsigned long long w = lane < kWarps ? warp_sums[lane] : 0ull;
#pragma unroll
    for (int s = 1; s < kWarps; s <<= 1) {
      const unsigned long long o = __shfl_up_sync(0xffffffffu, w, s);
      if (lane >= s) w += o;
    }
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  const unsigned long long before = (warp > 0 ? warp_sums[warp - 1] : 0ull) + incl - v;
  *total = warp_sums[kWarps - 1];
  return before;
}

// Warp 0 of tile t > 0: the counts of tiles 0 .. t-1, from the status words
// of the 32 nearest predecessors at a time, back to the nearest inclusive
// one. A predecessor holds a lower ticket, so it is running and publishes
// its aggregate without waiting on this tile.
__device__ unsigned long long look_back(const unsigned long long* status, int t) {
  const int lane = threadIdx.x & 31;
  unsigned long long prefix = 0;
  for (int j = t - 1;; j -= 32) {
    const int idx = j - lane;
    unsigned long long w = kInclusive;  // before tile 0: an inclusive 0
    if (idx >= 0) {
      do {
        w = load_status(status + idx);
      } while (w < kAggregate);
    }
    const unsigned incl = __ballot_sync(0xffffffffu, w >= kInclusive);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    unsigned long long v = lane <= stop ? (w & kCounts) : 0ull;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
    prefix += v;
    if (incl) return prefix;
  }
}

struct CompactArgs {
  const uint8_t* cls;
  const uint8_t* skip;             // flat: FREE entries to leave out; hier: sat (nb) or NULL
  const int* gid;                  // hier: each child's global id
  const int* sf_ids;               // hier: the kept FREE supers (cap_sfree)
  const long long* super_counts;   // hier: [n_mixed, n_sf, ...]
  int* ids;                        // (cap_a + cap_b)
  long long* counts;               // (4,)
  unsigned long long* scratch;     // kScratchHead + tiles words, 0 between launches
  int n, cap_a, cap_b, fill;
  int tiles, blocks, vec;          // flag tiles, all blocks; 16-byte loads
  int cap_sfree, cap_mixed, f, nsj, nsk, nbj, nbk, nb, ns;  // hier
};

// The global id of child c of super sid on the fine grid.
__device__ __forceinline__ int child_id(const CompactArgs& a, int sid, int c) {
  return (((sid / (a.nsj * a.nsk)) * a.f + c / (a.f * a.f)) * a.nbj
          + ((sid / a.nsk) % a.nsj) * a.f + (c / a.f) % a.f) * a.nbk
         + (sid % a.nsk) * a.f + c % a.f;
}

// Flag tile t: 16 flags a thread, ranked in the block, staged in shared
// memory in list order (the tile's A values, then its B values), written
// out after the look-back under the caps. Flag 1 (A): FULL; flag 2 (B):
// FREE and not skipped (flat: skip[i]; hier: sat of the child's id).
template <bool kHier>
__device__ void flag_tile(const CompactArgs& a, int t, unsigned long long* status) {
  __shared__ int stage[kCompactTile];
  __shared__ unsigned long long tile_prefix;
  const long long i0 = static_cast<long long>(t) * kCompactTile
                       + kFlagsPerThread * static_cast<long long>(threadIdx.x);
  const bool whole = a.vec && i0 + kFlagsPerThread <= a.n;
  uint8_t c[kFlagsPerThread], s[kFlagsPerThread];
  int v[kFlagsPerThread];
  if (whole) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(a.cls + i0));
    const uint4 k = !kHier && a.skip != nullptr
                        ? __ldg(reinterpret_cast<const uint4*>(a.skip + i0)) : make_uint4(0, 0, 0, 0);
    const unsigned qw[4] = {q.x, q.y, q.z, q.w}, kw[4] = {k.x, k.y, k.z, k.w};
#pragma unroll
    for (int j = 0; j < kFlagsPerThread; ++j) {
      c[j] = static_cast<uint8_t>(qw[j >> 2] >> (8 * (j & 3)));
      s[j] = static_cast<uint8_t>(kw[j >> 2] >> (8 * (j & 3)));
    }
    if (kHier) {
#pragma unroll
      for (int k4 = 0; k4 < kFlagsPerThread / 4; ++k4) {
        const int4 g = __ldg(reinterpret_cast<const int4*>(a.gid + i0) + k4);
        v[4 * k4] = g.x;
        v[4 * k4 + 1] = g.y;
        v[4 * k4 + 2] = g.z;
        v[4 * k4 + 3] = g.w;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kFlagsPerThread; ++j) {
      const bool in = i0 + j < a.n;
      c[j] = in ? a.cls[i0 + j] : 0;
      s[j] = in && !kHier && a.skip != nullptr ? a.skip[i0 + j] : 0;
      if (kHier) v[j] = in ? a.gid[i0 + j] : 0;
    }
  }
  unsigned ma = 0, mb = 0;  // bit j: flag j is A / B
#pragma unroll
  for (int j = 0; j < kFlagsPerThread; ++j) {
    if (!kHier) v[j] = static_cast<int>(i0 + j);
    if (kHier && c[j] == kFree && a.skip != nullptr) s[j] = a.skip[min(v[j], a.nb - 1)];
    ma |= static_cast<unsigned>(c[j] == kFull) << j;
    mb |= static_cast<unsigned>(c[j] == kFree && !s[j]) << j;
  }
  unsigned long long total;
  const unsigned long long before = block_scan(__popc(ma) + __popc(mb) * kHigh, &total);
  if (threadIdx.x == 0)  // tile 0's counts are its inclusive prefix
    atomicExch(status + t, (t == 0 ? kInclusive : kAggregate) | total);
  const int tile_a = static_cast<int>(count_a(total)), tile_b = static_cast<int>(count_b(total));
  int pa = static_cast<int>(count_a(before)), pb = tile_a + static_cast<int>(count_b(before));
#pragma unroll
  for (int j = 0; j < kFlagsPerThread; ++j) {
    if (ma >> j & 1) stage[pa++] = v[j];
    if (mb >> j & 1) stage[pb++] = v[j];
  }
  if (threadIdx.x < 32) {
    const unsigned long long prefix = t > 0 ? look_back(status, t) : 0ull;
    if (threadIdx.x == 0) {
      if (t > 0) atomicExch(status + t, kInclusive | (prefix + total));
      tile_prefix = prefix;
    }
  }
  __syncthreads();
  const long long pre_a = static_cast<long long>(count_a(tile_prefix));
  const long long pre_b = static_cast<long long>(count_b(tile_prefix));
  for (int i = threadIdx.x; i < tile_a && pre_a + i < a.cap_a; i += kCompactThreads)
    a.ids[pre_a + i] = stage[i];
  for (int i = threadIdx.x; i < tile_b && pre_b + i < a.cap_b; i += kCompactThreads)
    a.ids[a.cap_a + pre_b + i] = stage[tile_a + i];
}

// Padding block e, once the last tile has published the totals: list
// positions [e, e + 1) x kFinishSpan past each count. Hier: a FREE position
// p >= n_free_mixed holds the kept FREE supers' child p - n_free_mixed (the
// `fill` hole if it is saturated or its super a padding slot), and the block
// counts the saturated children of slots [e, e + 1) x kFinishSpan.
template <bool kHier>
__device__ void pad_block(const CompactArgs& a, int e, const unsigned long long* status,
                          unsigned int* n_sat) {
  __shared__ unsigned long long totals;
  if (threadIdx.x == 0) {
    unsigned long long w;
    do {
      w = load_status(status + a.tiles - 1);
    } while (w < kInclusive);
    totals = w & kCounts;
  }
  __syncthreads();
  const long long na = static_cast<long long>(count_a(totals));
  const long long nb = static_cast<long long>(count_b(totals));
  const long long lo = static_cast<long long>(e) * kFinishSpan;
  const long long hi = min(lo + kFinishSpan, static_cast<long long>(a.cap_a) + a.cap_b);
  const int vol = a.f * a.f * a.f;
  const long long slots = kHier ? static_cast<long long>(a.cap_sfree) * vol : 0;
  for (long long p = lo + threadIdx.x; p < hi; p += kCompactThreads) {
    const long long q = p - a.cap_a;  // the B position
    if (q < 0 ? p < na : q < nb) continue;  // a listed value
    int val = a.fill;
    if (kHier && q >= 0 && q - nb < slots) {
      const int k = static_cast<int>(q - nb), sid = a.sf_ids[k / vol];
      if (sid < a.ns) {
        const int g = child_id(a, sid, k % vol);
        if (a.skip == nullptr || !a.skip[g]) val = g;
      }
    }
    a.ids[p] = val;
  }
  if (kHier && a.skip != nullptr) {
    unsigned int sat = 0;
    for (long long k = lo + threadIdx.x; k < min(lo + kFinishSpan, slots); k += kCompactThreads) {
      const int sid = a.sf_ids[k / vol];
      sat += sid < a.ns && a.skip[child_id(a, sid, static_cast<int>(k % vol))];
    }
    sat = __reduce_add_sync(0xffffffffu, sat);
    if ((threadIdx.x & 31) == 0 && sat) atomicAdd(n_sat, sat);
  }
}

// Flat form counts [n_a, n_b, max(n_b - cap_b, 0), 0]. Hier: [n_full,
// n_free, overflow_free, overflow_mixed] from the supers' counts [n_mixed,
// n_sf] (brick.classify_compact_hier_reference).
template <bool kHier>
__device__ void write_counts(const CompactArgs& a, unsigned long long totals,
                             unsigned int n_sat) {
  const long long na = static_cast<long long>(count_a(totals));
  const long long nb = static_cast<long long>(count_b(totals));
  a.counts[0] = na;
  if (!kHier) {
    a.counts[1] = nb;
    a.counts[2] = max(nb - a.cap_b, 0ll);
    a.counts[3] = 0;
    return;
  }
  const long long vol = a.f * a.f * a.f;
  const long long n_mixed = a.super_counts[0], n_sf = a.super_counts[1];
  a.counts[1] = nb + vol * n_sf - static_cast<long long>(n_sat);
  a.counts[2] = max(nb + vol * min(n_sf, static_cast<long long>(a.cap_sfree)) - a.cap_b, 0ll)
                + vol * max(n_sf - a.cap_sfree, 0ll);
  a.counts[3] = max(n_mixed - a.cap_mixed, 0ll);
}

// Tickets 0 .. tiles-1 are flag tiles, the rest padding blocks; the last
// block to finish writes the counts and zeroes the status words and the
// saturated count (both tickets wrap back to 0), so the scratch is as the
// launch found it.
template <bool kHier>
__device__ __forceinline__ void compact(const CompactArgs& a) {
  unsigned int* counters = reinterpret_cast<unsigned int*>(a.scratch);  // ticket, done, n_sat
  unsigned long long* status = a.scratch + kScratchHead;
  __shared__ int ticket;
  __shared__ bool last;
  if (threadIdx.x == 0) ticket = atomicInc(counters, static_cast<unsigned int>(a.blocks - 1));
  __syncthreads();
  if (ticket < a.tiles)
    flag_tile<kHier>(a, ticket, status);
  else
    pad_block<kHier>(a, ticket - a.tiles, status, counters + 2);
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicInc(counters + 1, static_cast<unsigned int>(a.blocks - 1))
           == static_cast<unsigned int>(a.blocks - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (threadIdx.x == 0) {
    write_counts<kHier>(a, load_status(status + a.tiles - 1) & kCounts,
                        *reinterpret_cast<volatile unsigned int*>(counters + 2));
    counters[2] = 0;
  }
  __syncthreads();  // the last tile's word is read before it is zeroed
  for (int i = threadIdx.x; i < a.tiles; i += kCompactThreads) status[i] = 0;
}

__global__ void __launch_bounds__(kCompactThreads) compact_lists_kernel(CompactArgs a) {
  compact<false>(a);
}

__global__ void __launch_bounds__(kCompactThreads) compact_lists_hier_kernel(CompactArgs a) {
  compact<true>(a);
}

// Grid of a K7 launch: the flag tiles, then enough padding blocks for the
// lists (and the hierarchical form's FREE-super slots).
void compact_grid(CompactArgs& a, long long slots) {
  a.tiles = std::max((a.n + kCompactTile - 1) / kCompactTile, 1);
  const long long span = std::max(static_cast<long long>(a.cap_a) + a.cap_b, slots);
  a.blocks = a.tiles + static_cast<int>(std::max((span + kFinishSpan - 1) / kFinishSpan, 1ll));
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
// vec: 16-byte loads, for w % 4 == 0 and 16-byte-aligned pts, nrm (and rgb
// with color); refused otherwise.
extern "C" int tsdf_frame_tables(const float* pts, const float* nrm, const float* rgb, float* pix,
                                 float* mip, unsigned int* ticket, const int* levels, int h, int w,
                                 int mode, int point_to_plane, int channels, int vec, float cx,
                                 float cy, float inv_fx, float inv_fy, float delta,
                                 float share_margin, cudaStream_t stream) {
  const Levels L = levels_from(levels);
  const bool color = (mode & kModeTable) && channels == 8;
  if (mode < 1 || mode > 3 || ((mode & kModeTable) && channels != 4 && channels != 8)
      || L.n < 1 || L.n > kMaxLevels || L.dh[0] != (h + kTile - 1) / kTile
      || L.dw[0] != (w + kTile - 1) / kTile
      || (vec && (w % kPixels || !aligned16(pts) || !aligned16(nrm) || (color && !aligned16(rgb)))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (h <= 0 || w <= 0) return 0;
  const dim3 grid((w + kRegion - 1) / kRegion, (h + kRegion - 1) / kRegion);
  // the last block's levels 2 and 3, zeta and eta
  const size_t tail = (mode & kModeMip) && L.n > 3
                          ? 2 * sizeof(float) * (L.dh[2] * L.dw[2] + L.dh[3] * L.dw[3]) : 0;
  if (tail > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        frame_tables_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(tail));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const TableArgs a{h,  w,  mode,   point_to_plane, channels, static_cast<int>(grid.x * grid.y),
                    vec, cx, cy,    inv_fx,         inv_fy,   delta,
                    share_margin};
  frame_tables_kernel<<<grid, dim3(kTablesX, kTablesY), tail, stream>>>(pts, nrm, rgb, pix, mip,
                                                                       ticket, a, L);
  return static_cast<int>(cudaGetLastError());
}

// K6. form 0 flat / 1 super: cls (nbi nbj nbk) over the grid of bricks of
// extent (bi, bj, bk); super with sat (the fine grid's bits) also writes
// sat_super. form 2 children: the f^3 children of each of the n_slots
// mixed_ids (an id >= ns is padding) on the fine grid (nbi, nbj, nbk), into
// cls and gid (n_slots f^3). R: the pose's rotation (row-major), base:
// -(Rᵀ t), both float32 on the device. lanes: 1 or 8 a brick.
extern "C" int tsdf_classify_bricks(int form, const float* zeta, const float* zeta_down,
                                    const float* eta, const float* eta_down, const int* levels,
                                    const float* R, const float* base, const uint8_t* sat,
                                    const int* mixed_ids, uint8_t* cls, uint8_t* sat_super,
                                    int* gid, int nbi, int nbj, int nbk, int bi, int bj, int bk,
                                    int i_offset, int f, int n_slots, int ns, int nsj, int nsk,
                                    int nb, int img_h, int img_w, float si, float sj, float sk,
                                    float ox, float oy, float oz, float fx, float fy, float cx,
                                    float cy, float inv_span, int lanes, cudaStream_t stream) {
  const Levels L = levels_from(levels);
  if (form < kFlat || form > kChildren || L.n < 1 || L.n > kMaxLevels || f < 1
      || (lanes != 1 && lanes != 8)
      || (form == kChildren && (mixed_ids == nullptr || gid == nullptr))
      || (form == kSuper && sat != nullptr && sat_super == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = form == kChildren ? n_slots * f * f * f : nbi * nbj * nbk;
  if (n <= 0) return 0;
  const ClassifyArgs a{form, nbi,   nbj,   nbk,   bi, bj, bk, i_offset, f,  n_slots,
                       ns,   nsj,   nsk,   nb,    img_h, img_w, si, sj, sk, ox,
                       oy,   oz,    fx,    fy,    cx, cy,       inv_span};
  const Mip mip{zeta, zeta_down, eta, eta_down};
  const int blocks = static_cast<int>(
      (static_cast<long long>(n) * lanes + kClassifyThreads - 1) / kClassifyThreads);
  const auto kernel = lanes == 8 ? classify_bricks_kernel<8> : classify_bricks_kernel<1>;
  kernel<<<blocks, kClassifyThreads, 0, stream>>>(mip, R, base, sat, mixed_ids, cls, sat_super,
                                                  gid, a, L);
  return static_cast<int>(cudaGetLastError());
}

// K7, flat form: ids (cap_a + cap_b) int32, counts (4,) int64. scratch:
// kScratchHead + scratch_tiles int64 words, 0 between launches (the last
// block leaves them so); vec: 16-byte flag loads, for 16-byte-aligned cls
// (and skip), refused otherwise.
extern "C" int tsdf_compact_lists(const uint8_t* cls, const uint8_t* skip, int n, int cap_a,
                                  int cap_b, int fill, int* ids, long long* counts,
                                  unsigned long long* scratch, int scratch_tiles, int vec,
                                  cudaStream_t stream) {
  if (n < 0 || cap_a < 0 || cap_b < 0 || scratch == nullptr
      || (vec && (!aligned16(cls) || (skip != nullptr && !aligned16(skip)))))
    return static_cast<int>(cudaErrorInvalidValue);
  CompactArgs a{};
  a.cls = cls;
  a.skip = skip;
  a.ids = ids;
  a.counts = counts;
  a.scratch = scratch;
  a.n = n;
  a.cap_a = cap_a;
  a.cap_b = cap_b;
  a.fill = fill;
  a.vec = vec;
  a.f = 1;
  compact_grid(a, 0);
  if (a.tiles > scratch_tiles) return static_cast<int>(cudaErrorInvalidValue);
  compact_lists_kernel<<<a.blocks, kCompactThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K7, hierarchical form: fcls and gid (n) from K6's children form, sat (nb)
// or NULL, sf_ids (cap_sfree) and super_counts [n_mixed, n_sf, ...] from the
// flat form over the supers; ids (cap + cap_free) int32, counts (4,) int64;
// scratch and vec (fcls and gid) as in the flat form.
extern "C" int tsdf_compact_lists_hier(const uint8_t* fcls, const int* gid, const uint8_t* sat,
                                       const int* sf_ids, const long long* super_counts, int* ids,
                                       long long* counts, unsigned long long* scratch, int n,
                                       int cap, int cap_free, int cap_sfree, int cap_mixed, int f,
                                       int nsj, int nsk, int nbj, int nbk, int nb, int ns,
                                       int scratch_tiles, int vec, cudaStream_t stream) {
  if (n < 0 || cap < 0 || cap_free < 0 || cap_sfree < 1 || f < 1 || nb < 1 || scratch == nullptr
      || (vec && (!aligned16(fcls) || !aligned16(gid))))
    return static_cast<int>(cudaErrorInvalidValue);
  CompactArgs a{};
  a.cls = fcls;
  a.skip = sat;
  a.gid = gid;
  a.sf_ids = sf_ids;
  a.super_counts = super_counts;
  a.ids = ids;
  a.counts = counts;
  a.scratch = scratch;
  a.n = n;
  a.cap_a = cap;
  a.cap_b = cap_free;
  a.fill = nb;
  a.vec = vec;
  a.cap_sfree = cap_sfree;
  a.cap_mixed = cap_mixed;
  a.f = f;
  a.nsj = nsj;
  a.nsk = nsk;
  a.nbj = nbj;
  a.nbk = nbk;
  a.nb = nb;
  a.ns = ns;
  compact_grid(a, static_cast<long long>(cap_sfree) * f * f * f);
  if (a.tiles > scratch_tiles) return static_cast<int>(cudaErrorInvalidValue);
  compact_lists_hier_kernel<<<a.blocks, kCompactThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
