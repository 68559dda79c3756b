// brick_fuse_rows: one frame's brick-major fusion, the FULL bricks' per-voxel
// update sums computed and merged into the BrickGrid rows in one launch.
//
// Replaces the Pallas merge `merge_active_bricks`
// (tracking_sdf_tpu/fusion/pallas_merge.py:94) in its row form, together
// with the update math that the JAX package leaves to XLA to fuse into the
// merge: `_full_brick_updates` (tracking_sdf_tpu/fusion/brick.py:676) and
// the merge of fuse_frame_brickmajor with free_fold
// (tracking_sdf_tpu/fusion/brickmajor.py:382-460). The port's plain version
// is fusion/brick_fuse.py `brick_fuse_rows_reference`.
//
// One thread block per listed slot of `ids` (the FULL slots, then the FREE
// ids; an id >= nb is padding and its block returns at once):
//   FULL  (slot < cap): every voxel of the brick projects its centre into the
//         image for its own in-front and inside masks and its camera-space
//         position. Voxels in groups of sj x sk (j, k) share one pixel row:
//         the row of the group's centre voxel (sj/2, sk/2), with the pixel
//         index clamped into the image. Distance (point-to-point: s - pz;
//         point-to-plane: -(s - p.n)), the d >= -delta cut, the weighting and
//         the sums (w, w*d[, w*cos, w*cos*r, w*cos*g, w*cos*b]) are then
//         folded into D, W[, R, G, B, Wc] as brick_merge_rows does.
//   FREE  (slot >= cap): w = 1, w*d = +delta, geometry only.
// The lists are disjoint and hold each brick once: no atomics, deterministic.
//
// The saturated-FREE skip (FusionConfig.sat_skip; the JAX package's `sat` in
// tracking_sdf_tpu/fusion/brickmajor.py:462-470, 542-550): with a non-null
// `sat` (one byte per brick, bool) a FULL block writes 0 for its brick, and a
// FREE block writes 1 when the stored D and W of every voxel after the merge
// equal their values before it (a block-wide AND, __syncthreads_and; NaN
// never equals), else 0. Each block owns its brick's byte. With a null `sat`
// the kernel writes exactly what it writes without the skip.
//
// What bounds it on the card: bytes. A FULL brick with color and bf16
// storage reads and writes 1 KB each of D and W and its 4 KB row of C, and
// reads its share groups' pixel rows (32 rows of 32 B with 4x4 sharing); a
// FREE brick moves D and W only. The update sums, which the unfused chain
// wrote to and read back from device memory (24 B per FULL voxel with color,
// and about 45 eager passes over (cap, 512) tensors to make them), live in
// registers here. (On the H100 the kernel reaches 46-48% of that bound with
// color and 22-23% on geometry: per-block latency holds it back.) The
// design keeps every byte moved useful:
//   - the group-centre projections are made once per group, and their pixel
//     rows are loaded once into shared memory with 16-byte loads (the wrapper
//     checks the table's alignment); every voxel reads its row from there;
//   - each thread handles two k-neighbouring voxels, with 2-element vector
//     loads and stores of the D, W and color lanes: every row access is a
//     contiguous run; the pair shares its (x, y) part of the camera
//     transform;
//   - a block loads its stored rows before the pixel-row phase, so that
//     their latency overlaps it (a block's work is a short chain of
//     dependent loads, so latency, not throughput, sets the pace);
//   - the pose is read from device memory (a view of the tracking state):
//     the launch needs no host copy of it.
//
// Arithmetic: bitwise equal to the plain version, which is eager PyTorch
// rounding after every operation. So the kernel uses __fmul_rn / __fadd_rn /
// __fsub_rn / __fdiv_rn (nvcc may not contract them into FMAs), in the order
// of the eager ops; float -> int truncation saturates (__float2int_rz; the
// plain version's int64 cast saturates too, and a value past the int32
// range is off the image either way); masks select, never multiply (an invalid
// pixel carries s = +-inf); expf as torch.exp. Host scalars (voxel size,
// intrinsics, delta, eps) arrive already rounded to float32 as PyTorch rounds
// a Python scalar. PyTorch on the card divides a tensor by a Python scalar
// as a product with the scalar's reciprocal, taken in double and rounded to
// float32 (the CPU divides), so the linear weighting here multiplies by that
// reciprocal of delta' - eps: the kernel equals the plain version run on the
// card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 512;  // one voxel pair per thread, bv <= 1024
constexpr int kExponential = 0;
constexpr int kConstant = 2;

struct FuseArgs {
  int nb, bv, bi, bj, bk, nbj, nbk;  // grid of bricks (nb: the rows listed)
  int i_offset;                      // global voxel i of the rows' first layer
  int cap;                           // FULL slots come first in ids
  int c_width;                       // int16 lanes per C row
  int channels;                      // pixel table: 4 (geometry) or 8 (color)
  int img_h, img_w;
  int sj, sk;                        // share group (j, k) extents
  int point_to_plane, weighting;
  float sx, sy, sz, ox, oy, oz;      // voxel size and grid origin
  float fx, fy, cx, cy;
  float delta, eps;
  float w_delta, w_inv;              // linear weighting: delta', f32(1 / (delta' - eps))
  float max_weight;                  // +inf for no clamp
};

template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// (w_old * v_old + sum) / w_sum, each step rounded on its own
__device__ __forceinline__ float running_mean(float w_old, float v_old, float sum,
                                              float w_sum) {
  return __fdiv_rn(__fadd_rn(__fmul_rn(w_old, v_old), sum), w_sum);
}

// World centre of voxel index i along one axis: (size / m) * (i + 0.5) + origin.
__device__ __forceinline__ float centre(float size, float origin, int i) {
  return __fadd_rn(__fmul_rn(size, __fadd_rn(static_cast<float>(i), 0.5f)), origin);
}

// The (x, y) part of Rᵀ(p - t), row c: R[c] * dx + R[3 + c] * dy. R is
// row-major camera-to-world, so Rᵀ's row c is R's column c; world_to_camera
// _components sums ((a * dx + b * dy) + c * dz), so this part is exact to
// share between voxels of one (i, j).
__device__ __forceinline__ void xy_part(const float* R, float dx, float dy, float xy[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) xy[c] = __fadd_rn(__fmul_rn(R[c], dx), __fmul_rn(R[3 + c], dy));
}

struct Proj {
  float px, py, pz;
  bool in_front, ins;
  int flat;  // pixel index clamped into the image
};

// Camera-space position and pixel of a voxel centre, from its (x, y) part
// and dz, as the projection of _full_brick_updates. Truncation to int32
// saturates (NaN -> 0) as the int64 cast on the card does, and every value
// past the int32 range lies outside the image either way: the masks and the
// clamped index equal the int64 path's.
__device__ __forceinline__ Proj project(const FuseArgs& a, const float* R, const float xy[3],
                                        float dz) {
  Proj p;
  p.px = __fadd_rn(xy[0], __fmul_rn(R[6], dz));
  p.py = __fadd_rn(xy[1], __fmul_rn(R[7], dz));
  p.pz = __fadd_rn(xy[2], __fmul_rn(R[8], dz));
  p.in_front = p.pz > 0.f;
  const float safe = p.in_front ? p.pz : 1.f;
  const float u = __fdiv_rn(__fadd_rn(__fmul_rn(a.fx, p.px), __fmul_rn(a.cx, p.pz)), safe);
  const float v = __fdiv_rn(__fadd_rn(__fmul_rn(a.fy, p.py), __fmul_rn(a.cy, p.pz)), safe);
  const int iu = __float2int_rz(u), iv = __float2int_rz(v);
  p.ins = iu >= 0 && iu < a.img_w && iv >= 0 && iv < a.img_h;
  p.flat = min(max(iv, 0), a.img_h - 1) * a.img_w + min(max(iu, 0), a.img_w - 1);
  return p;
}

// fusion.fuse.weighting of the clamped distance d
__device__ __forceinline__ float weight_of(const FuseArgs& a, float d) {
  if (a.weighting == kConstant) return 1.f;
  if (!(d <= -a.eps)) return 1.f;
  if (a.weighting == kExponential) {
    const float e = __fadd_rn(d, a.eps);
    return expf(__fmul_rn(-0.5f, __fmul_rn(e, e)));
  }
  const float r = __fmul_rn(__fadd_rn(d, a.w_delta), a.w_inv);
  return fminf(fmaxf(r, 0.f), 1.f);
}

// One block per listed slot, one thread per k-neighbouring voxel pair: the
// block is (bk / 2, bj, bi) threads, so a thread's voxels (i, j, k), (i, j,
// k + 1) need no index division, and its linear index is the pair's index in
// the row. The stored rows are loaded first, so that their latency overlaps
// the share groups' pixel-row phase.
// At most 42 registers (512 x 3 threads an SM), so that six blocks of an
// 8^3 brick fit on an SM. On the H100 that took 5-8% less device time at
// 512^3 than 64 registers, the same at 256^3, and half the time of a 32
// register budget (scripts/brick_fuse_launch_bounds.sh).
template <typename TV, typename TW>
__global__ void __launch_bounds__(kMaxThreads, 3)
brick_fuse_rows_kernel(TV* __restrict__ D, TW* __restrict__ W, uint16_t* __restrict__ C,
                       const int* __restrict__ ids, const float* __restrict__ pix,
                       const float* __restrict__ pose_R, const float* __restrict__ pose_t,
                       uint8_t* __restrict__ sat, FuseArgs a) {
  using PV = typename Pair<TV>::type;
  using PW = typename Pair<TW>::type;
  extern __shared__ float4 group_rows[];  // (groups, channels / 4)
  const int s = blockIdx.x;
  const bool full = s < a.cap;
  float R[9], t[3];
  if (full) {
#pragma unroll
    for (int i = 0; i < 9; ++i) R[i] = pose_R[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) t[i] = pose_t[i];
  }
  const int b = ids[s];
  if (b < 0 || b >= a.nb) return;
  const int di = threadIdx.z, dj = threadIdx.y, dk0 = 2 * threadIdx.x;
  const int q = (di * a.bj + dj) * blockDim.x + threadIdx.x;
  const size_t row = static_cast<size_t>(b) * a.bv;
  PV* Dp = reinterpret_cast<PV*>(D + row);
  PW* Wp = reinterpret_cast<PW*>(W + row);
  const PV draw = Dp[q];
  const PW wraw = Wp[q];
  const bool color = full && a.channels == 8;
  const int lv = a.bv * static_cast<int>(sizeof(TV) / 2);
  uint16_t* crow = C + static_cast<size_t>(b) * a.c_width;
  PV* Rp = reinterpret_cast<PV*>(crow);
  PV* Gp = reinterpret_cast<PV*>(crow + lv);
  PV* Bp = reinterpret_cast<PV*>(crow + 2 * lv);
  PW* Wcp = reinterpret_cast<PW*>(crow + 3 * lv);
  PV cold[3];
  PW wcraw;
  if (color) {
    cold[0] = Rp[q];
    cold[1] = Gp[q];
    cold[2] = Bp[q];
    wcraw = Wcp[q];
  }

  float w_add[2] = {1.f, 1.f}, wd_add[2] = {a.delta, a.delta};
  float csum[2][4];
  if (full) {
    const unsigned ub = b, nbk = a.nbk, nbj = a.nbj, sj = a.sj, sk = a.sk;
    const int I0 = static_cast<int>(ub / (nbj * nbk)) * a.bi + a.i_offset;
    const int J0 = static_cast<int>((ub / nbk) % nbj) * a.bj;
    const int K0 = static_cast<int>(ub % nbk) * a.bk;
    const int gj = a.bj / a.sj, gk = a.bk / a.sk;
    const int c4 = a.channels / 4;
    // the share groups' pixel rows, once per group: group (di, y, x) by
    // thread (x, y, di), x looping where gk > bk / 2
    if (dj < gj) {
      const float ycoord = __fsub_rn(centre(a.sy, a.oy, J0 + dj * a.sj + a.sj / 2), t[1]);
      float xy[3];
      xy_part(R, __fsub_rn(centre(a.sx, a.ox, I0 + di), t[0]), ycoord, xy);
      for (int gx = threadIdx.x; gx < gk; gx += blockDim.x) {
        const Proj p = project(a, R, xy,
                               __fsub_rn(centre(a.sz, a.oz, K0 + gx * a.sk + a.sk / 2), t[2]));
        const float4* src = reinterpret_cast<const float4*>(pix) +
                            static_cast<size_t>(p.flat) * c4;
        float4* dst = group_rows + ((di * gj + dj) * gk + gx) * c4;
        for (int c = 0; c < c4; ++c) dst[c] = __ldg(src + c);
      }
    }
    __syncthreads();

    float xy[3];
    xy_part(R, __fsub_rn(centre(a.sx, a.ox, I0 + di), t[0]),
            __fsub_rn(centre(a.sy, a.oy, J0 + dj), t[1]), xy);
    const int grow = (di * gj + static_cast<int>(static_cast<unsigned>(dj) / sj)) * gk;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int dk = dk0 + e;
      const Proj p = project(a, R, xy, __fsub_rn(centre(a.sz, a.oz, K0 + dk), t[2]));
      const float* g = reinterpret_cast<const float*>(
          group_rows + (grow + static_cast<int>(static_cast<unsigned>(dk) / sk)) * c4);
      float d = a.point_to_plane
                    ? -__fsub_rn(g[3], __fadd_rn(__fadd_rn(__fmul_rn(p.px, g[0]),
                                                           __fmul_rn(p.py, g[1])),
                                                 __fmul_rn(p.pz, g[2])))
                    : __fsub_rn(g[3], p.pz);
      const bool mask = p.in_front && p.ins && d >= -a.delta;
      d = mask ? fminf(d, a.delta) : 0.f;
      const float w = mask ? weight_of(a, d) : 0.f;
      w_add[e] = w;
      wd_add[e] = __fmul_rn(w, d);
      if (color) {
#pragma unroll
        for (int c = 0; c < 4; ++c) csum[e][c] = __fmul_rn(w, g[4 + c]);
      }
    }
  }

  // geometry: D sanitised to 0 where W <= 0 (D holds NaN there); divide by
  // the uncapped sum; store the clamped weight; keep D's bits where w_add == 0
  const TV dr[2] = {draw.x, draw.y};
  const TW wr[2] = {wraw.x, wraw.y};
  PV dout = draw;
  PW wout = wraw;
  TV* dn = reinterpret_cast<TV*>(&dout);
  TW* wn = reinterpret_cast<TW*>(&wout);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const float w_old = to_f32(wr[e]);
    const float d_san = w_old > 0.f ? to_f32(dr[e]) : 0.f;
    const float w_sum = __fadd_rn(w_old, w_add[e]);
    wn[e] = from_f32<TW>(fminf(w_sum, a.max_weight));
    if (w_add[e] > 0.f) dn[e] = from_f32<TV>(running_mean(w_old, d_san, wd_add[e], w_sum));
  }
  Dp[q] = dout;
  Wp[q] = wout;
  if (sat != nullptr) {
    // block-uniform branches: every thread of the block reaches the AND
    const bool first = threadIdx.x == 0 && threadIdx.y == 0 && threadIdx.z == 0;
    if (full) {
      if (first) sat[b] = 0;
    } else {
      bool same = true;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        same = same && to_f32(dn[e]) == to_f32(dr[e]) && to_f32(wn[e]) == to_f32(wr[e]);
      const int all = __syncthreads_and(same);
      if (first) sat[b] = all ? 1 : 0;
    }
  }
  if (color) {
    // no sanitising here, as in the merge; colors keep their bits where
    // w*cos == 0
    PV cnew[3] = {cold[0], cold[1], cold[2]};
    PW wcnew = wcraw;
    const TW* wco = reinterpret_cast<const TW*>(&wcraw);
    TW* wcn = reinterpret_cast<TW*>(&wcnew);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float wc_old = to_f32(wco[e]);
      const float wc_sum = __fadd_rn(wc_old, csum[e][0]);
      if (csum[e][0] > 0.f) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          TV* cv = reinterpret_cast<TV*>(&cnew[c]);
          cv[e] = from_f32<TV>(running_mean(wc_old, to_f32(cv[e]), csum[e][1 + c], wc_sum));
        }
      }
      wcn[e] = from_f32<TW>(fminf(wc_sum, a.max_weight));
    }
    Rp[q] = cnew[0];
    Gp[q] = cnew[1];
    Bp[q] = cnew[2];
    Wcp[q] = wcnew;
  }
}

template <typename TV, typename TW>
int launch(void* D, void* W, void* C, const int* ids, int n_ids, const float* pix,
           const float* R, const float* t, uint8_t* sat, const FuseArgs& a,
           cudaStream_t stream) {
  const int groups = a.bi * (a.bj / a.sj) * (a.bk / a.sk);
  const size_t smem = static_cast<size_t>(groups) * a.channels * sizeof(float);
  const dim3 block(a.bk / 2, a.bj, a.bi);
  brick_fuse_rows_kernel<TV, TW><<<n_ids, block, smem, stream>>>(
      static_cast<TV*>(D), static_cast<TW*>(W), static_cast<uint16_t*>(C), ids, pix, R,
      t, sat, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// value_bf16 / weight_bf16 != 0: D (and R, G, B) / W (and Wc) are bfloat16,
// else float32. The wrapper (fusion/brick_fuse.py) has checked shapes,
// dtypes, the even k extent, the share groups and the table's alignment.
// `sat` may be null (no saturated-FREE skip). Slab form: the nb rows are an
// i-slab of the m^3 grid whose first brick layer starts at global voxel i =
// i_offset (0 and nb = (m/bi)(m/bj)(m/bk) for the whole grid); ids are local
// to the slab and only the voxel centres move.
extern "C" int tsdf_brick_fuse_rows(
    void* D, void* W, void* C, int c_width, int value_bf16, int weight_bf16,
    const int* ids, int n_ids, int cap, int nb, int bi, int bj, int bk, int m,
    int i_offset,
    const float* pix, int channels, int img_h, int img_w, const float* R,
    const float* t, void* sat_bytes, int sj, int sk, int point_to_plane, int weighting, float sx,
    float sy, float sz, float ox, float oy, float oz, float fx, float fy, float cx,
    float cy, float delta, float eps, float w_delta, float w_inv, float max_weight,
    cudaStream_t stream) {
  FuseArgs a;
  a.nb = nb;
  a.bv = bi * bj * bk;
  a.bi = bi;
  a.bj = bj;
  a.bk = bk;
  a.nbj = m / bj;
  a.nbk = m / bk;
  a.i_offset = i_offset;
  a.cap = cap;
  a.c_width = c_width;
  a.channels = channels;
  a.img_h = img_h;
  a.img_w = img_w;
  a.sj = sj;
  a.sk = sk;
  a.point_to_plane = point_to_plane;
  a.weighting = weighting;
  a.sx = sx;
  a.sy = sy;
  a.sz = sz;
  a.ox = ox;
  a.oy = oy;
  a.oz = oz;
  a.fx = fx;
  a.fy = fy;
  a.cx = cx;
  a.cy = cy;
  a.delta = delta;
  a.eps = eps;
  a.w_delta = w_delta;
  a.w_inv = w_inv;
  a.max_weight = max_weight;
  using bf16 = __nv_bfloat16;
  uint8_t* sat = static_cast<uint8_t*>(sat_bytes);
  if (value_bf16 && weight_bf16)
    return launch<bf16, bf16>(D, W, C, ids, n_ids, pix, R, t, sat, a, stream);
  if (value_bf16) return launch<bf16, float>(D, W, C, ids, n_ids, pix, R, t, sat, a, stream);
  if (weight_bf16) return launch<float, bf16>(D, W, C, ids, n_ids, pix, R, t, sat, a, stream);
  return launch<float, float>(D, W, C, ids, n_ids, pix, R, t, sat, a, stream);
}
