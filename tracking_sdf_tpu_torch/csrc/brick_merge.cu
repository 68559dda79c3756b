// K2 brick_merge: fold one frame's brick updates into the TSDF grid in place.
// Two forms: the dense (m, m, m) float32 grid of the flat bricked loop, and
// the brick-major rows of the presets' main path (below, `brick_merge_rows`).
//
// DENSE FORM. Replaces the Pallas kernels `_merge_kernel_geo` /
// `_merge_kernel_color` launched by `merge_active_bricks`
// (tracking_sdf_tpu/fusion/pallas_merge.py).
// One thread block per active brick, one thread per voxel. A block loads its
// own brick id, class and update slot (the TPU kernel's scalar prefetch); the
// list holds active bricks only, so the TPU's PAD slots do not exist here.
//   FREE  (class 1): w = 1, w*d = +delta.
//   FULL  (class 2): the compacted sums (w, w*d[, wc, wc*r, wc*g, wc*b]) of
//         slot `slot`; a FULL brick past the FULL cap points at the zero row.
// The running means divide by the uncapped weight sum and store the weight
// clamped at max_weight (pass +inf for no clamp), for W and Wc alike — as the
// XLA tail of fuse_frame_bricked does. (The Pallas kernel drops the clamp.)
// FULL and FREE id sets are disjoint and each brick has one block, so there
// are no atomics and the result is deterministic.
//
// What bounds it on the card: bytes. A FULL brick with color reads 6 leaves
// + 6 update channels and writes 6 leaves (~37 KB per 8^3 brick); FREE reads
// and writes D and W only. Each warp touches 4 contiguous 32-byte k-runs per
// leaf, so every sector fetched is used; there is no reuse to stage in shared
// memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kFree = 1;
constexpr int kFull = 2;

__global__ void brick_merge_kernel(float* __restrict__ D, float* __restrict__ W,
                                   float* __restrict__ R, float* __restrict__ G,
                                   float* __restrict__ B, float* __restrict__ Wc,
                                   const float* __restrict__ upd, int channels,
                                   const int* __restrict__ bid,
                                   const int* __restrict__ cls,
                                   const int* __restrict__ slot, int m, int bi,
                                   int bj, int bk, float delta,
                                   float max_weight) {
  const int b = bid[blockIdx.x];
  const int c = cls[blockIdx.x];
  const int s = slot[blockIdx.x];
  const int nbj = m / bj, nbk = m / bk;
  const int ib = b / (nbj * nbk), jb = (b / nbk) % nbj, kb = b % nbk;
  const int bv = bi * bj * bk;
  const bool full = c == kFull, free_ = c == kFree;
  for (int vx = threadIdx.x; vx < bv; vx += blockDim.x) {
    const int di = vx / (bj * bk), dj = (vx / bk) % bj, dk = vx % bk;
    const size_t o = (static_cast<size_t>(ib * bi + di) * m + (jb * bj + dj)) * m
                     + (kb * bk + dk);
    const float* u = upd + (static_cast<size_t>(s) * bv + vx) * channels;
    const float w_add = full ? u[0] : (free_ ? 1.f : 0.f);
    const float wd_add = full ? u[1] : (free_ ? delta : 0.f);
    const float w_old = W[o];
    const float w_sum = w_old + w_add;
    if (w_add > 0.f) D[o] = (w_old * D[o] + wd_add) / w_sum;
    W[o] = fminf(w_sum, max_weight);
    if (channels == 6) {
      const float wc_add = full ? u[2] : 0.f;
      const float wc_old = Wc[o];
      const float wc_sum = wc_old + wc_add;
      if (wc_add > 0.f) {
        R[o] = (wc_old * R[o] + u[3]) / wc_sum;
        G[o] = (wc_old * G[o] + u[4]) / wc_sum;
        B[o] = (wc_old * B[o] + u[5]) / wc_sum;
      }
      Wc[o] = fminf(wc_sum, max_weight);
    }
  }
}


// ROW FORM. The same job on the brick-major BrickGrid (D, W and the packed
// [R | G | B | Wc] color leaf C, one row per brick), which is what the merge
// of fuse_frame_brickmajor (tracking_sdf_tpu/fusion/brickmajor.py:444-531)
// computes in XLA with free_fold: one pass over the FULL slots, then the FREE
// ids. One thread block per listed brick, one thread per voxel; a list entry
// >= nb is padding and its block returns at once.
//   FULL  (slot s < cap): the compacted sums of update row s, planar
//         (channels, cap, bv): w, w*d[, wc, wc*r, wc*g, wc*b].
//   FREE  (slot s >= cap): w = 1, w*d = +delta, geometry only.
// Geometry follows the XLA merge step for step: stored D and W upcast to
// float32; D sanitised to 0 where W <= 0 (D holds NaN there) before the W*D
// product; the running mean divides by the uncapped sum; W is stored clamped
// at max_weight; where w_add == 0 the stored D is kept (NaN stays NaN). Color
// (FULL slots, channels == 6) updates R, G, B and Wc through their lane blocks
// of C; there is no sanitising there, as in XLA. The arithmetic is written
// with __fmul_rn / __fadd_rn / __fdiv_rn so that nvcc cannot contract a*b + c
// into an FMA: PyTorch's eager ops round each step, and the plain version
// must agree bit for bit. Values are rounded to the storage type only at the
// store (round to nearest even, as PyTorch's and XLA's casts do).
// The FULL and FREE lists are disjoint and hold each brick at most once: no
// atomics, deterministic.
//
// What bounds it on the card: bytes. A FULL brick with color and bf16
// storage reads and writes 2 x 1 KB of D and W plus a 4 KB row of C, and
// reads 12 KB of update sums; a FREE brick moves D and W only. Every access
// is a contiguous row run, so each sector fetched is used.

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

template <typename TV, typename TW>
__global__ void brick_merge_rows_kernel(TV* __restrict__ D, TW* __restrict__ W,
                                        uint16_t* __restrict__ C, int c_width,
                                        const float* __restrict__ upd, int channels,
                                        const int* __restrict__ ids, int cap, int nb,
                                        int bv, float delta, float max_weight) {
  const int s = blockIdx.x;
  const int b = ids[s];
  if (b < 0 || b >= nb) return;
  const bool full = s < cap;
  const size_t plane = static_cast<size_t>(cap) * bv;
  for (int v = threadIdx.x; v < bv; v += blockDim.x) {
    const size_t o = static_cast<size_t>(b) * bv + v;
    const size_t u = static_cast<size_t>(s) * bv + v;  // full slots only
    const float w_add = full ? upd[u] : 1.f;
    const float wd_add = full ? upd[plane + u] : delta;
    const float d_old = to_f32(D[o]);
    const float w_old = to_f32(W[o]);
    const float d_san = w_old > 0.f ? d_old : 0.f;
    const float w_sum = __fadd_rn(w_old, w_add);
    W[o] = from_f32<TW>(fminf(w_sum, max_weight));
    if (w_add > 0.f) D[o] = from_f32<TV>(running_mean(w_old, d_san, wd_add, w_sum));
    if (full && channels == 6) {
      // lane blocks of the packed row: [R | G | B] of bv values each, then Wc
      uint16_t* row = C + static_cast<size_t>(b) * c_width;
      const int lv = bv * static_cast<int>(sizeof(TV) / 2);
      TV* R = reinterpret_cast<TV*>(row);
      TV* G = reinterpret_cast<TV*>(row + lv);
      TV* B = reinterpret_cast<TV*>(row + 2 * lv);
      TW* Wc = reinterpret_cast<TW*>(row + 3 * lv);
      const float wc_add = upd[2 * plane + u];
      const float wc_old = to_f32(Wc[v]);
      const float wc_sum = __fadd_rn(wc_old, wc_add);
      if (wc_add > 0.f) {
        R[v] = from_f32<TV>(running_mean(wc_old, to_f32(R[v]), upd[3 * plane + u], wc_sum));
        G[v] = from_f32<TV>(running_mean(wc_old, to_f32(G[v]), upd[4 * plane + u], wc_sum));
        B[v] = from_f32<TV>(running_mean(wc_old, to_f32(B[v]), upd[5 * plane + u], wc_sum));
      }
      Wc[v] = from_f32<TW>(fminf(wc_sum, max_weight));
    }
  }
}

template <typename TV, typename TW>
int launch_rows(void* D, void* W, void* C, int c_width, const float* upd,
                int channels, const int* ids, int n_ids, int cap, int nb, int bv,
                float delta, float max_weight, cudaStream_t stream) {
  const int threads = bv < 1024 ? ((bv + 31) / 32) * 32 : 1024;
  brick_merge_rows_kernel<TV, TW><<<n_ids, threads, 0, stream>>>(
      static_cast<TV*>(D), static_cast<TW*>(W), static_cast<uint16_t*>(C), c_width,
      upd, channels, ids, cap, nb, bv, delta, max_weight);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tsdf_brick_merge(float* D, float* W, float* R, float* G, float* B,
                                float* Wc, const float* upd, int channels,
                                const int* bid, const int* cls, const int* slot,
                                int n, int m, int bi, int bj, int bk,
                                float delta, float max_weight,
                                cudaStream_t stream) {
  const int bv = bi * bj * bk;
  const int threads = bv < 1024 ? ((bv + 31) / 32) * 32 : 1024;
  brick_merge_kernel<<<n, threads, 0, stream>>>(D, W, R, G, B, Wc, upd, channels,
                                                bid, cls, slot, m, bi, bj, bk,
                                                delta, max_weight);
  return static_cast<int>(cudaGetLastError());
}

// value_bf16 / weight_bf16 != 0: D (and R, G, B) / W (and Wc) are bfloat16,
// else float32. C may be null when channels == 2.
extern "C" int tsdf_brick_merge_rows(void* D, void* W, void* C, int c_width,
                                     int value_bf16, int weight_bf16,
                                     const float* upd, int channels, const int* ids,
                                     int n_ids, int cap, int nb, int bv, float delta,
                                     float max_weight, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  if (value_bf16 && weight_bf16)
    return launch_rows<bf16, bf16>(D, W, C, c_width, upd, channels, ids, n_ids, cap,
                                   nb, bv, delta, max_weight, stream);
  if (value_bf16)
    return launch_rows<bf16, float>(D, W, C, c_width, upd, channels, ids, n_ids, cap,
                                    nb, bv, delta, max_weight, stream);
  if (weight_bf16)
    return launch_rows<float, bf16>(D, W, C, c_width, upd, channels, ids, n_ids, cap,
                                    nb, bv, delta, max_weight, stream);
  return launch_rows<float, float>(D, W, C, c_width, upd, channels, ids, n_ids, cap,
                                   nb, bv, delta, max_weight, stream);
}
