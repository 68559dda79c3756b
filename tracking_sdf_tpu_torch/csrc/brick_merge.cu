// K2 brick_merge: fold one frame's brick updates into the TSDF grid in place.
// Two forms: the dense (m, m, m) float32 grid of the flat bricked loop, and
// the brick-major rows of the presets' main path (below, `brick_merge_rows`).
//
// DENSE FORM. Replaces the Pallas kernels `_merge_kernel_geo` /
// `_merge_kernel_color` launched by `merge_active_bricks`
// (tracking_sdf_tpu/fusion/pallas_merge.py). Each listed brick's id, class
// and update slot are loaded by the threads that work on it (the TPU
// kernel's scalar prefetch); the list holds active bricks only, so the TPU's
// PAD slots do not exist here.
//   FREE  (class 1): w = 1, w*d = +delta.
//   FULL  (class 2): the compacted sums (w, w*d[, wc, wc*r, wc*g, wc*b]) of
//         slot `slot`; a FULL brick past the FULL cap points at the zero row.
// The running means divide by the uncapped weight sum and store the weight
// clamped at max_weight (pass +inf for no clamp), for W and Wc alike — as the
// XLA tail of fuse_frame_bricked does. (The Pallas kernel drops the clamp.)
// The arithmetic is written with __fmul_rn / __fadd_rn / __fdiv_rn, so that
// nvcc cannot contract a*b + c into an FMA and the result is the plain
// version's (PyTorch's eager ops round each step) bit for bit.
// FULL and FREE id sets are disjoint and each voxel has one thread, so
// there are no atomics and the result is deterministic.
//
// What bounds it on the card: bytes. A FULL brick with color reads 6 leaves
// + 6 update channels and writes 6 leaves (72 B a voxel); FREE reads and
// writes D and W (16 B a voxel). There is no reuse to stage in shared memory.
// What held the first version back (one block of 512 threads per brick, one
// voxel per thread, 24% of the bound at 24,576 bricks): every thread made
// scalar loads in a dependent chain (W, then D only where the update weight
// was positive, then the six channel-interleaved update floats, then R, G, B
// and Wc), so a thread had one 4-byte load in flight at a time; far too few
// bytes in flight per SM to cover the memory latency, and 24,576 short
// blocks each paid a block's start-up. This version gives each thread VEC = 4
// voxels along k (a brick's k-run of 8 float32 is 32 B and 16-B aligned, so
// two threads cover it with one float4 per leaf), issues all of its loads
// before any store (the leaves, and for a FULL brick the 4 x C update floats
// as float4s of one contiguous 16-B aligned run), and gives a block of up to
// 512 threads several consecutive list entries (four 8^3 bricks), its
// threads k-major across them: consecutive threads read one row of brick e,
// then the same row of brick e + 1, so where the listed bricks are
// neighbours along k (ids are sorted) a warp reads whole 128-B lines: a
// k-run is one 32-B sector, and the sector beside it in the same line
// belongs to the neighbouring brick, which the same warp reads at the same
// time instead of leaving it to a later visit through the L2. A voxel group
// is stored only where a value changed (an unchanged store writes the same
// bits), so a FULL brick past the cap moves only its reads. A brick whose k extent is not a
// multiple of 4, or a leaf that is not 16-B aligned, takes VEC = 1 (scalar
// leaves, the update as float2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kFree = 1;
constexpr int kFull = 2;
constexpr int kMergeThreads = 512;  // at most, a block

// n floats from p into v (16-B aligned when n % 4 == 0, else 8-B, n even)
template <int N, bool kReadOnly>
__device__ __forceinline__ void load_n(const float* p, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 x = kReadOnly ? __ldg(reinterpret_cast<const float4*>(p) + i)
                                 : reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = x.x; v[4 * i + 1] = x.y; v[4 * i + 2] = x.z; v[4 * i + 3] = x.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 x = kReadOnly ? __ldg(reinterpret_cast<const float2*>(p) + i)
                                 : reinterpret_cast<const float2*>(p)[i];
      v[2 * i] = x.x; v[2 * i + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = kReadOnly ? __ldg(p + i) : p[i];
  }
}

// v into p (N = 1 or 4) where any value's bits differ from old's
template <int N>
__device__ __forceinline__ void store_changed(float* p, const float (&old)[N],
                                              const float (&v)[N]) {
  bool changed = false;
#pragma unroll
  for (int i = 0; i < N; ++i) changed |= __float_as_uint(v[i]) != __float_as_uint(old[i]);
  if (!changed) return;
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = v[i];
  }
}

// (w_old * v_old + sum) / w_sum, each step rounded on its own
__device__ __forceinline__ float running_mean(float w_old, float v_old, float sum,
                                              float w_sum) {
  return __fdiv_rn(__fadd_rn(__fmul_rn(w_old, v_old), sum), w_sum);
}

// A block of nbb * groups threads takes list entries [nbb * blockIdx.x,
// + nbb); thread t takes row t / (nbb * kq) (the (di, dj) row of bk voxels)
// of entry t % (nbb * kq) / kq, at its k-group t % kq (VEC voxels), with
// groups = bv / VEC and kq = bk / VEC.
template <int VEC, int C>
__global__ void __launch_bounds__(kMergeThreads)
brick_merge_kernel(float* __restrict__ D, float* __restrict__ W, float* __restrict__ R,
                   float* __restrict__ G, float* __restrict__ B, float* __restrict__ Wc,
                   const float* __restrict__ upd, const int* __restrict__ bid,
                   const int* __restrict__ cls, const int* __restrict__ slot, int n,
                   int m, int bi, int bj, int bk, float delta, float max_weight) {
  const int bv = bi * bj * bk, kq = bk / VEC;
  const int span = blockDim.x / (bi * bj);  // nbb * kq threads a row
  const int rem = threadIdx.x % span;
  const int e = blockIdx.x * (span / kq) + rem / kq;
  if (e >= n) return;
  const int v = static_cast<int>(threadIdx.x / span) * bk + (rem % kq) * VEC;
  const int b = __ldg(bid + e), c = __ldg(cls + e), s = __ldg(slot + e);
  const int nbj = m / bj, nbk = m / bk;
  const int ib = b / (nbj * nbk), jb = (b / nbk) % nbj, kb = b % nbk;
  const int di = v / (bj * bk), dj = (v / bk) % bj, dk = v % bk;
  const size_t o = (static_cast<size_t>(ib * bi + di) * m + (jb * bj + dj)) * m
                   + (kb * bk + dk);
  const bool full = c == kFull, free_ = c == kFree;

  // every load first
  float w[VEC], d[VEC], u[VEC * C];
  load_n<VEC, false>(W + o, w);
  load_n<VEC, false>(D + o, d);
  if (full) {
    load_n<VEC * C, true>(upd + (static_cast<size_t>(s) * bv + v) * C, u);
  } else {
#pragma unroll
    for (int i = 0; i < VEC * C; ++i) u[i] = 0.f;
  }
  float wc[VEC], r[VEC], g[VEC], bl[VEC];
  if constexpr (C == 6) {
    load_n<VEC, false>(Wc + o, wc);
    if (full) {
      load_n<VEC, false>(R + o, r);
      load_n<VEC, false>(G + o, g);
      load_n<VEC, false>(B + o, bl);
    }
  }

  float wn[VEC], dn[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float w_add = full ? u[i * C] : (free_ ? 1.f : 0.f);
    const float wd_add = full ? u[i * C + 1] : (free_ ? delta : 0.f);
    const float w_sum = __fadd_rn(w[i], w_add);
    dn[i] = w_add > 0.f ? running_mean(w[i], d[i], wd_add, w_sum) : d[i];
    wn[i] = fminf(w_sum, max_weight);
  }
  store_changed<VEC>(D + o, d, dn);
  store_changed<VEC>(W + o, w, wn);
  if constexpr (C == 6) {
    float wcn[VEC], rn[VEC], gn[VEC], bn[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float wc_add = u[i * C + 2];  // 0 unless FULL
      const float wc_sum = __fadd_rn(wc[i], wc_add);
      wcn[i] = fminf(wc_sum, max_weight);
      if (full) {
        const bool has = wc_add > 0.f;
        rn[i] = has ? running_mean(wc[i], r[i], u[i * C + 3], wc_sum) : r[i];
        gn[i] = has ? running_mean(wc[i], g[i], u[i * C + 4], wc_sum) : g[i];
        bn[i] = has ? running_mean(wc[i], bl[i], u[i * C + 5], wc_sum) : bl[i];
      }
    }
    store_changed<VEC>(Wc + o, wc, wcn);
    if (full) {
      store_changed<VEC>(R + o, r, rn);
      store_changed<VEC>(G + o, g, gn);
      store_changed<VEC>(B + o, bl, bn);
    }
  }
}

template <int VEC, int C>
int launch_dense(float* D, float* W, float* R, float* G, float* B, float* Wc,
                 const float* upd, const int* bid, const int* cls, const int* slot, int n,
                 int m, int bi, int bj, int bk, float delta, float max_weight,
                 cudaStream_t stream) {
  const int groups = bi * bj * bk / VEC;
  if (groups > kMergeThreads) return static_cast<int>(cudaErrorInvalidValue);
  const int nbb = kMergeThreads / groups;  // list entries a block
  brick_merge_kernel<VEC, C><<<(n + nbb - 1) / nbb, nbb * groups, 0, stream>>>(
      D, W, R, G, B, Wc, upd, bid, cls, slot, n, m, bi, bj, bk, delta, max_weight);
  return static_cast<int>(cudaGetLastError());
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

// n list entries; the leaves are (m, m, m) float32, upd (cap + 1, bi, bj,
// bk, channels) float32 with channels 2 or 6. R, G, B and Wc may be null
// when channels == 2.
extern "C" int tsdf_brick_merge(float* D, float* W, float* R, float* G, float* B,
                                float* Wc, const float* upd, int channels,
                                const int* bid, const int* cls, const int* slot,
                                int n, int m, int bi, int bj, int bk,
                                float delta, float max_weight,
                                cudaStream_t stream) {
  if (n <= 0) return 0;
  if (channels != 2 && channels != 6) return static_cast<int>(cudaErrorInvalidValue);
  const auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool v4 = bk % 4 == 0 && a16(D) && a16(W) && a16(upd)
                  && (channels == 2 || (a16(R) && a16(G) && a16(B) && a16(Wc)));
  if (v4) {
    return channels == 6 ? launch_dense<4, 6>(D, W, R, G, B, Wc, upd, bid, cls, slot, n, m,
                                              bi, bj, bk, delta, max_weight, stream)
                         : launch_dense<4, 2>(D, W, R, G, B, Wc, upd, bid, cls, slot, n, m,
                                              bi, bj, bk, delta, max_weight, stream);
  }
  if (reinterpret_cast<uintptr_t>(upd) % 8) return static_cast<int>(cudaErrorMisalignedAddress);
  return channels == 6 ? launch_dense<1, 6>(D, W, R, G, B, Wc, upd, bid, cls, slot, n, m,
                                            bi, bj, bk, delta, max_weight, stream)
                       : launch_dense<1, 2>(D, W, R, G, B, Wc, upd, bid, cls, slot, n, m,
                                            bi, bj, bk, delta, max_weight, stream);
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
