// K2 brick_merge: fold one frame's brick updates into the dense TSDF grid
// in place.
//
// Replaces the Pallas kernels `_merge_kernel_geo` / `_merge_kernel_color`
// launched by `merge_active_bricks` (tracking_sdf_tpu/fusion/pallas_merge.py).
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

#include <cuda_runtime.h>

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
