// K3 and K4: depth preprocessing, the stage of every frame before tracking.
//   tsdf_bilateral_pass  K3, separable form: one 1-D bilateral pass along
//                        axis 0 (rows) or 1 (columns);
//   tsdf_bilateral_2d    K3, 2-D form: the full (2r+1)^2 window;
//   tsdf_normals         K4: backprojection and organized normals in ONE
//                        launch, writing the points and the normals (or, with
//                        no depth, the normals of a given point image).
//
// No Pallas original: the JAX package leaves these stencils to XLA's fusions
// (tracking_sdf_tpu/tracking/preprocess.py: bilateral_filter,
// bilateral_filter_separable, estimate_normals; tracking_sdf_tpu/core/
// camera.py: backproject). The plain PyTorch versions beside the wrappers
// (tracking_sdf_tpu_torch/tracking/preprocess.py, *_reference) build every
// tap as a shifted copy of the image, some 700 small launches a frame.
//
// Invalid is NaN. K3, per output pixel and per tap inside the image whose
// value dn is finite: w = sw * exp(-(dn - d0)^2 / (2 sr^2)), num += w * dn,
// den += w, out = num / max(den, 1e-12); NaN where the centre d0 is not
// finite or den = 0. Taps outside the image or not finite add nothing (the
// plain version adds +0 there, which leaves the sums' bits as they are). The
// separable form runs pass 2 on pass 1's output; the plain version's last
// mask (NaN where the original centre was not finite) is already pass 1's
// own, so pass 2 needs no second input.
// K4, per pixel: the point p = ((u - cx) / fx * z, (v - cy) / fy * z, z), NaN
// where the depth is not finite or <= 0; central-difference tangents
// t = (p[+1] - p[-1]) / 2 along u and v, kept where both neighbours are
// finite and |dz| < factor * max(|z|, 1) * 2 (NaN outside the image); each
// tangent and its mask summed over the (2R+1) box, rows first, then columns,
// zero outside the image, and divided by the count; n = t_u x t_v over its
// norm where the norm > 1e-12, flipped where n . p > 0, NaN where the pixel
// is not ok.
//
// Arithmetic: the plain version is eager PyTorch, which rounds after every
// operation, so sums and products here are __fadd_rn / __fmul_rn / __fsub_rn
// / __fdiv_rn (nvcc may not contract them into FMAs), in the plain
// version's order: taps summed from zero in the plain loop's order (for the
// 2-D form its row-major (dy, dx) order), expf as torch.exp (no fast math).
// Host scalars arrive rounded to float32 as PyTorch rounds a Python scalar.
// PyTorch on the card divides a tensor by a Python scalar as a product with
// the scalar's reciprocal, so backprojection multiplies by 1/fx and 1/fy as
// the wrapper passes them. torch.linalg.cross, torch.linalg.norm and the
// three-term sum of the orientation test are PyTorch's own kernels; the
// functions below follow the rounding measured on the H100 against them.
//
// What bounds them on the card. K3's 1-D pass: bytes (the 1.2 MB image read,
// the output written, each pixel's 11 taps from L1/L2), ~90 float ops a
// pixel. The 2-D form: operations, 121 taps of ~8 float ops and one expf a
// pixel; it stages a (32 + 2r) x (8 + 2r) tile and the tap weights in shared
// memory so each depth is read from device memory once a block. K4: bytes
// (1.2 MB of depth in, 3.7 MB of points and 3.7 MB of normals out); each
// 16x16 block stages the depth tile plus a halo of R + 1 as points, the
// tangents of the tile plus R, and the row sums, all in shared memory as
// planes (consecutive threads on consecutive words).

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kBX = 32;  // K3: a block is 32 x 8 output pixels, one a thread
constexpr int kBY = 8;
constexpr int kMaxRadius2d = 16;
constexpr int kTile = 16;  // K4: a block is one 16 x 16 tile
constexpr int kMaxBoxRadius = 5;

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }

// sw * exp(-(dn - d0)^2 * inv2sr), as the plain version's ops round it
__device__ __forceinline__ float range_weight(float sw, float dn, float d0, float inv2sr) {
  const float diff = __fsub_rn(dn, d0);
  return __fmul_rn(sw, expf(__fmul_rn(-__fmul_rn(diff, diff), inv2sr)));
}

__device__ __forceinline__ float filtered(float num, float den) {
  return den > 0.f ? __fdiv_rn(num, fmaxf(den, 1e-12f)) : nan_f();
}

__global__ void __launch_bounds__(kBX * kBY)
bilateral_pass_kernel(const float* __restrict__ in, float* __restrict__ out, int h, int w,
                      int axis, int r, const float* __restrict__ sw, float inv2sr) {
  const int x = blockIdx.x * kBX + threadIdx.x;
  const int y = blockIdx.y * kBY + threadIdx.y;
  if (x >= w || y >= h) return;
  const float d0 = in[y * w + x];
  float res = nan_f();
  if (isfinite(d0)) {
    float num = 0.f, den = 0.f;
    for (int d = -r; d <= r; ++d) {
      const int yy = axis == 0 ? y + d : y;
      const int xx = axis == 0 ? x : x + d;
      if (yy < 0 || yy >= h || xx < 0 || xx >= w) continue;
      const float dn = __ldg(in + yy * w + xx);
      if (!isfinite(dn)) continue;
      const float wt = range_weight(__ldg(sw + d + r), dn, d0, inv2sr);
      num = __fadd_rn(num, __fmul_rn(wt, dn));
      den = __fadd_rn(den, wt);
    }
    res = filtered(num, den);
  }
  out[y * w + x] = res;
}

__global__ void __launch_bounds__(kBX * kBY)
bilateral_2d_kernel(const float* __restrict__ in, float* __restrict__ out, int h, int w,
                    int r, const float* __restrict__ sw, float inv2sr) {
  extern __shared__ float smem[];
  const int k = 2 * r + 1;
  const int tw = kBX + 2 * r, th = kBY + 2 * r;
  float* tile = smem;
  float* wts = smem + tw * th;
  const int x0 = blockIdx.x * kBX - r, y0 = blockIdx.y * kBY - r;
  const int tid = threadIdx.y * kBX + threadIdx.x;
  for (int i = tid; i < tw * th; i += kBX * kBY) {
    const int gy = y0 + i / tw, gx = x0 + i % tw;
    tile[i] = (gy >= 0 && gy < h && gx >= 0 && gx < w) ? in[gy * w + gx] : nan_f();
  }
  for (int i = tid; i < k * k; i += kBX * kBY) wts[i] = sw[i];
  __syncthreads();
  const int x = blockIdx.x * kBX + threadIdx.x;
  const int y = blockIdx.y * kBY + threadIdx.y;
  if (x >= w || y >= h) return;
  const float d0 = tile[(threadIdx.y + r) * tw + threadIdx.x + r];
  float res = nan_f();
  if (isfinite(d0)) {
    float num = 0.f, den = 0.f;
    for (int dy = 0; dy < k; ++dy) {
      const float* row = tile + (threadIdx.y + dy) * tw + threadIdx.x;
      for (int dx = 0; dx < k; ++dx) {
        const float dn = row[dx];
        if (!isfinite(dn)) continue;
        const float wt = range_weight(wts[dy * k + dx], dn, d0, inv2sr);
        num = __fadd_rn(num, __fmul_rn(wt, dn));
        den = __fadd_rn(den, wt);
      }
    }
    res = filtered(num, den);
  }
  out[y * w + x] = res;
}

struct NormalsArgs {
  int h, w, radius;
  float inv_fx, inv_fy, cx, cy, factor;
};

// a * b - c * d as torch.linalg.cross rounds it on the card
__device__ __forceinline__ float cross_term(float a, float b, float c, float d) {
  return __fmaf_rn(a, b, -__fmul_rn(c, d));
}

// sqrt(x0^2 + x1^2 + x2^2) as torch.linalg.norm over 3 floats rounds it
__device__ __forceinline__ float norm3(float x0, float x1, float x2) {
  return __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(x0, x0), __fmul_rn(x2, x2)),
                              __fmul_rn(x1, x1)));
}

// x0 + x1 + x2 as torch.sum over 3 floats rounds it
__device__ __forceinline__ float sum3(float x0, float x1, float x2) {
  return __fadd_rn(__fadd_rn(x0, x2), x1);
}

// One tangent of the tangent region: the points at ip (+1) and im (-1) of
// the point planes, the centre's depth-jump threshold thr; writes the masked
// tangent and its mask (1 or 0) to four planes at it.
__device__ __forceinline__ void tangent(const float* pts, int pplane, int ip, int im,
                                        float thr, float* tan, int tplane, int it) {
  float pp[3], pm[3];
  bool fin = true;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    pp[c] = pts[c * pplane + ip];
    pm[c] = pts[c * pplane + im];
    fin = fin && isfinite(pp[c]) && isfinite(pm[c]);
  }
  const bool ok = fin && fabsf(__fsub_rn(pp[2], pm[2])) < thr;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    tan[c * tplane + it] = ok ? __fmul_rn(0.5f, __fsub_rn(pp[c], pm[c])) : 0.f;
  tan[3 * tplane + it] = ok ? 1.f : 0.f;
}

// Shared memory, as planes: the points of the tile plus R + 1 (3 planes of
// P x P), the tangents t_u, count_u, t_v, count_v of the tile plus R (8 of
// Q x Q), their sums over the box's rows for the tile's rows (8 of kTile x Q).
__host__ __device__ constexpr int normals_smem_floats(int radius) {
  return 3 * (kTile + 2 * radius + 2) * (kTile + 2 * radius + 2)
         + 8 * (kTile + 2 * radius) * (kTile + 2 * radius)
         + 8 * kTile * (kTile + 2 * radius);
}

template <bool kFromDepth>
__global__ void __launch_bounds__(kTile * kTile)
normals_kernel(const float* __restrict__ depth, float* __restrict__ points,
               float* __restrict__ normals, NormalsArgs a) {
  extern __shared__ float smem[];
  const int R = a.radius, h = a.h, w = a.w;
  const int P = kTile + 2 * R + 2, Q = kTile + 2 * R;
  const int pp = P * P, qq = Q * Q, vv = kTile * Q;
  float* pts = smem;
  float* tan = pts + 3 * pp;
  float* vs = tan + 8 * qq;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int bx = blockIdx.x * kTile, by = blockIdx.y * kTile;

  // 1. the points of the tile plus R + 1 (NaN outside the image)
  for (int i = tid; i < pp; i += kTile * kTile) {
    const int gy = by - R - 1 + i / P, gx = bx - R - 1 + i % P;
    float p[3] = {nan_f(), nan_f(), nan_f()};
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      const int g = gy * w + gx;
      if (kFromDepth) {
        const float d = depth[g];
        const float z = isfinite(d) && d > 0.f ? d : nan_f();
        p[0] = __fmul_rn(__fmul_rn(__fsub_rn(static_cast<float>(gx), a.cx), a.inv_fx), z);
        p[1] = __fmul_rn(__fmul_rn(__fsub_rn(static_cast<float>(gy), a.cy), a.inv_fy), z);
        p[2] = z;
      } else {
#pragma unroll
        for (int c = 0; c < 3; ++c) p[c] = points[3 * g + c];
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) pts[c * pp + i] = p[c];
  }
  __syncthreads();

  // 2. the masked tangents of the tile plus R (zero outside the image)
  for (int i = tid; i < qq; i += kTile * kTile) {
    const int qy = i / Q, qx = i % Q;
    const int gy = by - R + qy, gx = bx - R + qx;
    if (gy < 0 || gy >= h || gx < 0 || gx >= w) {
#pragma unroll
      for (int c = 0; c < 8; ++c) tan[c * qq + i] = 0.f;
      continue;
    }
    const int ic = (qy + 1) * P + qx + 1;  // the centre among the points
    const float az = fabsf(pts[2 * pp + ic]);
    // torch.clamp keeps a NaN, so a NaN centre fails every test
    const float thr = __fmul_rn(__fmul_rn(a.factor, isnan(az) ? az : fmaxf(az, 1.f)), 2.f);
    tangent(pts, pp, ic + 1, ic - 1, thr, tan, qq, i);       // along u
    tangent(pts, pp, ic + P, ic - P, thr, tan + 4 * qq, qq, i);  // along v
  }
  __syncthreads();

  // 3. the box's rows: for each row of the tile, every column of the region
  for (int i = tid; i < vv; i += kTile * kTile) {
    const int ry = i / Q, qx = i % Q;
    float acc[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[c] = 0.f;
    for (int d = 0; d <= 2 * R; ++d) {
      const int it = (ry + d) * Q + qx;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[c] = __fadd_rn(acc[c], tan[c * qq + it]);
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) vs[c * vv + i] = acc[c];
  }
  __syncthreads();

  // 4. the box's columns, the cross product, the norm and the orientation
  const int x = bx + threadIdx.x, y = by + threadIdx.y;
  if (x >= w || y >= h) return;
  float acc[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) acc[c] = 0.f;
  for (int d = 0; d <= 2 * R; ++d) {
    const int iv = threadIdx.y * Q + threadIdx.x + d;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[c] = __fadd_rn(acc[c], vs[c * vv + iv]);
  }
  float tu[3], tv[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    tu[c] = __fdiv_rn(acc[c], fmaxf(acc[3], 1e-12f));
    tv[c] = __fdiv_rn(acc[4 + c], fmaxf(acc[7], 1e-12f));
  }
  const int ic = (threadIdx.y + R + 1) * P + threadIdx.x + R + 1;
  const float p[3] = {pts[ic], pts[pp + ic], pts[2 * pp + ic]};
  const int g = y * w + x;
  if (kFromDepth) {
#pragma unroll
    for (int c = 0; c < 3; ++c) points[3 * g + c] = p[c];
  }
  float n[3] = {cross_term(tu[1], tv[2], tu[2], tv[1]), cross_term(tu[2], tv[0], tu[0], tv[2]),
                cross_term(tu[0], tv[1], tu[1], tv[0])};
  const float norm = norm3(n[0], n[1], n[2]);
  const bool ok = isfinite(p[2]) && acc[3] > 0.f && acc[7] > 0.f && norm > 1e-12f
                  && isfinite(n[0]) && isfinite(n[1]) && isfinite(n[2]);
  if (!ok) {
#pragma unroll
    for (int c = 0; c < 3; ++c) normals[3 * g + c] = nan_f();
    return;
  }
  const float den = fmaxf(norm, 1e-12f);
#pragma unroll
  for (int c = 0; c < 3; ++c) n[c] = __fdiv_rn(n[c], den);
  const bool flip = sum3(__fmul_rn(n[0], p[0]), __fmul_rn(n[1], p[1]), __fmul_rn(n[2], p[2])) > 0.f;
#pragma unroll
  for (int c = 0; c < 3; ++c) normals[3 * g + c] = flip ? -n[c] : n[c];
}

dim3 blocks_for(int h, int w, int bx, int by) {
  return dim3((w + bx - 1) / bx, (h + by - 1) / by);
}

}  // namespace

extern "C" int tsdf_bilateral_pass(const float* in, float* out, int h, int w, int axis,
                                   int radius, const float* sw, float inv2sr,
                                   cudaStream_t stream) {
  if ((axis != 0 && axis != 1) || radius < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (h <= 0 || w <= 0) return 0;
  bilateral_pass_kernel<<<blocks_for(h, w, kBX, kBY), dim3(kBX, kBY), 0, stream>>>(
      in, out, h, w, axis, radius, sw, inv2sr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tsdf_bilateral_2d(const float* in, float* out, int h, int w, int radius,
                                 const float* sw, float inv2sr, cudaStream_t stream) {
  if (radius < 0 || radius > kMaxRadius2d) return static_cast<int>(cudaErrorInvalidValue);
  if (h <= 0 || w <= 0) return 0;
  const int k = 2 * radius + 1;
  const size_t smem = sizeof(float) * ((kBX + 2 * radius) * (kBY + 2 * radius) + k * k);
  bilateral_2d_kernel<<<blocks_for(h, w, kBX, kBY), dim3(kBX, kBY), smem, stream>>>(
      in, out, h, w, radius, sw, inv2sr);
  return static_cast<int>(cudaGetLastError());
}

// depth NULL: the normals of the point image in `points` (read, not written)
extern "C" int tsdf_normals(const float* depth, float* points, float* normals, int h, int w,
                            float inv_fx, float inv_fy, float cx, float cy, float factor,
                            int radius, cudaStream_t stream) {
  if (radius < 0 || radius > kMaxBoxRadius) return static_cast<int>(cudaErrorInvalidValue);
  if (h <= 0 || w <= 0) return 0;
  const NormalsArgs a{h, w, radius, inv_fx, inv_fy, cx, cy, factor};
  const size_t smem = sizeof(float) * normals_smem_floats(radius);
  const dim3 grid = blocks_for(h, w, kTile, kTile), block(kTile, kTile);
  if (depth != nullptr)
    normals_kernel<true><<<grid, block, smem, stream>>>(depth, points, normals, a);
  else
    normals_kernel<false><<<grid, block, smem, stream>>>(depth, points, normals, a);
  return static_cast<int>(cudaGetLastError());
}
