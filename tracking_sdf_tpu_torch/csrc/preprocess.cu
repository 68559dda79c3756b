// K3 and K4: depth preprocessing, the stage of every frame before tracking.
//   tsdf_bilateral_pass  K3, separable form: both 1-D bilateral passes of the
//                        separable filter in ONE launch (mode 2: along axis 0,
//                        then axis 1), or one pass along axis 0 (rows, mode 0)
//                        or axis 1 (columns, mode 1);
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
// K4's masks are counted as integers: the plain float sums of 0 / 1 are
// exact integers, so the counts convert to the same floats.
//
// What bounds them on the card. K3's separable form moves 8 bytes a pixel
// (the depth in, the filtered depth out) against ~18 instructions a tap with
// one precise expf (one MUFU ex2) for 2 x 10 taps a pixel, so instruction
// issue, not bytes or the ex2 rate, sets its floor. A block stages its
// kSepW x kSepH tile of depth with r rows above and below and r (rounded up
// to 4) columns left and right in shared memory, NaN outside the image;
// pass 1 (axis 0) makes the tile's rows over its columns plus the 2r halo
// columns into shared memory (a halo column outside the image has a NaN
// centre, so it stays NaN and pass 2 skips it, as the plain version's NaN
// fill does), and after one barrier pass 2 (axis 1) makes kSepPx pixels of
// a row a thread from a register window; two neighbouring threads join
// their pixels for one 16-byte store. A thread's pixels' taps interleave,
// and a tap that is not finite is skipped by selects, not branches. The
// presets' r = 5 is compiled (taps unrolled); any other radius up to
// kMaxSepRadius (the two-pass launch's shared memory reaches kMaxSmem)
// runs the same code with a runtime radius. The spatial weights travel by
// value in the kernel's parameters, not as a load a tap. Tiles, strips and
// pixels a thread are the fastest of tools/preprocess_tile_trials.py's
// candidates.
// The 2-D form: operations, 121 taps of ~8 float ops and one expf a pixel,
// ~16 instructions a tap, so instruction issue sets its floor as it does
// the separable form's. A block stages its k2dW x k2dH tile with r rows above
// and below and r (rounded up to 4) columns left and right in shared memory
// (16-byte loads where it can), NaN outside the image; each thread makes
// k2dPx consecutive pixels of a row from a register window of k2dPx + 2r
// floats a tap row (vector loads from shared memory), their taps
// interleaved (tap row, tap column, pixel); a tap that is not finite adds
// nothing, not by a branch: the compiled radius takes it as +inf (weight
// exactly 0) and the runtime radius selects its weight. The default r = 5
// is compiled (the 121 taps unrolled), its spatial weights by value in the
// kernel's parameters, one a squared distance dy^2 + dx^2 (51 floats), not
// as a load a tap; any other radius up to kMaxRadius2d (the staged tile
// reaches kMaxSmem) runs the same loop with a runtime radius, reading each
// tap's weight from the plain version's (2r+1)^2 table on the device. Stores are 16 bytes where w % 4 == 0 and the tensors are aligned. Tile and
// pixels a thread: the fastest of tools/preprocess_tile_trials.py's
// candidates.
// K4: bytes (1.2 MB of depth in, 3.7 MB of points and 3.7 MB of normals
// out) against ~450 instructions a pixel. A block makes a kNormW x kNormH
// tile: it stages the depth (or the three point planes) of the tile plus
// R + 1 with 16-byte loads, the tangents and the packed integer masks of the
// tile plus R as planes, then sums kNormStrip rows of one column of the box
// (axis 0) a thread, one plane at a time, each plane's column sums taking
// its tangents' place after a barrier; each thread then sums 4 pixels of a
// row along axis 1 from 16-byte shared loads and finishes their normals;
// the tile's points and normals pass through shared memory and leave as
// 16-byte stores, consecutive threads on consecutive 16 bytes. 600 blocks
// at 640x480 stay resident in one wave (kNormBlocks); its load, compute and
// store phases then run one after the other on every SM. The presets'
// R = 4 is compiled; any other radius up to kMaxBoxRadius (the point form's
// shared memory reaches kMaxSmem) runs the same code with a runtime radius.

#include <cuda_runtime.h>

#include <cmath>

namespace {

// K3 2-D form: a block makes a k2dW x k2dH tile, k2dPx pixels of a row a thread
constexpr int k2dW = 64;
constexpr int k2dH = 8;
constexpr int k2dPx = 2;  // 2 or 4
constexpr int k2dThreads = k2dW * k2dH / k2dPx;
constexpr int k2dRadius = 5;  // compiled: bilateral_filter's default
// K3 separable form: a block makes a kSepW x kSepH tile, kSepStrip rows of one
// column a thread in pass 1 and kSepPx pixels of a row a thread in pass 2
constexpr int kSepW = 128;
constexpr int kSepH = 4;
constexpr int kSepStrip = 2;
constexpr int kSepPx = 2;  // 2 or 4
constexpr int kSepThreads = kSepW * kSepH / kSepPx;
constexpr int kSepRadius = 5;  // compiled: bilateral_filter_separable's default
// K4: a block makes a kNormW x kNormH tile, 4 pixels of a row a thread at the end
constexpr int kNormW = 32;
constexpr int kNormH = 16;
constexpr int kNormThreads = 128;  // >= kNormW * kNormH / 4: 4 pixels a thread at the end
constexpr int kNormBlocks = 5;  // resident blocks an SM: 600 fill 132 SMs in one wave
constexpr int kNormStrip = 8;  // rows of the box's column sums a thread
constexpr int kBoxRadius = 4;  // compiled: estimate_normals' SMOOTHING_RADIUS
// The dynamic shared memory an sm_90 block may have: each kernel takes any
// radius up to the last whose launch fits it (kMaxRadius2d, kMaxSepRadius,
// kMaxBoxRadius below, from the tiles).
constexpr int kMaxSmem = 227 * 1024;

static_assert(k2dW % 4 == 0 && (k2dPx == 2 || k2dPx == 4) && (k2dW / k2dPx) % 2 == 0
              && k2dThreads % 32 == 0, "K3 2-D tile");
static_assert(kSepW % 4 == 0 && kSepH % kSepStrip == 0 && (kSepPx == 2 || kSepPx == 4)
              && kSepThreads % 32 == 0, "K3 tile");
static_assert(kNormW % 4 == 0 && kNormH % kNormStrip == 0 && kNormW * kNormH <= 4 * kNormThreads,
              "K4 tile");

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fc00000); }
__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// sw * exp(-(dn - d0)^2 * inv2sr), as the plain version's ops round it
__device__ __forceinline__ float range_weight(float sw, float dn, float d0, float inv2sr) {
  const float diff = __fsub_rn(dn, d0);
  return __fmul_rn(sw, expf(__fmul_rn(-__fmul_rn(diff, diff), inv2sr)));
}

// A kernel whose dynamic shared memory passes 48 KB must be allowed it first.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return bytes <= 48 * 1024 ? cudaSuccess
      : cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
}

template <bool kDepth>
__device__ __forceinline__ float staged(float d) {
  return !kDepth || (isfinite(d) && d > 0.f) ? d : nan_f();
}

// Rows [y0, y0 + rows) and columns [x0, x0 + pitch) of an (h, w) image into
// shared memory (pitch floats a row), NaN outside the image; kDepth: NaN also
// where the depth is not finite or <= 0 (a point's z). vec: 16-byte loads (w %
// 4 == 0 and src 16-byte aligned; x0 and pitch are multiples of 4, so each
// four lie wholly inside or outside the image).
template <bool kDepth, int kThreads>
__device__ __forceinline__ void stage_image(const float* __restrict__ src, float* dst, int h,
                                            int w, int y0, int x0, int rows, int pitch,
                                            bool vec) {
  if (vec) {
    const int q = pitch / 4;
    for (int i = threadIdx.x; i < rows * q; i += kThreads) {
      const int y = y0 + i / q, x = x0 + 4 * (i % q);
      float4 v = make_float4(nan_f(), nan_f(), nan_f(), nan_f());
      if (y >= 0 && y < h && x >= 0 && x < w) {
        v = __ldg(reinterpret_cast<const float4*>(src + y * w + x));
        v = make_float4(staged<kDepth>(v.x), staged<kDepth>(v.y), staged<kDepth>(v.z),
                        staged<kDepth>(v.w));
      }
      reinterpret_cast<float4*>(dst)[i] = v;
    }
  } else {
    for (int i = threadIdx.x; i < rows * pitch; i += kThreads) {
      const int y = y0 + i / pitch, x = x0 + i % pitch;
      dst[i] = y >= 0 && y < h && x >= 0 && x < w ? staged<kDepth>(src[y * w + x]) : nan_f();
    }
  }
}

// The (h, w, 3) points of rows [y0, y0 + rows) and columns [x0, x0 + pitch)
// into three planes (x, y, z) of rows x pitch floats, NaN outside the image;
// vec as stage_image (a float4 of a row lies within one group of 4 pixels).
template <int kThreads>
__device__ __forceinline__ void stage_points(const float* __restrict__ src, float* dst, int h,
                                             int w, int y0, int x0, int rows, int pitch,
                                             bool vec) {
  const int plane = rows * pitch;
  if (vec) {
    const int q = 3 * pitch / 4;
    for (int i = threadIdx.x; i < rows * q; i += kThreads) {
      const int r = i / q, k = i % q;
      const int y = y0 + r, x = x0 + 4 * (k / 3);
      float4 v = make_float4(nan_f(), nan_f(), nan_f(), nan_f());
      if (y >= 0 && y < h && x >= 0 && x < w)
        v = __ldg(reinterpret_cast<const float4*>(src + 3 * (y * w + x0)) + k);
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int f = 4 * k + j;
        dst[(f % 3) * plane + r * pitch + f / 3] = e[j];
      }
    }
  } else {
    for (int i = threadIdx.x; i < rows * pitch; i += kThreads) {
      const int y = y0 + i / pitch, x = x0 + i % pitch;
      const bool in = y >= 0 && y < h && x >= 0 && x < w;
#pragma unroll
      for (int c = 0; c < 3; ++c) dst[c * plane + i] = in ? src[3 * (y * w + x) + c] : nan_f();
    }
  }
}

// --- K3, separable form --------------------------------------------------------

// Staged rows above and below the tile, columns left and right (a multiple of
// 4), and the shared floats of a launch (the staged tile, and in mode 2 pass
// 1's rows).
__host__ __device__ constexpr int sep_rows(int r, int mode) { return mode == 1 ? 0 : r; }
__host__ __device__ constexpr int sep_pad(int r, int mode) { return mode == 0 ? 0 : (r + 3) & ~3; }
__host__ __device__ constexpr int sep_pitch(int r, int mode) {
  return kSepW + 2 * sep_pad(r, mode);
}
__host__ __device__ constexpr int sep_smem_floats(int r, int mode) {
  return (kSepH + 2 * sep_rows(r, mode) + (mode == 2 ? kSepH : 0)) * sep_pitch(r, mode);
}
// the largest radius of the two-pass launch (mode 2), which every mode takes
constexpr int largest_sep_radius() {
  int r = 0;
  while (4 * sep_smem_floats(r + 1, 2) <= kMaxSmem) ++r;
  return r;
}
constexpr int kMaxSepRadius = largest_sep_radius();

// the spatial weights by value: the compiled radius's 2 kR + 1, or room for
// any radius up to kMaxSepRadius
__host__ __device__ constexpr int sep_weights(int kR) {
  return 2 * (kR >= 0 ? kR : kMaxSepRadius) + 1;
}
template <int kN>
struct SepArgs {
  int h, w, radius;
  float inv2sr;
  float sw[kN];
};

// kN values from 16-byte (kN 4) or 8-byte (2) aligned shared memory
template <int kN>
__device__ __forceinline__ void load_px(const float* p, float* b) {
  if constexpr (kN == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    b[0] = v.x, b[1] = v.y, b[2] = v.z, b[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    b[0] = v.x, b[1] = v.y;
  }
}

// A thread's kN pixels of row y from column x (a multiple of kN) into the
// (h, w) output, res[0, kN): with vec (w % 4 == 0, out 16-byte aligned) one
// 16-byte store a group of 4 pixels, which lies wholly inside or outside the
// image (kN 2: an even thread takes its odd neighbour's pair, so every lane
// of the warp calls this, and res has room for 4), else one float at a time.
template <int kN>
__device__ __forceinline__ void store_px(float* __restrict__ out, float res[4], int y, int x,
                                         int h, int w, int vec) {
  if (kN == 2 && vec) {
    res[2] = __shfl_down_sync(0xffffffffu, res[0], 1);
    res[3] = __shfl_down_sync(0xffffffffu, res[1], 1);
  }
  if (y >= h || x >= w) return;
  if (vec) {
    if (x % 4 == 0)
      *reinterpret_cast<float4*>(out + y * w + x) = make_float4(res[0], res[1], res[2], res[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kN; ++j)
      if (x + j < w) out[y * w + x + j] = res[j];
  }
}

// One output of a 1-D pass with a runtime radius R from its 2R + 1 taps
// t[0], t[s], ..., t[2R s] (the centre t[R s]) as the plain pass rounds it;
// wc is the centre tap's weight, sw[R] * exp(-0 * inv2sr). Selects, not
// branches, skip the taps that are not finite.
template <typename Args>
__device__ __forceinline__ float pass_px(const float* t, int s, int R, const Args& a, float wc) {
  const float d0 = t[R * s];
  float num = 0.f, den = 0.f;
  for (int k = 0; k <= 2 * R; ++k) {
    const float dn = t[k * s];
    const float wt = k == R ? wc : range_weight(a.sw[k], dn, d0, a.inv2sr);
    const bool ok = isfinite(dn);
    num = ok ? __fadd_rn(num, __fmul_rn(wt, dn)) : num;
    den = ok ? __fadd_rn(den, wt) : den;
  }
  const float q = __fdiv_rn(num, fmaxf(den, 1e-12f));
  return isfinite(d0) && den > 0.f ? q : nan_f();
}

// kN consecutive outputs of a 1-D pass with the compiled radius kR from a
// window t[0, kN + 2 kR) in registers: output j's taps are t[j + k], k =
// 0..2 kR, each output's summed from zero in k's order, as pass_px; the kN
// outputs' taps interleave (k outer, j inner), so their expf do.
template <int kR, int kN, typename Args>
__device__ __forceinline__ void pass_run(const float* t, float* res, const Args& a, float wc) {
  float num[kN], den[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) num[j] = den[j] = 0.f;
#pragma unroll
  for (int k = 0; k <= 2 * kR; ++k) {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const float dn = t[j + k];
      const float wt = k == kR ? wc : range_weight(a.sw[k], dn, t[j + kR], a.inv2sr);
      const bool ok = isfinite(dn);
      num[j] = ok ? __fadd_rn(num[j], __fmul_rn(wt, dn)) : num[j];
      den[j] = ok ? __fadd_rn(den[j], wt) : den[j];
    }
  }
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const float q = __fdiv_rn(num[j], fmaxf(den[j], 1e-12f));
    res[j] = isfinite(t[j + kR]) && den[j] > 0.f ? q : nan_f();
  }
}

// kMode 0: the pass along axis 0 (rows); 1: along axis 1 (columns); 2: both,
// axis 0 then axis 1, the separable filter. kR >= 0: the compiled radius.
template <int kR, int kMode>
__global__ void __launch_bounds__(kSepThreads)
bilateral_pass_kernel(const float* __restrict__ in, float* __restrict__ out,
                      SepArgs<sep_weights(kR)> a, int vec) {
  extern __shared__ float4 smem4[];
  const int R = kR >= 0 ? kR : a.radius;
  const int ry = sep_rows(R, kMode), pad = sep_pad(R, kMode), pitch = sep_pitch(R, kMode);
  const int rx = kMode == 0 ? 0 : R;  // pass 1's columns left and right of the tile
  const int h = a.h, w = a.w;
  const int bx = blockIdx.x * kSepW, by = blockIdx.y * kSepH;
  float* tile = reinterpret_cast<float*>(smem4);  // (kSepH + 2 ry) x pitch at (by - ry, bx - pad)
  float* mid = tile + (kSepH + 2 * ry) * pitch;   // mode 2: pass 1, kSepH x pitch at (by, bx - pad)
  stage_image<false, kSepThreads>(in, tile, h, w, by - ry, bx - pad, kSepH + 2 * ry, pitch,
                                  vec);
  const float wc = range_weight(a.sw[R], 0.f, 0.f, a.inv2sr);
  __syncthreads();

  if (kMode != 1) {  // pass 1, along axis 0: kSepStrip rows of one column an item
    const int cols = kSepW + 2 * rx;
    for (int i = threadIdx.x; i < cols * (kSepH / kSepStrip); i += kSepThreads) {
      const int c = pad - rx + i % cols, r0 = (i / cols) * kSepStrip;
      const float* col = tile + r0 * pitch + c;  // row r0 + j's taps: col[(j + k) * pitch]
      float res[kSepStrip];
      if constexpr (kR >= 0) {
        float win[kSepStrip + 2 * kR];
#pragma unroll
        for (int k = 0; k < kSepStrip + 2 * kR; ++k) win[k] = col[k * pitch];
        pass_run<kR, kSepStrip>(win, res, a, wc);
      } else {
#pragma unroll
        for (int j = 0; j < kSepStrip; ++j) res[j] = pass_px(col + j * pitch, pitch, R, a, wc);
      }
#pragma unroll
      for (int j = 0; j < kSepStrip; ++j) {
        if (kMode == 2) {
          mid[(r0 + j) * pitch + c] = res[j];
        } else {
          const int y = by + r0 + j, x = bx + c;  // pad = 0
          if (y < h && x < w) out[y * w + x] = res[j];
        }
      }
    }
  }
  if (kMode == 0) return;
  if (kMode == 2) __syncthreads();

  // pass 2, along axis 1: kSepPx pixels of a row a thread; pixel x0 + j's
  // taps are row[pad - R + j + k]
  const int r = threadIdx.x / (kSepW / kSepPx), x0 = kSepPx * (threadIdx.x % (kSepW / kSepPx));
  const float* row = (kMode == 2 ? mid : tile) + r * pitch + x0;
  float res[4];
  if constexpr (kR >= 0) {
    constexpr int kPad = (kR + 3) & ~3, kBuf = 2 * kPad + kSepPx;
    float buf[kBuf];
#pragma unroll
    for (int k = 0; k < kBuf; k += kSepPx) load_px<kSepPx>(row + k, buf + k);
    pass_run<kR, kSepPx>(buf + kPad - kR, res, a, wc);
  } else {
#pragma unroll
    for (int j = 0; j < kSepPx; ++j) res[j] = pass_px(row + pad - R + j, 1, R, a, wc);
  }
  store_px<kSepPx>(out, res, by + r, bx + x0, h, w, vec);
}

// --- K3, 2-D form ---------------------------------------------------------------

// The compiled radius's spatial weights by value, one a squared tap
// distance d = dy^2 + dx^2 (the plain version's exp(-d / (2 ss^2)) depends on
// d alone); the runtime radius reads the plain version's (2r+1)^2 table.
__host__ __device__ constexpr int b2d_weights(int r) { return 2 * r * r + 1; }
struct Bil2dArgs {
  int h, w, radius;
  float inv2sr;
  const float* table;  // (2r+1)^2 row-major, on the device
  float sw[b2d_weights(k2dRadius)];
};
__host__ __device__ constexpr int b2d_pad(int r) { return (r + 3) & ~3; }
__host__ __device__ constexpr int b2d_pitch(int r) { return k2dW + 2 * b2d_pad(r); }
__host__ __device__ constexpr int b2d_smem_floats(int r) { return (k2dH + 2 * r) * b2d_pitch(r); }
constexpr int largest_2d_radius() {
  int r = 0;
  while (4 * b2d_smem_floats(r + 1) <= kMaxSmem) ++r;
  return r;
}
constexpr int kMaxRadius2d = largest_2d_radius();

// One tap of value dn (dn0: dn, or 0 where it is not finite) and spatial
// weight sw added to a pixel's sums. A tap that is not finite adds +0 to
// both, by a select of its weight, not a branch: num and den start at +0 and
// so are never -0, and adding +0 leaves their bits as the plain version's
// skip does. (The compiled radius gets the same sums without the select.)
__device__ __forceinline__ void tap_2d(float sw, float dn, float dn0, float d0, float inv2sr,
                                       float& num, float& den) {
  const float wt = isfinite(dn) ? range_weight(sw, dn, d0, inv2sr) : 0.f;
  num = __fadd_rn(num, __fmul_rn(wt, dn0));
  den = __fadd_rn(den, wt);
}

// kR >= 0: the compiled radius (taps unrolled; inv2sr > 0), else a.radius
// at run time.
template <int kR>
__global__ void __launch_bounds__(k2dThreads)
bilateral_2d_kernel(const float* __restrict__ in, float* __restrict__ out, Bil2dArgs a,
                    int vec) {
  extern __shared__ float4 smem4[];
  const int R = kR >= 0 ? kR : a.radius;
  const int pad = b2d_pad(R), pitch = b2d_pitch(R);
  const int h = a.h, w = a.w;
  const int bx = blockIdx.x * k2dW, by = blockIdx.y * k2dH;
  float* tile = reinterpret_cast<float*>(smem4);  // (k2dH + 2R) x pitch at (by - R, bx - pad)
  stage_image<false, k2dThreads>(in, tile, h, w, by - R, bx - pad, k2dH + 2 * R, pitch, vec);
  __syncthreads();

  // pixel x0 + j of tile row r; its tap (dy, dx) is tile row r + dy, column
  // pad - R + x0 + j + dx
  const int r = threadIdx.x / (k2dW / k2dPx), x0 = k2dPx * (threadIdx.x % (k2dW / k2dPx));
  float d0[k2dPx], num[k2dPx], den[k2dPx];
#pragma unroll
  for (int j = 0; j < k2dPx; ++j) {
    d0[j] = tile[(r + R) * pitch + pad + x0 + j];
    num[j] = den[j] = 0.f;
  }
  if constexpr (kR >= 0) {
    // inv2sr > 0 here: a tap that is not finite enters as +inf, whose weight
    // is then exactly 0 (sw * expf(-inf)) wherever the centre is finite, and
    // its value as 0, so a tap needs no test of its own
    constexpr int kPad = b2d_pad(kR), kBuf = 2 * kPad + k2dPx;
#pragma unroll
    for (int dy = 0; dy <= 2 * kR; ++dy) {
      float buf[kBuf], buf0[kBuf];  // the tap row's window: +inf / 0 where not finite
      const float* row = tile + (r + dy) * pitch + x0;
#pragma unroll
      for (int k = 0; k < kBuf; k += k2dPx) load_px<k2dPx>(row + k, buf + k);
#pragma unroll
      for (int k = 0; k < kBuf; ++k) {
        const bool fin = isfinite(buf[k]);
        buf0[k] = fin ? buf[k] : 0.f;
        buf[k] = fin ? buf[k] : inf_f();
      }
#pragma unroll
      for (int dx = 0; dx <= 2 * kR; ++dx) {
        const float sw = a.sw[(dy - kR) * (dy - kR) + (dx - kR) * (dx - kR)];
#pragma unroll
        for (int j = 0; j < k2dPx; ++j) {
          const int k = kPad - kR + j + dx;
          const float wt = range_weight(sw, buf[k], d0[j], a.inv2sr);
          num[j] = __fadd_rn(num[j], __fmul_rn(wt, buf0[k]));
          den[j] = __fadd_rn(den[j], wt);
        }
      }
    }
  } else {
    for (int dy = 0; dy <= 2 * R; ++dy) {
      const float* row = tile + (r + dy) * pitch + pad - R + x0;
      const float* tw = a.table + dy * (2 * R + 1);
      for (int dx = 0; dx <= 2 * R; ++dx) {
        const float sw = __ldg(tw + dx);
#pragma unroll
        for (int j = 0; j < k2dPx; ++j) {
          const float dn = row[j + dx];
          tap_2d(sw, dn, isfinite(dn) ? dn : 0.f, d0[j], a.inv2sr, num[j], den[j]);
        }
      }
    }
  }
  float res[4];
#pragma unroll
  for (int j = 0; j < k2dPx; ++j) {
    const float q = __fdiv_rn(num[j], fmaxf(den[j], 1e-12f));
    res[j] = isfinite(d0[j]) && den[j] > 0.f ? q : nan_f();
  }
  store_px<k2dPx>(out, res, by + r, bx + x0, h, w, vec);
}

// --- K4, backprojection and normals ------------------------------------------

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

// The tangent (pp - pm) / 2 of the points at +1 and -1 where both are finite
// and |dz| < thr (the centre's depth-jump threshold), else 0; true where kept.
__device__ __forceinline__ bool tangent(const float pp[3], const float pm[3], float thr,
                                        float t[3]) {
  const bool ok = isfinite(pp[0]) && isfinite(pp[1]) && isfinite(pp[2]) && isfinite(pm[0])
                  && isfinite(pm[1]) && isfinite(pm[2]) && fabsf(__fsub_rn(pp[2], pm[2])) < thr;
#pragma unroll
  for (int c = 0; c < 3; ++c) t[c] = ok ? __fmul_rn(0.5f, __fsub_rn(pp[c], pm[c])) : 0.f;
  return ok;
}

// Shared memory of K4 in floats: the staged depth (or 3 point planes) of the
// tile plus R + 1, norm_stage_rows(R) x norm_stage_pitch(R) (norm_halo(R)
// columns left and right, R + 1 rounded up to 4); the depth form's ray
// factors of each staged column and row (rounded up to 4); 7 planes of the
// tile plus R (t_u, t_v and the packed masks), (kNormH + 2R) x norm_pitch(R),
// whose place the box's column sums take later.
__host__ __device__ constexpr int norm_halo(int r) { return (r + 4) & ~3; }
__host__ __device__ constexpr int norm_stage_pitch(int r) { return kNormW + 2 * norm_halo(r); }
__host__ __device__ constexpr int norm_stage_rows(int r) { return kNormH + 2 * r + 2; }
__host__ __device__ constexpr int norm_pitch(int r) { return kNormW + ((2 * r + 3) & ~3); }
__host__ __device__ constexpr int norm_rays(int r, bool depth) {
  return depth ? norm_stage_pitch(r) + ((norm_stage_rows(r) + 3) & ~3) : 0;
}
__host__ __device__ constexpr int normals_smem_floats(int r, bool depth) {
  return (depth ? 1 : 3) * norm_stage_rows(r) * norm_stage_pitch(r) + norm_rays(r, depth)
         + 7 * (kNormH + 2 * r) * norm_pitch(r);
}
// the largest radius of the point form, which needs more than the depth form
constexpr int largest_box_radius() {
  int r = 0;
  while (4 * normals_smem_floats(r + 1, false) <= kMaxSmem) ++r;
  return r;
}
constexpr int kMaxBoxRadius = largest_box_radius();
static_assert(normals_smem_floats(kMaxBoxRadius, true) <= normals_smem_floats(kMaxBoxRadius, false)
              && kBoxRadius <= kMaxBoxRadius, "K4: the depth form fits where the point form does");

// The point at staged row sr, column sc (pitch floats a row): from the depth
// plane and the ray factors, or from the three point planes.
template <bool kFromDepth>
__device__ __forceinline__ void staged_point(const float* pl, const float* ax, const float* ay,
                                             int pitch, int plane, int sr, int sc, float p[3]) {
  const int i = sr * pitch + sc;
  if (kFromDepth) {
    const float z = pl[i];
    p[0] = __fmul_rn(ax[sc], z);
    p[1] = __fmul_rn(ay[sr], z);
    p[2] = z;
  } else {
    p[0] = pl[i];
    p[1] = pl[plane + i];
    p[2] = pl[2 * plane + i];
  }
}

// Pixel (u, v)'s normal from its box sums su (t_u), sv (t_v) and counts cu,
// cv, and its point p: NaN where it is not ok (selects, not branches).
__device__ __forceinline__ void finish_normal(const float su[3], int cu, const float sv[3],
                                              int cv, const float p[3], float n[3]) {
  float tu[3], tv[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    tu[c] = __fdiv_rn(su[c], fmaxf(static_cast<float>(cu), 1e-12f));
    tv[c] = __fdiv_rn(sv[c], fmaxf(static_cast<float>(cv), 1e-12f));
  }
  n[0] = cross_term(tu[1], tv[2], tu[2], tv[1]);
  n[1] = cross_term(tu[2], tv[0], tu[0], tv[2]);
  n[2] = cross_term(tu[0], tv[1], tu[1], tv[0]);
  const float norm = norm3(n[0], n[1], n[2]);
  const bool ok = isfinite(p[2]) && cu > 0 && cv > 0 && norm > 1e-12f && isfinite(n[0])
                  && isfinite(n[1]) && isfinite(n[2]);
  const float den = fmaxf(norm, 1e-12f);
#pragma unroll
  for (int c = 0; c < 3; ++c) n[c] = __fdiv_rn(n[c], den);
  const bool flip = sum3(__fmul_rn(n[0], p[0]), __fmul_rn(n[1], p[1]), __fmul_rn(n[2], p[2])) > 0.f;
#pragma unroll
  for (int c = 0; c < 3; ++c) n[c] = !ok ? nan_f() : flip ? -n[c] : n[c];
}

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ int add(int a, int b) { return a + b; }

// four values from 16-byte-aligned shared memory
__device__ __forceinline__ void load4(const float* p, float* b) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  b[0] = v.x, b[1] = v.y, b[2] = v.z, b[3] = v.w;
}
__device__ __forceinline__ void load4(const int* p, int* b) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  b[0] = v.x, b[1] = v.y, b[2] = v.z, b[3] = v.w;
}

// kNormStrip box sums down a column: s[j] = sum of col[(j + d) * pitch], d =
// 0..2R, from zero in order.
template <int kR, typename T>
__device__ __forceinline__ void column_sums(const T* col, int pitch, int R, T s[kNormStrip]) {
  if constexpr (kR >= 0) {
    T win[kNormStrip + 2 * kR];
#pragma unroll
    for (int k = 0; k < kNormStrip + 2 * kR; ++k) win[k] = col[k * pitch];
#pragma unroll
    for (int j = 0; j < kNormStrip; ++j) {
      T acc = 0;
#pragma unroll
      for (int d = 0; d <= 2 * kR; ++d) acc = add(acc, win[j + d]);
      s[j] = acc;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kNormStrip; ++j) {
      T acc = 0;
      for (int d = 0; d <= 2 * R; ++d) acc = add(acc, col[(j + d) * pitch]);
      s[j] = acc;
    }
  }
}

// Four box sums along a row: s[j] = sum of row[j + d], d = 0..2R, from zero
// in order; kR >= 0 reads the window 16 bytes at a time (row 16-byte aligned).
template <int kR, typename T>
__device__ __forceinline__ void row_sums(const T* row, int R, T s[4]) {
  if constexpr (kR >= 0) {
    constexpr int kBuf = (2 * kR + 4 + 3) & ~3;
    T buf[kBuf];
#pragma unroll
    for (int k = 0; k < kBuf / 4; ++k) load4(row + 4 * k, buf + 4 * k);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      T acc = 0;
#pragma unroll
      for (int d = 0; d <= 2 * kR; ++d) acc = add(acc, buf[j + d]);
      s[j] = acc;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      T acc = 0;
      for (int d = 0; d <= 2 * R; ++d) acc = add(acc, row[j + d]);
      s[j] = acc;
    }
  }
}

// kFromDepth: backproject the depth (writing the points) and take their
// normals; else the normals of the given points. kR >= 0: the compiled radius.
template <int kR, bool kFromDepth>
__global__ void __launch_bounds__(kNormThreads, kNormBlocks)
normals_kernel(const float* __restrict__ depth, float* __restrict__ points,
               float* __restrict__ normals, NormalsArgs a, int vec) {
  extern __shared__ float4 smem4[];
  const int R = kR >= 0 ? kR : a.radius;
  const int h = a.h, w = a.w;
  const int halo = norm_halo(R), SP = norm_stage_pitch(R);
  const int PH = norm_stage_rows(R), plane = PH * SP;
  const int QH = kNormH + 2 * R, QW = kNormW + 2 * R, QP = norm_pitch(R), tplane = QH * QP;
  const int bx = blockIdx.x * kNormW, by = blockIdx.y * kNormH;
  const int y0 = by - R - 1, x0 = bx - halo;      // the image position of staged (0, 0)
  float* pl = reinterpret_cast<float*>(smem4);    // depth, or the x, y, z planes
  float* ax = pl + (kFromDepth ? 1 : 3) * plane;  // (u - cx) / fx of each staged column
  float* ay = ax + SP;                            // (v - cy) / fy of each staged row
  float* tan = ax + norm_rays(R, kFromDepth);     // t_u (x, y, z), t_v (x, y, z), masks
  int* mask = reinterpret_cast<int*>(tan + 6 * tplane);

  // 1. the points of the tile plus R + 1 (NaN outside the image)
  if (kFromDepth) {
    stage_image<true, kNormThreads>(depth, pl, h, w, y0, x0, PH, SP, vec);
    for (int i = threadIdx.x; i < SP + PH; i += kNormThreads) {
      if (i < SP)
        ax[i] = __fmul_rn(__fsub_rn(static_cast<float>(x0 + i), a.cx), a.inv_fx);
      else
        ay[i - SP] = __fmul_rn(__fsub_rn(static_cast<float>(y0 + i - SP), a.cy), a.inv_fy);
    }
  } else {
    stage_points<kNormThreads>(points, pl, h, w, y0, x0, PH, SP, vec);
  }
  __syncthreads();

  // 2. the masked tangents of the tile plus R (zero outside the image) and
  // their masks, t_u's in bit 0 and t_v's in bit 16
  for (int i = threadIdx.x; i < QH * QW; i += kNormThreads) {
    const int qy = i / QW, qx = i % QW;
    const int gy = by - R + qy, gx = bx - R + qx;
    float tu[3] = {0.f, 0.f, 0.f}, tv[3] = {0.f, 0.f, 0.f};
    int m = 0;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      const int sr = qy + 1, sc = qx - R + halo;  // the centre among the staged points
      float pc[3], pp[3], pm[3];
      staged_point<kFromDepth>(pl, ax, ay, SP, plane, sr, sc, pc);
      const float az = fabsf(pc[2]);
      // torch.clamp keeps a NaN, so a NaN centre fails every test
      const float thr = __fmul_rn(__fmul_rn(a.factor, isnan(az) ? az : fmaxf(az, 1.f)), 2.f);
      staged_point<kFromDepth>(pl, ax, ay, SP, plane, sr, sc + 1, pp);
      staged_point<kFromDepth>(pl, ax, ay, SP, plane, sr, sc - 1, pm);
      m = tangent(pp, pm, thr, tu) ? 1 : 0;  // along u
      staged_point<kFromDepth>(pl, ax, ay, SP, plane, sr + 1, sc, pp);
      staged_point<kFromDepth>(pl, ax, ay, SP, plane, sr - 1, sc, pm);
      m |= tangent(pp, pm, thr, tv) ? 1 << 16 : 0;  // along v
    }
    const int it = qy * QP + qx;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      tan[c * tplane + it] = tu[c];
      tan[(3 + c) * tplane + it] = tv[c];
    }
    mask[it] = m;
  }
  __syncthreads();

  // 3. the box along axis 0: kNormStrip rows of one column of the tile plus R
  // a strip, one plane at a time, a strip a thread in rounds of kNormThreads
  // (one round up to R = 16); after a barrier a round's column sums take the
  // place of their tangents (a plane's first kNormH rows). The strips go in
  // row-major order, so a strip's rows are never written in an earlier round.
  const int strips = QW * (kNormH / kNormStrip);
#pragma unroll 1
  for (int c = 0; c < 7; ++c) {
#pragma unroll 1
    for (int s0 = 0; s0 < strips; s0 += kNormThreads) {
      const int i = s0 + threadIdx.x;
      const bool strip = i < strips;
      float cs[kNormStrip];
      int cm[kNormStrip];
      float* t = tan + c * tplane + i / QW * kNormStrip * QP + i % QW;
      if (strip) {
        if (c < 6)
          column_sums<kR>(t, QP, R, cs);
        else
          column_sums<kR>(reinterpret_cast<const int*>(t), QP, R, cm);
      }
      __syncthreads();
      if (strip) {
#pragma unroll
        for (int j = 0; j < kNormStrip; ++j) {
          if (c < 6)
            t[j * QP] = cs[j];
          else
            reinterpret_cast<int*>(t)[j * QP] = cm[j];
        }
      }
    }
  }
  __syncthreads();
  const int vplane = tplane;
  const int* vmask = mask;

  // 4. the box along axis 1 for 4 pixels of a row a thread, the cross
  // product, the norm and the orientation
  const int ty = threadIdx.x / (kNormW / 4), tx = 4 * (threadIdx.x % (kNormW / 4));
  const int y = by + ty, x = bx + tx;
  const bool live = ty < kNormH && y < h && x < w;
  float pt[12] = {}, nr[12] = {};
  if (live) {
    float s[6][4];
    int sm[4];
#pragma unroll
    for (int c = 0; c < 6; ++c) row_sums<kR>(tan + c * vplane + ty * QP + tx, R, s[c]);
    row_sums<kR>(vmask + ty * QP + tx, R, sm);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      staged_point<kFromDepth>(pl, ax, ay, SP, plane, ty + R + 1, tx + j + halo, pt + 3 * j);
      const float su[3] = {s[0][j], s[1][j], s[2][j]}, sv[3] = {s[3][j], s[4][j], s[5][j]};
      finish_normal(su, sm[j] & 0xffff, sv, sm[j] >> 16, pt + 3 * j, nr + 3 * j);
    }
  }
  if (!vec) {  // each thread's own pixels, one float at a time
    if (live) {
      const int g = 3 * (y * w + x), n = min(4, w - x);
      for (int k = 0; k < 3 * n; ++k) {
        normals[g + k] = nr[k];
        if (kFromDepth) points[g + k] = pt[k];
      }
    }
    return;
  }

  // 5. the tile's normals (and points) through shared memory, in the box
  // sums' place, then out as 16-byte stores, consecutive threads on
  // consecutive 16 bytes (w % 4 == 0: a group of 4 pixels lies wholly inside
  // or outside the image)
  constexpr int kRow = 3 * kNormW;  // floats a tile row of one output
  __syncthreads();
  if (ty < kNormH) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float4* o = reinterpret_cast<float4*>(tan + ty * kRow + 3 * tx) + k;
      *o = make_float4(nr[4 * k], nr[4 * k + 1], nr[4 * k + 2], nr[4 * k + 3]);
      if (kFromDepth)
        o[kNormH * kRow / 4] = make_float4(pt[4 * k], pt[4 * k + 1], pt[4 * k + 2], pt[4 * k + 3]);
    }
  }
  __syncthreads();
  const int rows = min(kNormH, h - by), q = 3 * (min(kNormW, w - bx) / 4);
  for (int i = threadIdx.x; i < (kFromDepth ? 2 : 1) * kNormH * (kRow / 4); i += kNormThreads) {
    const int out = i / (kNormH * kRow / 4), r = i / (kRow / 4) % kNormH, k = i % (kRow / 4);
    if (r >= rows || k >= q) continue;
    float* dst = (out ? points : normals) + 3 * ((by + r) * w + bx);
    reinterpret_cast<float4*>(dst)[k] = reinterpret_cast<const float4*>(tan)[i];
  }
}

dim3 blocks_for(int h, int w, int bx, int by) {
  return dim3((w + bx - 1) / bx, (h + by - 1) / by);
}

template <int kR, int kMode>
cudaError_t launch_pass(const float* in, float* out, int h, int w, int radius, const float* sw,
                        float inv2sr, int vec, cudaStream_t stream) {
  SepArgs<sep_weights(kR)> a{h, w, radius, inv2sr, {}};
  for (int k = 0; k <= 2 * radius; ++k) a.sw[k] = sw[k];
  const size_t smem = sizeof(float) * sep_smem_floats(radius, kMode);
  const auto kernel = bilateral_pass_kernel<kR, kMode>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<blocks_for(h, w, kSepW, kSepH), kSepThreads, smem, stream>>>(in, out, a, vec);
  return cudaGetLastError();
}

template <int kR>
cudaError_t launch_2d(const float* in, float* out, const Bil2dArgs& a, int vec,
                      cudaStream_t stream) {
  const int h = a.h, w = a.w;
  const size_t smem = sizeof(float) * b2d_smem_floats(a.radius);
  const auto kernel = bilateral_2d_kernel<kR>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<blocks_for(h, w, k2dW, k2dH), k2dThreads, smem, stream>>>(in, out, a, vec);
  return cudaGetLastError();
}

template <int kR, bool kFromDepth>
cudaError_t launch_normals(const float* depth, float* points, float* normals,
                           const NormalsArgs& a, int vec, cudaStream_t stream) {
  const size_t smem = sizeof(float) * normals_smem_floats(kR >= 0 ? kR : a.radius, kFromDepth);
  const auto kernel = normals_kernel<kR, kFromDepth>;
  const cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<blocks_for(a.h, a.w, kNormW, kNormH), kNormThreads, smem, stream>>>(
      depth, points, normals, a, vec);
  return cudaGetLastError();
}

}  // namespace

// mode 0 / 1: one pass along axis 0 / 1; 2: the separable filter (axis 0,
// then 1). sw: the 2 radius + 1 spatial weights in host memory (passed to
// the kernel by value). vec: 16-byte loads and stores (w % 4 == 0, in and out
// 16-byte aligned). kSepRadius runs compiled, any other radius at run time.
extern "C" int tsdf_bilateral_pass(const float* in, float* out, int h, int w, int mode,
                                   int radius, const float* sw, float inv2sr, int vec,
                                   cudaStream_t stream) {
  if (mode < 0 || mode > 2 || radius < 0 || radius > kMaxSepRadius)
    return static_cast<int>(cudaErrorInvalidValue);
  if (h <= 0 || w <= 0) return 0;
  cudaError_t e;
  if (radius == kSepRadius)
    e = mode == 0   ? launch_pass<kSepRadius, 0>(in, out, h, w, radius, sw, inv2sr, vec, stream)
        : mode == 1 ? launch_pass<kSepRadius, 1>(in, out, h, w, radius, sw, inv2sr, vec, stream)
                    : launch_pass<kSepRadius, 2>(in, out, h, w, radius, sw, inv2sr, vec, stream);
  else
    e = mode == 0   ? launch_pass<-1, 0>(in, out, h, w, radius, sw, inv2sr, vec, stream)
        : mode == 1 ? launch_pass<-1, 1>(in, out, h, w, radius, sw, inv2sr, vec, stream)
                    : launch_pass<-1, 2>(in, out, h, w, radius, sw, inv2sr, vec, stream);
  return static_cast<int>(e);
}

// sw: the compiled radius's 2 k2dRadius^2 + 1 spatial weights in host
// memory, one a squared tap distance (passed to the kernel by value); table:
// the (2 radius + 1)^2 weights, row-major, on the device (read by any other
// radius). vec: 16-byte loads and stores (w % 4 == 0, in and out 16-byte
// aligned). k2dRadius runs compiled (with inv2sr > 0, as any finite
// sigma_range gives), anything else at run time.
extern "C" int tsdf_bilateral_2d(const float* in, float* out, int h, int w, int radius,
                                 const float* sw, const float* table, float inv2sr, int vec,
                                 cudaStream_t stream) {
  if (radius < 0 || radius > kMaxRadius2d) return static_cast<int>(cudaErrorInvalidValue);
  if (h <= 0 || w <= 0) return 0;
  Bil2dArgs a{h, w, radius, inv2sr, table, {}};
  for (int d = 0; d < b2d_weights(k2dRadius); ++d) a.sw[d] = sw[d];
  const cudaError_t e = radius == k2dRadius && inv2sr > 0.f
                            ? launch_2d<k2dRadius>(in, out, a, vec, stream)
                            : launch_2d<-1>(in, out, a, vec, stream);
  return static_cast<int>(e);
}

// depth NULL: the normals of the point image in `points` (read, not written).
// vec: 16-byte loads and stores (w % 4 == 0, every pointer 16-byte aligned).
// kBoxRadius runs compiled, any other radius at run time.
extern "C" int tsdf_normals(const float* depth, float* points, float* normals, int h, int w,
                            float inv_fx, float inv_fy, float cx, float cy, float factor,
                            int radius, int vec, cudaStream_t stream) {
  if (radius < 0 || radius > kMaxBoxRadius) return static_cast<int>(cudaErrorInvalidValue);
  if (h <= 0 || w <= 0) return 0;
  const NormalsArgs a{h, w, radius, inv_fx, inv_fy, cx, cy, factor};
  cudaError_t e;
  const bool compiled = radius == kBoxRadius;
  if (depth != nullptr)
    e = compiled ? launch_normals<kBoxRadius, true>(depth, points, normals, a, vec, stream)
                 : launch_normals<-1, true>(depth, points, normals, a, vec, stream);
  else
    e = compiled ? launch_normals<kBoxRadius, false>(depth, points, normals, a, vec, stream)
                 : launch_normals<-1, false>(depth, points, normals, a, vec, stream);
  return static_cast<int>(e);
}
