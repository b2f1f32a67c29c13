// LayerNorm forward over the last dim.
//
// Replaces paddle_tpu/ops/pallas/layer_norm.py `_ln_kernel` (called from
// `_ln_fwd_call`).  Bound by bytes: x is read and y written once per
// element, with a handful of flops each.  Two-pass statistics in float32
// match the Pallas kernel's mean-then-centred-variance formula.  Any row
// count and any width: the Pallas `rows % 8` refusal was a TPU tiling
// artefact.
//
// Two hand-written kernels; the C entry picks one from the width and the
// pointers' alignment alone, and counts the choice:
//
// `layer_norm_warp_kernel` (x, y, w and b on 16-byte boundaries, the width a
// multiple of one 16-byte vector and at most 256 of them: every path of the
// models) gives each row one warp, eight rows a block.  The row is read
// once, as 16-byte vectors (8 bf16 or 4 float32, lane i taking vectors
// i, i + 32, ...: three a lane at N = 768 bf16), into registers, where it
// stays packed; both passes of the statistics run on those registers and
// finish with warp shuffles, with no shared memory and no block barrier;
// y leaves as 16-byte vectors.  w and b are loaded as vectors beside x.
//
// `layer_norm_fwd_kernel` (every other width or alignment) gives each row a
// block of 256 threads (512 from N = 4096) with scalar loads; the row is
// read three times (mean, centred variance, normalise), the second and
// third reads hitting L1/L2, and each statistic takes a block-wide sum.
#include <stdint.h>

#include <atomic>

#include "common.cuh"

namespace {

template <typename T>
__global__ void layer_norm_fwd_kernel(const T* __restrict__ x,
                                      const T* __restrict__ w,
                                      const T* __restrict__ b,
                                      T* __restrict__ y,
                                      float* __restrict__ mean_out,
                                      float* __restrict__ rstd_out, int n,
                                      float eps) {
  __shared__ float red[32];
  const long long row = blockIdx.x;
  const T* xr = x + row * n;
  T* yr = y + row * n;

  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) s += ptt::to_f32(xr[i]);
  const float mean = ptt::block_sum(s, red) / n;

  float ss = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float d = ptt::to_f32(xr[i]) - mean;
    ss += d * d;
  }
  const float rstd = rsqrtf(ptt::block_sum(ss, red) / n + eps);

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float xh = (ptt::to_f32(xr[i]) - mean) * rstd;
    yr[i] = ptt::from_f32<T>(xh * ptt::to_f32(w[i]) + ptt::to_f32(b[i]));
  }
  if (threadIdx.x == 0) {
    if (mean_out != nullptr) mean_out[row] = mean;
    if (rstd_out != nullptr) rstd_out[row] = rstd;
  }
}

// 16 bytes of T as float32 and back.
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(const uint4& r, float (&f)[kN]) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  __device__ static uint4 pack(const float (&f)[kN]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void unpack(const uint4& r, float (&f)[kN]) {
    const uint32_t u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bf16 is the high half of a float32
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
  __device__ static uint4 pack(const float (&f)[kN]) {
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      u[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(u[0], u[1], u[2], u[3]);
  }
};

constexpr int kRowsPerBlock = 8;  // one warp a row
constexpr int kMaxVecs = 8;       // 16-byte vectors a lane, at most

// kVecs: 16-byte vectors a lane holds, ceil(n / kN / 32).
template <typename T, int kVecs>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
    layer_norm_warp_kernel(const T* __restrict__ x, const T* __restrict__ w,
                           const T* __restrict__ b, T* __restrict__ y,
                           float* __restrict__ mean_out,
                           float* __restrict__ rstd_out, long long rows,
                           int n, float eps) {
  using V = Vec16<T>;
  constexpr int kN = V::kN;
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int nv = n / kN;  // vectors in a row
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * n);
  const uint4* wr = reinterpret_cast<const uint4*>(w);
  const uint4* br = reinterpret_cast<const uint4*>(b);

  // the row stays as the 16-byte vectors it was read in, unpacked again in
  // each pass: half the registers of float copies
  uint4 xv[kVecs], wv[kVecs], bv[kVecs];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int c = i * 32 + lane;
    if (kVecs * 32 <= nv || c < nv) {
      xv[i] = xr[c];
      wv[i] = __ldg(wr + c);
      bv[i] = __ldg(br + c);
    }
  }
  float f[kN];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    if (kVecs * 32 <= nv || i * 32 + lane < nv) {
      V::unpack(xv[i], f);
#pragma unroll
      for (int e = 0; e < kN; ++e) s += f[e];
    }
  }
  const float mean = ptt::warp_sum(s) / n;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    if (kVecs * 32 <= nv || i * 32 + lane < nv) {
      V::unpack(xv[i], f);
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        const float d = f[e] - mean;
        ss += d * d;
      }
    }
  }
  const float rstd = rsqrtf(ptt::warp_sum(ss) / n + eps);

  uint4* yr = reinterpret_cast<uint4*>(y + row * n);
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int c = i * 32 + lane;
    if (kVecs * 32 <= nv || c < nv) {
      float wf[kN], bf[kN];
      V::unpack(xv[i], f);
      V::unpack(wv[i], wf);
      V::unpack(bv[i], bf);
#pragma unroll
      for (int e = 0; e < kN; ++e) f[e] = (f[e] - mean) * rstd * wf[e] + bf[e];
      yr[c] = V::pack(f);
    }
  }
  if (lane == 0) {
    if (mean_out != nullptr) mean_out[row] = mean;
    if (rstd_out != nullptr) rstd_out[row] = rstd;
  }
}

template <typename T>
int launch_warp(const T* x, const T* w, const T* b, T* y, float* mean,
                float* rstd, long long rows, int n, float eps,
                cudaStream_t st) {
  const int vecs = (n / Vec16<T>::kN + 31) / 32;
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  switch (vecs) {
#define PTT_LN_CASE(K)                                                      \
  case K:                                                                   \
    layer_norm_warp_kernel<T, K><<<blocks, kRowsPerBlock * 32, 0, st>>>(    \
        x, w, b, y, mean, rstd, rows, n, eps);                              \
    break;
    PTT_LN_CASE(1)
    PTT_LN_CASE(2)
    PTT_LN_CASE(3)
    PTT_LN_CASE(4)
    PTT_LN_CASE(5)
    PTT_LN_CASE(6)
    PTT_LN_CASE(7)
    PTT_LN_CASE(8)
#undef PTT_LN_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* y, void* mean,
           void* rstd, long long rows, int n, float eps, bool warp,
           cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* bt = static_cast<const T*>(b);
  T* yt = static_cast<T*>(y);
  float* mt = static_cast<float*>(mean);
  float* rt = static_cast<float*>(rstd);
  if (warp) return launch_warp<T>(xt, wt, bt, yt, mt, rt, rows, n, eps, st);
  const int threads = n >= 4096 ? 512 : 256;
  layer_norm_fwd_kernel<T><<<rows, threads, 0, st>>>(xt, wt, bt, yt, mt, rt,
                                                      n, eps);
  return static_cast<int>(cudaGetLastError());
}

bool aligned_16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// launches of each variant since the library was loaded: [block, warp]
std::atomic<long long> variant_launches[2];

}  // namespace

// x, y: [rows, n] contiguous; w, b: [n] in x's dtype; mean/rstd: [rows]
// float32 or null.
extern "C" int ptt_layer_norm_fwd(const void* x, const void* w, const void* b,
                                  void* y, void* mean, void* rstd,
                                  long long rows, int n, float eps, int dtype,
                                  void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  if (dtype != ptt::kF32 && dtype != ptt::kBF16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per_vec = dtype == ptt::kF32 ? 4 : 8;  // elements in 16 bytes
  const bool warp = n % per_vec == 0 && n <= 32 * kMaxVecs * per_vec &&
                    aligned_16(x) && aligned_16(w) && aligned_16(b) &&
                    aligned_16(y);
  ++variant_launches[warp];
  if (dtype == ptt::kF32)
    return launch<float>(x, w, b, y, mean, rstd, rows, n, eps, warp, st);
  return launch<__nv_bfloat16>(x, w, b, y, mean, rstd, rows, n, eps, warp,
                               st);
}

// How many launches took the block-per-row kernel (variant 0) or the
// warp-per-row vector kernel (variant 1) since the library was loaded.
extern "C" long long ptt_layer_norm_variant_launches(int variant) {
  return variant == 0 || variant == 1 ? variant_launches[variant].load() : -1;
}
