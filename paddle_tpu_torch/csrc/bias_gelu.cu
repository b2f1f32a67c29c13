// Fused bias + exact-erf GeLU, forward y = gelu(x + b) and backward
// dx = dy * gelu'(x + b).
//
// Replace paddle_tpu/ops/pallas/bias_gelu.py `_fwd_kernel` and
// `_bwd_kernel` (both called from `_row_call`).  Both are bound by bytes:
// the forward reads x and writes y once per element, the backward reads x
// and dy and writes dx once, with a few dozen flops each.  Each is an
// elementwise grid-stride loop with all arithmetic in float32 (as
// bias_gelu.py:42 and :47 do), sized to a few waves of blocks per SM; the
// backward recomputes u = x + b instead of saving it, as the Pallas kernel
// does.  db, the row-sum of dx, is left to the caller, as `_bg_bwd`
// leaves it to XLA.  Any row count: the Pallas `rows % 8` refusal was a
// TPU tiling artefact.
#include "common.cuh"

namespace {

template <typename T>
__global__ void bias_gelu_fwd_kernel(const T* __restrict__ x,
                                     const T* __restrict__ b,
                                     T* __restrict__ y, long long total,
                                     int n) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += step) {
    const float u = ptt::to_f32(x[i]) + ptt::to_f32(b[i % n]);
    y[i] = ptt::from_f32<T>(0.5f * u * (1.f + erff(u * 0.70710678118654752f)));
  }
}

template <typename T>
__global__ void bias_gelu_bwd_kernel(const T* __restrict__ x,
                                     const T* __restrict__ b,
                                     const T* __restrict__ dy,
                                     T* __restrict__ dx, long long total,
                                     int n) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += step) {
    const float u = ptt::to_f32(x[i]) + ptt::to_f32(b[i % n]);
    const float cdf = 0.5f * (1.f + erff(u * 0.70710678118654752f));
    const float pdf = expf(-0.5f * u * u) * 0.3989422804014327f;
    dx[i] = ptt::from_f32<T>(ptt::to_f32(dy[i]) * (cdf + u * pdf));
  }
}

long long grid_for(long long total, int threads) {
  const long long blocks = (total + threads - 1) / threads;
  return blocks > 132 * 16 ? 132 * 16 : blocks;
}

}  // namespace

// x, y: [total / n, n] contiguous; b: [n] in x's dtype.
extern "C" int ptt_bias_gelu_fwd(const void* x, const void* b, void* y,
                                 long long total, int n, int dtype,
                                 void* stream) {
  if (total <= 0 || n <= 0) return 0;
  const int threads = 256;
  const long long blocks = grid_for(total, threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kF32) {
    bias_gelu_fwd_kernel<float><<<blocks, threads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(b),
        static_cast<float*>(y), total, n);
  } else if (dtype == ptt::kBF16) {
    bias_gelu_fwd_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(b),
        static_cast<__nv_bfloat16*>(y), total, n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, dy, dx: [total / n, n] contiguous; b: [n]; all in one dtype.
extern "C" int ptt_bias_gelu_bwd(const void* x, const void* b, const void* dy,
                                 void* dx, long long total, int n, int dtype,
                                 void* stream) {
  if (total <= 0 || n <= 0) return 0;
  const int threads = 256;
  const long long blocks = grid_for(total, threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kF32) {
    bias_gelu_bwd_kernel<float><<<blocks, threads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(b),
        static_cast<const float*>(dy), static_cast<float*>(dx), total, n);
  } else if (dtype == ptt::kBF16) {
    bias_gelu_bwd_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(b),
        static_cast<const __nv_bfloat16*>(dy),
        static_cast<__nv_bfloat16*>(dx), total, n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
