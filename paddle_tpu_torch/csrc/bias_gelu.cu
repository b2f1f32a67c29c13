// Fused bias + exact-erf GeLU, forward y = gelu(x + b) and backward
// dx = dy * gelu'(x + b).
//
// Replace paddle_tpu/ops/pallas/bias_gelu.py `_fwd_kernel` and
// `_bwd_kernel` (both called from `_row_call`).  Both are bound by bytes:
// the forward reads x and writes y once per element, the backward reads x
// and dy and writes dx once, with a few dozen flops each.  All arithmetic
// is in float32 (as bias_gelu.py:42 and :47 do); the backward recomputes
// u = x + b instead of saving it, as the Pallas kernel does.  db, the
// row-sum of dx, is left to the caller, as `_bg_bwd` leaves it to XLA.  Any
// row count: the Pallas `rows % 8` refusal was a TPU tiling artefact.
//
// The forward is an elementwise grid-stride loop with scalar loads.  The
// backward has two kernels; its C entry picks one from the width and the
// pointers' alignment alone, and counts the choice:
//
// `bias_gelu_bwd_vec_kernel` (x, b, dy, dx on 16-byte boundaries, F a
// multiple of one 16-byte vector: every path of the models) indexes by
// (row, 16-byte column vector): a thread owns one column vector, loads its
// bias vector once and walks kRows rows of it, issuing all 2 * kRows
// 16-byte loads of x and dy before it computes, so each thread keeps
// 2 * kRows * 16 bytes in flight; dx leaves as 16-byte vectors.  No 64-bit
// `%` per element: the bias offset is the thread's column.  A block is 128
// column vectors wide (F = 3072 bf16: 3 blocks a row band) and a row band
// of kRows = 8 rows tall, so R = 8192 gives 3072 blocks, about 23 a SM.
//
// `bias_gelu_bwd_kernel` (any other width or alignment) is the scalar
// grid-stride loop, one element a thread, with the bias found by `i % n`.
#include <atomic>

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

constexpr int kVecThreads = 128;  // column vectors a block
constexpr int kRows = 8;          // rows a thread walks, loads in flight

template <typename T>
__global__ void __launch_bounds__(kVecThreads, 4)
    bias_gelu_bwd_vec_kernel(const T* __restrict__ x,
                             const T* __restrict__ b,
                             const T* __restrict__ dy, T* __restrict__ dx,
                             long long rows, int nv) {
  using V = ptt::Vec16<T>;
  constexpr int kN = V::kN;
  const int c = blockIdx.x * kVecThreads + threadIdx.x;  // column vector
  if (c >= nv) return;
  float bf[kN];
  V::unpack(__ldg(reinterpret_cast<const uint4*>(b) + c), bf);
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* dyv = reinterpret_cast<const uint4*>(dy);
  uint4* dxv = reinterpret_cast<uint4*>(dx);
  for (long long r0 = static_cast<long long>(blockIdx.y) * kRows; r0 < rows;
       r0 += static_cast<long long>(gridDim.y) * kRows) {
    uint4 xr[kRows], dyr[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (r0 + i < rows) {
        const long long at = (r0 + i) * nv + c;
        xr[i] = xv[at];
        dyr[i] = dyv[at];
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (r0 + i >= rows) break;
      float u[kN], g[kN];
      V::unpack(xr[i], u);
      V::unpack(dyr[i], g);
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        const float ue = u[e] + bf[e];
        const float cdf = 0.5f * (1.f + erff(ue * 0.70710678118654752f));
        const float pdf = expf(-0.5f * ue * ue) * 0.3989422804014327f;
        g[e] *= cdf + ue * pdf;
      }
      dxv[(r0 + i) * nv + c] = V::pack(g);
    }
  }
}

// launches of each backward kernel since the library was loaded:
// [scalar, vec]
std::atomic<long long> bwd_variant_launches[2];

template <typename T>
int launch_bwd(const void* x, const void* b, const void* dy, void* dx,
               long long total, int n, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(b);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  constexpr int kN = ptt::Vec16<T>::kN;
  const bool vec = n % kN == 0 && ptt::aligned_16(x) && ptt::aligned_16(b) &&
                   ptt::aligned_16(dy) && ptt::aligned_16(dx);
  ++bwd_variant_launches[vec];
  if (vec) {
    const int nv = n / kN;
    const long long rows = total / n;
    const long long bands = (rows + kRows - 1) / kRows;
    const dim3 grid((nv + kVecThreads - 1) / kVecThreads,
                    static_cast<unsigned>(bands < 65535 ? bands : 65535));
    bias_gelu_bwd_vec_kernel<T><<<grid, kVecThreads, 0, st>>>(
        xt, bt, dyt, dxt, rows, nv);
  } else {
    const int threads = 256;
    bias_gelu_bwd_kernel<T><<<grid_for(total, threads), threads, 0, st>>>(
        xt, bt, dyt, dxt, total, n);
  }
  return static_cast<int>(cudaGetLastError());
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kF32) return launch_bwd<float>(x, b, dy, dx, total, n, st);
  if (dtype == ptt::kBF16)
    return launch_bwd<__nv_bfloat16>(x, b, dy, dx, total, n, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// How many backward launches took the scalar kernel (variant 0) or the
// 16-byte vector kernel (variant 1) since the library was loaded.
extern "C" long long ptt_bias_gelu_bwd_variant_launches(int variant) {
  return variant == 0 || variant == 1 ? bwd_variant_launches[variant].load()
                                      : -1;
}
