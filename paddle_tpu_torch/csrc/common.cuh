// Shared helpers of the port's CUDA kernels (sm_90a).
//
// Every kernel reads float32 or bfloat16 and does its arithmetic in
// float32, as the Pallas kernels it replaces do.  Each C entry point takes
// the CUDA stream as a void*, launches on it, never synchronises and
// returns cudaGetLastError() so the Python wrapper can raise at once.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ptt {

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch casts
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the whole block; every thread gets the result.  `red` holds at
// least 32 floats of shared memory.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  __syncthreads();  // a previous call's readers of red[0] are done
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < n_warps ? red[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

// An additive float32 attention bias over [B, H, S_q, S_k], read through
// four element strides, 0 where a dimension is broadcast (a [B, 1, 1, S_k]
// padding mask is never materialised).  p == nullptr: no bias.
struct Bias {
  const float* p;
  long long b, h, q, k;

  // The whole block copies the kRows x kCols tile at (q0, k0) of plane
  // (bi, hi) into tile[row][col]; entries outside [S_q, S_k] are 0.
  template <int kRows, int kCols>
  __device__ __forceinline__ void stage(float (*tile)[kCols + 1], int bi,
                                        int hi, int q0, int k0, int s_q,
                                        int s_k) const {
    const long long base = bi * b + hi * h;
    for (int e = threadIdx.x; e < kRows * kCols; e += blockDim.x) {
      const int i = e / kCols, j = e % kCols, qi = q0 + i, kj = k0 + j;
      tile[i][j] = (qi < s_q && kj < s_k) ? p[base + qi * q + kj * k] : 0.f;
    }
  }
};

}  // namespace ptt
