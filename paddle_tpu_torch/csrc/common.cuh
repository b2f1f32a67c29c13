// Shared helpers of the port's CUDA kernels (sm_90a).
//
// Every kernel reads float32, bfloat16 or float16 and does its arithmetic
// in float32, as the Pallas kernels it replaces do.  Each C entry point takes
// the CUDA stream as a void*, launches on it, never synchronises and
// returns cudaGetLastError() so the Python wrapper can raise at once.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptt {

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch casts
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);  // round to nearest even, as torch casts
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

template <>
struct Vec16<__half> {
  static constexpr int kN = 8;
  __device__ static void unpack(const uint4& r, float (&f)[kN]) {
    const uint32_t u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v =
          __half22float2(*reinterpret_cast<const __half2*>(&u[i]));
      f[2 * i] = v.x;
      f[2 * i + 1] = v.y;
    }
  }
  __device__ static uint4 pack(const float (&f)[kN]) {
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __half2 h = __floats2half2_rn(f[2 * i], f[2 * i + 1]);
      u[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(u[0], u[1], u[2], u[3]);
  }
};

// kN consecutive elements of W, read as whole 16-byte vectors (one for
// kN elements of a 16-bit W beside kN of the same type; two when W is
// float32 beside kN = 8 of a 16-bit type: a float32 weight or bias beside
// 16-bit activations), and unpacked to float32.
template <typename W, int kN>
struct VecN {
  static constexpr int kPer = Vec16<W>::kN;
  static constexpr int kU = kN / kPer;
  static_assert(kN % kPer == 0, "whole 16-byte vectors");
  uint4 u[kU];
  // through the read-only cache: p on a 16-byte boundary
  __device__ void load(const W* p) {
#pragma unroll
    for (int i = 0; i < kU; ++i)
      u[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
  }
  __device__ void unpack(float (&f)[kN]) const {
#pragma unroll
    for (int i = 0; i < kU; ++i) {
      float g[kPer];
      Vec16<W>::unpack(u[i], g);
#pragma unroll
      for (int e = 0; e < kPer; ++e) f[i * kPer + e] = g[e];
    }
  }
};

// Whether a pointer lies on a 16-byte boundary (a Vec16 load or store).
inline bool aligned_16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
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

// Streaming multiprocessors of the current device (asked once).
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

}  // namespace ptt
