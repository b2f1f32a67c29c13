// check_finite_and_unscale: every gradient of one (device, dtype) group
// multiplied by 1 / loss scale in place, and a found-inf flag set when any
// unscaled element is not finite, in ONE launch.
//
// Replaces what the reference's dynamic loss scaling does in XLA:
// `GradScaler.unscale_` (paddle_tpu/amp/__init__.py:127-139, one
// `g * inv` and one `jnp.any(~jnp.isfinite(g))` a parameter, each read
// back to the host) and the functional `check_finite_and_unscale`
// (:187-197, fused by XLA inside the jitted step).  It is no pallas_call.
//
// Bound by bytes: each element is read and written once (2 + 2 bytes in
// float16), with one multiply and one compare.
//
// Design.  The table of the gradients' pointers, element counts and first
// chunks is one `__grid_constant__` kernel parameter, with the chunking of
// the multi-tensor optimizer (multi_tensor_optim.cu, ops/kernels/
// optimizer.py `chunk_groups`): a block takes one fixed-size chunk of one
// tensor, found by a binary search of the chunk prefix, so a 14 M-element
// embedding and a 768-element bias balance.  1 / scale is read from a
// float32 device word that the host writes before the launch (no sync,
// and a captured launch reads the scale of its replay).  A tensor on
// 16-byte boundaries is walked as 16-byte vectors (8 16-bit or 4 float32
// elements a thread), any other element by element.  Each element becomes
// float32, is multiplied by inv_scale with `__fmul_rn` and rounds back to
// the gradient's type (round to nearest even, as torch casts): bitwise
// `(g.float() * inv_scale).to(g.dtype)`, the plain version
// (ops/kernels/amp.py).  A power-of-two scale makes the unscale exact
// except where an element becomes subnormal.  A thread that finds a value
// that is not finite writes 1 into the int32 flag, which the caller zeroed
// first: every writer writes the same word, so no atomics are needed.
#include "common.cuh"

namespace {

constexpr int kMaxTensors = 512;  // tensors a launch (the table's rows)
constexpr int kThreads = 256;

struct Table {
  void* g[kMaxTensors];
  long long n[kMaxTensors];
  int chunk0[kMaxTensors + 1];  // first chunk of each tensor; [count] = all
  int count;
  int chunk;                    // elements a chunk, a multiple of 8
};

__device__ __forceinline__ bool on_16(const void* q) {
  return reinterpret_cast<uintptr_t>(q) % 16 == 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    unscale_kernel(__grid_constant__ const Table tab,
                   const float* __restrict__ inv_scale,
                   int* __restrict__ found_inf) {
  using V = ptt::Vec16<T>;
  constexpr int kN = V::kN;
  const float inv = *inv_scale;
  // the tensor of this block's chunk: the last t with chunk0[t] <= chunk
  const int chunk = blockIdx.x;
  int lo = 0, hi = tab.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tab.chunk0[mid] <= chunk) lo = mid; else hi = mid - 1;
  }
  T* __restrict__ g = static_cast<T*>(tab.g[lo]);
  const long long begin =
      static_cast<long long>(chunk - tab.chunk0[lo]) * tab.chunk;
  const long long end =
      begin + tab.chunk < tab.n[lo] ? begin + tab.chunk : tab.n[lo];
  bool bad = false;
  long long tail = begin;
  if (on_16(g)) {
    tail = begin + (end - begin) / kN * kN;
    for (long long i = begin + kN * threadIdx.x; i < tail;
         i += kN * kThreads) {
      uint4* at = reinterpret_cast<uint4*>(g + i);
      float f[kN];
      V::unpack(*at, f);
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        f[e] = ptt::to_f32(ptt::from_f32<T>(__fmul_rn(f[e], inv)));
        bad |= !isfinite(f[e]);
      }
      *at = V::pack(f);
    }
  }
  for (long long i = tail + threadIdx.x; i < end; i += kThreads) {
    const T u = ptt::from_f32<T>(__fmul_rn(ptt::to_f32(g[i]), inv));
    bad |= !isfinite(ptt::to_f32(u));
    g[i] = u;
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) *found_inf = 1;
}

}  // namespace

// Unscale `count` gradients (at most kMaxTensors, which MAX_TENSORS in
// ops/kernels/optimizer.py matches; a larger group is split) of `dtype`,
// n[i] elements each, contiguous on one device, in place; chunk0[i] the
// first chunk of tensor i in chunks of `chunk` elements (a multiple of 8),
// chunk0[count] the number of chunks.  `inv_scale`: a DEVICE pointer to
// one float32, 1 / loss scale; `found_inf`: a DEVICE pointer to one int32,
// set to 1 if an unscaled element is inf or NaN and left as it is
// otherwise.
extern "C" int ptt_check_finite_and_unscale(int dtype, int count,
                                            void* const* g,
                                            const long long* n,
                                            const int* chunk0, int chunk,
                                            const void* inv_scale,
                                            void* found_inf, void* stream) {
  if (count < 0 || count > kMaxTensors || chunk <= 0 || chunk % 8 != 0 ||
      inv_scale == nullptr || found_inf == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (count == 0 || chunk0[count] == 0) return 0;
  thread_local Table tab;  // 10 KB: off the caller's stack
  for (int i = 0; i < count; ++i) {
    tab.g[i] = g[i];
    tab.n[i] = n[i];
    tab.chunk0[i] = chunk0[i];
  }
  tab.chunk0[count] = chunk0[count];
  tab.count = count;
  tab.chunk = chunk;
  const unsigned blocks = static_cast<unsigned>(chunk0[count]);
  const float* inv = static_cast<const float*>(inv_scale);
  int* found = static_cast<int*>(found_inf);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kF32)
    unscale_kernel<float><<<blocks, kThreads, 0, st>>>(tab, inv, found);
  else if (dtype == ptt::kBF16)
    unscale_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(tab, inv,
                                                                found);
  else if (dtype == ptt::kF16)
    unscale_kernel<__half><<<blocks, kThreads, 0, st>>>(tab, inv, found);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
