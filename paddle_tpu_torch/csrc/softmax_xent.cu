// Softmax cross entropy over the last axis with hard labels: forward
// (per-row loss and log-sum-exp) and backward (dz).
//
// Replaces paddle_tpu/ops/pallas/softmax_xent.py `_fwd_kernel` (called
// from `_fwd_call`) and `_bwd_kernel` (called from `_bwd_call`).  Both are
// bound by bytes: the forward reads the [N, V] logits once and writes two
// floats a row; the backward reads them once more and writes dz once, with
// one exp per element.
//
// Design for the card (not the TPU's vocab-tile grid):
// - Forward: one block per row, 256 threads (one warp when V < 2048, the
//   NSP head's V = 2 included).  Each thread keeps a running max and sum of
//   exp in float32 over its share of the row, read as 16-byte vectors (a
//   scalar head and tail cover a row that does not start on a 16-byte
//   boundary, as V = 30522 in bfloat16 does not); a block reduction merges
//   the (max, sum) pairs.  The label's logit is read directly: a GPU can
//   gather, so the TPU's one-hot select is not carried over.  A label
//   outside [0, V) picks 0, as the one-hot select does.  Rows with the
//   ignore index give loss 0.
// - Backward: a grid over rows x 2048-column chunks; each thread writes
//   dz = (exp(z - lse) - [col == label]) * g for 8 columns, coalesced, in
//   z's dtype.  Ignored rows are written as exact zeros without reading z.
// The logits' rows are addressed through two strides (row r starts at
// (r / inner) * so + (r % inner) * si), so the strided view logits[:, :-1]
// of the GPT loss is read in place; the vocab axis has unit stride.  Any N
// and any V: the TPU's lane and row padding were tiling artefacts.  The
// logits are float32, bfloat16 or float16 (AMP); loss and lse stay
// float32 (the wrapper casts the loss to the logits' dtype, as
// softmax_xent.py:205 does).
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBwdThreads = 256;
constexpr int kBwdPer = 8;  // columns per thread in the backward

struct Rows {
  long long so, si, inner;
  __device__ __forceinline__ long long offset(long long r) const {
    return (r / inner) * so + (r % inner) * si;
  }
};

// Fold one group of values, whose max is `lm`, into a running (max m, sum
// s of exp(x - m)).  An all -inf group adds nothing.
template <int N>
__device__ __forceinline__ void lse_add(float& m, float& s, const float* x,
                                        float lm) {
  if (lm == -INFINITY) return;
  const float mn = fmaxf(m, lm);
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j) acc += expf(x[j] - mn);
  s = s * expf(m - mn) + acc;  // expf(-inf) = 0 while m is still -inf
  m = mn;
}

__device__ __forceinline__ void lse_merge(float& m, float& s, float m2,
                                          float s2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;  // both sides empty
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

template <typename T>
__global__ void xent_fwd_kernel(const T* __restrict__ z, Rows rows, int V,
                                const long long* __restrict__ labels,
                                long long ignore, float* __restrict__ loss,
                                float* __restrict__ lse_out) {
  constexpr int kVec = 16 / sizeof(T);
  __shared__ float red_m[32], red_s[32];
  const long long r = blockIdx.x;
  const T* row = z + rows.offset(r);

  // elements before the row's first 16-byte boundary, then whole vectors
  const int mis =
      static_cast<int>((reinterpret_cast<uintptr_t>(row) & 15) / sizeof(T));
  const int head = min(V, mis ? kVec - mis : 0);
  const int n_vec = (V - head) / kVec;
  float m = -INFINITY, s = 0.f;
  for (int c = threadIdx.x; c < head; c += blockDim.x) {
    const float x = ptt::to_f32(row[c]);
    lse_add<1>(m, s, &x, x);
  }
  const uint4* body = reinterpret_cast<const uint4*>(row + head);
#pragma unroll 4
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x) {
    const uint4 raw = __ldg(body + i);
    const T* e = reinterpret_cast<const T*>(&raw);
    float x[kVec];
    float lm = -INFINITY;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      x[j] = ptt::to_f32(e[j]);
      lm = fmaxf(lm, x[j]);
    }
    lse_add<kVec>(m, s, x, lm);
  }
  for (int c = head + n_vec * kVec + threadIdx.x; c < V; c += blockDim.x) {
    const float x = ptt::to_f32(row[c]);
    lse_add<1>(m, s, &x, x);
  }

  // merge the (max, sum) pairs: within each warp, then across warps
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    lse_merge(m, s, m2, s2);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  if (n_warps > 1) {
    if (lane == 0) {
      red_m[warp] = m;
      red_s[warp] = s;
    }
    __syncthreads();
    if (warp == 0) {
      m = lane < n_warps ? red_m[lane] : -INFINITY;
      s = lane < n_warps ? red_s[lane] : 0.f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
        const float s2 = __shfl_xor_sync(0xffffffffu, s, o);
        lse_merge(m, s, m2, s2);
      }
    }
  }
  if (threadIdx.x == 0) {
    const float lse = m + logf(s);
    const long long label = labels[r];
    const float picked =
        (label >= 0 && label < V) ? ptt::to_f32(row[label]) : 0.f;
    loss[r] = label == ignore ? 0.f : lse - picked;
    lse_out[r] = lse;
  }
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
    xent_bwd_kernel(const T* __restrict__ z, Rows rows, int V,
                    const long long* __restrict__ labels, long long ignore,
                    const float* __restrict__ lse,
                    const float* __restrict__ g, T* __restrict__ dz) {
  const long long r = blockIdx.x;
  const int c0 = blockIdx.y * (kBwdThreads * kBwdPer) + threadIdx.x;
  const T* row = z + rows.offset(r);
  T* out = dz + r * V;
  const long long label = labels[r];
  if (label == ignore) {
#pragma unroll
    for (int i = 0; i < kBwdPer; ++i) {
      const int c = c0 + i * kBwdThreads;
      if (c < V) out[c] = ptt::from_f32<T>(0.f);
    }
    return;
  }
  const float l = lse[r], gr = g[r];
  float x[kBwdPer];
#pragma unroll
  for (int i = 0; i < kBwdPer; ++i) {  // all loads in flight first
    const int c = c0 + i * kBwdThreads;
    x[i] = c < V ? ptt::to_f32(row[c]) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kBwdPer; ++i) {
    const int c = c0 + i * kBwdThreads;
    if (c < V)
      out[c] = ptt::from_f32<T>((expf(x[i] - l) - (c == label ? 1.f : 0.f)) *
                                gr);
  }
}

template <typename T>
int launch_fwd(const void* z, Rows rows, long long n, int V,
               const void* labels, long long ignore, void* loss, void* lse,
               cudaStream_t st) {
  const int threads = V >= 2048 ? 256 : 32;
  xent_fwd_kernel<T><<<static_cast<unsigned>(n), threads, 0, st>>>(
      static_cast<const T*>(z), rows, V,
      static_cast<const long long*>(labels), ignore,
      static_cast<float*>(loss), static_cast<float*>(lse));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* z, Rows rows, long long n, int V,
               const void* labels, long long ignore, const void* lse,
               const void* g, void* dz, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(n),
                  (V + kBwdThreads * kBwdPer - 1) / (kBwdThreads * kBwdPer));
  xent_bwd_kernel<T><<<grid, kBwdThreads, 0, st>>>(
      static_cast<const T*>(z), rows, V,
      static_cast<const long long*>(labels), ignore,
      static_cast<const float*>(lse), static_cast<const float*>(g),
      static_cast<T*>(dz));
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(long long n, int V, long long inner) {
  return n > 0x7fffffffLL || inner <= 0 ||
         (V + kBwdThreads * kBwdPer - 1) / (kBwdThreads * kBwdPer) > 65535;
}

}  // namespace

// z: n rows of V logits, row r at element (r / inner) * so + (r % inner) *
// si, unit stride over the vocab; labels: [n] int64; loss, lse: [n]
// float32.
extern "C" int ptt_softmax_xent_fwd(const void* z, long long so, long long si,
                                    long long inner, long long n, int V,
                                    const void* labels, long long ignore,
                                    void* loss, void* lse, int dtype,
                                    void* stream) {
  if (n <= 0 || V <= 0) return 0;
  if (bad_shape(n, V, inner)) return static_cast<int>(cudaErrorInvalidValue);
  const Rows rows{so, si, inner};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kF32)
    return launch_fwd<float>(z, rows, n, V, labels, ignore, loss, lse, st);
  if (dtype == ptt::kBF16)
    return launch_fwd<__nv_bfloat16>(z, rows, n, V, labels, ignore, loss, lse,
                                     st);
  if (dtype == ptt::kF16)
    return launch_fwd<__half>(z, rows, n, V, labels, ignore, loss, lse, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// As above; lse, g: [n] float32; dz: [n, V] contiguous in z's dtype.
extern "C" int ptt_softmax_xent_bwd(const void* z, long long so, long long si,
                                    long long inner, long long n, int V,
                                    const void* labels, long long ignore,
                                    const void* lse, const void* g, void* dz,
                                    int dtype, void* stream) {
  if (n <= 0 || V <= 0) return 0;
  if (bad_shape(n, V, inner)) return static_cast<int>(cudaErrorInvalidValue);
  const Rows rows{so, si, inner};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kF32)
    return launch_bwd<float>(z, rows, n, V, labels, ignore, lse, g, dz, st);
  if (dtype == ptt::kBF16)
    return launch_bwd<__nv_bfloat16>(z, rows, n, V, labels, ignore, lse, g,
                                     dz, st);
  if (dtype == ptt::kF16)
    return launch_bwd<__half>(z, rows, n, V, labels, ignore, lse, g, dz, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
