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
// x, y, dy and dx are float32, bfloat16 or float16; b is x's type, or
// float32 beside 16-bit x (AMP-O1: the FFN's 16-bit matmul output meets
// its float32 bias; the Pallas kernel adds them in float32,
// bias_gelu.py:42).  B, the bias's type, is a template parameter of every
// kernel; the outputs are in x's type.
//
// Forward and backward each have two kernels; each C entry picks one from
// the width and the pointers' alignment alone, and counts the choice:
//
// `bias_gelu_fwd_vec_kernel` and `bias_gelu_bwd_vec_kernel` (every operand
// on a 16-byte boundary, F a multiple of one 16-byte vector: every path of
// the models) index by (row, 16-byte column vector): a thread owns one
// column vector, loads its bias vector once and walks kRows rows of it,
// issuing all its 16-byte loads of those rows (x, and dy for the backward)
// before the first erff, so each thread keeps kRows loads of each operand
// in flight; the result leaves as 16-byte vectors.  No 64-bit `%` per
// element: the bias offset is the thread's column.  The backward's block
// is 128 column vectors wide (F = 3072 bf16: 3 blocks a row band) and
// kRows = 8 rows tall, so R = 8192 gives 3072 blocks, about 23 a SM.  The
// forward also runs at serving shapes (R = 8 a decode step, R <= 128 a
// prefill), where 8 rows a thread would leave three blocks for 132 SMs:
// its entry takes 8 rows a thread where that still gives at least two
// blocks a SM (the count read from the device), else one row a thread in
// blocks 64 column vectors wide (R = 8, F = 3072 bf16: 48 blocks of one
// 16-byte load each).
//
// `bias_gelu_fwd_kernel` and `bias_gelu_bwd_kernel` (any other width or
// alignment) are the scalar grid-stride loops, one element a thread, with
// the bias found by `i % n`.
#include <atomic>

#include "common.cuh"

namespace {

template <typename T, typename B>
__global__ void bias_gelu_fwd_kernel(const T* __restrict__ x,
                                     const B* __restrict__ b,
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

template <typename T, typename B>
__global__ void bias_gelu_bwd_kernel(const T* __restrict__ x,
                                     const B* __restrict__ b,
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

template <typename T, typename B>
__global__ void __launch_bounds__(kVecThreads, 4)
    bias_gelu_bwd_vec_kernel(const T* __restrict__ x,
                             const B* __restrict__ b,
                             const T* __restrict__ dy, T* __restrict__ dx,
                             long long rows, int nv) {
  using V = ptt::Vec16<T>;
  constexpr int kN = V::kN;
  const int c = blockIdx.x * kVecThreads + threadIdx.x;  // column vector
  if (c >= nv) return;
  float bf[kN];
  ptt::VecN<B, kN> bv;
  bv.load(b + c * kN);
  bv.unpack(bf);
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

template <typename T, typename B, int kRowsT>
__global__ void __launch_bounds__(kVecThreads, 4)
    bias_gelu_fwd_vec_kernel(const T* __restrict__ x,
                             const B* __restrict__ b, T* __restrict__ y,
                             long long rows, int nv) {
  using V = ptt::Vec16<T>;
  constexpr int kN = V::kN;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;  // column vector
  if (c >= nv) return;
  float bf[kN];
  ptt::VecN<B, kN> bv;
  bv.load(b + c * kN);
  bv.unpack(bf);
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  uint4* yv = reinterpret_cast<uint4*>(y);
  for (long long r0 = static_cast<long long>(blockIdx.y) * kRowsT; r0 < rows;
       r0 += static_cast<long long>(gridDim.y) * kRowsT) {
    uint4 xr[kRowsT];
#pragma unroll
    for (int i = 0; i < kRowsT; ++i) {
      if (r0 + i < rows) xr[i] = xv[(r0 + i) * nv + c];
    }
#pragma unroll
    for (int i = 0; i < kRowsT; ++i) {
      if (r0 + i >= rows) break;
      float u[kN];
      V::unpack(xr[i], u);
#pragma unroll
      for (int e = 0; e < kN; ++e) {
        const float ue = u[e] + bf[e];
        u[e] = 0.5f * ue * (1.f + erff(ue * 0.70710678118654752f));
      }
      yv[(r0 + i) * nv + c] = V::pack(u);
    }
  }
}

// launches of each forward kernel since the library was loaded:
// [scalar, vec]
std::atomic<long long> fwd_variant_launches[2];

template <typename T, typename B, int kRowsT>
void launch_fwd_vec(const T* x, const B* b, T* y, long long rows, int nv,
                    int width, cudaStream_t st) {
  const long long bands = (rows + kRowsT - 1) / kRowsT;
  const dim3 grid((nv + width - 1) / width,
                  static_cast<unsigned>(bands < 65535 ? bands : 65535));
  bias_gelu_fwd_vec_kernel<T, B, kRowsT><<<grid, width, 0, st>>>(x, b, y,
                                                                 rows, nv);
}

template <typename T, typename B>
int launch_fwd(const void* x, const void* b, void* y, long long total, int n,
               cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const B* bt = static_cast<const B*>(b);
  T* yt = static_cast<T*>(y);
  constexpr int kN = ptt::Vec16<T>::kN;
  const bool vec = n % kN == 0 && ptt::aligned_16(x) && ptt::aligned_16(b) &&
                   ptt::aligned_16(y);
  ++fwd_variant_launches[vec];
  if (!vec) {
    const int threads = 256;
    bias_gelu_fwd_kernel<T, B><<<grid_for(total, threads), threads, 0, st>>>(
        xt, bt, yt, total, n);
    return static_cast<int>(cudaGetLastError());
  }
  const int nv = n / kN;
  const long long rows = total / n;
  // kRows rows a thread where that still leaves two blocks a SM, else one
  const long long cols = (nv + kVecThreads - 1) / kVecThreads;
  if (cols * ((rows + kRows - 1) / kRows) >= 2LL * ptt::sm_count()) {
    launch_fwd_vec<T, B, kRows>(xt, bt, yt, rows, nv, kVecThreads, st);
  } else {
    launch_fwd_vec<T, B, 1>(xt, bt, yt, rows, nv, kVecThreads / 2, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// launches of each backward kernel since the library was loaded:
// [scalar, vec]
std::atomic<long long> bwd_variant_launches[2];

template <typename T, typename B>
int launch_bwd(const void* x, const void* b, const void* dy, void* dx,
               long long total, int n, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const B* bt = static_cast<const B*>(b);
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
    bias_gelu_bwd_vec_kernel<T, B><<<grid, kVecThreads, 0, st>>>(
        xt, bt, dyt, dxt, rows, nv);
  } else {
    const int threads = 256;
    bias_gelu_bwd_kernel<T, B><<<grid_for(total, threads), threads, 0, st>>>(
        xt, bt, dyt, dxt, total, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

namespace {

// x's type T and the bias's type B of a (dtype, bdtype) pair: B is T, or
// float32 beside a 16-bit T; anything else is refused.
template <template <typename, typename> class F, typename... Args>
int dispatch(int dtype, int bdtype, Args... args) {
  const bool mixed = dtype != ptt::kF32 && bdtype == ptt::kF32;
  if (bdtype != dtype && !mixed)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == ptt::kF32) return F<float, float>::run(args...);
  if (dtype == ptt::kBF16)
    return mixed ? F<__nv_bfloat16, float>::run(args...)
                 : F<__nv_bfloat16, __nv_bfloat16>::run(args...);
  if (dtype == ptt::kF16)
    return mixed ? F<__half, float>::run(args...)
                 : F<__half, __half>::run(args...);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, typename B>
struct Fwd {
  static int run(const void* x, const void* b, void* y, long long total,
                 int n, cudaStream_t st) {
    return launch_fwd<T, B>(x, b, y, total, n, st);
  }
};

template <typename T, typename B>
struct Bwd {
  static int run(const void* x, const void* b, const void* dy, void* dx,
                 long long total, int n, cudaStream_t st) {
    return launch_bwd<T, B>(x, b, dy, dx, total, n, st);
  }
};

}  // namespace

// x, y: [total / n, n] contiguous in `dtype`; b: [n] in `bdtype`, which is
// `dtype` or float32 beside a 16-bit `dtype`.
extern "C" int ptt_bias_gelu_fwd(const void* x, const void* b, void* y,
                                 long long total, int n, int dtype,
                                 int bdtype, void* stream) {
  if (total <= 0 || n <= 0) return 0;
  return dispatch<Fwd>(dtype, bdtype, x, b, y, total, n,
                       static_cast<cudaStream_t>(stream));
}

// x, dy, dx: [total / n, n] contiguous in `dtype`; b: [n] in `bdtype`, as
// above.
extern "C" int ptt_bias_gelu_bwd(const void* x, const void* b, const void* dy,
                                 void* dx, long long total, int n, int dtype,
                                 int bdtype, void* stream) {
  if (total <= 0 || n <= 0) return 0;
  return dispatch<Bwd>(dtype, bdtype, x, b, dy, dx, total, n,
                       static_cast<cudaStream_t>(stream));
}

// How many backward launches took the scalar kernel (variant 0) or the
// 16-byte vector kernel (variant 1) since the library was loaded.
extern "C" long long ptt_bias_gelu_bwd_variant_launches(int variant) {
  return variant == 0 || variant == 1 ? bwd_variant_launches[variant].load()
                                      : -1;
}

// How many forward launches took the scalar kernel (variant 0) or the
// 16-byte vector kernel (variant 1) since the library was loaded.
extern "C" long long ptt_bias_gelu_fwd_variant_launches(int variant) {
  return variant == 0 || variant == 1 ? fwd_variant_launches[variant].load()
                                      : -1;
}
