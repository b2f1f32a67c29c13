// The whole-tree optimizer update: every parameter of one (device, dtype)
// group, with its gradient and its slots, updated by ONE launch.
//
// Replaces what `Optimizer.apply_pytree` (paddle_tpu/optimizer/__init__.py
// :155) gives the reference: one update over the whole parameter tree,
// fused by XLA into the jitted, donated train step
// (paddle_tpu/hapi/engine.py:517).  It is not a pallas_call; the port's
// eager loop made about 17 launches a parameter instead (148 parameters a
// GPT-2-small step, 206 a BERT-base step).  Rules: SGD, Momentum (plain
// and Nesterov), Adam and AdamW, as paddle_tpu_torch/optimizer computes
// them.
//
// Bound by bytes: each element's p and g are read once, p written once,
// and each slot read and written once (bf16 Adam: 2 + 2 + 2 + 4 * 4 = 22
// bytes an element), with about 15 flops.
//
// Design.  The host passes a table of per-tensor pointers (p, g, two
// slots), element counts and each tensor's first chunk as ONE kernel
// parameter (`__grid_constant__`, up to 32,764 bytes of parameters on
// CUDA >= 12.1, sm_70+), so a step never synchronises.  The nine scalars
// (`Hyper`) are read from device memory, which the host writes before the
// launch (ops/kernels/optimizer.py): the learning rate and the bias
// corrections of the step change every step, and a launch captured in a
// CUDA graph keeps its parameters, so the captured training step reads
// this step's values where a parameter would hold the capture's.  Each block takes one fixed-size chunk of one tensor,
// found by a binary search of the chunk prefix (uniform over the block,
// read from the constant bank), so the 38.6 M-element embedding and a
// 768-element bias are cut into like pieces of work.  A tensor whose
// pointers all lie on 16-byte boundaries is walked four elements a thread
// (8 or 16-byte loads and stores), two such vectors in flight; any other
// tensor element by element.
//
// Rounding.  The result is bitwise what the eager per-parameter loop
// (`Optimizer.step_plain`) gives on the card: each eager op rounds once to
// float32, or to bf16 where its result is a bf16 tensor, and this kernel
// copies that op for op with `__fmul_rn`, `__fadd_rn`, `__fsub_rn`,
// `__fdiv_rn` and `__fsqrt_rn` (no FMA contraction), rounding through
// bf16 or float16 where the eager op's result is a tensor of that type
// (float16 parameters: AMP-O2 after `amp.decorate`, whose AdamW keeps
// float32 moments and float16 parameters, as the reference's dygraph
// loop does).  The scalars arrive as the
// float32 values the eager ops use: each Python scalar cast to float32
// (`lr`, `beta1`, `1 - beta1`, `eps`, `lr * wd` formed in double first), and
// `m / bias_correction` as the eager CUDA division by a host scalar does
// it, a multiply by the float32 reciprocal `1.0f / float(bc)`.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kMaxTensors = 512;  // tensors a launch (the table's rows)
constexpr int kThreads = 256;

enum Kind { kSGD = 0, kMomentum = 1, kNesterov = 2, kAdam = 3, kAdamW = 4 };

// The update's scalars, each the float32 value the eager op uses.
struct Hyper {
  float lr;
  float beta1;    // Momentum: the momentum
  float omb1;     // 1 - beta1
  float beta2;
  float omb2;     // 1 - beta2
  float inv_bc1;  // 1.0f / float32(1 - beta1 ** t)
  float inv_bc2;  // 1.0f / float32(1 - beta2 ** t)
  float eps;
  float lr_wd;    // lr * weight decay (AdamW)
};

struct Table {
  void* p[kMaxTensors];
  const void* g[kMaxTensors];
  void* s0[kMaxTensors];
  void* s1[kMaxTensors];
  long long n[kMaxTensors];
  int chunk0[kMaxTensors + 1];  // first chunk of each tensor; [count] = all
  int count;
  int chunk;                    // elements a chunk, a multiple of 4
};

__device__ __forceinline__ bool on_16(const void* q) {
  return reinterpret_cast<uintptr_t>(q) % 16 == 0;
}

// Round to T and back: what storing an eager op's result in a T tensor does.
template <typename T>
__device__ __forceinline__ float rt(float x) {
  return ptt::to_f32(ptt::from_f32<T>(x));
}

// The slots' type: Adam-family moments are float32 for any parameter,
// Momentum's velocity has the parameter's dtype.
template <typename T, int K>
struct Slot {
  using type = typename std::conditional<(K >= kAdam), float, T>::type;
};

template <typename T, int K>
__device__ __forceinline__ void update(float& p, float g, float& s0,
                                       float& s1, const Hyper& h) {
  if (K == kSGD) {                                      // p - lr * g
    p = rt<T>(__fsub_rn(p, rt<T>(__fmul_rn(g, h.lr))));
  } else if (K == kMomentum || K == kNesterov) {
    const float v = rt<T>(__fadd_rn(rt<T>(__fmul_rn(s0, h.beta1)), g));
    s0 = v;                                             // mu * v + g
    const float step =
        K == kNesterov  // lr * (g + mu * v), else lr * v
            ? rt<T>(__fmul_rn(
                  rt<T>(__fadd_rn(g, rt<T>(__fmul_rn(v, h.beta1)))), h.lr))
            : rt<T>(__fmul_rn(v, h.lr));
    p = rt<T>(__fsub_rn(p, step));
  } else {
    const float m = __fadd_rn(__fmul_rn(s0, h.beta1), __fmul_rn(g, h.omb1));
    const float v =
        __fadd_rn(__fmul_rn(s1, h.beta2), __fmul_rn(__fmul_rn(g, g), h.omb2));
    s0 = m;
    s1 = v;
    // lr * mhat / (sqrt(vhat) + eps), cast to p's dtype
    const float num = __fmul_rn(__fmul_rn(m, h.inv_bc1), h.lr);
    const float den = __fadd_rn(__fsqrt_rn(__fmul_rn(v, h.inv_bc2)), h.eps);
    float np = rt<T>(__fsub_rn(p, rt<T>(__fdiv_rn(num, den))));
    if (K == kAdamW)  // decoupled decay: new_p - (lr * wd) * p_old
      np = rt<T>(__fsub_rn(np, rt<T>(__fmul_rn(p, h.lr_wd))));
    p = np;
  }
}

// Four consecutive elements as float32 and back (16 bytes of float32, 8
// of bf16 or float16).
__device__ __forceinline__ void load4(const float* q, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(q);
  f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* q, float (&f)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(q);
  f[0] = __uint_as_float(v.x << 16);
  f[1] = __uint_as_float(v.x & 0xffff0000u);
  f[2] = __uint_as_float(v.y << 16);
  f[3] = __uint_as_float(v.y & 0xffff0000u);
}
__device__ __forceinline__ void load4(const __half* q, float (&f)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(q);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&v.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&v.y));
  f[0] = a.x, f[1] = a.y, f[2] = b.x, f[3] = b.y;
}
__device__ __forceinline__ void store4(float* q, const float (&f)[4]) {
  *reinterpret_cast<float4*>(q) = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* q, const float (&f)[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(f[0], f[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(f[2], f[3]);
  *reinterpret_cast<uint2*>(q) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                 *reinterpret_cast<const uint32_t*>(&b));
}
__device__ __forceinline__ void store4(__half* q, const float (&f)[4]) {
  const __half2 a = __floats2half2_rn(f[0], f[1]);
  const __half2 b = __floats2half2_rn(f[2], f[3]);
  *reinterpret_cast<uint2*>(q) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                 *reinterpret_cast<const uint32_t*>(&b));
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    multi_tensor_kernel(__grid_constant__ const Table tab,
                        const Hyper* __restrict__ hyper) {
  using S = typename Slot<T, K>::type;
  const Hyper h = *hyper;
  constexpr int kSlots = K == kSGD ? 0 : (K >= kAdam ? 2 : 1);
  // the tensor of this block's chunk: the last t with chunk0[t] <= chunk
  const int chunk = blockIdx.x;
  int lo = 0, hi = tab.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tab.chunk0[mid] <= chunk) lo = mid; else hi = mid - 1;
  }
  const int t = lo;
  T* __restrict__ p = static_cast<T*>(tab.p[t]);
  const T* __restrict__ g = static_cast<const T*>(tab.g[t]);
  S* __restrict__ s0 = static_cast<S*>(tab.s0[t]);
  S* __restrict__ s1 = static_cast<S*>(tab.s1[t]);
  const long long begin =
      static_cast<long long>(chunk - tab.chunk0[t]) * tab.chunk;
  const long long end =
      begin + tab.chunk < tab.n[t] ? begin + tab.chunk : tab.n[t];
  const bool vec = on_16(p) && on_16(g) && on_16(s0) && on_16(s1);
  long long tail = begin;
  if (vec) {
    tail = begin + (end - begin) / 4 * 4;
    constexpr long long kStride = 4 * kThreads;
    for (long long i = begin + 4 * threadIdx.x; i < tail; i += 2 * kStride) {
      const bool two = i + kStride < tail;
      float pf[2][4], gf[2][4], a[2][4] = {}, b[2][4] = {};
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (k == 1 && !two) break;
        const long long at = i + k * kStride;
        load4(p + at, pf[k]);
        load4(g + at, gf[k]);
        if (kSlots >= 1) load4(s0 + at, a[k]);
        if (kSlots >= 2) load4(s1 + at, b[k]);
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (k == 1 && !two) break;
        const long long at = i + k * kStride;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          update<T, K>(pf[k][e], gf[k][e], a[k][e], b[k][e], h);
        store4(p + at, pf[k]);
        if (kSlots >= 1) store4(s0 + at, a[k]);
        if (kSlots >= 2) store4(s1 + at, b[k]);
      }
    }
  }
  for (long long i = tail + threadIdx.x; i < end; i += kThreads) {
    float pf = ptt::to_f32(p[i]), a = 0.f, b = 0.f;
    if (kSlots >= 1) a = ptt::to_f32(s0[i]);
    if (kSlots >= 2) b = ptt::to_f32(s1[i]);
    update<T, K>(pf, ptt::to_f32(g[i]), a, b, h);
    p[i] = ptt::from_f32<T>(pf);
    if (kSlots >= 1) s0[i] = ptt::from_f32<S>(a);
    if (kSlots >= 2) s1[i] = ptt::from_f32<S>(b);
  }
}

template <typename T>
int launch(int kind, const Table& tab, const Hyper* h, cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>(tab.chunk0[tab.count]);
  switch (kind) {
    case kSGD:
      multi_tensor_kernel<T, kSGD><<<blocks, kThreads, 0, st>>>(tab, h);
      break;
    case kMomentum:
      multi_tensor_kernel<T, kMomentum><<<blocks, kThreads, 0, st>>>(tab, h);
      break;
    case kNesterov:
      multi_tensor_kernel<T, kNesterov><<<blocks, kThreads, 0, st>>>(tab, h);
      break;
    case kAdam:
      multi_tensor_kernel<T, kAdam><<<blocks, kThreads, 0, st>>>(tab, h);
      break;
    case kAdamW:
      multi_tensor_kernel<T, kAdamW><<<blocks, kThreads, 0, st>>>(tab, h);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One update of `count` tensors (at most kMaxTensors, which the host's
// MAX_TENSORS in ops/kernels/optimizer.py matches; a larger tree is split):
// p[i], g[i] in `dtype`, slots s0[i], s1[i] (nullptr where the rule has
// fewer), n[i] elements each, all contiguous on one device; chunk0[i] the
// first chunk of tensor i in chunks of `chunk` elements (a multiple of 4),
// chunk0[count] the number of chunks; `hyper` a DEVICE pointer to the nine
// floats of Hyper, in its order, which the launch reads when it runs.
extern "C" int ptt_multi_tensor_step(int kind, int dtype, int count,
                                     void* const* p, void* const* g,
                                     void* const* s0, void* const* s1,
                                     const long long* n, const int* chunk0,
                                     int chunk, const void* hyper,
                                     void* stream) {
  if (count < 0 || count > kMaxTensors || chunk <= 0 || chunk % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (count == 0 || chunk0[count] == 0) return 0;
  thread_local Table tab;  // 22.5 KB: off the caller's stack
  for (int i = 0; i < count; ++i) {
    tab.p[i] = p[i];
    tab.g[i] = g[i];
    tab.s0[i] = s0[i];
    tab.s1[i] = s1[i];
    tab.n[i] = n[i];
    tab.chunk0[i] = chunk0[i];
  }
  tab.chunk0[count] = chunk0[count];
  tab.count = count;
  tab.chunk = chunk;
  if (hyper == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const Hyper* h = static_cast<const Hyper*>(hyper);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kF32) return launch<float>(kind, tab, h, st);
  if (dtype == ptt::kBF16) return launch<__nv_bfloat16>(kind, tab, h, st);
  if (dtype == ptt::kF16) return launch<__half>(kind, tab, h, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
