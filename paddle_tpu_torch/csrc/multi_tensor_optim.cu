// The whole-tree optimizer update: every parameter of one (device, dtype)
// group, with its gradient and its slots, updated by ONE launch (two for
// the rules that need per-tensor norms).
//
// Replaces what `Optimizer.apply_pytree` (paddle_tpu/optimizer/__init__.py
// :155) gives the reference: one update over the whole parameter tree,
// fused by XLA into the jitted, donated train step
// (paddle_tpu/hapi/engine.py:517).  It is not a pallas_call; the port's
// eager loop made about 17 launches a parameter instead (148 parameters a
// GPT-2-small step, 206 a BERT-base step).  Rules, as
// paddle_tpu_torch/optimizer computes them:
//
// - `multi_tensor_kernel`: SGD, Momentum (plain and Nesterov), Adam, AdamW,
//   Adagrad, Adamax, Adadelta, RMSProp (plain and centered, with momentum)
//   and Ftrl, each after the coupled decay of the gradient (a float or
//   L2Decay: g + c p; L1Decay: g + c sign(p));
// - `norm_partials_kernel` then `norm_update_kernel`: Lamb (trust ratio
//   ||p|| / ||r||, r from the updated moments), LarsMomentum (local lr from
//   ||p|| and ||g||) and Dpsgd (each gradient clipped by its norm, Gaussian
//   noise added).
//
// Bound by bytes: each element's p and g are read once, p written once,
// and each slot read and written once (bf16 Adam: 2 + 2 + 2 + 4 * 4 = 22
// bytes an element), with about 15 flops.  The norm rules read p and g (and
// Lamb its moments) twice, once a launch: Lamb moves 2 + 2 + 2 * 2 * 2
// bytes an element in the first and 2 + 2 + 2 * 2 + 2 in the second.
//
// Design.  The host passes a table of per-tensor pointers (p, g, three
// slots), element counts and each tensor's first chunk as ONE kernel
// parameter (`__grid_constant__`, up to 32,764 bytes of parameters on
// CUDA >= 12.1, sm_70+; the table is 26.6 KB at 512 tensors), so a step
// never synchronises.  The sixteen scalars (`Hyper`) are read from device
// memory, which the host writes before the launch (ops/kernels/
// optimizer.py): the learning rate and the bias corrections of the step
// change every step, and a launch captured in a CUDA graph keeps its
// parameters, so the captured training step reads this step's values where
// a parameter would hold the capture's.  Each block takes one fixed-size
// chunk of one tensor, found by a binary search of the chunk prefix
// (uniform over the block, read from the constant bank), so the 38.6
// M-element embedding and a 768-element bias are cut into like pieces of
// work.  A tensor whose pointers all lie on 16-byte boundaries is walked
// four elements a thread (8 or 16-byte loads and stores); any other tensor
// element by element.
//
// The norm rules need a sum over a whole tensor before any element can be
// updated, and the blocks of one tensor run in no order.  So the first
// launch has each block write its chunk's float32 sums of squares to a
// scratch row (Lamb also writes its updated moments there), and the second
// has every block of a tensor sum that tensor's rows in one fixed order,
// form the ratio, and update its chunk.  No atomics: a replay is bitwise
// repeatable.  Dpsgd's noise is a counter-based draw (Philox4x32-10 of
// csrc/dropout.cuh keyed by the step's seed, counter (element / 4, tensor,
// 0, 0), then Box-Muller), so nothing is stored.
//
// Rounding.  The elementwise rules' result is bitwise what the eager
// per-parameter loop (`Optimizer.step_plain`) gives on the card: each eager
// op rounds once to float32, or to bf16 where its result is a bf16 tensor,
// and this kernel copies that op for op with `__fmul_rn`, `__fadd_rn`,
// `__fsub_rn`, `__fdiv_rn` and `__fsqrt_rn` (no FMA contraction), rounding
// through bf16 or float16 where the eager op's result is a tensor of that
// type (float16 parameters: AMP-O2 after `amp.decorate`, whose AdamW keeps
// float32 moments and float16 parameters, as the reference's dygraph loop
// does).  The scalars arrive as the float32 values the eager ops use: each
// Python scalar cast to float32 (`lr`, `beta1`, `1 - beta1`, `eps`,
// `lr * wd` formed in double first), and a division of a tensor by a host
// scalar (`m / bias_correction`, Ftrl's `/ lr`) as the eager CUDA op does
// it, a multiply by the reciprocal (`1.0f / bc` of the float32 bias
// correction; `float(1.0 / lr)` of a double lr).  Ftrl's
// `x ** lp` takes the kernel torch's pow dispatches to on the card (sqrt,
// rsqrt, reciprocal, square, else powf).  The norm rules' sums run in
// another order than torch's reductions, so they hold the loop to a
// relative tolerance (ops/kernels/optimizer.py NORM_RTOL), not bitwise.
#include <type_traits>

#include "common.cuh"
#include "dropout.cuh"

namespace {

constexpr int kMaxTensors = 512;  // tensors a launch (the table's rows)
constexpr int kThreads = 256;

enum Kind {
  kSGD = 0, kMomentum = 1, kNesterov = 2, kAdam = 3, kAdamW = 4,
  kAdagrad = 5, kAdamax = 6, kAdadelta = 7, kRMSProp = 8,
  kRMSPropCentered = 9, kFtrl = 10
};
enum NormKind { kLamb = 0, kLars = 1, kDpsgd = 2 };
enum Decay { kNoDecay = 0, kL2 = 1, kL1 = 2 };
// Ftrl's x ** lp as torch's pow(Tensor, Scalar) runs it on the card
enum Pow { kPowf = 0, kSqrt = 1, kRsqrt = 2, kReciprocal = 3, kSquare = 4 };

// The update's scalars, each the float32 value the eager op uses
// (ops/kernels/optimizer.py hyper_floats).
struct Hyper {
  float lr;
  float beta1;    // Momentum's and LARS's momentum; Adadelta's, RMSProp's rho
  float omb1;     // 1 - beta1
  float beta2;
  float omb2;     // 1 - beta2
  float inv_bc1;  // 1.0f / float32(1 - beta1 ** t)
  float inv_bc2;  // 1.0f / float32(1 - beta2 ** t)
  float eps;
  float lr_wd;    // lr * weight decay (AdamW)
  float wd;       // Lamb's or LARS's weight decay
  // the rule's own: Adamax a = lr / (1 - beta1 ** t); RMSProp a = the
  // momentum; Ftrl a = l1, b = 2 * l2, c = 1 / lr, d = -lr_power; LARS
  // a = the coefficient; Dpsgd a = 1 / clip, b = sigma, c = clip,
  // d = 1 / batch_size
  float a, b, c, d;
  float decay;    // the coupled decay's coefficient
  float unused;
};

struct Table {
  void* p[kMaxTensors];
  const void* g[kMaxTensors];
  void* s0[kMaxTensors];
  void* s1[kMaxTensors];
  void* s2[kMaxTensors];
  long long n[kMaxTensors];
  int chunk0[kMaxTensors + 1];  // first chunk of each tensor; [count] = all
  int count;
  int chunk;                    // elements a chunk, a multiple of 4
  int decay;                    // Decay of the gradient (elementwise rules)
  int pow_mode;                 // Pow (Ftrl)
  int base;                     // Dpsgd: the noise index of tensor 0
};

__device__ __forceinline__ bool on_16(const void* q) {
  return reinterpret_cast<uintptr_t>(q) % 16 == 0;
}

// Round to T and back: what storing an eager op's result in a T tensor does.
template <typename T>
__device__ __forceinline__ float rt(float x) {
  return ptt::to_f32(ptt::from_f32<T>(x));
}

// torch.sign of a float: 1, -1 or 0 (0 for +-0 and NaN).
__device__ __forceinline__ float sgn(float x) {
  return static_cast<float>((x > 0.f) - (x < 0.f));
}

// torch.maximum: NaN if either is NaN.
__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// The slots' type: Adam-family moments are float32 for any parameter,
// every other slot has the parameter's dtype.
template <typename T, int K>
struct Slot {
  using type =
      typename std::conditional<(K == kAdam || K == kAdamW), float, T>::type;
};

template <int K>
__host__ __device__ constexpr int n_slots() {
  return K == kSGD ? 0
         : (K == kMomentum || K == kNesterov || K == kAdagrad) ? 1
         : (K == kRMSProp || K == kRMSPropCentered) ? 3
                                                    : 2;
}

// x ** e in T as torch's pow(Tensor, Scalar) computes it on the card.
template <typename T>
__device__ __forceinline__ float pow_like_torch(float x, float e, int mode) {
  switch (mode) {
    case kSqrt: return rt<T>(__fsqrt_rn(x));
    case kRsqrt: return rt<T>(rsqrtf(x));
    case kReciprocal: return rt<T>(__fdiv_rn(1.f, x));
    case kSquare: return rt<T>(__fmul_rn(x, x));
    default: return rt<T>(powf(x, rt<T>(e)));
  }
}

template <typename T, int K>
__device__ __forceinline__ void update(float& p, float g, float& s0,
                                       float& s1, float& s2, const Hyper& h,
                                       int decay, int pow_mode) {
  // the coupled decay (Optimizer._apply_decay): g + c * p or g + c * sign(p)
  if (decay == kL2)
    g = rt<T>(__fadd_rn(g, rt<T>(__fmul_rn(p, h.decay))));
  else if (decay == kL1)
    g = rt<T>(__fadd_rn(g, rt<T>(__fmul_rn(sgn(p), h.decay))));
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
  } else if (K == kAdam || K == kAdamW) {
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
  } else if (K == kAdagrad) {
    // m = m + g^2; p - lr * g / (sqrt(m) + eps)
    const float m = rt<T>(__fadd_rn(s0, rt<T>(__fmul_rn(g, g))));
    s0 = m;
    const float den = rt<T>(__fadd_rn(rt<T>(__fsqrt_rn(m)), h.eps));
    p = rt<T>(__fsub_rn(p, rt<T>(__fdiv_rn(rt<T>(__fmul_rn(g, h.lr)), den))));
  } else if (K == kAdamax) {
    // m = b1 m + (1 - b1) g; u = max(b2 u, |g|);
    // p - (lr / (1 - b1 ** t)) * m / (u + eps)
    const float m = rt<T>(__fadd_rn(rt<T>(__fmul_rn(s0, h.beta1)),
                                    rt<T>(__fmul_rn(g, h.omb1))));
    const float u = max_nan(rt<T>(__fmul_rn(s1, h.beta2)), fabsf(g));
    s0 = m;
    s1 = u;
    const float den = rt<T>(__fadd_rn(u, h.eps));
    p = rt<T>(__fsub_rn(p, rt<T>(__fdiv_rn(rt<T>(__fmul_rn(m, h.a)), den))));
  } else if (K == kAdadelta) {
    // asg = rho asg + (1 - rho) g^2;
    // upd = g * sqrt(asu + eps) / sqrt(asg + eps);
    // asu = rho asu + (1 - rho) upd^2; p - lr * upd
    const float asg =
        rt<T>(__fadd_rn(rt<T>(__fmul_rn(s0, h.beta1)),
                        rt<T>(__fmul_rn(rt<T>(__fmul_rn(g, g)), h.omb1))));
    const float num =
        rt<T>(__fmul_rn(g, rt<T>(__fsqrt_rn(rt<T>(__fadd_rn(s1, h.eps))))));
    const float upd = rt<T>(
        __fdiv_rn(num, rt<T>(__fsqrt_rn(rt<T>(__fadd_rn(asg, h.eps))))));
    const float asu =
        rt<T>(__fadd_rn(rt<T>(__fmul_rn(s1, h.beta1)),
                        rt<T>(__fmul_rn(rt<T>(__fmul_rn(upd, upd)), h.omb1))));
    s0 = asg;
    s1 = asu;
    p = rt<T>(__fsub_rn(p, rt<T>(__fmul_rn(upd, h.lr))));
  } else if (K == kRMSProp || K == kRMSPropCentered) {
    // ms = rho ms + (1 - rho) g^2; centered: mg = rho mg + (1 - rho) g,
    // denom = sqrt(ms - mg^2 + eps), else sqrt(ms + eps);
    // mom = momentum * mom + lr * g / denom; p - mom
    const float ms =
        rt<T>(__fadd_rn(rt<T>(__fmul_rn(s0, h.beta1)),
                        rt<T>(__fmul_rn(rt<T>(__fmul_rn(g, g)), h.omb1))));
    float denom;
    if (K == kRMSPropCentered) {
      const float mg = rt<T>(__fadd_rn(rt<T>(__fmul_rn(s1, h.beta1)),
                                       rt<T>(__fmul_rn(g, h.omb1))));
      s1 = mg;
      denom = rt<T>(__fsqrt_rn(rt<T>(
          __fadd_rn(rt<T>(__fsub_rn(ms, rt<T>(__fmul_rn(mg, mg)))), h.eps))));
    } else {
      denom = rt<T>(__fsqrt_rn(rt<T>(__fadd_rn(ms, h.eps))));
    }
    const float mom =
        rt<T>(__fadd_rn(rt<T>(__fmul_rn(s2, h.a)),
                        rt<T>(__fdiv_rn(rt<T>(__fmul_rn(g, h.lr)), denom))));
    s0 = ms;
    s2 = mom;
    p = rt<T>(__fsub_rn(p, mom));
  } else if (K == kFtrl) {
    // sq' = sq + g^2; sigma = (sq'^lp - sq^lp) / lr;
    // lin' = lin + g - sigma p; quad = sq'^lp / lr + 2 l2;
    // p = |lin'| > l1 ? (sign(lin') l1 - lin') / quad : 0
    const float sq = rt<T>(__fadd_rn(s0, rt<T>(__fmul_rn(g, g))));
    const float pa = pow_like_torch<T>(sq, h.d, pow_mode);
    const float pb = pow_like_torch<T>(s0, h.d, pow_mode);
    const float sigma = rt<T>(__fmul_rn(rt<T>(__fsub_rn(pa, pb)), h.c));
    const float lin = rt<T>(__fsub_rn(rt<T>(__fadd_rn(s1, g)),
                                      rt<T>(__fmul_rn(sigma, p))));
    const float quad = rt<T>(__fadd_rn(rt<T>(__fmul_rn(pa, h.c)), h.b));
    const float pre = rt<T>(__fsub_rn(rt<T>(__fmul_rn(sgn(lin), h.a)), lin));
    s0 = sq;
    s1 = lin;
    // |lin'| > l1 compares in p's dtype: l1 rounded to it
    p = fabsf(lin) > rt<T>(h.a) ? rt<T>(__fdiv_rn(pre, quad)) : 0.f;
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

// Elements i .. i + 3 of q (those below `end`; 0 past it): one vector load
// where the group is whole and `vec`.
template <typename T>
__device__ __forceinline__ void load_group(const T* q, long long i,
                                           long long end, bool vec,
                                           float (&f)[4]) {
  if (vec && i + 4 <= end) {
    load4(q, f);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) f[e] = i + e < end ? ptt::to_f32(q[e]) : 0.f;
}
template <typename T>
__device__ __forceinline__ void store_group(T* q, long long i, long long end,
                                            bool vec, const float (&f)[4]) {
  if (vec && i + 4 <= end) {
    store4(q, f);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (i + e < end) q[e] = ptt::from_f32<T>(f[e]);
}

// The tensor of block `chunk`: the last t with chunk0[t] <= chunk.
__device__ __forceinline__ int tensor_of(const Table& tab, int chunk) {
  int lo = 0, hi = tab.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tab.chunk0[mid] <= chunk) lo = mid; else hi = mid - 1;
  }
  return lo;
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    multi_tensor_kernel(__grid_constant__ const Table tab,
                        const Hyper* __restrict__ hyper) {
  using S = typename Slot<T, K>::type;
  const Hyper h = *hyper;
  constexpr int kSlots = n_slots<K>();
  const int decay = tab.decay, pow_mode = tab.pow_mode;
  const int chunk = blockIdx.x;
  const int t = tensor_of(tab, chunk);
  T* __restrict__ p = static_cast<T*>(tab.p[t]);
  const T* __restrict__ g = static_cast<const T*>(tab.g[t]);
  S* __restrict__ s0 = static_cast<S*>(tab.s0[t]);
  S* __restrict__ s1 = static_cast<S*>(tab.s1[t]);
  S* __restrict__ s2 = static_cast<S*>(tab.s2[t]);
  const long long begin =
      static_cast<long long>(chunk - tab.chunk0[t]) * tab.chunk;
  const long long end =
      begin + tab.chunk < tab.n[t] ? begin + tab.chunk : tab.n[t];
  const bool vec = on_16(p) && on_16(g) && (kSlots < 1 || on_16(s0)) &&
                   (kSlots < 2 || on_16(s1)) && (kSlots < 3 || on_16(s2));
  long long tail = begin;
  if (vec) {
    tail = begin + (end - begin) / 4 * 4;
    constexpr long long kStride = 4 * kThreads;
    for (long long i = begin + 4 * threadIdx.x; i < tail; i += 2 * kStride) {
      const bool two = i + kStride < tail;
      float pf[2][4], gf[2][4], a[2][4] = {}, b[2][4] = {}, c[2][4] = {};
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (k == 1 && !two) break;
        const long long at = i + k * kStride;
        load4(p + at, pf[k]);
        load4(g + at, gf[k]);
        if (kSlots >= 1) load4(s0 + at, a[k]);
        if (kSlots >= 2) load4(s1 + at, b[k]);
        if (kSlots >= 3) load4(s2 + at, c[k]);
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (k == 1 && !two) break;
        const long long at = i + k * kStride;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          update<T, K>(pf[k][e], gf[k][e], a[k][e], b[k][e], c[k][e], h,
                       decay, pow_mode);
        store4(p + at, pf[k]);
        if (kSlots >= 1) store4(s0 + at, a[k]);
        if (kSlots >= 2) store4(s1 + at, b[k]);
        if (kSlots >= 3) store4(s2 + at, c[k]);
      }
    }
  }
  for (long long i = tail + threadIdx.x; i < end; i += kThreads) {
    float pf = ptt::to_f32(p[i]), a = 0.f, b = 0.f, c = 0.f;
    if (kSlots >= 1) a = ptt::to_f32(s0[i]);
    if (kSlots >= 2) b = ptt::to_f32(s1[i]);
    if (kSlots >= 3) c = ptt::to_f32(s2[i]);
    update<T, K>(pf, ptt::to_f32(g[i]), a, b, c, h, decay, pow_mode);
    p[i] = ptt::from_f32<T>(pf);
    if (kSlots >= 1) s0[i] = ptt::from_f32<S>(a);
    if (kSlots >= 2) s1[i] = ptt::from_f32<S>(b);
    if (kSlots >= 3) s2[i] = ptt::from_f32<S>(c);
  }
}

// ---------------------------------------------------------------------------
// The norm rules.  Every value below is what the eager op of
// ops/kernels/optimizer.py update_plain gives, op for op; only the norms'
// sums run in another order.

// Lamb's moments (in p's dtype, as the reference's zeros_like slots) and
// r = mhat / (sqrt(vhat) + eps) + wd * p in float32 (the bias-corrected
// moments are float32).
template <typename T>
__device__ __forceinline__ float lamb_r(float p, float m, float v,
                                        const Hyper& h) {
  const float den =
      __fadd_rn(__fsqrt_rn(__fmul_rn(v, h.inv_bc2)), h.eps);
  return __fadd_rn(__fdiv_rn(__fmul_rn(m, h.inv_bc1), den),
                   rt<T>(__fmul_rn(p, h.wd)));
}

template <typename T>
__device__ __forceinline__ void lamb_moments(float g, float& m, float& v,
                                             const Hyper& h) {
  m = rt<T>(__fadd_rn(rt<T>(__fmul_rn(m, h.beta1)),
                      rt<T>(__fmul_rn(g, h.omb1))));
  v = rt<T>(__fadd_rn(rt<T>(__fmul_rn(v, h.beta2)),
                      rt<T>(__fmul_rn(rt<T>(__fmul_rn(g, g)), h.omb2))));
}

// Sums of a block's (a, b), in a fixed order: a warp tree, then the warps
// in order.  The result is thread 0's.
__device__ __forceinline__ float2 block_sum2(float a, float b) {
  __shared__ float2 part[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, o));
    b = __fadd_rn(b, __shfl_xor_sync(0xffffffffu, b, o));
  }
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = make_float2(a, b);
  __syncthreads();
  float2 s = make_float2(0.f, 0.f);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w)
      s = make_float2(__fadd_rn(s.x, part[w].x), __fadd_rn(s.y, part[w].y));
  }
  return s;
}

// Launch 1: each chunk's float32 sums of squares, (||p||^2, ||r||^2) for
// Lamb (whose moments are updated here), (||p||^2, ||g||^2) for LARS,
// (0, ||g||^2) for Dpsgd, into partials[chunk].
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    norm_partials_kernel(__grid_constant__ const Table tab,
                         const Hyper* __restrict__ hyper,
                         float2* __restrict__ partials) {
  const Hyper h = *hyper;
  const int chunk = blockIdx.x;
  const int t = tensor_of(tab, chunk);
  const T* __restrict__ p = static_cast<const T*>(tab.p[t]);
  const T* __restrict__ g = static_cast<const T*>(tab.g[t]);
  T* __restrict__ s0 = static_cast<T*>(tab.s0[t]);
  T* __restrict__ s1 = static_cast<T*>(tab.s1[t]);
  const long long begin =
      static_cast<long long>(chunk - tab.chunk0[t]) * tab.chunk;
  const long long end =
      begin + tab.chunk < tab.n[t] ? begin + tab.chunk : tab.n[t];
  const bool vec = on_16(p) && on_16(g) &&
                   (K != kLamb || (on_16(s0) && on_16(s1)));
  float a = 0.f, b = 0.f;
  for (long long i = begin + 4 * threadIdx.x; i < end; i += 4 * kThreads) {
    float pf[4], gf[4];
    load_group(g + i, i, end, vec, gf);
    if (K != kDpsgd) load_group(p + i, i, end, vec, pf);
    if (K == kLamb) {
      float m[4], v[4];
      load_group(s0 + i, i, end, vec, m);
      load_group(s1 + i, i, end, vec, v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (i + e >= end) break;
        lamb_moments<T>(gf[e], m[e], v[e], h);
        const float r = lamb_r<T>(pf[e], m[e], v[e], h);
        a = __fadd_rn(a, __fmul_rn(pf[e], pf[e]));
        b = __fadd_rn(b, __fmul_rn(r, r));
      }
      store_group(s0 + i, i, end, vec, m);
      store_group(s1 + i, i, end, vec, v);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (i + e >= end) break;
        if (K == kLars) a = __fadd_rn(a, __fmul_rn(pf[e], pf[e]));
        b = __fadd_rn(b, __fmul_rn(gf[e], gf[e]));
      }
    }
  }
  const float2 s = block_sum2(a, b);
  if (threadIdx.x == 0) partials[chunk] = s;
}

// Launch 2: every block of a tensor sums the tensor's partials in one
// order (so all agree), forms its scalar and updates its chunk.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    norm_update_kernel(__grid_constant__ const Table tab,
                       const Hyper* __restrict__ hyper,
                       const float2* __restrict__ partials,
                       const ptt::Dropout key) {
  const Hyper h = *hyper;
  const int chunk = blockIdx.x;
  const int t = tensor_of(tab, chunk);
  __shared__ float scale;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float a = 0.f, b = 0.f;
    for (int c = tab.chunk0[t] + lane; c < tab.chunk0[t + 1]; c += 32) {
      const float2 v = partials[c];
      a = __fadd_rn(a, v.x);
      b = __fadd_rn(b, v.y);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, o));
      b = __fadd_rn(b, __shfl_xor_sync(0xffffffffu, b, o));
    }
    if (lane == 0) {
      const float na = __fsqrt_rn(a), nb = __fsqrt_rn(b);
      if (K == kLamb) {
        // lr * where(w > 0 & r > 0, w / r, 1)
        const float trust = na > 0.f && nb > 0.f ? __fdiv_rn(na, nb) : 1.f;
        scale = __fmul_rn(trust, h.lr);
      } else if (K == kLars) {
        // lr * where(w > 0 & g > 0, coeff * w / (g + wd * w + eps), 1)
        const float local =
            na > 0.f && nb > 0.f
                ? __fdiv_rn(__fmul_rn(na, h.a),
                            __fadd_rn(__fadd_rn(nb, __fmul_rn(na, h.wd)),
                                      h.eps))
                : 1.f;
        // lr * local is a float32 0-d tensor; its product with the
        // p-dtype (g + wd p) casts it to p's dtype first
        scale = rt<T>(__fmul_rn(local, h.lr));
      } else {
        // max(1, ||g|| / clip), as the divisor's dtype holds it
        scale = rt<T>(fmaxf(__fmul_rn(nb, h.a), 1.f));
      }
    }
  }
  __syncthreads();
  const float sc = scale;
  T* __restrict__ p = static_cast<T*>(tab.p[t]);
  const T* __restrict__ g = static_cast<const T*>(tab.g[t]);
  T* __restrict__ s0 = static_cast<T*>(tab.s0[t]);
  T* __restrict__ s1 = static_cast<T*>(tab.s1[t]);
  const long long begin =
      static_cast<long long>(chunk - tab.chunk0[t]) * tab.chunk;
  const long long end =
      begin + tab.chunk < tab.n[t] ? begin + tab.chunk : tab.n[t];
  const bool vec = on_16(p) && on_16(g) &&
                   (K == kDpsgd || on_16(s0)) && (K != kLamb || on_16(s1));
  for (long long i = begin + 4 * threadIdx.x; i < end; i += 4 * kThreads) {
    float pf[4], gf[4], a[4], b[4];
    load_group(p + i, i, end, vec, pf);
    if (K != kLamb) load_group(g + i, i, end, vec, gf);
    if (K != kDpsgd) load_group(s0 + i, i, end, vec, a);
    if (K == kLamb) load_group(s1 + i, i, end, vec, b);
    float z[4] = {0.f, 0.f, 0.f, 0.f};
    if (K == kDpsgd) {
      // Box-Muller over the group's Philox words: (w0, w1) -> elements
      // 0, 1; (w2, w3) -> 2, 3
      const uint4 w = ptt::philox4x32_10(
          make_uint4(static_cast<uint32_t>(i >> 2),
                     static_cast<uint32_t>(tab.base + t), 0u, 0u),
          key.key);
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float u1 =
            __fmul_rn(static_cast<float>(((ws[2 * k] >> 9) << 1) + 1u),
                      5.9604644775390625e-08f);  // 2^-24
        const float u2 = __fmul_rn(static_cast<float>(ws[2 * k + 1] >> 8),
                                   5.9604644775390625e-08f);
        const float r = __fsqrt_rn(__fmul_rn(-2.f, logf(u1)));
        const float th = __fmul_rn(6.2831855f, u2);  // float32(2 pi)
        z[2 * k] = __fmul_rn(r, cosf(th));
        z[2 * k + 1] = __fmul_rn(r, sinf(th));
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (K == kLamb) {
        // p - (lr * trust) * r
        const float r = lamb_r<T>(pf[e], a[e], b[e], h);
        pf[e] = rt<T>(__fsub_rn(pf[e], __fmul_rn(sc, r)));
      } else if (K == kLars) {
        // v = mu v + (lr * local) * (g + wd p); p - v
        const float x = rt<T>(__fadd_rn(gf[e], rt<T>(__fmul_rn(pf[e], h.wd))));
        const float v = rt<T>(__fadd_rn(rt<T>(__fmul_rn(a[e], h.beta1)),
                                        rt<T>(__fmul_rn(sc, x))));
        a[e] = v;
        pf[e] = rt<T>(__fsub_rn(pf[e], v));
      } else {
        // p - lr * (g / max(1, ||g|| / clip) + noise * sigma * clip / B)
        const float gc = rt<T>(__fdiv_rn(gf[e], sc));
        const float nz = rt<T>(__fmul_rn(
            __fmul_rn(__fmul_rn(z[e], h.b), h.c), h.d));
        pf[e] = rt<T>(__fsub_rn(
            pf[e], rt<T>(__fmul_rn(rt<T>(__fadd_rn(gc, nz)), h.lr))));
      }
    }
    store_group(p + i, i, end, vec, pf);
    if (K == kLars) store_group(s0 + i, i, end, vec, a);
  }
}

template <typename T>
int launch(int kind, const Table& tab, const Hyper* h, cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>(tab.chunk0[tab.count]);
#define PTT_CASE(K)                                                     \
  case K:                                                               \
    multi_tensor_kernel<T, K><<<blocks, kThreads, 0, st>>>(tab, h); \
    break;
  switch (kind) {
    PTT_CASE(kSGD)
    PTT_CASE(kMomentum)
    PTT_CASE(kNesterov)
    PTT_CASE(kAdam)
    PTT_CASE(kAdamW)
    PTT_CASE(kAdagrad)
    PTT_CASE(kAdamax)
    PTT_CASE(kAdadelta)
    PTT_CASE(kRMSProp)
    PTT_CASE(kRMSPropCentered)
    PTT_CASE(kFtrl)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PTT_CASE
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K>
int launch_norm_rule(const Table& tab, const Hyper* h, float2* partials,
                     const ptt::Dropout& key, cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>(tab.chunk0[tab.count]);
  norm_partials_kernel<T, K><<<blocks, kThreads, 0, st>>>(tab, h, partials);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  norm_update_kernel<T, K><<<blocks, kThreads, 0, st>>>(tab, h, partials,
                                                        key);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_norm(int kind, const Table& tab, const Hyper* h, float2* partials,
                const ptt::Dropout& key, cudaStream_t st) {
  switch (kind) {
    case kLamb: return launch_norm_rule<T, kLamb>(tab, h, partials, key, st);
    case kLars: return launch_norm_rule<T, kLars>(tab, h, partials, key, st);
    case kDpsgd:
      return launch_norm_rule<T, kDpsgd>(tab, h, partials, key, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

thread_local Table host_tab;  // 26.6 KB: off the caller's stack

int fill_table(int count, void* const* p, void* const* g, void* const* s0,
               void* const* s1, void* const* s2, const long long* n,
               const int* chunk0, int chunk) {
  if (count < 0 || count > kMaxTensors || chunk <= 0 || chunk % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < count; ++i) {
    host_tab.p[i] = p[i];
    host_tab.g[i] = g[i];
    host_tab.s0[i] = s0[i];
    host_tab.s1[i] = s1[i];
    host_tab.s2[i] = s2 != nullptr ? s2[i] : nullptr;
    host_tab.n[i] = n[i];
    host_tab.chunk0[i] = chunk0[i];
  }
  host_tab.chunk0[count] = chunk0[count];
  host_tab.count = count;
  host_tab.chunk = chunk;
  host_tab.decay = kNoDecay;
  host_tab.pow_mode = kPowf;
  host_tab.base = 0;
  return 0;
}

}  // namespace

// One elementwise update of `count` tensors (at most kMaxTensors, which the
// host's MAX_TENSORS in ops/kernels/optimizer.py matches; a larger tree is
// split): p[i], g[i] in `dtype`, slots s0[i], s1[i], s2[i] (nullptr where
// the rule has fewer), n[i] elements each, all contiguous on one device;
// chunk0[i] the first chunk of tensor i in chunks of `chunk` elements (a
// multiple of 4), chunk0[count] the number of chunks; `decay` the coupled
// decay (Decay), `pow_mode` Ftrl's power (Pow); `hyper` a DEVICE pointer to
// the sixteen floats of Hyper, in its order, which the launch reads when
// it runs.
extern "C" int ptt_multi_tensor_step(int kind, int dtype, int count,
                                     void* const* p, void* const* g,
                                     void* const* s0, void* const* s1,
                                     void* const* s2, const long long* n,
                                     const int* chunk0, int chunk, int decay,
                                     int pow_mode, const void* hyper,
                                     void* stream) {
  const int bad = fill_table(count, p, g, s0, s1, s2, n, chunk0, chunk);
  if (bad != 0 || decay < kNoDecay || decay > kL1 || pow_mode < kPowf ||
      pow_mode > kSquare || hyper == nullptr)
    return bad != 0 ? bad : static_cast<int>(cudaErrorInvalidValue);
  if (count == 0 || chunk0[count] == 0) return 0;
  host_tab.decay = decay;
  host_tab.pow_mode = pow_mode;
  const Hyper* h = static_cast<const Hyper*>(hyper);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kF32) return launch<float>(kind, host_tab, h, st);
  if (dtype == ptt::kBF16) return launch<__nv_bfloat16>(kind, host_tab, h, st);
  if (dtype == ptt::kF16) return launch<__half>(kind, host_tab, h, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// One norm-rule update (NormKind) of `count` tensors, as above (slots s0,
// s1: Lamb's moments, LARS's velocity), in two launches on `stream`:
// `partials` a DEVICE scratch of chunk0[count] float2; `seed` keys
// Dpsgd's noise, tensor i drawing with index base + i.
extern "C" int ptt_multi_tensor_norm_step(
    int kind, int dtype, int count, int base, void* const* p, void* const* g,
    void* const* s0, void* const* s1, const long long* n, const int* chunk0,
    int chunk, void* partials, unsigned long long seed, const void* hyper,
    void* stream) {
  const int bad = fill_table(count, p, g, s0, s1, nullptr, n, chunk0, chunk);
  if (bad != 0 || hyper == nullptr || partials == nullptr || base < 0)
    return bad != 0 ? bad : static_cast<int>(cudaErrorInvalidValue);
  if (count == 0 || chunk0[count] == 0) return 0;
  host_tab.base = base;
  const Hyper* h = static_cast<const Hyper*>(hyper);
  float2* part = static_cast<float2*>(partials);
  const ptt::Dropout key = ptt::Dropout::make(seed, 0.f);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == ptt::kF32)
    return launch_norm<float>(kind, host_tab, h, part, key, st);
  if (dtype == ptt::kBF16)
    return launch_norm<__nv_bfloat16>(kind, host_tab, h, part, key, st);
  if (dtype == ptt::kF16)
    return launch_norm<__half>(kind, host_tab, h, part, key, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
