// Flash-attention backward (FlashAttention-2 style): dq, and dk/dv, as two
// entries; causal or not, with an optional additive float32 bias.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py `_dq_kernel` and
// `_dkv_kernel` (both called from `_bwd_call`) in all their forms: causal
// and not, with and without `has_bias`.  At the training paths' shapes
// (GPT: B = 8, S = 1024; BERT: B = 32, S = 128; 12 heads of 64) the bound
// is operations: each visible (query, key) pair costs 6 * D flops in dq and
// 8 * D in dk/dv, against one read of q, k, v, dO and the row statistics.
//
// The two reductions run in separate kernels, as in the Pallas code, and
// none uses atomics, so every gradient is summed in one fixed order and is
// the same from run to run.  All recompute p = exp(s - lse) in float32 from
// the forward's LSE, with the scores of the reference's `_scores` (scale,
// add the bias, causal replace), and accumulate in float32; delta =
// rowsum(dO * O) is computed by the caller in PyTorch (as the Pallas caller
// computes it in XLA).  The bias is read through four element strides, 0
// where it is broadcast; its gradient is not formed (the reference defines
// it as zero).  Every tensor is read through its (batch, seq, head) element
// strides with a unit stride over D, so the slices of the fused qkv
// projection are read in place and dq, dk, dv are written straight into
// the slices of one packed [B, S, 3, H, D] gradient.  Any S >= 1.
//
// dk/dv has two hand-written kernels; the C entry picks one from the dtype
// and the operands' alignment alone:
//
// `flash_dkv_mma_kernel` (bf16 whose base pointers and (b, s, h) strides
// are 16-byte multiples: every path of the models) does its four products
// on the tensor cores, `mma.sync.m16n8k16` with bf16 operands and float32
// accumulators.  A block owns 16 to 64 keys of one (batch, head), 16 a
// warp; their K and V stay in shared memory (and, for D <= 64, as A
// fragments in registers) and the dk, dv accumulators in registers for the
// whole query loop.  Q and dO tiles of 32 queries, their LSE and delta,
// stay bf16 / float32 in shared memory, filled by `cp.async` in two stages,
// so the next tile is in flight while this one is multiplied; rows are
// padded by 16 bytes, which keeps `ldmatrix` free of bank conflicts.  The
// warp computes the score tile transposed, S^T = K Q^T, and dP^T = V dO^T,
// so that P^T and dS^T, rounded to bf16 in registers as the reference
// rounds them, are the A operands of dv += P^T dO and dk += dS^T Q as they
// stand; Q and dO are the B operands of all four, through `ldmatrix` where
// d is contracted and `ldmatrix.trans` where the query is.  dS^T is formed
// without the scale, which dk takes once at the end; without a bias the
// scale of the scores is folded into the exponent.  Causal: the query loop
// starts at the key tile's diagonal, a warp skips query tiles wholly before
// its keys, and key tile 0, which walks the most queries, is scheduled
// first.  The key tile shrinks (64, 32, 16) until the grid has a block for
// every SM.  dk and dv leave through the block's K and V tiles as 16-byte
// stores.
//
// `flash_dkv_kernel` (float32, where TF32 would not hold the parity limits,
// and bf16 operands that are not 16-byte aligned) and `flash_dq_kernel`
// (every dtype) run on the CUDA cores:
// - dq: one block per (batch*head, 64-query tile).  The block walks the
//   key tiles from 0 up to the diagonal (causal) or to S, staging 32 keys
//   of K and V and the 64 x 32 bias tile in shared memory, and keeps its
//   rows' q, dO and dq accumulator in registers.
// - dk/dv: one block per (batch*head, 64-key tile).  The block walks the
//   query tiles from the diagonal (causal) or from 0 down to S, staging 32
//   queries of Q and dO, their LSE and delta and the 32 x 64 bias tile in
//   shared memory, and keeps its rows' k, v and the dk, dv accumulators in
//   registers.
// Four threads own a row, each with D/4 interleaved dims (a warp reading a
// shared-memory row hits four consecutive banks), and two shuffles finish
// each dot product.
#include <math.h>

#include <atomic>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kBlockRows = 64;  // rows a block owns (queries or keys)
constexpr int kTile = 32;       // rows of the streamed operand per step
constexpr int kThreads = 256;   // 4 threads per owned row

struct Strides {
  long long b, s, h;
};

__host__ __device__ inline long long offset(const Strides& st, int b, int s,
                                            int h) {
  return b * st.b + s * st.s + h * st.h;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B*H, S]
  const float* delta;  // [B*H, S]
  void* d0;            // dq (dq kernel) or dk (dk/dv kernel)
  void* d1;            // dv (dk/dv kernel)
  Strides sq, sk, sv, sdo, sd0, sd1;
  ptt::Bias bias;
  int H, S;
  float scale;
  bool causal;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(Args a) {
  constexpr int kPer = D / 4;
  __shared__ float k_tile[kTile][D];
  __shared__ float v_tile[kTile][D];
  __shared__ float b_tile[kBlockRows][kTile + 1];  // +1: rows in other banks
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);

  const int bh = blockIdx.y, S = a.S;
  const int b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * kBlockRows;
  const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
  const int qi = q0 + r;
  const bool row_ok = qi < S;

  float qreg[kPer], doreg[kPer], acc[kPer];
  const long long q_off = offset(a.sq, b, qi, h);
  const long long do_off = offset(a.sdo, b, qi, h);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int d = i * 4 + part;
    qreg[i] = row_ok ? ptt::to_f32(q[q_off + d]) * a.scale : 0.f;
    doreg[i] = row_ok ? ptt::to_f32(dout[do_off + d]) : 0.f;
    acc[i] = 0.f;
  }
  const long long row = static_cast<long long>(bh) * S + qi;
  const float lse = row_ok ? a.lse[row] : 0.f;
  const float delta = row_ok ? a.delta[row] : 0.f;

  const long long k_base = offset(a.sk, b, 0, h);
  const long long v_base = offset(a.sv, b, 0, h);
  const bool has_bias = a.bias.p != nullptr;
  // causal: keys up to the tile's diagonal; otherwise every key
  const int k_end = a.causal ? min(S, q0 + kBlockRows) : S;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile has been consumed
    for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
      const int j = e / D, c = e % D, kj = k0 + j;
      k_tile[j][c] = kj < S ? ptt::to_f32(k[k_base + kj * a.sk.s + c]) : 0.f;
      v_tile[j][c] = kj < S ? ptt::to_f32(v[v_base + kj * a.sv.s + c]) : 0.f;
    }
    if (has_bias)
      a.bias.stage<kBlockRows, kTile>(b_tile, b, h, q0, k0, S, S);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        s += qreg[i] * k_tile[j][i * 4 + part];
        dp += doreg[i] * v_tile[j][i * 4 + part];
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 2);
      if (has_bias) s += b_tile[r][j];
      // a visible key (kj < S, and kj <= qi when causal) of a real row
      const int kj = k0 + j;
      const bool seen = row_ok && kj < S && (!a.causal || kj <= qi);
      const float p = seen ? expf(s - lse) : 0.f;
      const float ds = p * (dp - delta) * a.scale;
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc[i] += ds * k_tile[j][i * 4 + part];
    }
  }

  if (row_ok) {
    T* dq = static_cast<T*>(a.d0) + offset(a.sd0, b, qi, h);
#pragma unroll
    for (int i = 0; i < kPer; ++i) dq[i * 4 + part] = ptt::from_f32<T>(acc[i]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(Args a) {
  constexpr int kPer = D / 4;
  __shared__ float q_tile[kTile][D];
  __shared__ float do_tile[kTile][D];
  __shared__ float lse_tile[kTile];
  __shared__ float delta_tile[kTile];
  __shared__ float b_tile[kTile][kBlockRows + 1];
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);

  const int bh = blockIdx.y, S = a.S;
  const int b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x * kBlockRows;
  const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
  const int kj = k0 + r;
  const bool row_ok = kj < S;

  float kreg[kPer], vreg[kPer], dk[kPer], dv[kPer];
  const long long k_off = offset(a.sk, b, kj, h);
  const long long v_off = offset(a.sv, b, kj, h);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int d = i * 4 + part;
    kreg[i] = row_ok ? ptt::to_f32(k[k_off + d]) * a.scale : 0.f;
    vreg[i] = row_ok ? ptt::to_f32(v[v_off + d]) : 0.f;
    dk[i] = 0.f;
    dv[i] = 0.f;
  }

  const long long q_base = offset(a.sq, b, 0, h);
  const long long do_base = offset(a.sdo, b, 0, h);
  const long long stat_base = static_cast<long long>(bh) * S;
  const bool has_bias = a.bias.p != nullptr;
  // causal: only queries at or after this tile's first key see it
  for (int q0 = a.causal ? k0 : 0; q0 < S; q0 += kTile) {
    __syncthreads();
    for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
      const int i = e / D, c = e % D, qi = q0 + i;
      q_tile[i][c] = qi < S ? ptt::to_f32(q[q_base + qi * a.sq.s + c]) : 0.f;
      do_tile[i][c] =
          qi < S ? ptt::to_f32(dout[do_base + qi * a.sdo.s + c]) : 0.f;
    }
    if (threadIdx.x < kTile) {
      const int qi = q0 + threadIdx.x;
      lse_tile[threadIdx.x] = qi < S ? a.lse[stat_base + qi] : 0.f;
      delta_tile[threadIdx.x] = qi < S ? a.delta[stat_base + qi] : 0.f;
    }
    if (has_bias)
      a.bias.stage<kTile, kBlockRows>(b_tile, b, h, q0, k0, S, S);
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < kTile; ++i) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        s += kreg[c] * q_tile[i][c * 4 + part];
        dp += vreg[c] * do_tile[i][c * 4 + part];
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 2);
      if (has_bias) s += b_tile[i][r];
      const int qi = q0 + i;
      // a real key seen by a real query (kj <= qi when causal); else 0
      const bool seen = row_ok && qi < S && (!a.causal || kj <= qi);
      const float p = seen ? expf(s - lse_tile[i]) : 0.f;
      const float ds = p * (dp - delta_tile[i]) * a.scale;
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        dv[c] += p * do_tile[i][c * 4 + part];
        dk[c] += ds * q_tile[i][c * 4 + part];
      }
    }
  }

  if (row_ok) {
    T* dkp = static_cast<T*>(a.d0) + offset(a.sd0, b, kj, h);
    T* dvp = static_cast<T*>(a.d1) + offset(a.sd1, b, kj, h);
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      dkp[c * 4 + part] = ptt::from_f32<T>(dk[c]);
      dvp[c * 4 + part] = ptt::from_f32<T>(dv[c]);
    }
  }
}

// ---------------------------------------------------------------------------
// the tensor-core dk/dv kernel
// ---------------------------------------------------------------------------
// The A operand of k-step kk: 16 rows of a row-major shared tile.
template <int kLd>
__device__ __forceinline__ void load_a(uint32_t (&frag)[4],
                                       const __nv_bfloat16* rows, int kk,
                                       int lane) {
  ptt::ldmatrix_x4(frag, rows + (lane & 15) * kLd + kk * 16 + (lane >> 4) * 8);
}

// acc = A B^T over d, for S^T = K Q^T and dP^T = V dO^T: A is the warp's 16
// rows of K or V (`af` when kRegA, else read from `a_rows`), and B[d][query]
// is the row-major Q or dO tile as it lies.
template <int D, int kLd, int kNt, bool kRegA>
__device__ __forceinline__ void times_transposed(
    float (&acc)[kNt][4], const uint32_t (&af)[kRegA ? D / 16 : 1][4],
    const __nv_bfloat16* a_rows, const __nv_bfloat16* b_tile, int lane) {
#pragma unroll
  for (int j = 0; j < kNt; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    if constexpr (kRegA) {
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = af[kk][r];
    } else {
      load_a<kLd>(a, a_rows, kk, lane);
    }
#pragma unroll
    for (int jp = 0; jp < kNt / 2; ++jp) {
      uint32_t bf[4];
      ptt::ldmatrix_x4(bf, b_tile +
                               (jp * 16 + (lane >> 4) * 8 + (lane & 7)) * kLd +
                               kk * 16 + ((lane >> 3) & 1) * 8);
      ptt::mma_bf16(acc[2 * jp], a, bf[0], bf[1]);
      ptt::mma_bf16(acc[2 * jp + 1], a, bf[2], bf[3]);
    }
  }
}

// acc += X B over the tile's queries, for dv += P^T dO and dk += dS^T Q: X
// (P^T or dS^T, float32 accumulators) is rounded to bf16 in registers, and
// B[query][d] contracts the tile's rows, hence the transposed load.
template <int D, int kLd, int kNt>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4],
                                           const float (&x)[kNt][4],
                                           const __nv_bfloat16* b_tile,
                                           int lane) {
#pragma unroll
  for (int kk = 0; kk < kNt / 2; ++kk) {
    const uint32_t a[4] = {
        ptt::pack_bf16(x[2 * kk][0], x[2 * kk][1]),
        ptt::pack_bf16(x[2 * kk][2], x[2 * kk][3]),
        ptt::pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
        ptt::pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t bf[4];
      ptt::ldmatrix_x4_trans(
          bf, b_tile + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * kLd +
                  dp * 16 + (lane >> 4) * 8);
      ptt::mma_bf16(acc[2 * dp], a, bf[0], bf[1]);
      ptt::mma_bf16(acc[2 * dp + 1], a, bf[2], bf[3]);
    }
  }
}

// Queries per staged tile: with 64 the four accumulator tiles of a D = 64
// warp took 228 registers; 32 leaves room for three blocks on an SM.
constexpr int kTileM = 32;

// kWarps warps of 16 keys each; query tiles of kTileM rows.
template <int D, int kWarps>
__global__ void __launch_bounds__(kWarps * 32) flash_dkv_mma_kernel(Args a) {
  using bf16 = __nv_bfloat16;
  constexpr bool kRegA = D <= 64;  // K, V fragments stay in registers
  constexpr int kThreads = kWarps * 32;
  constexpr int kTileN = kWarps * 16;        // keys a block owns
  constexpr int kLd = D + 8;                  // padded row, in elements
  constexpr int kKs = D / 16;
  constexpr int kNt = kTileM / 8;     // 8-query tiles of S^T and dP^T
  extern __shared__ __align__(16) unsigned char ptt_smem[];
  bf16* k_s = reinterpret_cast<bf16*>(ptt_smem);  // [kTileN][kLd]
  bf16* v_s = k_s + kTileN * kLd;                 // [kTileN][kLd]
  bf16* q_s = v_s + kTileN * kLd;                 // [2][kTileM][kLd]
  bf16* do_s = q_s + 2 * kTileM * kLd;            // [2][kTileM][kLd]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kTileM * kLd);
  float* delta_s = lse_s + 2 * kTileM;            // both [2][kTileM]

  const int S = a.S;
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.y * kTileN;  // causal: key tile 0 is the heaviest
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int key_w = k0 + warp * 16;  // the warp's first key
  const bool has_bias = a.bias.p != nullptr;
  const long long bias_base = b * a.bias.b + h * a.bias.h;
  const float scale_log2 = a.scale * ptt::kLog2e;

  const bf16* q_src = static_cast<const bf16*>(a.q) + offset(a.sq, b, 0, h);
  const bf16* k_src = static_cast<const bf16*>(a.k) + offset(a.sk, b, 0, h);
  const bf16* v_src = static_cast<const bf16*>(a.v) + offset(a.sv, b, 0, h);
  const bf16* do_src =
      static_cast<const bf16*>(a.dout) + offset(a.sdo, b, 0, h);
  const float* lse_src = a.lse + static_cast<long long>(bh) * S;
  const float* delta_src = a.delta + static_cast<long long>(bh) * S;
  // causal: only queries at or after this tile's first key see it
  const int q_begin = a.causal ? k0 / kTileM * kTileM : 0;
  const int n_tiles = (S - q_begin + kTileM - 1) / kTileM;

  auto stage_queries = [&](int stage, int q0) {
    ptt::stage_rows<D, kLd, kTileM, kThreads>(q_s + stage * kTileM * kLd,
                                              q_src, a.sq.s, q0, S);
    ptt::stage_rows<D, kLd, kTileM, kThreads>(do_s + stage * kTileM * kLd,
                                              do_src, a.sdo.s, q0, S);
    for (int i = threadIdx.x; i < kTileM; i += kThreads) {
      const bool ok = q0 + i < S;
      const int qi = ok ? q0 + i : 0;
      ptt::cp_async_4(lse_s + stage * kTileM + i, lse_src + qi, ok);
      ptt::cp_async_4(delta_s + stage * kTileM + i, delta_src + qi, ok);
    }
  };
  ptt::stage_rows<D, kLd, kTileN, kThreads>(k_s, k_src, a.sk.s, k0, S);
  ptt::stage_rows<D, kLd, kTileN, kThreads>(v_s, v_src, a.sv.s, k0, S);
  stage_queries(0, q_begin);
  ptt::cp_async_commit();

  // the A operands: this warp's 16 rows of K and of V
  bf16* k_w = k_s + warp * 16 * kLd;
  bf16* v_w = v_s + warp * 16 * kLd;
  uint32_t kf[kRegA ? kKs : 1][4], vf[kRegA ? kKs : 1][4];
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
    dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
  }

  for (int i = 0; i < n_tiles; ++i) {
    const int stage = i & 1, q0 = q_begin + i * kTileM;
    if (i + 1 < n_tiles) stage_queries(stage ^ 1, q0 + kTileM);
    ptt::cp_async_commit();
    ptt::cp_async_wait<1>();  // tile i has landed; tile i + 1 is in flight
    __syncthreads();
    if (kRegA && i == 0) {
#pragma unroll
      for (int kk = 0; kk < kKs; ++kk) {
        load_a<kLd>(kf[kRegA ? kk : 0], k_w, kk, lane);
        load_a<kLd>(vf[kRegA ? kk : 0], v_w, kk, lane);
      }
    }
    // causal: a query tile wholly before the warp's keys sees none of them
    if (!a.causal || q0 + kTileM - 1 >= key_w) {
      const bf16* qt = q_s + stage * kTileM * kLd;
      const bf16* dot = do_s + stage * kTileM * kLd;
      // each lane's query columns 2t, 2t + 1 of every 8-query tile
      const float2* lse_t =
          reinterpret_cast<const float2*>(lse_s + stage * kTileM) + t;
      const float2* delta_t =
          reinterpret_cast<const float2*>(delta_s + stage * kTileM) + t;
      float p[kNt][4];  // rows: keys g, g + 8; columns: queries
      times_transposed<D, kLd, kNt, kRegA>(p, kf, k_w, qt, lane);
      if (has_bias) {
        // natural units, the difference formed first: a row masked
        // everywhere by -1e30 gives exactly exp(0)
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
          const float2 lse = lse_t[j * 4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = q0 + j * 8 + 2 * t + (e & 1);
            const int kj = key_w + g + (e >> 1) * 8;
            float x = p[j][e] * a.scale;
            if (qi < S && kj < S)
              x += a.bias.p[bias_base + qi * a.bias.q + kj * a.bias.k];
            p[j][e] = ptt::fast_exp2((x - (e & 1 ? lse.y : lse.x)) *
                                     ptt::kLog2e);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
          const float2 lse = lse_t[j * 4];
          const float lx = lse.x * ptt::kLog2e, ly = lse.y * ptt::kLog2e;
          p[j][0] = ptt::fast_exp2(fmaf(p[j][0], scale_log2, -lx));
          p[j][1] = ptt::fast_exp2(fmaf(p[j][1], scale_log2, -ly));
          p[j][2] = ptt::fast_exp2(fmaf(p[j][2], scale_log2, -lx));
          p[j][3] = ptt::fast_exp2(fmaf(p[j][3], scale_log2, -ly));
        }
      }
      // queries past S, keys past S or pairs above the diagonal
      if (q0 + kTileM > S || key_w + 16 > S ||
          (a.causal && q0 < key_w + 15)) {
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = q0 + j * 8 + 2 * t + (e & 1);
            const int kj = key_w + g + (e >> 1) * 8;
            if (qi >= S || kj >= S || (a.causal && kj > qi)) p[j][e] = 0.f;
          }
        }
      }
      accumulate<D, kLd, kNt>(dv, p, dot, lane);
      float ds[kNt][4];  // without the scale, which dk takes at the end
      times_transposed<D, kLd, kNt, kRegA>(ds, vf, v_w, dot, lane);
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
        const float2 delta = delta_t[j * 4];
        ds[j][0] = p[j][0] * (ds[j][0] - delta.x);
        ds[j][1] = p[j][1] * (ds[j][1] - delta.y);
        ds[j][2] = p[j][2] * (ds[j][2] - delta.x);
        ds[j][3] = p[j][3] * (ds[j][3] - delta.y);
      }
      accumulate<D, kLd, kNt>(dk, ds, qt, lane);
    }
    __syncthreads();  // the stage is free for the copy after next
  }

  // dk, dv through the warp's own rows of the K and V tiles, then 16-byte
  // stores
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(k_w + g * kLd + c) =
        ptt::pack_bf16(dk[j][0] * a.scale, dk[j][1] * a.scale);
    *reinterpret_cast<uint32_t*>(k_w + (g + 8) * kLd + c) =
        ptt::pack_bf16(dk[j][2] * a.scale, dk[j][3] * a.scale);
    *reinterpret_cast<uint32_t*>(v_w + g * kLd + c) =
        ptt::pack_bf16(dv[j][0], dv[j][1]);
    *reinterpret_cast<uint32_t*>(v_w + (g + 8) * kLd + c) =
        ptt::pack_bf16(dv[j][2], dv[j][3]);
  }
  __syncwarp();
  ptt::store_rows_16<D, kLd>(k_w,
                             static_cast<bf16*>(a.d0) + offset(a.sd0, b, 0, h),
                             a.sd0.s, key_w, S);
  ptt::store_rows_16<D, kLd>(v_w,
                             static_cast<bf16*>(a.d1) + offset(a.sd1, b, 0, h),
                             a.sd1.s, key_w, S);
}

template <int D, int kWarps>
int launch_dkv_mma_tile(const Args& a, int B, cudaStream_t st) {
  constexpr int kTileN = kWarps * 16;
  constexpr int kSmem =
      (2 * kTileN + 4 * kTileM) * (D + 8) * 2 + 4 * kTileM * 4;
  static bool configured = false;  // more than 48 KB needs asking for, once
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_dkv_mma_kernel<D, kWarps>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(B * a.H, (a.S + kTileN - 1) / kTileN);
  flash_dkv_mma_kernel<D, kWarps><<<grid, kWarps * 32, kSmem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The largest key tile that still gives every SM a block (and is not
// mostly padding); 16 keys when no tile does.
template <int D>
int launch_dkv_mma_dim(const Args& a, int B, cudaStream_t st) {
  const long long bh = static_cast<long long>(B) * a.H;
  const int sms = ptt::sm_count();
  auto fills = [&](int tile) {
    return a.S > tile / 2 && bh * ((a.S + tile - 1) / tile) >= sms;
  };
  if (fills(64)) return launch_dkv_mma_tile<D, 4>(a, B, st);
  if (fills(32)) return launch_dkv_mma_tile<D, 2>(a, B, st);
  return launch_dkv_mma_tile<D, 1>(a, B, st);
}

int launch_dkv_mma(const Args& a, int B, int D, cudaStream_t st) {
  switch (D) {
    case 16:
      return launch_dkv_mma_dim<16>(a, B, st);
    case 32:
      return launch_dkv_mma_dim<32>(a, B, st);
    case 64:
      return launch_dkv_mma_dim<64>(a, B, st);
    case 128:
      return launch_dkv_mma_dim<128>(a, B, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dk/dv launches of each variant since the library was loaded: [simt, mma]
std::atomic<long long> dkv_variant_launches[2];

bool aligned_16(const void* p, const Strides& s) {
  return ptt::aligned_16(p, s.b, s.s, s.h);
}

template <typename T, bool kDq>
int launch(const Args& a, int B, int D, cudaStream_t st) {
  const dim3 grid((a.S + kBlockRows - 1) / kBlockRows, B * a.H);
#define PTT_FLASH_BWD_CASE(DIM)                                            \
  case DIM:                                                                \
    if constexpr (kDq)                                                     \
      flash_dq_kernel<T, DIM><<<grid, kThreads, 0, st>>>(a);               \
    else                                                                   \
      flash_dkv_kernel<T, DIM><<<grid, kThreads, 0, st>>>(a);              \
    break;
  switch (D) {
    PTT_FLASH_BWD_CASE(16)
    PTT_FLASH_BWD_CASE(32)
    PTT_FLASH_BWD_CASE(64)
    PTT_FLASH_BWD_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PTT_FLASH_BWD_CASE
  return static_cast<int>(cudaGetLastError());
}

Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
}

template <bool kDq>
int dispatch(const Args& a, int B, int D, int dtype, void* stream) {
  if (B <= 0 || a.S <= 0 || a.H <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != ptt::kF32 && dtype != ptt::kBF16)
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (!kDq) {
    const bool mma = dtype == ptt::kBF16 && aligned_16(a.q, a.sq) &&
                     aligned_16(a.k, a.sk) && aligned_16(a.v, a.sv) &&
                     aligned_16(a.dout, a.sdo) && aligned_16(a.d0, a.sd0) &&
                     aligned_16(a.d1, a.sd1);
    ++dkv_variant_launches[mma];
    if (mma) return launch_dkv_mma(a, B, D, st);
  }
  if (dtype == ptt::kF32) return launch<float, kDq>(a, B, D, st);
  return launch<__nv_bfloat16, kDq>(a, B, D, st);
}

}  // namespace

// q, k, v, dout, dq: [B, S, H, D] with unit stride over d; `strides` is a
// host array of their (b, s, h) element strides, in that order (15
// values).  lse, delta: [B*H, S] float32.  bias: NULL, or float32
// [B, H, S, S] with element strides (bias_b, bias_h, bias_q, bias_k), any
// of them 0.  causal: 0 or 1.
extern "C" int ptt_flash_attention_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const long long* strides,
    const void* bias, long long bias_b, long long bias_h, long long bias_q,
    long long bias_k, int B, int S, int H, int D, float sm_scale, int causal,
    int dtype, void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), dq, nullptr,
         strides_at(strides, 0), strides_at(strides, 1),
         strides_at(strides, 2), strides_at(strides, 3),
         strides_at(strides, 4), Strides{0, 0, 0},
         ptt::Bias{static_cast<const float*>(bias), bias_b, bias_h, bias_q,
                   bias_k},
         H, S, sm_scale, causal != 0};
  return dispatch<true>(a, B, D, dtype, stream);
}

// As above, with dk and dv as the outputs; `strides` holds the (b, s, h)
// strides of q, k, v, dout, dk, dv (18 values).
extern "C" int ptt_flash_attention_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    const long long* strides, const void* bias, long long bias_b,
    long long bias_h, long long bias_q, long long bias_k, int B, int S, int H,
    int D, float sm_scale, int causal, int dtype, void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), dk, dv,
         strides_at(strides, 0), strides_at(strides, 1),
         strides_at(strides, 2), strides_at(strides, 3),
         strides_at(strides, 4), strides_at(strides, 5),
         ptt::Bias{static_cast<const float*>(bias), bias_b, bias_h, bias_q,
                   bias_k},
         H, S, sm_scale, causal != 0};
  return dispatch<false>(a, B, D, dtype, stream);
}

// How many dk/dv launches took the CUDA-core kernel (variant 0) or the
// tensor-core kernel (variant 1) since the library was loaded.
extern "C" long long ptt_flash_attention_dkv_variant_launches(int variant) {
  return variant == 0 || variant == 1 ? dkv_variant_launches[variant].load()
                                      : -1;
}
