// Flash-attention backward (FlashAttention-2 style): dq, and dk/dv, as two
// entries; causal or not, with an optional additive float32 bias, over S_q
// queries and S_k keys (self-attention, or cross-attention with S_q != S_k).
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py `_dq_kernel` and
// `_dkv_kernel` (both called from `_bwd_call`) in all their forms: causal
// and not, with and without `has_bias`, at any (S_q, S_k).  At the training
// paths' shapes (GPT: B = 8, S = 1024; BERT: B = 32, S = 128; 12 heads of
// 64; Transformer-base: B = 48, S_q = 64, S_k = 72, 8 heads of 64) the
// bound is operations: each visible (query, key) pair costs 6 * D flops in
// dq and 8 * D in dk/dv, against one read of q, k, v, dO and the row
// statistics.
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
// the slices of one packed [B, S, 3, H, D] gradient.  q, dO and dq are
// [B, S_q, H, D], k, v, dk and dv [B, S_k, H, D], LSE and delta
// [B*H, S_q]; any S_q, S_k >= 1.  Causal is top-left aligned (query i sees
// key j iff j <= i), as the reference's `_causal_mask`: with S_q < S_k the
// keys past the last query see no query, and their dk and dv are written
// as zeros.
//
// dq and dk/dv each have three hand-written kernels; the C entry picks one
// from the dtype and the operands' alignment alone, and counts the choice:
//
// `flash_dq_mma_kernel` (bf16 or float16 whose base pointers and (b, s, h)
// strides are 16-byte multiples: every path of the models, AMP's float16
// included) does its three products on the tensor cores,
// `mma.sync.m16n8k16` with 16-bit operands (the element type T, a template
// parameter) and float32 accumulators.  A block owns 16 to 128 queries of
// one (batch, head), 16 a warp; their Q and dO tiles are staged once in shared memory (and, for
// D <= 64, kept as A fragments in registers), with the rows' LSE and delta
// in registers, and the dq accumulator stays in registers for the whole
// key loop.  K and V tiles of 32 keys stream through
// padded shared memory by `cp.async` in two stages, so the next tile is in
// flight while this one is multiplied.  S = Q K^T and dP = dO V^T take K
// and V as they lie as the B operands (`ldmatrix`); the float32 softmax
// runs on the accumulators (without a bias, the scale and log2(e) folded
// into one FFMA before `ex2`; with one, the difference s - lse formed first
// in natural units); dS = P * (dP - delta) * scale is rounded to T in
// registers, scaled before it is rounded as the reference's
// `ds.astype(k.dtype)` is (float16 overflows 1 / scale sooner without it),
// and is the A operand of dq += dS K, with K through `ldmatrix.trans`
// (its contracted dimension is the row).
// Causal: the key loop ends at the block's diagonal, a warp skips key
// tiles wholly above its rows, only a tile that straddles the diagonal or
// S_k is masked entry by entry, and the last query tile, which walks the
// most keys, is scheduled first.  The query tile shrinks (64, 32, 16)
// until the grid has a block for every SM.  dq leaves through the warp's
// own rows of the Q tile as 16-byte stores.
//
// `flash_dkv_mma_kernel` (bf16 or float16 on 16-byte boundaries, as
// above) does its four products on the tensor cores, with the same
// primitives.  A block owns 16 to 64 keys of one (batch, head), 16 a
// warp; their K and V stay in shared memory (and, for D <= 64, as A
// fragments in registers) and the dk, dv accumulators in registers for the
// whole query loop.  Q and dO tiles of 32 queries, their LSE and delta,
// stay 16-bit / float32 in shared memory, filled by `cp.async` in two
// stages, so the next tile is in flight while this one is multiplied; rows are
// padded by 16 bytes, which keeps `ldmatrix` free of bank conflicts.  The
// warp computes the score tile transposed, S^T = K Q^T, and dP^T = V dO^T,
// so that P^T and dS^T, rounded to T in registers as the reference
// rounds them, are the A operands of dv += P^T dO and dk += dS^T Q as they
// stand; Q and dO are the B operands of all four, through `ldmatrix` where
// d is contracted and `ldmatrix.trans` where the query is.  dS^T takes
// the scale before it is rounded, as dq's dS does; without a bias the
// scale of the scores is folded into the exponent.  Causal: the query loop
// starts at the key tile's diagonal, a warp skips query tiles wholly before
// its keys, and key tile 0, which walks the most queries, is scheduled
// first.  The key tile shrinks (64, 32, 16) until the grid has a block for
// every SM.  dk and dv leave through the block's K and V tiles as 16-byte
// stores.
//
// `flash_dq_tf32x3_kernel` and `flash_dkv_tf32x3_kernel` (float32 whose
// base pointers and (b, s, h) strides are 16-byte multiples: the fused
// qkv's slices of every float32 training path) are the same two designs
// with every product on the TF32 tensor cores, each operand split into two
// TF32 terms and three products summed (`mma_tf32x3`), which holds float32
// parity where one TF32 product does not.  dq's key tiles are 32 keys (16 at
// D = 128), dk/dv's query tiles 16 queries, and at D = 128 two warps share
// a dk/dv band of 16 keys, each accumulating half of D.  Details at the
// kernels.
//
// `flash_dq_kernel` and `flash_dkv_kernel` (float32 and 16-bit operands
// that are not 16-byte aligned) run on the CUDA cores:
// - dq: one block per (batch*head, 64-query tile).  The block walks the
//   key tiles from 0 up to the diagonal (causal) or to S_k, staging 32 keys
//   of K and V and the 64 x 32 bias tile in shared memory, and keeps its
//   rows' q, dO and dq accumulator in registers.
// - dk/dv: one block per (batch*head, 64-key tile).  The block walks the
//   query tiles from the diagonal (causal) or from 0 up to S_q, staging 32
//   queries of Q and dO, their LSE and delta and the 32 x 64 bias tile in
//   shared memory, and keeps its rows' k, v and the dk, dv accumulators in
//   registers.
// Four threads own a row, each with D/4 interleaved dims (a warp reading a
// shared-memory row hits four consecutive banks), and two shuffles finish
// each dot product.
//
// Dropout is a template flag of all six kernels (p = 0 launches the
// instantiations without it): each draws the forward's mask again from
// dropout.cuh with its seed.  dv takes the dropped weights P Z / (1 - p);
// dP = dO V^T is masked and rescaled the same way before dS = P (dP - delta),
// delta = rowsum(dO O) of the dropped output.  dq draws as the forward does
// (a warp's rows, shuffles); dk/dv holds the score tile transposed, so each
// lane draws its query's groups of the warp's 16 keys and ballots turn the
// bits into each lane's key columns.
#include <math.h>

#include <atomic>
#include <type_traits>

#include "common.cuh"
#include "dropout.cuh"
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
  const float* lse;    // [B*H, S_q]
  const float* delta;  // [B*H, S_q]
  void* d0;            // dq (dq kernel) or dk (dk/dv kernel)
  void* d1;            // dv (dk/dv kernel)
  Strides sq, sk, sv, sdo, sd0, sd1;
  ptt::Bias bias;
  int H, S_q, S_k;  // heads; queries and keys of a plane
  float scale;
  bool causal;
  ptt::Dropout drop;
};

// Blocks an SM for __launch_bounds__ (0: ptxas's own choice).  At D = 16
// with dropout ptxas fitted the kernel to 48 registers (five blocks an SM)
// and spilled once the Philox counter's fourth word became a loaded value;
// three blocks give it 80 registers and no spill, but float16's converts
// still spilled 4 bytes at 80 (H100 build): two blocks for float16.
template <typename T, int D, bool kDropout>
constexpr int kDqMinBlocks =
    D == 16 && kDropout ? (std::is_same<T, __half>::value ? 2 : 3) : 0;

template <typename T, int D, bool kDropout>
__global__ void __launch_bounds__(kThreads, (kDqMinBlocks<T, D, kDropout>))
    flash_dq_kernel(Args a) {
  constexpr int kPer = D / 4;
  __shared__ float k_tile[kTile][D];
  __shared__ float v_tile[kTile][D];
  __shared__ float b_tile[kBlockRows][kTile + 1];  // +1: rows in other banks
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);

  const int bh = blockIdx.y, S_q = a.S_q, S_k = a.S_k;
  const int b = bh / a.H, h = bh % a.H;
  const int q0 = blockIdx.x * kBlockRows;
  const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
  const int qi = q0 + r;
  const bool row_ok = qi < S_q;

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
  const long long row = static_cast<long long>(bh) * S_q + qi;
  const float lse = row_ok ? a.lse[row] : 0.f;
  const float delta = row_ok ? a.delta[row] : 0.f;

  const long long k_base = offset(a.sk, b, 0, h);
  const long long v_base = offset(a.sv, b, 0, h);
  const bool has_bias = a.bias.p != nullptr;
  // causal: keys up to the tile's diagonal; otherwise every key
  const int k_end = a.causal ? min(S_k, q0 + kBlockRows) : S_k;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile has been consumed
    for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
      const int j = e / D, c = e % D, kj = k0 + j;
      k_tile[j][c] =
          kj < S_k ? ptt::to_f32(k[k_base + kj * a.sk.s + c]) : 0.f;
      v_tile[j][c] =
          kj < S_k ? ptt::to_f32(v[v_base + kj * a.sv.s + c]) : 0.f;
    }
    if (has_bias)
      a.bias.stage<kBlockRows, kTile>(b_tile, b, h, q0, k0, S_q, S_k);
    uint32_t keep = 0;  // bit j keeps key k0 + j
    if constexpr (kDropout)
      keep = ptt::quad_keep_bits(a.drop, bh, qi, k0, part);
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
      // a visible key (kj < S_k, and kj <= qi when causal) of a real row
      const int kj = k0 + j;
      const bool seen = row_ok && kj < S_k && (!a.causal || kj <= qi);
      const float p = seen ? expf(s - lse) : 0.f;
      // dropout: dP of the dropped weights, masked and rescaled likewise
      if constexpr (kDropout) dp = (keep >> j) & 1u ? dp * a.drop.scale : 0.f;
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

template <typename T, int D, bool kDropout>
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

  const int bh = blockIdx.y, S_q = a.S_q, S_k = a.S_k;
  const int b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.x * kBlockRows;
  const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
  const int kj = k0 + r;
  const bool row_ok = kj < S_k;

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
  const long long stat_base = static_cast<long long>(bh) * S_q;
  const bool has_bias = a.bias.p != nullptr;
  // causal: only queries at or after this tile's first key see it (none
  // when the tile starts at or past S_q: dk and dv stay 0)
  for (int q0 = a.causal ? k0 : 0; q0 < S_q; q0 += kTile) {
    __syncthreads();
    for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
      const int i = e / D, c = e % D, qi = q0 + i;
      q_tile[i][c] =
          qi < S_q ? ptt::to_f32(q[q_base + qi * a.sq.s + c]) : 0.f;
      do_tile[i][c] =
          qi < S_q ? ptt::to_f32(dout[do_base + qi * a.sdo.s + c]) : 0.f;
    }
    if (threadIdx.x < kTile) {
      const int qi = q0 + threadIdx.x;
      lse_tile[threadIdx.x] = qi < S_q ? a.lse[stat_base + qi] : 0.f;
      delta_tile[threadIdx.x] = qi < S_q ? a.delta[stat_base + qi] : 0.f;
    }
    if (has_bias)
      a.bias.stage<kTile, kBlockRows>(b_tile, b, h, q0, k0, S_q, S_k);
    // dropout: each warp owns the 8 keys k0 + 8 * warp + (lane >> 2); bit i
    // keeps (q0 + i, kj)
    uint32_t keep[1] = {0};
    if constexpr (kDropout)
      ptt::column_keep_bits<1>(keep, a.drop, bh, q0,
                               k0 + 8 * (threadIdx.x >> 5),
                               (threadIdx.x & 31) >> 2);
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
      const bool seen = row_ok && qi < S_q && (!a.causal || kj <= qi);
      const float p = seen ? expf(s - lse_tile[i]) : 0.f;
      float pd = p;  // the weight dv takes: after dropout
      if constexpr (kDropout) {
        const bool z = (keep[0] >> i) & 1u;
        pd = z ? p * a.drop.scale : 0.f;
        dp = z ? dp * a.drop.scale : 0.f;
      }
      const float ds = p * (dp - delta_tile[i]) * a.scale;
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        dv[c] += pd * do_tile[i][c * 4 + part];
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
template <int kLd, typename T>
__device__ __forceinline__ void load_a(uint32_t (&frag)[4], const T* rows,
                                       int kk, int lane) {
  ptt::ldmatrix_x4(frag, rows + (lane & 15) * kLd + kk * 16 + (lane >> 4) * 8);
}

// acc = A B^T over d, for S^T = K Q^T and dP^T = V dO^T (dk/dv) or
// S = Q K^T and dP = dO V^T (dq): A is the warp's 16 rows of one operand
// (`af` when kRegA, else read from `a_rows`), and B[d][n] is the other's
// row-major tile as it lies.
template <typename T, int D, int kLd, int kNt, bool kRegA>
__device__ __forceinline__ void times_transposed(
    float (&acc)[kNt][4], const uint32_t (&af)[kRegA ? D / 16 : 1][4],
    const T* a_rows, const T* b_tile, int lane) {
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
      ptt::mma16<T>(acc[2 * jp], a, bf[0], bf[1]);
      ptt::mma16<T>(acc[2 * jp + 1], a, bf[2], bf[3]);
    }
  }
}

// acc += X B over the tile's rows, for dv += P^T dO and dk += dS^T Q (rows:
// queries) or dq += dS K (rows: keys): X (float32 accumulators) is rounded
// to T in registers, and B[row][d] contracts the tile's rows, hence the
// transposed load.
template <typename T, int D, int kLd, int kNt>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4],
                                           const float (&x)[kNt][4],
                                           const T* b_tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < kNt / 2; ++kk) {
    const uint32_t a[4] = {
        ptt::pack16<T>(x[2 * kk][0], x[2 * kk][1]),
        ptt::pack16<T>(x[2 * kk][2], x[2 * kk][3]),
        ptt::pack16<T>(x[2 * kk + 1][0], x[2 * kk + 1][1]),
        ptt::pack16<T>(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t bf[4];
      ptt::ldmatrix_x4_trans(
          bf, b_tile + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * kLd +
                  dp * 16 + (lane >> 4) * 8);
      ptt::mma16<T>(acc[2 * dp], a, bf[0], bf[1]);
      ptt::mma16<T>(acc[2 * dp + 1], a, bf[2], bf[3]);
    }
  }
}

// Queries per staged tile: with 64 the four accumulator tiles of a D = 64
// warp took 228 registers; 32 leaves room for three blocks on an SM.
constexpr int kTileM = 32;

// kWarps warps of 16 keys each; query tiles of kTileM rows.
template <typename T, int D, int kWarps, bool kDropout>
__global__ void __launch_bounds__(kWarps * 32) flash_dkv_mma_kernel(Args a) {
  constexpr bool kRegA = D <= 64;  // K, V fragments stay in registers
  constexpr int kThreads = kWarps * 32;
  constexpr int kTileN = kWarps * 16;        // keys a block owns
  constexpr int kLd = D + 8;                  // padded row, in elements
  constexpr int kKs = D / 16;
  constexpr int kNt = kTileM / 8;     // 8-query tiles of S^T and dP^T
  extern __shared__ __align__(16) unsigned char ptt_smem[];
  T* k_s = reinterpret_cast<T*>(ptt_smem);  // [kTileN][kLd]
  T* v_s = k_s + kTileN * kLd;                 // [kTileN][kLd]
  T* q_s = v_s + kTileN * kLd;                 // [2][kTileM][kLd]
  T* do_s = q_s + 2 * kTileM * kLd;            // [2][kTileM][kLd]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kTileM * kLd);
  float* delta_s = lse_s + 2 * kTileM;            // both [2][kTileM]

  const int S_q = a.S_q, S_k = a.S_k;
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.y * kTileN;  // causal: key tile 0 is the heaviest
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int key_w = k0 + warp * 16;  // the warp's first key
  const bool has_bias = a.bias.p != nullptr;
  const long long bias_base = b * a.bias.b + h * a.bias.h;
  const float scale_log2 = a.scale * ptt::kLog2e;

  const T* q_src = static_cast<const T*>(a.q) + offset(a.sq, b, 0, h);
  const T* k_src = static_cast<const T*>(a.k) + offset(a.sk, b, 0, h);
  const T* v_src = static_cast<const T*>(a.v) + offset(a.sv, b, 0, h);
  const T* do_src =
      static_cast<const T*>(a.dout) + offset(a.sdo, b, 0, h);
  const float* lse_src = a.lse + static_cast<long long>(bh) * S_q;
  const float* delta_src = a.delta + static_cast<long long>(bh) * S_q;
  // causal: only queries at or after this tile's first key see it; a tile
  // at or past S_q (S_q < S_k) sees none, stages nothing and writes zeros
  const int q_begin = a.causal ? k0 / kTileM * kTileM : 0;
  const int n_tiles = max(0, (S_q - q_begin + kTileM - 1) / kTileM);

  auto stage_queries = [&](int stage, int q0) {
    ptt::stage_rows<D, kLd, kTileM, kThreads>(q_s + stage * kTileM * kLd,
                                              q_src, a.sq.s, q0, S_q);
    ptt::stage_rows<D, kLd, kTileM, kThreads>(do_s + stage * kTileM * kLd,
                                              do_src, a.sdo.s, q0, S_q);
    for (int i = threadIdx.x; i < kTileM; i += kThreads) {
      const bool ok = q0 + i < S_q;
      const int qi = ok ? q0 + i : 0;
      ptt::cp_async_4(lse_s + stage * kTileM + i, lse_src + qi, ok);
      ptt::cp_async_4(delta_s + stage * kTileM + i, delta_src + qi, ok);
    }
  };
  if (n_tiles > 0) {
    ptt::stage_rows<D, kLd, kTileN, kThreads>(k_s, k_src, a.sk.s, k0, S_k);
    ptt::stage_rows<D, kLd, kTileN, kThreads>(v_s, v_src, a.sv.s, k0, S_k);
    stage_queries(0, q_begin);
  }
  ptt::cp_async_commit();

  // the A operands: this warp's 16 rows of K and of V
  T* k_w = k_s + warp * 16 * kLd;
  T* v_w = v_s + warp * 16 * kLd;
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
      const T* qt = q_s + stage * kTileM * kLd;
      const T* dot = do_s + stage * kTileM * kLd;
      // each lane's query columns 2t, 2t + 1 of every 8-query tile
      const float2* lse_t =
          reinterpret_cast<const float2*>(lse_s + stage * kTileM) + t;
      const float2* delta_t =
          reinterpret_cast<const float2*>(delta_s + stage * kTileM) + t;
      float p[kNt][4];  // rows: keys g, g + 8; columns: queries
      times_transposed<T, D, kLd, kNt, kRegA>(p, kf, k_w, qt, lane);
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
            if (qi < S_q && kj < S_k)
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
      // queries past S_q, keys past S_k or pairs above the diagonal
      if (q0 + kTileM > S_q || key_w + 16 > S_k ||
          (a.causal && q0 < key_w + 15)) {
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = q0 + j * 8 + 2 * t + (e & 1);
            const int kj = key_w + g + (e >> 1) * 8;
            if (qi >= S_q || kj >= S_k || (a.causal && kj > qi))
              p[j][e] = 0.f;
          }
        }
      }
      if constexpr (!kDropout) {
        accumulate<T, D, kLd, kNt>(dv, p, dot, lane);
        float ds[kNt][4];  // dS^T = P^T (dP^T - delta) * scale
        times_transposed<T, D, kLd, kNt, kRegA>(ds, vf, v_w, dot, lane);
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
          const float2 delta = delta_t[j * 4];
          ds[j][0] = p[j][0] * (ds[j][0] - delta.x) * a.scale;
          ds[j][1] = p[j][1] * (ds[j][1] - delta.y) * a.scale;
          ds[j][2] = p[j][2] * (ds[j][2] - delta.x) * a.scale;
          ds[j][3] = p[j][3] * (ds[j][3] - delta.y) * a.scale;
        }
        accumulate<T, D, kLd, kNt>(dk, ds, qt, lane);
      } else {
        // keep[n] bit 8j + i (after the shift by 2t) keeps the lane's key
        // key_w + g + 8n against query q0 + 8j + 2t + i
        uint32_t keep[2];
        ptt::column_keep_bits<2>(keep, a.drop, bh, q0, key_w, g);
        keep[0] >>= 2 * t;
        keep[1] >>= 2 * t;
        float ds[kNt][4];  // dS^T = P^T (dP^T Z / (1 - p) - delta) * scale
        times_transposed<T, D, kLd, kNt, kRegA>(ds, vf, v_w, dot, lane);
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
          const float2 delta = delta_t[j * 4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool z = (keep[e >> 1] >> (8 * j + (e & 1))) & 1u;
            const float dp = z ? ds[j][e] * a.drop.scale : 0.f;
            ds[j][e] =
                p[j][e] * (dp - (e & 1 ? delta.y : delta.x)) * a.scale;
            p[j][e] = z ? p[j][e] * a.drop.scale : 0.f;  // dv's weights
          }
        }
        accumulate<T, D, kLd, kNt>(dv, p, dot, lane);
        accumulate<T, D, kLd, kNt>(dk, ds, qt, lane);
      }
    }
    __syncthreads();  // the stage is free for the copy after next
  }

  // dk, dv through the warp's own rows of the K and V tiles, then 16-byte
  // stores
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(k_w + g * kLd + c) =
        ptt::pack16<T>(dk[j][0], dk[j][1]);
    *reinterpret_cast<uint32_t*>(k_w + (g + 8) * kLd + c) =
        ptt::pack16<T>(dk[j][2], dk[j][3]);
    *reinterpret_cast<uint32_t*>(v_w + g * kLd + c) =
        ptt::pack16<T>(dv[j][0], dv[j][1]);
    *reinterpret_cast<uint32_t*>(v_w + (g + 8) * kLd + c) =
        ptt::pack16<T>(dv[j][2], dv[j][3]);
  }
  __syncwarp();
  ptt::store_rows_16<D, kLd>(k_w,
                             static_cast<T*>(a.d0) + offset(a.sd0, b, 0, h),
                             a.sd0.s, key_w, S_k);
  ptt::store_rows_16<D, kLd>(v_w,
                             static_cast<T*>(a.d1) + offset(a.sd1, b, 0, h),
                             a.sd1.s, key_w, S_k);
}

template <typename T, int D, int kWarps, bool kDropout>
int launch_dkv_mma_tile(const Args& a, int B, cudaStream_t st) {
  constexpr int kTileN = kWarps * 16;
  constexpr int kSmem =
      (2 * kTileN + 4 * kTileM) * (D + 8) * 2 + 4 * kTileM * 4;
  static bool configured = false;  // more than 48 KB needs asking for, once
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_dkv_mma_kernel<T, D, kWarps, kDropout>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(B * a.H, (a.S_k + kTileN - 1) / kTileN);
  flash_dkv_mma_kernel<T, D, kWarps, kDropout>
      <<<grid, kWarps * 32, kSmem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The largest key tile that still gives every SM a block (and is not
// mostly padding); 16 keys when no tile does.
template <typename T, int D, bool kDropout>
int launch_dkv_mma_dim(const Args& a, int B, cudaStream_t st) {
  const long long bh = static_cast<long long>(B) * a.H;
  const int sms = ptt::sm_count();
  auto fills = [&](int tile) {
    return a.S_k > tile / 2 && bh * ((a.S_k + tile - 1) / tile) >= sms;
  };
  if (fills(64)) return launch_dkv_mma_tile<T, D, 4, kDropout>(a, B, st);
  if (fills(32)) return launch_dkv_mma_tile<T, D, 2, kDropout>(a, B, st);
  return launch_dkv_mma_tile<T, D, 1, kDropout>(a, B, st);
}

// ---------------------------------------------------------------------------
// the tensor-core dq kernel
// ---------------------------------------------------------------------------
// Keys per streamed tile: 32 was faster than 64 at every training shape.
constexpr int kDqKeys = 32;

// kWarps warps of 16 queries each; key tiles of kDqKeys rows.  The
// minimum of one block an SM in the launch bounds lets ptxas give each
// thread the registers it needs: without it, ptxas capped D = 64 at 4
// warps below them and spilled.
template <typename T, int D, int kWarps, bool kDropout>
__global__ void __launch_bounds__(kWarps * 32, 1) flash_dq_mma_kernel(Args a) {
  constexpr bool kRegA = D <= 64;  // Q, dO fragments stay in registers
  constexpr int kThreads = kWarps * 32;
  constexpr int kTileM = kWarps * 16;  // queries a block owns
  constexpr int kTileN = kDqKeys;
  constexpr int kLd = D + 8;  // padded row, in elements
  constexpr int kKs = D / 16;
  constexpr int kNt = kTileN / 8;  // 8-key tiles of S and dP
  extern __shared__ __align__(16) unsigned char ptt_smem[];
  T* q_s = reinterpret_cast<T*>(ptt_smem);  // [kTileM][kLd]
  T* do_s = q_s + kTileM * kLd;                // [kTileM][kLd]
  T* k_s = do_s + kTileM * kLd;                // [2][kTileN][kLd]
  T* v_s = k_s + 2 * kTileN * kLd;             // [2][kTileN][kLd]

  const int S_q = a.S_q, S_k = a.S_k;
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  // causal: the last query tile walks the most keys, so it goes first
  const int q_tile = a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = q_tile * kTileM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16;  // the warp's first query
  const bool has_bias = a.bias.p != nullptr;
  const long long bias_base = b * a.bias.b + h * a.bias.h;
  const float scale_log2 = a.scale * ptt::kLog2e;

  const T* q_src = static_cast<const T*>(a.q) + offset(a.sq, b, 0, h);
  const T* k_src = static_cast<const T*>(a.k) + offset(a.sk, b, 0, h);
  const T* v_src = static_cast<const T*>(a.v) + offset(a.sv, b, 0, h);
  const T* do_src =
      static_cast<const T*>(a.dout) + offset(a.sdo, b, 0, h);
  // causal: keys up to the tile's diagonal; otherwise every key
  const int k_end = a.causal ? min(S_k, q0 + kTileM) : S_k;
  const int n_tiles = (k_end + kTileN - 1) / kTileN;

  ptt::stage_rows<D, kLd, kTileM, kThreads>(q_s, q_src, a.sq.s, q0, S_q);
  ptt::stage_rows<D, kLd, kTileM, kThreads>(do_s, do_src, a.sdo.s, q0, S_q);
  ptt::stage_rows<D, kLd, kTileN, kThreads>(k_s, k_src, a.sk.s, 0, S_k);
  ptt::stage_rows<D, kLd, kTileN, kThreads>(v_s, v_src, a.sv.s, 0, S_k);
  ptt::cp_async_commit();

  // LSE and delta of the lane's rows g and g + 8; without a bias LSE is
  // taken in base-2 units, the scale folded into the exponent
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + g + r * 8;
    const long long row = static_cast<long long>(bh) * S_q + qi;
    lse[r] = qi < S_q ? a.lse[row] : 0.f;
    delta[r] = qi < S_q ? a.delta[row] : 0.f;
    if (!has_bias) lse[r] *= ptt::kLog2e;
  }

  // the A operands: this warp's 16 rows of Q and of dO
  const T* q_w = q_s + warp * 16 * kLd;
  const T* do_w = do_s + warp * 16 * kLd;
  uint32_t qf[kRegA ? kKs : 1][4], dof[kRegA ? kKs : 1][4];
  float dq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int stage = i & 1, k0 = i * kTileN;
    if (i + 1 < n_tiles) {
      const int next = (stage ^ 1) * kTileN * kLd;
      ptt::stage_rows<D, kLd, kTileN, kThreads>(k_s + next, k_src, a.sk.s,
                                                k0 + kTileN, S_k);
      ptt::stage_rows<D, kLd, kTileN, kThreads>(v_s + next, v_src, a.sv.s,
                                                k0 + kTileN, S_k);
    }
    ptt::cp_async_commit();
    ptt::cp_async_wait<1>();  // tile i has landed; tile i + 1 is in flight
    __syncthreads();
    if (kRegA && i == 0) {
#pragma unroll
      for (int kk = 0; kk < kKs; ++kk) {
        load_a<kLd>(qf[kRegA ? kk : 0], q_w, kk, lane);
        load_a<kLd>(dof[kRegA ? kk : 0], do_w, kk, lane);
      }
    }
    // rows past S_q do no work; causal: a key tile wholly above the
    // warp's rows changes nothing
    if (row0 < S_q && (!a.causal || k0 <= row0 + 15)) {
      const T* kt = k_s + stage * kTileN * kLd;
      const T* vt = v_s + stage * kTileN * kLd;
      float p[kNt][4];  // rows: queries g, g + 8; columns: keys
      times_transposed<T, D, kLd, kNt, kRegA>(p, qf, q_w, kt, lane);
      if (has_bias) {
        // natural units, the difference formed first: a row masked
        // everywhere by -1e30 gives exactly exp(0)
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = row0 + g + (e >> 1) * 8;
            const int kj = k0 + j * 8 + 2 * t + (e & 1);
            float x = p[j][e] * a.scale;
            if (qi < S_q && kj < S_k)
              x += a.bias.p[bias_base + qi * a.bias.q + kj * a.bias.k];
            p[j][e] = ptt::fast_exp2((x - lse[e >> 1]) * ptt::kLog2e);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            p[j][e] = ptt::fast_exp2(fmaf(p[j][e], scale_log2, -lse[e >> 1]));
        }
      }
      // keys past S_k, or pairs above the diagonal: only on a straddling
      // tile
      if (k0 + kTileN > S_k || (a.causal && k0 + kTileN - 1 > row0)) {
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = row0 + g + (e >> 1) * 8;
            const int kj = k0 + j * 8 + 2 * t + (e & 1);
            if (kj >= S_k || (a.causal && kj > qi)) p[j][e] = 0.f;
          }
        }
      }
      float ds[kNt][4];  // dS = P (dP - delta) * scale
      times_transposed<T, D, kLd, kNt, kRegA>(ds, dof, do_w, vt, lane);
      if constexpr (kDropout) {
        // dP of the dropped weights, masked and rescaled likewise
        uint32_t keep[2][2];
        ptt::row_keep_bits<kTileN>(keep, a.drop, bh, row0, k0, lane);
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ds[j][e] = ptt::row_kept<kTileN>(keep, j, e)
                           ? ds[j][e] * a.drop.scale
                           : 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[j][e] = p[j][e] * (ds[j][e] - delta[e >> 1]) * a.scale;
      }
      accumulate<T, D, kLd, kNt>(dq, ds, kt, lane);
    }
    __syncthreads();  // the stage is free for the copy after next
  }

  // dq through the warp's own rows of the Q tile, then 16-byte stores
  T* out_w = q_s + warp * 16 * kLd;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(out_w + g * kLd + c) =
        ptt::pack16<T>(dq[j][0], dq[j][1]);
    *reinterpret_cast<uint32_t*>(out_w + (g + 8) * kLd + c) =
        ptt::pack16<T>(dq[j][2], dq[j][3]);
  }
  __syncwarp();
  ptt::store_rows_16<D, kLd>(out_w,
                             static_cast<T*>(a.d0) + offset(a.sd0, b, 0, h),
                             a.sd0.s, row0, S_q);
}

template <typename T, int D, int kWarps, bool kDropout>
int launch_dq_mma_tile(const Args& a, int B, cudaStream_t st) {
  constexpr int kTileM = kWarps * 16;
  constexpr int kSmem = (2 * kTileM + 4 * kDqKeys) * (D + 8) * 2;
  static bool configured = false;  // more than 48 KB needs asking for, once
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_dq_mma_kernel<T, D, kWarps, kDropout>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(B * a.H, (a.S_q + kTileM - 1) / kTileM);
  flash_dq_mma_kernel<T, D, kWarps, kDropout>
      <<<grid, kWarps * 32, kSmem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The largest query tile that still gives every SM a block (and is not
// mostly padding); 16 queries when no tile does.
template <typename T, int D, bool kDropout>
int launch_dq_mma_dim(const Args& a, int B, cudaStream_t st) {
  const long long bh = static_cast<long long>(B) * a.H;
  const int sms = ptt::sm_count();
  auto fills = [&](int tile) {
    return a.S_q > tile / 2 && bh * ((a.S_q + tile - 1) / tile) >= sms;
  };
  if (fills(64)) return launch_dq_mma_tile<T, D, 4, kDropout>(a, B, st);
  if (fills(32)) return launch_dq_mma_tile<T, D, 2, kDropout>(a, B, st);
  return launch_dq_mma_tile<T, D, 1, kDropout>(a, B, st);
}

template <typename T, bool kDq, bool kDropout>
int launch_mma(const Args& a, int B, int D, cudaStream_t st) {
#define PTT_FLASH_BWD_MMA_CASE(DIM)                           \
  case DIM:                                                   \
    if constexpr (kDq)                                        \
      return launch_dq_mma_dim<T, DIM, kDropout>(a, B, st);   \
    else                                                      \
      return launch_dkv_mma_dim<T, DIM, kDropout>(a, B, st);
  switch (D) {
    PTT_FLASH_BWD_MMA_CASE(16)
    PTT_FLASH_BWD_MMA_CASE(32)
    PTT_FLASH_BWD_MMA_CASE(64)
    PTT_FLASH_BWD_MMA_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PTT_FLASH_BWD_MMA_CASE
}

// ---------------------------------------------------------------------------
// the split-TF32 tensor-core kernels (float32)
// ---------------------------------------------------------------------------
// Both kernels are the 16-bit kernels' design with every product on
// `mma.sync.m16n8k8` TF32 through `mma_tf32x3` (mma.cuh): each float32
// operand x is split into big = tf32(x) and small = tf32(x - big), and
// a . b = al.bh + ah.bl + ah.bh with float32 accumulators, as the float32
// forward (flash_fwd_tf32x3_kernel) computes.  The contraction index is
// permuted on both sides of a product (k-slot t is index 2t, k-slot t + 4 is
// 2t + 1), so a lane's score accumulators (columns 2t and 2t + 1) are its A
// operand of the second product as they stand: dS for dq += dS K, P^T and
// dS^T for dv += P^T dO and dk += dS^T Q.  P and dS stay float32 (the
// reference's `ds.astype(k.dtype)` is the identity) and are split like any
// operand.
//
// Shared float32 tiles: `ldmatrix` does not transpose 32-bit elements, so
// fragments are plain shared-memory reads, and one streamed tile is read two
// ways.  Where d is contracted (S = Q K^T, dP = dO V^T and their transposes)
// a lane reads a float2 of row g at columns 8kk + 2t, 2t + 1; where the
// sequence is contracted (dS K; P^T dO, dS^T Q) it reads rows 8kk + 2t and
// 8kk + 2t + 1 at column 8dp + g.  No row padding serves both (a stride of
// 8 mod 32 floats makes the second 2-way, 4 mod 32 the first), so the rows
// are unpadded (32 floats at D = 16) and the four 8-float column groups of
// each 32 are XOR-swizzled by the row: column c of row r lies at
// c ^ 8 * swz(r), swz(r) = (r & 3) ^ ((r >> 2) & 1), a permutation of 0..3
// on rows 0-3, on 4-7, on the even rows and on the odd rows of each 8.  Both
// reads then hit 32 distinct banks (a half-warp's float2 reads, a warp's
// float reads; tests/test_torch_tf32x3_attention_bwd.py counts them, as no
// profiler counts bank conflicts on the card's machine), and a 16-byte
// `cp.async` chunk (columns 4c..4c + 3) stays whole.
//
// Every staged tile is split once, in place, after it lands: big where x
// was and small in a second tile of the same layout (one pass of the whole
// block and a barrier), so a fragment is read as its big and small words
// with no split at the read: the operands a block keeps for its whole loop
// (Q and dO in dq, K and V in dk/dv) once, each streamed tile (K and V in
// dq, Q and dO in dk/dv) once a tile, where split at each read (as the
// forward splits) every warp would split it again for each product.  Only
// the accumulator tiles (dS; P^T and dS^T) are split in registers.
//
// The tensor cores truncate (round toward zero) when they add to an
// accumulator.  S = Q K^T (and S^T) chains its D / 8 k-steps in one
// accumulator, as the forward's Q K^T does, so p = exp(s - lse) sees the
// scores the forward's LSE was formed from.  dP = dO V^T (and dP^T) starts
// each k-step from a zero accumulator (`mma_tf32x3_zero`) and adds it on
// the CUDA cores, rounded to nearest (`add_tf32x3`): dS = P (dP - delta)
// subtracts two nearly equal numbers, so a drift of dP toward zero becomes
// a systematic error of dS (chained on an H100, it lifted full-width
// BERT-base's worst float32 gradient against the CPU from 2.6e-4 to
// 8.2e-4 of its scale; the limit is 1e-3).  The sums over the loop (dq
// over S_k keys; dk and dv over S_q queries: 128 k-steps of 8 at
// S = 1024) would drift toward zero chained, as the forward's O did: each
// streamed tile's part starts from a zero accumulator, chains that tile's
// k-steps (4 in dq, 2 in dk/dv) and is added to the running sum on the
// CUDA cores, rounded to nearest.
template <int D>
constexpr int kRowF = D < 32 ? 32 : D;  // floats a shared row

__device__ __forceinline__ int swz(int r) {
  return ((r & 3) ^ ((r >> 2) & 1)) << 3;
}

// Element (r, c) of a swizzled tile.
template <int D>
__device__ __forceinline__ int at(int r, int c) {
  return r * kRowF<D> + (c ^ swz(r));
}

// Copy kRows rows of D float32 (tile row i from src + (r0 + i) * row_stride)
// into a swizzled tile, 16 bytes a copy, by a block of kThreads threads;
// rows at or beyond n_rows are filled with zeros.
template <int D, int kRows, int kThreads>
__device__ __forceinline__ void stage_swz(float* tile, const float* src,
                                          long long row_stride, int r0,
                                          int n_rows) {
  constexpr int kChunks = D / 4;  // 16-byte pieces of a row
#pragma unroll 4
  for (int c = threadIdx.x; c < kRows * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 4;
    const bool ok = r0 + r < n_rows;
    ptt::cp_async_16(tile + at<D>(r, col),
                     ok ? src + (r0 + r) * row_stride + col : src, ok);
  }
}

// Split a block's landed tiles in place: x becomes tf32(x), and `lo` (the
// same layout, kElems floats) receives tf32(x - tf32(x)).
template <int kElems, int kThreads>
__device__ __forceinline__ void split_tiles(float* hi, float* lo) {
  for (int e = threadIdx.x * 4; e < kElems; e += kThreads * 4) {
    const float4 x = *reinterpret_cast<const float4*>(hi + e);
    uint32_t b[4], s[4];
    ptt::split_tf32(x.x, b[0], s[0]);
    ptt::split_tf32(x.y, b[1], s[1]);
    ptt::split_tf32(x.z, b[2], s[2]);
    ptt::split_tf32(x.w, b[3], s[3]);
    *reinterpret_cast<uint4*>(hi + e) = make_uint4(b[0], b[1], b[2], b[3]);
    *reinterpret_cast<uint4*>(lo + e) = make_uint4(s[0], s[1], s[2], s[3]);
  }
}

// The A fragment of k-step kk from a split tile: rows r and r + 8 (r the
// lane's g of a 16-row band), d = 8kk + 2t in k-slot t, 8kk + 2t + 1 in
// t + 4.
template <int D>
__device__ __forceinline__ void load_a_split(uint32_t (&ah)[4],
                                             uint32_t (&al)[4],
                                             const float* hi, const float* lo,
                                             int r, int kk, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int e = at<D>(r + 8 * i, kk * 8 + 2 * t);
    const uint2 h = *reinterpret_cast<const uint2*>(hi + e);
    const uint2 l = *reinterpret_cast<const uint2*>(lo + e);
    ah[i] = h.x;
    ah[i + 2] = h.y;
    al[i] = l.x;
    al[i + 2] = l.y;
  }
}

// The B fragment of a split tile where d is contracted (k-step kk, n = row
// r).
template <int D>
__device__ __forceinline__ void load_b_rows(uint32_t (&bh)[2],
                                            uint32_t (&bl)[2],
                                            const float* hi, const float* lo,
                                            int r, int kk, int t) {
  const int e = at<D>(r, kk * 8 + 2 * t);
  const uint2 h = *reinterpret_cast<const uint2*>(hi + e);
  const uint2 l = *reinterpret_cast<const uint2*>(lo + e);
  bh[0] = h.x;
  bh[1] = h.y;
  bl[0] = l.x;
  bl[1] = l.y;
}

// The B fragment of a split tile where its rows are contracted (rows
// 8kk + 2t and 8kk + 2t + 1, column c).
template <int D>
__device__ __forceinline__ void load_b_cols(uint32_t (&bh)[2],
                                            uint32_t (&bl)[2],
                                            const float* hi, const float* lo,
                                            int kk, int c, int t) {
  const int e0 = at<D>(kk * 8 + 2 * t, c), e1 = at<D>(kk * 8 + 2 * t + 1, c);
  bh[0] = __float_as_uint(hi[e0]);
  bh[1] = __float_as_uint(hi[e1]);
  bl[0] = __float_as_uint(lo[e0]);
  bl[1] = __float_as_uint(lo[e1]);
}

// A score-shaped accumulator tile x[j] (rows g, g + 8; columns 8j + 2t,
// + 1) split as the A operand of k-step j of the second product.
template <int kNt>
__device__ __forceinline__ void split_acc(uint32_t (&xh)[kNt][4],
                                          uint32_t (&xl)[kNt][4],
                                          const float (&x)[kNt][4]) {
#pragma unroll
  for (int j = 0; j < kNt; ++j) {
    ptt::split_tf32(x[j][0], xh[j][0], xl[j][0]);
    ptt::split_tf32(x[j][2], xh[j][1], xl[j][1]);
    ptt::split_tf32(x[j][1], xh[j][2], xl[j][2]);
    ptt::split_tf32(x[j][3], xh[j][3], xl[j][3]);
  }
}

// acc[dp] += X B for the warp's 8-column tiles dp0 .. dp0 + kNd - 1, X the
// split accumulator tiles (kNt k-steps of 8 rows of the split streamed tile
// hi, lo): each column tile's part from a zero accumulator, chained over
// the k-steps, then added rounded to nearest.
template <int D, int kNt, int kNd>
__device__ __forceinline__ void accumulate_tf32x3(
    float (&acc)[kNd][4], const uint32_t (&xh)[kNt][4],
    const uint32_t (&xl)[kNt][4], const float* hi, const float* lo, int dp0,
    int g, int t) {
#pragma unroll
  for (int dp = 0; dp < kNd; ++dp) {
    float part[4];
#pragma unroll
    for (int kk = 0; kk < kNt; ++kk) {
      uint32_t bh[2], bl[2];
      load_b_cols<D>(bh, bl, hi, lo, kk, (dp0 + dp) * 8 + g, t);
      if (kk == 0)
        ptt::mma_tf32x3_zero(part, xh[kk], xl[kk], bh, bl);
      else
        ptt::mma_tf32x3(part, xh[kk], xl[kk], bh, bl);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dp][e] += part[e];
  }
}

// c += a . b with the three products from a zero accumulator, added to c
// rounded to nearest on the CUDA cores (dP and dP^T, a k-step at a time).
__device__ __forceinline__ void add_tf32x3(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  float step[4];
  ptt::mma_tf32x3_zero(step, ah, al, bh, bl);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += step[e];
}

// Keys per streamed tile of dq: 32, 16 at D = 128 (its dq accumulator
// leaves less room for the split dS).
template <int D>
constexpr int kDqKeysF32 = D == 128 ? 16 : 32;

// kWarps warps of 16 queries each, as flash_dq_mma_kernel.
template <int D, int kWarps, bool kDropout>
__global__ void __launch_bounds__(kWarps * 32, 1)
    flash_dq_tf32x3_kernel(Args a) {
  constexpr int kThreads = kWarps * 32;
  constexpr int kTileM = kWarps * 16;  // queries a block owns
  constexpr int kTileN = kDqKeysF32<D>;
  constexpr int kRow = kRowF<D>;
  constexpr int kKs = D / 8;       // k-steps of S, dP; column tiles of dq
  constexpr int kNt = kTileN / 8;  // key tiles of S, dP; k-steps of dS K
  constexpr int kT = kTileN * kRow;  // floats a streamed tile
  extern __shared__ __align__(16) unsigned char ptt_smem[];
  float* q_hi = reinterpret_cast<float*>(ptt_smem);  // [kTileM][kRow]
  float* do_hi = q_hi + kTileM * kRow;                // [kTileM][kRow]
  float* q_lo = do_hi + kTileM * kRow;                // [kTileM][kRow]
  float* do_lo = q_lo + kTileM * kRow;                // [kTileM][kRow]
  float* kv_s = do_lo + kTileM * kRow;  // [2 stages][K, V][kTileN][kRow]
  float* kv_lo = kv_s + 4 * kT;         // [K, V][kTileN][kRow]

  const int S_q = a.S_q, S_k = a.S_k;
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  // causal: the last query tile walks the most keys, so it goes first
  const int q_tile = a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = q_tile * kTileM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16;  // the warp's first query
  const bool has_bias = a.bias.p != nullptr;
  const long long bias_base = b * a.bias.b + h * a.bias.h;
  const float scale_log2 = a.scale * ptt::kLog2e;

  const float* q_src = static_cast<const float*>(a.q) + offset(a.sq, b, 0, h);
  const float* k_src = static_cast<const float*>(a.k) + offset(a.sk, b, 0, h);
  const float* v_src = static_cast<const float*>(a.v) + offset(a.sv, b, 0, h);
  const float* do_src =
      static_cast<const float*>(a.dout) + offset(a.sdo, b, 0, h);
  // causal: keys up to the tile's diagonal; otherwise every key
  const int k_end = a.causal ? min(S_k, q0 + kTileM) : S_k;
  const int n_tiles = (k_end + kTileN - 1) / kTileN;

  stage_swz<D, kTileM, kThreads>(q_hi, q_src, a.sq.s, q0, S_q);
  stage_swz<D, kTileM, kThreads>(do_hi, do_src, a.sdo.s, q0, S_q);
  stage_swz<D, kTileN, kThreads>(kv_s, k_src, a.sk.s, 0, S_k);
  stage_swz<D, kTileN, kThreads>(kv_s + kT, v_src, a.sv.s, 0, S_k);
  ptt::cp_async_commit();

  // LSE and delta of the lane's rows g and g + 8; without a bias LSE is
  // taken in base-2 units, the scale folded into the exponent
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + g + r * 8;
    const long long row = static_cast<long long>(bh) * S_q + qi;
    lse[r] = qi < S_q ? a.lse[row] : 0.f;
    delta[r] = qi < S_q ? a.delta[row] : 0.f;
    if (!has_bias) lse[r] *= ptt::kLog2e;
  }

  const int wrow = warp * 16 + g;  // the lane's first row of the Q tile
  float dq[kKs][4];
#pragma unroll
  for (int j = 0; j < kKs; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    const int stage = i & 1, k0 = i * kTileN;
    float* kt = kv_s + stage * 2 * kT;  // this tile's K, then V
    if (i + 1 < n_tiles) {
      float* next = kv_s + (stage ^ 1) * 2 * kT;
      stage_swz<D, kTileN, kThreads>(next, k_src, a.sk.s, k0 + kTileN, S_k);
      stage_swz<D, kTileN, kThreads>(next + kT, v_src, a.sv.s, k0 + kTileN,
                                     S_k);
    }
    ptt::cp_async_commit();
    ptt::cp_async_wait<1>();  // tile i has landed; tile i + 1 is in flight
    __syncthreads();
    if (i == 0)  // Q and dO have landed with tile 0: split them once
      split_tiles<2 * kTileM * kRow, kThreads>(q_hi, q_lo);
    split_tiles<2 * kT, kThreads>(kt, kv_lo);
    __syncthreads();
    // rows past S_q do no work; causal: a key tile wholly above the
    // warp's rows changes nothing
    if (row0 < S_q && (!a.causal || k0 <= row0 + 15)) {
      const float* vt = kt + kT;
      const float* kt_lo = kv_lo;
      const float* vt_lo = kv_lo + kT;
      float p[kNt][4], ds[kNt][4];  // rows: queries g, g + 8; columns: keys
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
        p[j][0] = p[j][1] = p[j][2] = p[j][3] = 0.f;
        ds[j][0] = ds[j][1] = ds[j][2] = ds[j][3] = 0.f;
      }
      // S = Q K^T (chained) and dP = dO V^T (a k-step at a time): B[d][key]
      // is key g's float2 at dims 8kk + 2t, + 1
#pragma unroll
      for (int kk = 0; kk < kKs; ++kk) {
        uint32_t qh[4], ql[4], oh[4], ol[4];
        load_a_split<D>(qh, ql, q_hi, q_lo, wrow, kk, t);
        load_a_split<D>(oh, ol, do_hi, do_lo, wrow, kk, t);
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
          uint32_t bh_[2], bl[2];
          load_b_rows<D>(bh_, bl, kt, kt_lo, j * 8 + g, kk, t);
          ptt::mma_tf32x3(p[j], qh, ql, bh_, bl);
          load_b_rows<D>(bh_, bl, vt, vt_lo, j * 8 + g, kk, t);
          add_tf32x3(ds[j], oh, ol, bh_, bl);
        }
      }
      if (has_bias) {
        // natural units, the difference formed first: a row masked
        // everywhere by -1e30 gives exactly exp(0)
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = row0 + g + (e >> 1) * 8;
            const int kj = k0 + j * 8 + 2 * t + (e & 1);
            float x = p[j][e] * a.scale;
            if (qi < S_q && kj < S_k)
              x += a.bias.p[bias_base + qi * a.bias.q + kj * a.bias.k];
            p[j][e] = ptt::fast_exp2((x - lse[e >> 1]) * ptt::kLog2e);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            p[j][e] = ptt::fast_exp2(fmaf(p[j][e], scale_log2, -lse[e >> 1]));
        }
      }
      // keys past S_k, or pairs above the diagonal: only on a straddling
      // tile
      if (k0 + kTileN > S_k || (a.causal && k0 + kTileN - 1 > row0)) {
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = row0 + g + (e >> 1) * 8;
            const int kj = k0 + j * 8 + 2 * t + (e & 1);
            if (kj >= S_k || (a.causal && kj > qi)) p[j][e] = 0.f;
          }
        }
      }
      if constexpr (kDropout) {
        // dP of the dropped weights, masked and rescaled likewise
        uint32_t keep[2][2];
        ptt::row_keep_bits<kTileN>(keep, a.drop, bh, row0, k0, lane);
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ds[j][e] = ptt::row_kept<kTileN>(keep, j, e)
                           ? ds[j][e] * a.drop.scale
                           : 0.f;
        }
      }
      // dS = P (dP - delta) * scale, float32
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[j][e] = p[j][e] * (ds[j][e] - delta[e >> 1]) * a.scale;
      }
      // dq += dS K: B[key][d] is K's rows 8kk + 2t, + 1 at column 8dp + g
      uint32_t sh[kNt][4], sl[kNt][4];
      split_acc<kNt>(sh, sl, ds);
      accumulate_tf32x3<D, kNt, kKs>(dq, sh, sl, kt, kt_lo, 0, g, t);
    }
    __syncthreads();  // the stage is free for the copy after next
  }

  // dq from the registers, a float2 a lane a row
  float* dq_dst =
      static_cast<float*>(a.d0) + offset(a.sd0, b, 0, h) + 2 * t;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + g + 8 * r;
    if (qi < S_q) {
#pragma unroll
      for (int j = 0; j < kKs; ++j)
        *reinterpret_cast<float2*>(dq_dst + qi * a.sd0.s + j * 8) =
            make_float2(dq[j][2 * r], dq[j][2 * r + 1]);
    }
  }
}

template <int D, int kWarps, bool kDropout>
int launch_dq_tf32x3_tile(const Args& a, int B, cudaStream_t st) {
  constexpr int kTileM = kWarps * 16;
  constexpr int kSmem = (4 * kTileM + 6 * kDqKeysF32<D>) * kRowF<D> * 4;
  static bool configured = false;  // more than 48 KB needs asking for, once
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_dq_tf32x3_kernel<D, kWarps, kDropout>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(B * a.H, (a.S_q + kTileM - 1) / kTileM);
  flash_dq_tf32x3_kernel<D, kWarps, kDropout>
      <<<grid, kWarps * 32, kSmem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The largest query tile that still gives every SM a block (and is not
// mostly padding), as launch_dq_mma_dim picks; 16 queries when no tile
// does.
template <int D, bool kDropout>
int launch_dq_tf32x3_dim(const Args& a, int B, cudaStream_t st) {
  const long long bh = static_cast<long long>(B) * a.H;
  const int sms = ptt::sm_count();
  auto fills = [&](int tile) {
    return a.S_q > tile / 2 && bh * ((a.S_q + tile - 1) / tile) >= sms;
  };
  if (fills(64)) return launch_dq_tf32x3_tile<D, 4, kDropout>(a, B, st);
  if (fills(32)) return launch_dq_tf32x3_tile<D, 2, kDropout>(a, B, st);
  return launch_dq_tf32x3_tile<D, 1, kDropout>(a, B, st);
}

// Queries per streamed tile of dk/dv: the split P^T and dS^T of a 16-query
// tile (16 registers each) fit beside the dk and dv accumulators.
constexpr int kDkvQueries = 16;

// Warps that share 16 keys, each accumulating D / kDkvSplit columns of dk
// and dv: two at D = 128, where one warp's dk and dv would take 128
// registers a lane (both compute the tile's S^T and dP^T).
template <int D>
constexpr int kDkvSplit = D == 128 ? 2 : 1;

// kWarps / kDkvSplit<D> groups of 16 keys; query tiles of kDkvQueries rows.
template <int D, int kWarps, bool kDropout>
__global__ void __launch_bounds__(kWarps * 32, 1)
    flash_dkv_tf32x3_kernel(Args a) {
  constexpr int kSplit = kDkvSplit<D>;
  constexpr int kThreads = kWarps * 32;
  constexpr int kTileN = kWarps / kSplit * 16;  // keys a block owns
  constexpr int kTileM = kDkvQueries;
  constexpr int kRow = kRowF<D>;
  constexpr int kKs = D / 8;          // k-steps of S^T and dP^T
  constexpr int kNd = kKs / kSplit;   // column tiles of dk, dv a warp owns
  constexpr int kNt = kTileM / 8;     // query tiles of S^T; k-steps of dv, dk
  constexpr int kT = kTileM * kRow;   // floats a streamed tile
  extern __shared__ __align__(16) unsigned char ptt_smem[];
  float* k_hi = reinterpret_cast<float*>(ptt_smem);  // [kTileN][kRow]
  float* v_hi = k_hi + kTileN * kRow;                 // [kTileN][kRow]
  float* k_lo = v_hi + kTileN * kRow;                 // [kTileN][kRow]
  float* v_lo = k_lo + kTileN * kRow;                 // [kTileN][kRow]
  float* qd_s = v_lo + kTileN * kRow;  // [2 stages][Q, dO][kTileM][kRow]
  float* qd_lo = qd_s + 4 * kT;        // [Q, dO][kTileM][kRow]
  float* lse_s = qd_lo + 2 * kT;       // [2][kTileM]
  float* delta_s = lse_s + 2 * kTileM;  // [2][kTileM]

  const int S_q = a.S_q, S_k = a.S_k;
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int k0 = blockIdx.y * kTileN;  // causal: key tile 0 is the heaviest
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int band = (warp / kSplit) * 16;   // the warp's keys in the tile
  const int dp0 = (warp % kSplit) * kNd;   // its first column tile
  const int key_w = k0 + band;             // the warp's first key
  const bool has_bias = a.bias.p != nullptr;
  const long long bias_base = b * a.bias.b + h * a.bias.h;
  const float scale_log2 = a.scale * ptt::kLog2e;

  const float* q_src = static_cast<const float*>(a.q) + offset(a.sq, b, 0, h);
  const float* k_src = static_cast<const float*>(a.k) + offset(a.sk, b, 0, h);
  const float* v_src = static_cast<const float*>(a.v) + offset(a.sv, b, 0, h);
  const float* do_src =
      static_cast<const float*>(a.dout) + offset(a.sdo, b, 0, h);
  const float* lse_src = a.lse + static_cast<long long>(bh) * S_q;
  const float* delta_src = a.delta + static_cast<long long>(bh) * S_q;
  // causal: only queries at or after this tile's first key see it; a tile
  // at or past S_q (S_q < S_k) sees none, stages nothing and writes zeros
  const int q_begin = a.causal ? k0 / kTileM * kTileM : 0;
  const int n_tiles = max(0, (S_q - q_begin + kTileM - 1) / kTileM);

  auto stage_queries = [&](int stage, int q0) {
    stage_swz<D, kTileM, kThreads>(qd_s + stage * 2 * kT, q_src, a.sq.s, q0,
                                   S_q);
    stage_swz<D, kTileM, kThreads>(qd_s + stage * 2 * kT + kT, do_src,
                                   a.sdo.s, q0, S_q);
    for (int i = threadIdx.x; i < kTileM; i += kThreads) {
      const bool ok = q0 + i < S_q;
      const int qi = ok ? q0 + i : 0;
      ptt::cp_async_4(lse_s + stage * kTileM + i, lse_src + qi, ok);
      ptt::cp_async_4(delta_s + stage * kTileM + i, delta_src + qi, ok);
    }
  };
  if (n_tiles > 0) {
    stage_swz<D, kTileN, kThreads>(k_hi, k_src, a.sk.s, k0, S_k);
    stage_swz<D, kTileN, kThreads>(v_hi, v_src, a.sv.s, k0, S_k);
    stage_queries(0, q_begin);
  }
  ptt::cp_async_commit();

  float dk[kNd][4], dv[kNd][4];
#pragma unroll
  for (int j = 0; j < kNd; ++j) {
    dk[j][0] = dk[j][1] = dk[j][2] = dk[j][3] = 0.f;
    dv[j][0] = dv[j][1] = dv[j][2] = dv[j][3] = 0.f;
  }
  // dropout: the keep bits of 32 queries (two tiles) against the warp's
  // keys, drawn at every even tile; keep[n] bit i keeps the lane's key
  // key_w + g + 8n against query q0 + i of the pair's first tile
  uint32_t keep[2] = {0u, 0u};

  for (int i = 0; i < n_tiles; ++i) {
    const int stage = i & 1, q0 = q_begin + i * kTileM;
    if (i + 1 < n_tiles) stage_queries(stage ^ 1, q0 + kTileM);
    ptt::cp_async_commit();
    ptt::cp_async_wait<1>();  // tile i has landed; tile i + 1 is in flight
    __syncthreads();
    float* qt = qd_s + stage * 2 * kT;  // this tile's Q, then dO
    if (i == 0)  // K and V have landed with tile 0: split them once
      split_tiles<2 * kTileN * kRow, kThreads>(k_hi, k_lo);
    split_tiles<2 * kT, kThreads>(qt, qd_lo);
    __syncthreads();
    if constexpr (kDropout) {
      if ((i & 1) == 0 && (!a.causal || q0 + 2 * kTileM - 1 >= key_w))
        ptt::column_keep_bits<2>(keep, a.drop, bh, q0, key_w, g);
    }
    // causal: a query tile wholly before the warp's keys sees none of them
    if (!a.causal || q0 + kTileM - 1 >= key_w) {
      const float* dot = qt + kT;
      const float* qt_lo = qd_lo;
      const float* dot_lo = qd_lo + kT;
      // each lane's query columns 2t, 2t + 1 of every 8-query tile
      const float2* lse_t =
          reinterpret_cast<const float2*>(lse_s + stage * kTileM) + t;
      const float2* delta_t =
          reinterpret_cast<const float2*>(delta_s + stage * kTileM) + t;
      float p[kNt][4], ds[kNt][4];  // rows: keys g, g + 8; columns: queries
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
        p[j][0] = p[j][1] = p[j][2] = p[j][3] = 0.f;
        ds[j][0] = ds[j][1] = ds[j][2] = ds[j][3] = 0.f;
      }
      // S^T = K Q^T (chained) and dP^T = V dO^T (a k-step at a time):
      // B[d][query] is query g's float2 at dims 8kk + 2t, + 1
#pragma unroll
      for (int kk = 0; kk < kKs; ++kk) {
        uint32_t kh[4], kl[4], vh[4], vl[4];
        load_a_split<D>(kh, kl, k_hi, k_lo, band + g, kk, t);
        load_a_split<D>(vh, vl, v_hi, v_lo, band + g, kk, t);
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
          uint32_t bh_[2], bl[2];
          load_b_rows<D>(bh_, bl, qt, qt_lo, j * 8 + g, kk, t);
          ptt::mma_tf32x3(p[j], kh, kl, bh_, bl);
          load_b_rows<D>(bh_, bl, dot, dot_lo, j * 8 + g, kk, t);
          add_tf32x3(ds[j], vh, vl, bh_, bl);
        }
      }
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
            if (qi < S_q && kj < S_k)
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
      // queries past S_q, keys past S_k or pairs above the diagonal
      if (q0 + kTileM > S_q || key_w + 16 > S_k ||
          (a.causal && q0 < key_w + 15)) {
#pragma unroll
        for (int j = 0; j < kNt; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = q0 + j * 8 + 2 * t + (e & 1);
            const int kj = key_w + g + (e >> 1) * 8;
            if (qi >= S_q || kj >= S_k || (a.causal && kj > qi))
              p[j][e] = 0.f;
          }
        }
      }
      // dS^T = P^T (dP^T - delta) * scale; with dropout dP^T Z / (1 - p),
      // and dv's weights P^T Z / (1 - p)
      float pd[kNt][4];
#pragma unroll
      for (int j = 0; j < kNt; ++j) {
        const float2 delta = delta_t[j * 4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float dp = ds[j][e];
          pd[j][e] = p[j][e];
          if constexpr (kDropout) {
            const int bit = (i & 1) * kTileM + j * 8 + 2 * t + (e & 1);
            const bool z = (keep[e >> 1] >> bit) & 1u;
            dp = z ? dp * a.drop.scale : 0.f;
            pd[j][e] = z ? p[j][e] * a.drop.scale : 0.f;
          }
          ds[j][e] = p[j][e] * (dp - (e & 1 ? delta.y : delta.x)) * a.scale;
        }
      }
      uint32_t xh[kNt][4], xl[kNt][4];
      // dv += P^T dO, dk += dS^T Q: B[query][d] is the tile's rows 8kk + 2t,
      // + 1 at column 8dp + g
      split_acc<kNt>(xh, xl, pd);
      accumulate_tf32x3<D, kNt, kNd>(dv, xh, xl, dot, dot_lo, dp0, g, t);
      split_acc<kNt>(xh, xl, ds);
      accumulate_tf32x3<D, kNt, kNd>(dk, xh, xl, qt, qt_lo, dp0, g, t);
    }
    __syncthreads();  // the stage is free for the copy after next
  }

  // dk, dv from the registers, a float2 a lane a row
  float* dk_dst =
      static_cast<float*>(a.d0) + offset(a.sd0, b, 0, h) + dp0 * 8 + 2 * t;
  float* dv_dst =
      static_cast<float*>(a.d1) + offset(a.sd1, b, 0, h) + dp0 * 8 + 2 * t;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = key_w + g + 8 * r;
    if (kj < S_k) {
#pragma unroll
      for (int j = 0; j < kNd; ++j) {
        *reinterpret_cast<float2*>(dk_dst + kj * a.sd0.s + j * 8) =
            make_float2(dk[j][2 * r], dk[j][2 * r + 1]);
        *reinterpret_cast<float2*>(dv_dst + kj * a.sd1.s + j * 8) =
            make_float2(dv[j][2 * r], dv[j][2 * r + 1]);
      }
    }
  }
}

template <int D, int kWarps, bool kDropout>
int launch_dkv_tf32x3_tile(const Args& a, int B, cudaStream_t st) {
  constexpr int kTileN = kWarps / kDkvSplit<D> * 16;
  constexpr int kSmem =
      (4 * kTileN + 6 * kDkvQueries) * kRowF<D> * 4 + 4 * kDkvQueries * 4;
  static bool configured = false;  // more than 48 KB needs asking for, once
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_dkv_tf32x3_kernel<D, kWarps, kDropout>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid(B * a.H, (a.S_k + kTileN - 1) / kTileN);
  flash_dkv_tf32x3_kernel<D, kWarps, kDropout>
      <<<grid, kWarps * 32, kSmem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The largest key tile that still gives every SM a block (and is not
// mostly padding), as launch_dkv_mma_dim picks; 16 keys when no tile does.
template <int D, bool kDropout>
int launch_dkv_tf32x3_dim(const Args& a, int B, cudaStream_t st) {
  constexpr int kSplit = kDkvSplit<D>;
  const long long bh = static_cast<long long>(B) * a.H;
  const int sms = ptt::sm_count();
  auto fills = [&](int tile) {
    return a.S_k > tile / 2 && bh * ((a.S_k + tile - 1) / tile) >= sms;
  };
  if (fills(64))
    return launch_dkv_tf32x3_tile<D, 4 * kSplit, kDropout>(a, B, st);
  if (fills(32))
    return launch_dkv_tf32x3_tile<D, 2 * kSplit, kDropout>(a, B, st);
  return launch_dkv_tf32x3_tile<D, kSplit, kDropout>(a, B, st);
}

template <bool kDq, bool kDropout>
int launch_tf32x3(const Args& a, int B, int D, cudaStream_t st) {
#define PTT_FLASH_BWD_TF32X3_CASE(DIM)                         \
  case DIM:                                                    \
    if constexpr (kDq)                                         \
      return launch_dq_tf32x3_dim<DIM, kDropout>(a, B, st);    \
    else                                                       \
      return launch_dkv_tf32x3_dim<DIM, kDropout>(a, B, st);
  switch (D) {
    PTT_FLASH_BWD_TF32X3_CASE(16)
    PTT_FLASH_BWD_TF32X3_CASE(32)
    PTT_FLASH_BWD_TF32X3_CASE(64)
    PTT_FLASH_BWD_TF32X3_CASE(128)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PTT_FLASH_BWD_TF32X3_CASE
}

// launches of each variant since the library was loaded, [simt, mma,
// tf32x3]: of dq (index 0) and of dk/dv (index 1)
enum Variant { kSimt = 0, kMma = 1, kTf32x3 = 2, kVariants = 3 };
std::atomic<long long> variant_launches[2][kVariants];

bool aligned_16(const void* p, const Strides& s, int elem_bytes) {
  return ptt::aligned_16(p, s.b, s.s, s.h, elem_bytes);
}

template <typename T, bool kDq, bool kDropout>
int launch(const Args& a, int B, int D, cudaStream_t st) {
  // dq: a block per query tile; dk/dv: a block per key tile
  const int rows = kDq ? a.S_q : a.S_k;
  const dim3 grid((rows + kBlockRows - 1) / kBlockRows, B * a.H);
#define PTT_FLASH_BWD_CASE(DIM)                                            \
  case DIM:                                                                \
    if constexpr (kDq)                                                     \
      flash_dq_kernel<T, DIM, kDropout><<<grid, kThreads, 0, st>>>(a);     \
    else                                                                   \
      flash_dkv_kernel<T, DIM, kDropout><<<grid, kThreads, 0, st>>>(a);    \
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

template <bool kDq, bool kDropout>
int dispatch_as(const Args& a, Variant variant, int B, int D, int dtype,
                cudaStream_t st) {
  if (variant == kTf32x3) return launch_tf32x3<kDq, kDropout>(a, B, D, st);
  if (variant == kMma)
    return dtype == ptt::kF16
               ? launch_mma<__half, kDq, kDropout>(a, B, D, st)
               : launch_mma<__nv_bfloat16, kDq, kDropout>(a, B, D, st);
  if (dtype == ptt::kF32) return launch<float, kDq, kDropout>(a, B, D, st);
  if (dtype == ptt::kF16) return launch<__half, kDq, kDropout>(a, B, D, st);
  return launch<__nv_bfloat16, kDq, kDropout>(a, B, D, st);
}

template <bool kDq>
int dispatch(Args a, int B, int D, int dtype, unsigned long long seed,
             const void* step, float dropout_p, void* stream) {
  if (B <= 0 || a.S_q <= 0 || a.S_k <= 0 || a.H <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((dtype != ptt::kF32 && dtype != ptt::kBF16 && dtype != ptt::kF16) ||
      !(dropout_p >= 0.f) || dropout_p > 1.f)
    return static_cast<int>(cudaErrorInvalidValue);
  a.drop = ptt::Dropout::make(seed, dropout_p, step);
  const int esize = dtype == ptt::kF32 ? 4 : 2;
  const bool aligned =
      aligned_16(a.q, a.sq, esize) && aligned_16(a.k, a.sk, esize) &&
      aligned_16(a.v, a.sv, esize) && aligned_16(a.dout, a.sdo, esize) &&
      aligned_16(a.d0, a.sd0, esize) &&
      (kDq || aligned_16(a.d1, a.sd1, esize));
  const Variant variant = !aligned              ? kSimt
                          : dtype == ptt::kF32 ? kTf32x3
                                               : kMma;
  ++variant_launches[kDq ? 0 : 1][variant];
  return dropout_p > 0.f
             ? dispatch_as<kDq, true>(a, variant, B, D, dtype, st)
             : dispatch_as<kDq, false>(a, variant, B, D, dtype, st);
}

}  // namespace

// q, dout, dq: [B, S_q, H, D], k, v: [B, S_k, H, D], with unit stride over
// d; `strides` is a host array of the (b, s, h) element strides of q, k, v,
// dout, dq, in that order (15 values).  lse, delta: [B*H, S_q] float32.
// bias: NULL, or float32 [B, H, S_q, S_k] with element strides (bias_b,
// bias_h, bias_q, bias_k), any of them 0.  causal: 0 or 1 (top-left: query
// i sees key j <= i).  seed, step, dropout_p: the forward's
// dropout (dropout.cuh), whose mask is drawn again here; dropout_p 0
// launches the kernels without it.
extern "C" int ptt_flash_attention_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const long long* strides,
    const void* bias, long long bias_b, long long bias_h, long long bias_q,
    long long bias_k, int B, int S_q, int S_k, int H, int D, float sm_scale,
    int causal, unsigned long long seed, const void* step, float dropout_p,
    int dtype, void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), dq, nullptr,
         strides_at(strides, 0), strides_at(strides, 1),
         strides_at(strides, 2), strides_at(strides, 3),
         strides_at(strides, 4), Strides{0, 0, 0},
         ptt::Bias{static_cast<const float*>(bias), bias_b, bias_h, bias_q,
                   bias_k},
         H, S_q, S_k, sm_scale, causal != 0, ptt::Dropout{}};
  return dispatch<true>(a, B, D, dtype, seed, step, dropout_p, stream);
}

// As above, with dk and dv ([B, S_k, H, D]) as the outputs; `strides` holds
// the (b, s, h) strides of q, k, v, dout, dk, dv (18 values).
extern "C" int ptt_flash_attention_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    const long long* strides, const void* bias, long long bias_b,
    long long bias_h, long long bias_q, long long bias_k, int B, int S_q,
    int S_k, int H, int D, float sm_scale, int causal, unsigned long long seed,
    const void* step, float dropout_p, int dtype, void* stream) {
  Args a{q, k, v, dout, static_cast<const float*>(lse),
         static_cast<const float*>(delta), dk, dv,
         strides_at(strides, 0), strides_at(strides, 1),
         strides_at(strides, 2), strides_at(strides, 3),
         strides_at(strides, 4), strides_at(strides, 5),
         ptt::Bias{static_cast<const float*>(bias), bias_b, bias_h, bias_q,
                   bias_k},
         H, S_q, S_k, sm_scale, causal != 0, ptt::Dropout{}};
  return dispatch<false>(a, B, D, dtype, seed, step, dropout_p, stream);
}

// How many dq launches took the CUDA-core kernel (variant 0), the 16-bit
// tensor-core kernel (variant 1) or the split-TF32 kernel (variant 2) since
// the library was loaded.
extern "C" long long ptt_flash_attention_dq_variant_launches(int variant) {
  return variant >= 0 && variant < kVariants
             ? variant_launches[0][variant].load()
             : -1;
}

// The same for dk/dv.
extern "C" long long ptt_flash_attention_dkv_variant_launches(int variant) {
  return variant >= 0 && variant < kVariants
             ? variant_launches[1][variant].load()
             : -1;
}
