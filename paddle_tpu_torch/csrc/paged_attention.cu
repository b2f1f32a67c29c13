// Ragged paged decode attention: one query token per lane over that lane's
// pages of the KV pool, walked through its int32 page-table row.
//
// Replaces paddle_tpu/ops/pallas/paged_attention.py `_kernel` (called from
// `paged_decode_attention`).  Bound by bytes: every live K and V element is
// read once for 2 flops each, so the kernel is a stream over the lane's
// live pages, and the lanes' lengths differ widely (one lane at 512 tokens
// beside lanes at 16).  Both kernels below load their own page-table row
// and `pos` (the TPU prefetched them as scalars), walk ceil(seq_cap /
// page_size) table columns, skip pages that are unmapped (-1), out of the
// pool, or start past `pos`, never visit a token past `pos`, and give a
// lane with no live token 0, never NaN.  Any page size: the Pallas
// `page_size < 8` refusal was a TPU tiling artefact.  The pool is only
// read; the current token's K/V was scattered before the call.
//
// float32, bf16 and float16 (each type its own instantiation of both
// kernels, chosen by the dtype code; scores, softmax and P.V accumulate in
// float32 and the output takes q's type, as the Pallas kernel's
// `o_ref.dtype`).  The C entry picks one of two kernels from the head dim
// and the operands' alignment alone, and counts the choice:
//
// `paged_decode_split_kernel` (flash-decoding; q rows, the pools and out
// on 16-byte boundaries and hd a multiple of one 16-byte vector: every
// path of the models).  The sequence is split across blocks: block
// (chunk, head, lane) takes one fixed chunk of the lane's tokens for one
// head, so no block's work grows with the longest lane, and a block whose
// chunk starts past `pos` exits at once.  A token's row for one head is hd
// contiguous elements (128 bytes at hd = 64 in bf16); kTpr threads take a
// row as one 16-byte vector each (8 at hd = 64 bf16), so a warp covers
// 32 / kTpr tokens an instruction, and a block of 128 threads covers 128 /
// kTpr tokens.  Each thread owns kTokensPerGroup = 4 tokens of the chunk
// and issues all their page-table, K and V loads before it uses one: the
// chunk is 4 * 128 / kTpr tokens (64 at hd = 64 bf16, a few pages).  Then
// the chunk's scores, one block max, one exp2 pass and P.V, with no
// rescaling per token.  Chunk and grouping: the table's shape (8 lanes,
// 12 heads, one lane at 512 tokens, six short, one inactive) gives 26 live
// chunks x 12 heads = 312 blocks, the serving wave's (8 lanes at 20-176
// tokens) about 190: one to three blocks of 4 warps on each of the 132
// SMs, with 8 16-byte loads in flight a thread.  The chunks of one (lane,
// head) are merged in the same launch, so serving pays no launch per layer
// for it: each block writes its float32 partial (m, l, acc[hd]) to scratch
// that the wrapper allocates; an arrival counter (int32, zeroed once by
// the wrapper, set back to 0 by the block that merges) finds the last
// block, which merges the partials in chunk order, not arrival order.  So
// the output is bitwise the same from run to run and does not depend on
// the batch mates.  A lane whose live tokens fit one chunk skips the
// scratch and writes its output directly.
//
// `paged_decode_kernel` (any other operand) gives each (head, lane) one
// block of four warps; warps take the tokens of each live page in turn, the
// 32 threads of a warp split the head dim, reduce the q.k dot with shuffles
// and keep an online softmax (m, l, acc) in float32 registers, and the four
// warps' states are merged through shared memory at the end.
#include <math.h>

#include <atomic>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kMaxPerThread = 4;  // head_dim <= 128

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    paged_decode_kernel(const T* __restrict__ q, long long q_lane_stride,
                        long long q_head_stride, const T* __restrict__ k_pages,
                        const T* __restrict__ v_pages,
                        const int* __restrict__ rows,
                        const int* __restrict__ pos, T* __restrict__ out,
                        int num_pages, int page_size, int nh, int hd,
                        int pages_per_slot, int pages_walked, float sm_scale) {
  __shared__ float part_m[kWarps], part_l[kWarps];
  __shared__ float part_acc[kWarps][kMaxPerThread * 32];

  const int h = blockIdx.x, lane = blockIdx.y;
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;

  float qreg[kMaxPerThread], acc[kMaxPerThread];
  const T* qrow = q + lane * q_lane_stride + h * q_head_stride;
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int d = t + 32 * i;
    qreg[i] = d < hd ? ptt::to_f32(qrow[d]) * sm_scale : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  const int last = pos[lane];  // inclusive attention extent
  const int* row = rows + static_cast<long long>(lane) * pages_per_slot;
  const long long tok_stride = static_cast<long long>(nh) * hd;
  const long long page_stride = tok_stride * page_size;
  for (int p = 0; p < pages_walked; ++p) {
    const int page = row[p];
    const int first_tok = p * page_size;
    if (page < 0 || page >= num_pages || first_tok > last) continue;
    const int n_tok = min(page_size, last - first_tok + 1);
    const T* kp = k_pages + page * page_stride + h * hd;
    const T* vp = v_pages + page * page_stride + h * hd;
    for (int j = warp; j < n_tok; j += kWarps) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxPerThread; ++i) {
        const int d = t + 32 * i;
        if (d < hd) dot += qreg[i] * ptt::to_f32(kp[j * tok_stride + d]);
      }
      dot = ptt::warp_sum(dot);
      const float m_new = fmaxf(m, dot);
      const float alpha = expf(m - m_new);
      const float pr = expf(dot - m_new);
      l = l * alpha + pr;
#pragma unroll
      for (int i = 0; i < kMaxPerThread; ++i) {
        const int d = t + 32 * i;
        const float vv = d < hd ? ptt::to_f32(vp[j * tok_stride + d]) : 0.f;
        acc[i] = acc[i] * alpha + pr * vv;
      }
      m = m_new;
    }
  }

  if (t == 0) {
    part_m[warp] = m;
    part_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) part_acc[warp][t + 32 * i] = acc[i];
  __syncthreads();
  if (warp != 0) return;

  float m_all = -INFINITY;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, part_m[w]);
  float scale[kWarps];
  float l_all = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    // a warp that saw no token has m = -inf: weight 0, never inf - inf
    scale[w] = part_m[w] == -INFINITY ? 0.f : expf(part_m[w] - m_all);
    l_all += part_l[w] * scale[w];
  }
  const float inv_l = l_all > 0.f ? 1.f / l_all : 0.f;
  T* orow = out + (static_cast<long long>(lane) * nh + h) * hd;
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int d = t + 32 * i;
    if (d >= hd) continue;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += part_acc[w][d] * scale[w];
    orow[d] = ptt::from_f32<T>(o * inv_l);
  }
}

constexpr int kSplitThreads = 128;
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kTokensPerGroup = 4;  // tokens a thread loads before use

// Max over the whole block; every thread gets it.  `red` holds kSplitWarps
// floats of shared memory.
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();  // a previous reader of red is done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < kSplitWarps; ++w) v = fmaxf(v, red[w]);
  return v;
}

// kTpr: threads a token row (4, 8, 16 or 32), each one 16-byte vector of
// it; lanes past hd / kN load nothing.  Scores are in base 2: q is scaled
// by sm_scale * log2(e) once.
template <typename T, int kTpr>
__global__ void __launch_bounds__(kSplitThreads, 1)
    paged_decode_split_kernel(const T* __restrict__ q, long long q_lane_stride,
                              long long q_head_stride,
                              const T* __restrict__ k_pages,
                              const T* __restrict__ v_pages,
                              const int* __restrict__ rows,
                              const int* __restrict__ pos,
                              T* __restrict__ out, float* __restrict__ part,
                              int* __restrict__ arrivals, int num_pages,
                              int page_size, int nh, int hd,
                              int pages_per_slot, int walked_tokens,
                              float scale_log2) {
  using V = ptt::Vec16<T>;
  constexpr int kN = V::kN;
  constexpr int kGroups = kSplitThreads / kTpr;
  constexpr int kChunk = kGroups * kTokensPerGroup;
  __shared__ float red[kSplitWarps];
  __shared__ float acc_s[kSplitWarps][kMaxPerThread * 32];
  __shared__ float w_s[kSplitThreads], l_s[kSplitThreads];
  __shared__ int merge;

  const int chunk = blockIdx.x, h = blockIdx.y, lane = blockIdx.z;
  const int n_chunks = gridDim.x;
  const int tid = threadIdx.x, grp = tid / kTpr, sub = tid % kTpr;
  const int warp = tid >> 5, wl = tid & 31;
  const bool has_vec = sub * kN < hd;
  const int c0 = chunk * kChunk;

  // first round trip, all independent: pos, this thread's page-table
  // entries and its q vector
  const int last = pos[lane];  // inclusive attention extent
  const int* row = rows + static_cast<long long>(lane) * pages_per_slot;
  int page[kTokensPerGroup];
#pragma unroll
  for (int i = 0; i < kTokensPerGroup; ++i) {
    const int t = c0 + i * kGroups + grp;
    page[i] = t < walked_tokens ? row[t / page_size] : -1;
  }
  uint4 qr = make_uint4(0u, 0u, 0u, 0u);
  if (has_vec)
    qr = *reinterpret_cast<const uint4*>(q + lane * q_lane_stride +
                                         h * q_head_stride + sub * kN);
  // a chunk past the lane's last token has nothing to do; chunk 0 always
  // runs, so a lane with no live token still writes its 0
  if (chunk > 0 && c0 > last) return;
  const int live = last < 0 ? 1 : min(n_chunks, last / kChunk + 1);
  const int lim = min(last, walked_tokens - 1);  // last token visited

  // second round trip: the chunk's K and V rows, all in flight together
  const long long tok_stride = static_cast<long long>(nh) * hd;
  uint4 kr[kTokensPerGroup], vr[kTokensPerGroup];
  bool ok[kTokensPerGroup];
#pragma unroll
  for (int i = 0; i < kTokensPerGroup; ++i) {
    const int t = c0 + i * kGroups + grp;
    ok[i] = t <= lim && page[i] >= 0 && page[i] < num_pages;
    kr[i] = vr[i] = make_uint4(0u, 0u, 0u, 0u);
    if (ok[i] && has_vec) {
      const long long at =
          (static_cast<long long>(page[i]) * page_size + t % page_size) *
              tok_stride +
          h * hd + sub * kN;
      kr[i] = *reinterpret_cast<const uint4*>(k_pages + at);
      vr[i] = *reinterpret_cast<const uint4*>(v_pages + at);
    }
  }

  float qf[kN];
  V::unpack(qr, qf);
#pragma unroll
  for (int e = 0; e < kN; ++e) qf[e] *= scale_log2;
  float s[kTokensPerGroup];
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < kTokensPerGroup; ++i) {
    float kf[kN];
    V::unpack(kr[i], kf);
    float d = 0.f;
#pragma unroll
    for (int e = 0; e < kN; ++e) d = fmaf(qf[e], kf[e], d);
#pragma unroll
    for (int o = kTpr / 2; o > 0; o >>= 1)  // the row's kTpr threads
      d += __shfl_xor_sync(0xffffffffu, d, o);
    s[i] = ok[i] ? d : -INFINITY;
    m = fmaxf(m, s[i]);
  }
  m = block_max(m, red);

  float l = 0.f, acc[kN];
#pragma unroll
  for (int e = 0; e < kN; ++e) acc[e] = 0.f;
#pragma unroll
  for (int i = 0; i < kTokensPerGroup; ++i) {
    const float p = ok[i] ? exp2f(s[i] - m) : 0.f;
    float vf[kN];
    V::unpack(vr[i], vf);
    l += p;
#pragma unroll
    for (int e = 0; e < kN; ++e) acc[e] = fmaf(p, vf[e], acc[e]);
  }
  // sum over the warp's groups (lanes kTpr apart hold the same column)
#pragma unroll
  for (int o = 16; o >= kTpr; o >>= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
    for (int e = 0; e < kN; ++e)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  }
  __syncthreads();  // block_max's readers of red are done
  if (wl == 0) red[warp] = l;
  if (wl < kTpr && has_vec) {
#pragma unroll
    for (int e = 0; e < kN; ++e) acc_s[warp][sub * kN + e] = acc[e];
  }
  __syncthreads();
  float l_blk = 0.f;
#pragma unroll
  for (int w = 0; w < kSplitWarps; ++w) l_blk += red[w];
  float o_blk = 0.f;
  if (tid < hd) {
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) o_blk += acc_s[w][tid];
  }
  T* orow = out + (static_cast<long long>(lane) * nh + h) * hd;
  if (live == 1) {  // the block's sums are the lane's
    if (tid < hd) orow[tid] = ptt::from_f32<T>(l_blk > 0.f ? o_blk / l_blk
                                                            : 0.f);
    return;
  }

  // write this chunk's partial; the last of the lane's live chunks to
  // arrive merges them all
  const int row_len = hd + 2;
  float* base =
      part + (static_cast<long long>(lane) * nh + h) * n_chunks * row_len;
  float* mine = base + static_cast<long long>(chunk) * row_len;
  if (tid < hd) mine[tid] = o_blk;
  if (tid == 0) {
    mine[hd] = m;
    mine[hd + 1] = l_blk;
  }
  __threadfence();  // the partial is visible before the arrival counts
  __syncthreads();
  if (tid == 0) {
    int* count = arrivals + static_cast<long long>(lane) * nh + h;
    merge = atomicAdd(count, 1) == live - 1;
    if (merge) *count = 0;  // every live chunk has arrived: ready for reuse
  }
  __syncthreads();
  if (!merge) return;
  __threadfence();

  // merge in chunk order; partials are read from L2 (__ldcg), never from a
  // stale L1 line
  float mx = -INFINITY;
  for (int c = tid; c < live; c += kSplitThreads)
    mx = fmaxf(mx, __ldcg(base + static_cast<long long>(c) * row_len + hd));
  mx = block_max(mx, red);
  float l_all = 0.f, o_all = 0.f;
  for (int t0 = 0; t0 < live; t0 += kSplitThreads) {
    const int c = t0 + tid;
    if (c < live) {
      const float* pc = base + static_cast<long long>(c) * row_len;
      const float mc = __ldcg(pc + hd);
      const float wc = mc == -INFINITY ? 0.f : exp2f(mc - mx);
      w_s[tid] = wc;
      l_s[tid] = __ldcg(pc + hd + 1) * wc;
    }
    __syncthreads();
    const int n = min(kSplitThreads, live - t0);
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      l_all += l_s[j];
      if (tid < hd)
        o_all = fmaf(w_s[j],
                     __ldcg(base + static_cast<long long>(t0 + j) * row_len +
                            tid),
                     o_all);
    }
    __syncthreads();
  }
  if (tid < hd)
    orow[tid] = ptt::from_f32<T>(l_all > 0.f ? o_all / l_all : 0.f);
}

// Threads a token row of the split kernel, 0 where it does not take hd.
int split_tpr(int hd, int dtype) {
  const int per_vec = dtype == ptt::kF32 ? 4 : 8;  // elements in 16 bytes
  if (hd <= 0 || hd % per_vec != 0 || hd > kMaxPerThread * 32) return 0;
  const int vecs = hd / per_vec;
  return vecs <= 4 ? 4 : vecs <= 8 ? 8 : vecs <= 16 ? 16 : 32;
}

// Tokens a chunk of the split kernel.
int split_chunk(int tpr) { return kSplitThreads / tpr * kTokensPerGroup; }

// launches of each kernel since the library was loaded: [lane, split]
std::atomic<long long> variant_launches[2];

template <typename T>
int launch_split(const void* q, long long q_lane_stride,
                 long long q_head_stride, const void* k_pages,
                 const void* v_pages, const int* rows, const int* pos,
                 void* out, float* part, int* arrivals, int slots,
                 int num_pages, int page_size, int nh, int hd,
                 int pages_per_slot, int walked_tokens, float scale_log2,
                 int tpr, cudaStream_t st) {
  const dim3 grid((walked_tokens + split_chunk(tpr) - 1) / split_chunk(tpr),
                  nh, slots);
  switch (tpr) {
#define PTT_SPLIT_CASE(K)                                                    \
  case K:                                                                    \
    paged_decode_split_kernel<T, K><<<grid, kSplitThreads, 0, st>>>(         \
        static_cast<const T*>(q), q_lane_stride, q_head_stride,              \
        static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),      \
        rows, pos, static_cast<T*>(out), part, arrivals, num_pages,          \
        page_size, nh, hd, pages_per_slot, walked_tokens, scale_log2);       \
    break;
    PTT_SPLIT_CASE(4)
    PTT_SPLIT_CASE(8)
    PTT_SPLIT_CASE(16)
    PTT_SPLIT_CASE(32)
#undef PTT_SPLIT_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_lane(const void* q, long long q_lane_stride,
                long long q_head_stride, const void* k_pages,
                const void* v_pages, const int* rows, const int* pos,
                void* out, int slots, int num_pages, int page_size, int nh,
                int hd, int pages_per_slot, int pages_walked, float sm_scale,
                cudaStream_t st) {
  paged_decode_kernel<T><<<dim3(nh, slots), kWarps * 32, 0, st>>>(
      static_cast<const T*>(q), q_lane_stride, q_head_stride,
      static_cast<const T*>(k_pages), static_cast<const T*>(v_pages), rows,
      pos, static_cast<T*>(out), num_pages, page_size, nh, hd,
      pages_per_slot, pages_walked, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of scratch the split kernel needs for these shapes (its partials,
// [slots, nh, chunks, hd + 2]); 0 when it does not take hd.
extern "C" long long ptt_paged_decode_scratch_floats(int slots, int nh,
                                                     int hd,
                                                     int walked_tokens,
                                                     int dtype) {
  const int tpr = split_tpr(hd, dtype);
  if (tpr == 0 || walked_tokens <= 0) return 0;
  const long long chunks =
      (walked_tokens + split_chunk(tpr) - 1) / split_chunk(tpr);
  return static_cast<long long>(slots) * nh * chunks * (hd + 2);
}

// q: [slots, nh, hd] with element strides (lane, head) and unit stride over
// d; k_pages/v_pages: [num_pages, page_size, nh, hd] contiguous; rows:
// [slots, pages_per_slot] int32; pos: [slots] int32; out: [slots, nh, hd]
// contiguous; part: float32 scratch of part_floats (at least
// ptt_paged_decode_scratch_floats); arrivals: n_arrivals >= slots * nh
// int32 counters, all 0 (the split kernel leaves them 0).
extern "C" int ptt_paged_decode_attention(
    const void* q, long long q_lane_stride, long long q_head_stride,
    const void* k_pages, const void* v_pages, const void* rows,
    const void* pos, void* out, void* part, long long part_floats,
    void* arrivals, long long n_arrivals, int slots, int num_pages,
    int page_size, int nh, int hd, int pages_per_slot, int pages_walked,
    float sm_scale, int dtype, void* stream) {
  if (slots <= 0 || nh <= 0) return 0;
  if (hd > kMaxPerThread * 32 ||
      (dtype != ptt::kF32 && dtype != ptt::kBF16 && dtype != ptt::kF16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* r = static_cast<const int*>(rows);
  const int* p = static_cast<const int*>(pos);
  const int esize = dtype == ptt::kF32 ? 4 : 2;
  const int walked_tokens = pages_walked * page_size;
  const int tpr = split_tpr(hd, dtype);
  const bool split =
      tpr != 0 && walked_tokens > 0 && part != nullptr &&
      arrivals != nullptr &&
      part_floats >= ptt_paged_decode_scratch_floats(slots, nh, hd,
                                                     walked_tokens, dtype) &&
      n_arrivals >= static_cast<long long>(slots) * nh &&
      ptt::aligned_16(q) && q_lane_stride * esize % 16 == 0 &&
      q_head_stride * esize % 16 == 0 && ptt::aligned_16(k_pages) &&
      ptt::aligned_16(v_pages) && ptt::aligned_16(out);
  ++variant_launches[split];
  if (split) {
    const float scale_log2 = sm_scale * 1.4426950408889634f;
    float* pt = static_cast<float*>(part);
    int* at = static_cast<int*>(arrivals);
    switch (dtype) {
      case ptt::kF32:
        return launch_split<float>(q, q_lane_stride, q_head_stride, k_pages,
                                   v_pages, r, p, out, pt, at, slots,
                                   num_pages, page_size, nh, hd,
                                   pages_per_slot, walked_tokens, scale_log2,
                                   tpr, st);
      case ptt::kBF16:
        return launch_split<__nv_bfloat16>(
            q, q_lane_stride, q_head_stride, k_pages, v_pages, r, p, out, pt,
            at, slots, num_pages, page_size, nh, hd, pages_per_slot,
            walked_tokens, scale_log2, tpr, st);
      case ptt::kF16:
        return launch_split<__half>(
            q, q_lane_stride, q_head_stride, k_pages, v_pages, r, p, out, pt,
            at, slots, num_pages, page_size, nh, hd, pages_per_slot,
            walked_tokens, scale_log2, tpr, st);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (dtype) {
    case ptt::kF32:
      return launch_lane<float>(q, q_lane_stride, q_head_stride, k_pages,
                                v_pages, r, p, out, slots, num_pages,
                                page_size, nh, hd, pages_per_slot,
                                pages_walked, sm_scale, st);
    case ptt::kBF16:
      return launch_lane<__nv_bfloat16>(q, q_lane_stride, q_head_stride,
                                        k_pages, v_pages, r, p, out, slots,
                                        num_pages, page_size, nh, hd,
                                        pages_per_slot, pages_walked,
                                        sm_scale, st);
    case ptt::kF16:
      return launch_lane<__half>(q, q_lane_stride, q_head_stride, k_pages,
                                 v_pages, r, p, out, slots, num_pages,
                                 page_size, nh, hd, pages_per_slot,
                                 pages_walked, sm_scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// How many launches took the block-per-(head, lane) kernel (variant 0) or
// the split kernel (variant 1) since the library was loaded.
extern "C" long long ptt_paged_decode_variant_launches(int variant) {
  return variant == 0 || variant == 1 ? variant_launches[variant].load() : -1;
}
