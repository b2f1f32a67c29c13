// Tensor-core and asynchronous-copy primitives of the bf16 attention
// kernels (sm_80 and later; built here for sm_90a): `cp.async` copies of 4
// and 16 bytes with zero fill, `ldmatrix` loads of four 8 x 8 bf16 matrices
// (plain and transposed) and the warp-wide
// `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`.
//
// Fragment layout of m16n8k16, with g = lane >> 2 and t = lane & 3:
//   A (16 x 16, row major)  a0: (g, 2t..2t+1)      a1: (g + 8, 2t..2t+1)
//                           a2: (g, 2t+8..2t+9)    a3: (g + 8, 2t+8..2t+9)
//   B (16 x 8, k by n)      b0: (k = 2t..2t+1, n = g)   b1: (k = 2t+8.., g)
//   C (16 x 8)              c0, c1: (g, 2t..2t+1)  c2, c3: (g + 8, 2t..2t+1)
// so two neighbouring C tiles, rounded to bf16, are the A operand of the
// next product without leaving the registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptt {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory to shared memory, past L1, without holding a
// register; `valid == false` writes 16 zero bytes and reads nothing.  Both
// addresses are 16-byte multiples.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n));
}

// The same for one 4-byte word (the row statistics).
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kPending of this thread's committed groups are still
// in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Four 8 x 8 bf16 matrices: lane i gives the address of row i % 8 of matrix
// i / 8 (16 bytes, 16-byte aligned); register j receives matrix j, each
// lane the pair (row g, columns 2t..2t+1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// The same with every matrix transposed: each lane receives the pair
// (rows 2t..2t+1, column g) of the stored matrix.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// c += a . b, bf16 operands, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two float32 rounded to bf16 (nearest even), `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x by the special-function unit (2 ulp; -inf gives 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// Copy kRows rows of D bf16 from device memory (tile row i from
// src + (r0 + i) * row_stride elements) into a shared tile whose rows are
// kLd elements apart, 16 bytes a copy, by a block of kThreads threads; rows
// at or beyond `n_rows` are filled with zeros.  A thread keeps one 16-byte
// column of the tile, so its addresses differ by constants.
template <int D, int kLd, int kRows, int kThreads>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* tile,
                                           const __nv_bfloat16* src,
                                           long long row_stride, int r0,
                                           int n_rows) {
  constexpr int kChunks = D / 8;              // 16-byte pieces of a row
  constexpr int kStep = kThreads / kChunks;   // rows between two copies
  static_assert(kThreads % kChunks == 0, "a thread keeps one column");
  const int piece = threadIdx.x % kChunks, first = threadIdx.x / kChunks;
  const __nv_bfloat16* column = src + piece * 8;
  __nv_bfloat16* dst = tile + first * kLd + piece * 8;
#pragma unroll
  for (int r = 0; r < kRows; r += kStep) {
    if (kRows % kStep != 0 && first + r >= kRows) break;
    const int row = r0 + first + r;
    const bool ok = row < n_rows;
    cp_async_16(dst + r * kLd, column + (ok ? row : 0) * row_stride, ok);
  }
}

// Write a warp's 16-row tile of D bf16 from shared memory to device memory
// (row i at dst + (r0 + i) * row_stride), 16 bytes a lane; rows at or
// beyond `n_rows` are dropped.
template <int D, int kLd>
__device__ __forceinline__ void store_rows_16(const __nv_bfloat16* tile,
                                              __nv_bfloat16* dst,
                                              long long row_stride, int r0,
                                              int n_rows) {
  constexpr int kChunks = D / 8;
  const int lane = threadIdx.x & 31;
  for (int c = lane; c < 16 * kChunks; c += 32) {
    const int r = c / kChunks, piece = c % kChunks;
    if (r0 + r < n_rows)
      *reinterpret_cast<uint4*>(dst + (r0 + r) * row_stride + piece * 8) =
          *reinterpret_cast<const uint4*>(tile + r * kLd + piece * 8);
  }
}

// True when a base pointer and its (b, s, h) element strides let every row
// of bf16 be moved in 16-byte pieces.
inline bool aligned_16(const void* p, long long sb, long long ss,
                       long long sh) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 8 == 0 &&
         ss % 8 == 0 && sh % 8 == 0;
}

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
