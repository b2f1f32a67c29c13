// Tensor-core and asynchronous-copy primitives of the attention kernels
// (sm_80 and later; built here for sm_90a): `cp.async` copies of 4 and 16
// bytes with zero fill, `ldmatrix` loads of four 8 x 8 matrices of 16-bit
// elements (plain and transposed) and the warp-wide
// `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32` and
// `mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32`, which share one
// fragment layout: the 16-bit kernels are templates over the element type
// T (`__nv_bfloat16` or `__half`), through `mma16<T>` and `pack16<T>`.
//
// Fragment layout of m16n8k16, with g = lane >> 2 and t = lane & 3:
//   A (16 x 16, row major)  a0: (g, 2t..2t+1)      a1: (g + 8, 2t..2t+1)
//                           a2: (g, 2t+8..2t+9)    a3: (g + 8, 2t+8..2t+9)
//   B (16 x 8, k by n)      b0: (k = 2t..2t+1, n = g)   b1: (k = 2t+8.., g)
//   C (16 x 8)              c0, c1: (g, 2t..2t+1)  c2, c3: (g + 8, 2t..2t+1)
// so two neighbouring C tiles, rounded to T, are the A operand of the
// next product without leaving the registers.
//
// The float32 kernel's `mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32`
// (`mma_tf32x3`: three TF32 products that hold float32 parity, below):
//   A (16 x 8)  a0: (g, t)  a1: (g + 8, t)  a2: (g, t + 4)  a3: (g + 8, t + 4)
//   B (8 x 8)   b0: (k = t, n = g)   b1: (k = t + 4, n = g)
//   C (16 x 8)  as m16n8k16's
// A lane's C entries are columns 2t and 2t + 1, its A entries columns t and
// t + 4: the kernel reads k-slot t as contraction index 2t and k-slot t + 4
// as 2t + 1 on both sides, so a C tile is an A operand as it stands.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// Four 8 x 8 matrices of 16-bit elements: lane i gives the address of row
// i % 8 of matrix i / 8 (16 bytes, 16-byte aligned); register j receives
// matrix j, each lane the pair (row g, columns 2t..2t+1).
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

// c += a . b, float16 operands, float32 accumulators (the fragment layout
// of mma_bf16).
__device__ __forceinline__ void mma_f16(float (&c)[4],
                                        const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two float32 rounded to bf16 (nearest even), `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two float32 rounded to float16 (nearest even; beyond 65504 to inf),
// `lo` in the low half.
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The product and the packing of element type T: bf16 or float16.
template <typename T>
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  static_assert(std::is_same<T, __nv_bfloat16>::value ||
                    std::is_same<T, __half>::value,
                "a 16-bit element type");
  if constexpr (std::is_same<T, __half>::value)
    mma_f16(c, a, b0, b1);
  else
    mma_bf16(c, a, b0, b1);
}

template <typename T>
__device__ __forceinline__ uint32_t pack16(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value)
    return pack_f16(lo, hi);
  else
    return pack_bf16(lo, hi);
}

// x rounded to TF32 (10 stored mantissa bits, nearest, ties away from 0):
// a float32 bit pattern whose low 13 bits are 0.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small + O(2^-22 |x|): big = tf32(x), small = tf32(x - big)
// (x - big is exact in float32).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// c += a . b, TF32 operands, float32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b to float32 accuracy on the TF32 tensor cores, from the splits
// of a (ah + al) and b (bh + bl): al.bh + ah.bl + ah.bh, the two small
// terms first; al.bl (2^-22 of the product) is dropped.  One TF32 product
// keeps 11 bits of each operand and misses float32 parity by far.
__device__ __forceinline__ void mma_tf32x3(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(c, al, bh[0], bh[1]);
  mma_tf32(c, ah, bl[0], bl[1]);
  mma_tf32(c, ah, bh[0], bh[1]);
}

// d = a . b from zero, the same three products: the first takes a zero
// accumulator, so d's old values are not read.
__device__ __forceinline__ void mma_tf32x3_zero(float (&d)[4],
                                                const uint32_t (&ah)[4],
                                                const uint32_t (&al)[4],
                                                const uint32_t (&bh)[2],
                                                const uint32_t (&bl)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(al[0]), "r"(al[1]), "r"(al[2]), "r"(al[3]), "r"(bh[0]),
        "r"(bh[1]), "f"(0.f), "f"(0.f), "f"(0.f), "f"(0.f));
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

// 2^x by the special-function unit (2 ulp; -inf gives 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// Copy kRows rows of D 16-bit elements from device memory (tile row i from
// src + (r0 + i) * row_stride elements) into a shared tile whose rows are
// kLd elements apart, 16 bytes a copy, by a block of kThreads threads; rows
// at or beyond `n_rows` are filled with zeros.  A thread keeps one 16-byte
// column of the tile, so its addresses differ by constants.
template <int D, int kLd, int kRows, int kThreads, typename T>
__device__ __forceinline__ void stage_rows(T* tile, const T* src,
                                           long long row_stride, int r0,
                                           int n_rows) {
  constexpr int kChunks = D / 8;              // 16-byte pieces of a row
  constexpr int kStep = kThreads / kChunks;   // rows between two copies
  static_assert(kThreads % kChunks == 0, "a thread keeps one column");
  const int piece = threadIdx.x % kChunks, first = threadIdx.x / kChunks;
  static_assert(sizeof(T) == 2, "16-bit elements: 8 a 16-byte copy");
  const T* column = src + piece * 8;
  T* dst = tile + first * kLd + piece * 8;
#pragma unroll
  for (int r = 0; r < kRows; r += kStep) {
    if (kRows % kStep != 0 && first + r >= kRows) break;
    const int row = r0 + first + r;
    const bool ok = row < n_rows;
    cp_async_16(dst + r * kLd, column + (ok ? row : 0) * row_stride, ok);
  }
}

// The same for rows of D float32 elements, eight copies an iteration of a
// loop with a running source pointer: fully unrolled, one address a row
// stays live across the kernel's key loop, which the float32 kernel's
// registers have no room for; not unrolled at all, a one-warp block issues
// its copies behind a chain of pointer increments.  (Four or two an
// iteration left ptxas spilling a few bytes in some instantiations.)
template <int D, int kLd, int kRows, int kThreads>
__device__ __forceinline__ void stage_rows_f32(float* tile, const float* src,
                                               long long row_stride, int r0,
                                               int n_rows) {
  constexpr int kChunks = D / 4;              // 16-byte pieces of a row
  constexpr int kStep = kThreads / kChunks;   // rows between two copies
  static_assert(kThreads % kChunks == 0, "a thread keeps one column");
  static_assert(kRows % kStep == 0, "whole steps");
  const int piece = threadIdx.x % kChunks, first = threadIdx.x / kChunks;
  const float* p = src + (r0 + first) * row_stride + piece * 4;
  float* dst = tile + first * kLd + piece * 4;
#pragma unroll 8
  for (int i = 0; i < kRows / kStep; ++i) {
    const bool ok = r0 + first + i * kStep < n_rows;
    cp_async_16(dst + i * kStep * kLd, ok ? p : src, ok);
    p += kStep * row_stride;
  }
}

// Write a warp's 16-row tile of D 16-bit elements from shared memory to
// device memory (row i at dst + (r0 + i) * row_stride), 16 bytes a lane;
// rows at or beyond `n_rows` are dropped.
template <int D, int kLd, typename T>
__device__ __forceinline__ void store_rows_16(const T* tile, T* dst,
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
// of `elem_bytes`-byte elements (2 or 4) be moved in 16-byte pieces.
inline bool aligned_16(const void* p, long long sb, long long ss,
                       long long sh, int elem_bytes = 2) {
  const long long n = 16 / elem_bytes;  // elements a 16-byte piece
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % n == 0 &&
         ss % n == 0 && sh % n == 0;
}

}  // namespace ptt
