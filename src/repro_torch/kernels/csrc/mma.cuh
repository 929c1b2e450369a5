// PTX helpers of the bf16 tensor-core kernels (dense_mma_tile.cuh,
// w4a16_mma_tile.cuh, flash_attention.cu, decode_flash.cu): cp.async into a
// shared-memory ring, ldmatrix into mma fragments, mma.sync m16n8k16 with
// f32 accumulation, the XOR swizzle of 16-byte chunks in a ring row, and the
// quad reductions of the attention kernels' online softmax.
#pragma once

#include "common.cuh"

namespace repro {

// The physical 16-byte chunk of logical chunk c in row r of a stage tile
// with R chunks a row.  R >= 8: a row fills whole 128-byte lines, XOR r's
// low 3 bits; R == 4: two rows share a line, XOR bits 1-2; R == 2: four
// rows share a line, XOR bit 2.
template <int R>
__device__ __forceinline__ int swz(int r, int c) {
  if constexpr (R >= 8) {
    return c ^ (r & 7);
  } else if constexpr (R == 4) {
    return c ^ ((r >> 1) & 3);
  } else {
    static_assert(R == 2, "rows of 2, 4 or 8+ chunks");
    return c ^ ((r >> 2) & 1);
  }
}

// The width, in values, a bf16 row of D values is staged at in shared
// memory: D itself where its D / 8 chunks are 2, 4 or whole 8-chunk groups,
// else the next multiple of 64 (head dim 112: 14 chunks staged in a row of
// 16).  swz<R> only moves a chunk within its group of 8, so in a 16-chunk
// row every one of the 14 chunks lands inside the row (8 rows at one
// logical chunk still hit 8 distinct slots: ldmatrix stays conflict-free);
// the 2 slots no chunk maps to are never written nor read.
__host__ __device__ constexpr int staged_dim(int d) {
  return (d / 8) % 8 == 0 || d / 8 <= 4 ? d : (d + 63) / 64 * 64;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy `bytes` (16 or 0) of 16 to shared memory, zero-filling the rest.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p))
      : "memory");
}

// d += a (16 x 16, row) * b (16 x 8, col), f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to bf16 as one fragment register: lo in bits
// 0-15 (the lower k or column index), hi in bits 16-31.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Max and sum over the 4 lanes of a quad (the lanes that share a row of
// an accumulator fragment); every lane of the quad ends with the same value.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Scores are taken to the log2 domain (s * scale * log2 e) and exponentiated
// with exp2f.
constexpr float kLog2e = 1.4426950408889634f;

}  // namespace repro
