// Shared helpers of the hand-written sm_90a kernels (plain C interface,
// loaded with ctypes).  Activations are float32 or bfloat16, selected by a
// dtype code the Python wrapper passes: 0 = float32, 1 = bfloat16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round through T and back: the reference casts softmax probabilities and
// FFN hidden tiles to the activation dtype before the next contraction.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// Butterfly sum over a warp.  Every lane ends with the same value: at each
// stage the two partners add the same pair of numbers (a + b == b + a), so
// the result does not depend on the lane.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}

}  // namespace repro

// Opts a kernel into more than 48 KB of dynamic shared memory, once.
#define REPRO_SMEM_OPT_IN(kernel, bytes)                                    \
  do {                                                                      \
    static int configured_ = 0;                                             \
    if (configured_ < (bytes)) {                                            \
      cudaError_t e_ = cudaFuncSetAttribute(                                \
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (bytes));    \
      if (e_ != cudaSuccess) return (int)e_;                                \
      configured_ = (bytes);                                                \
    }                                                                       \
  } while (0)

#define REPRO_ERROR_STRING_FN                                              \
  extern "C" const char* repro_error_string(int code) {                    \
    return cudaGetErrorString((cudaError_t)code);                           \
  }
