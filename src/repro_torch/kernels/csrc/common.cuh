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

// What the finished f32 sums s[0..NW) of one output become before the cast,
// in the weight tiles (w4a16_tile.cuh, dense_tile.cuh).  The codes are the
// activation codes the Python wrappers pass.
enum Epilogue : int {
  kEpiNone = 0,      // s[0]
  kEpiSwiglu = 1,    // silu(gate) * up                NW = 2: gate, up
  kEpiGeglu = 2,     // gelu_tanh(gate) * up           NW = 2
  kEpiGeluBias = 3,  // gelu_tanh(up + bias)           NW = 1: up
  kEpiBias = 4,      // s[0] + bias
};

__device__ __forceinline__ float silu(float g) {
  return g / (1.0f + expf(-g));
}

__device__ __forceinline__ float gelu_tanh(float g) {
  const float c = 0.7978845608028654f;   // sqrt(2 / pi)
  return 0.5f * g * (1.0f + tanhf(c * (g + 0.044715f * g * g * g)));
}

// bias: f32 per output column, added to the f32 sum before the activation
// or the cast, as the reference adds its FFN biases; null adds nothing.
template <int NW, int EPI>
__device__ __forceinline__ float epilogue(const float (&s)[NW],
                                          const float* __restrict__ bias,
                                          int col) {
  if constexpr (EPI == kEpiSwiglu) {
    return silu(s[0]) * s[NW - 1];
  } else if constexpr (EPI == kEpiGeglu) {
    return gelu_tanh(s[0]) * s[NW - 1];
  } else if constexpr (EPI == kEpiGeluBias) {
    return gelu_tanh(bias ? s[0] + bias[col] : s[0]);
  } else if constexpr (EPI == kEpiBias) {
    return bias ? s[0] + bias[col] : s[0];
  } else {
    return s[0];
  }
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
