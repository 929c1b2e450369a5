// LayerNorm with one fixed reduction order per row, for Hopper (sm_90a):
//   mu = mean(x), var = mean((x - mu)^2),
//   out = (x - mu) * rsqrt(var + eps) * gamma + beta, computed in f32.
//
// Not a port of a TPU kernel: the reference leaves layernorm
// (src/repro/models/layers.py:72-80) to XLA.  It is a kernel here for the
// reason rmsnorm.cu is: PyTorch's CUDA mean picks its reduction split from
// the row count, so a row's norm would depend on the batch and chunk width
// and break the engine's bitwise oracle parity.  Two passes over the row,
// as the reference computes it: the mean, then the mean of the squared
// deviations.  One block owns one row; in each pass every thread sums its
// strided elements in order, the warps combine by butterfly, and every
// thread adds the 8 warp sums in warp order.
// What bounds it: bytes, one read of x (twice from L1/L2: a row of 4608
// bf16 is 9 KB), gamma and beta and one write of out.
#include "common.cuh"

REPRO_ERROR_STRING_FN

namespace repro {

constexpr int kNormThreads = 256;

// The row sum of f(i) over i = 0..d-1, the same value in every thread.
template <typename F>
__device__ __forceinline__ float row_sum(int d, float* warp_sums, F f) {
  float s = 0.0f;
  for (int i = threadIdx.x; i < d; i += kNormThreads) s += f(i);
  s = warp_sum(s);
  __syncthreads();                 // warp_sums free from the last pass
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = s;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int w = 0; w < kNormThreads / 32; ++w) total += warp_sums[w];
  return total;
}

template <typename T>
__global__ void __launch_bounds__(kNormThreads)
    layernorm_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                     const T* __restrict__ beta, T* __restrict__ out, int d,
                     float eps) {
  __shared__ float warp_sums[kNormThreads / 32];
  const T* xr = x + (size_t)blockIdx.x * d;
  T* orow = out + (size_t)blockIdx.x * d;
  const float mu =
      row_sum(d, warp_sums, [&](int i) { return to_f32(xr[i]); }) /
      (float)d;
  const float var = row_sum(d, warp_sums, [&](int i) {
                      const float c = to_f32(xr[i]) - mu;
                      return c * c;
                    }) /
                    (float)d;
  const float r = rsqrtf(var + eps);
  for (int i = threadIdx.x; i < d; i += kNormThreads) {
    const float y = __fmul_rn(to_f32(xr[i]) - mu, r);
    orow[i] = from_f32<T>(
        __fadd_rn(__fmul_rn(y, to_f32(gamma[i])), to_f32(beta[i])));
  }
}

}  // namespace repro

extern "C" int layernorm_launch(const void* x, const void* gamma,
                                const void* beta, void* out, int rows, int d,
                                float eps, int dtype, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    layernorm_kernel<__nv_bfloat16><<<rows, kNormThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(gamma),
        static_cast<const __nv_bfloat16*>(beta),
        static_cast<__nv_bfloat16*>(out), d, eps);
  else
    layernorm_kernel<float><<<rows, kNormThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<float*>(out), d, eps);
  return (int)cudaGetLastError();
}
