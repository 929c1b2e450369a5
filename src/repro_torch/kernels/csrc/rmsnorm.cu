// RMSNorm with one fixed reduction order per row, for Hopper (sm_90a):
//   out = x * rsqrt(mean(x^2) + eps) * gamma, computed in f32.
//
// Not a port of a TPU kernel: the reference leaves rmsnorm
// (src/repro/models/layers.py:65) to XLA.  It is a kernel here because the
// engine's oracle parity needs each row's result to be bitwise independent
// of how many rows the call holds, and PyTorch's CUDA mean picks its
// reduction split from the output count (4 rows at decode and 256 rows in a
// prefill chunk reduce in different orders).  One block owns one row; each
// thread sums its strided elements in order, the warps combine by butterfly,
// and every thread adds the 8 warp sums in warp order.
// What bounds it: bytes, one read of x and gamma and one write of out.
#include "common.cuh"

REPRO_ERROR_STRING_FN

namespace repro {

constexpr int kNormThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kNormThreads)
    rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                   T* __restrict__ out, int d, float eps) {
  __shared__ float warp_sums[kNormThreads / 32];
  const T* xr = x + (size_t)blockIdx.x * d;
  T* orow = out + (size_t)blockIdx.x * d;
  float ss = 0.0f;
  for (int i = threadIdx.x; i < d; i += kNormThreads) {
    const float v = to_f32(xr[i]);
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int w = 0; w < kNormThreads / 32; ++w) total += warp_sums[w];
  const float r = rsqrtf(total / (float)d + eps);
  for (int i = threadIdx.x; i < d; i += kNormThreads)
    orow[i] = from_f32<T>(to_f32(xr[i]) * r * to_f32(gamma[i]));
}

}  // namespace repro

extern "C" int rmsnorm_launch(const void* x, const void* gamma, void* out,
                              int rows, int d, float eps, int dtype,
                              void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    rmsnorm_kernel<__nv_bfloat16><<<rows, kNormThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(gamma),
        static_cast<__nv_bfloat16*>(out), d, eps);
  else
    rmsnorm_kernel<float><<<rows, kNormThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(gamma),
        static_cast<float*>(out), d, eps);
  return (int)cudaGetLastError();
}
