// LayerNorm with one fixed reduction order per row, and the residual add
// fused in front of it, for Hopper (sm_90a):
//   s = x + h, rounded to x's type (add_layernorm; layernorm takes s = x),
//   mu = mean(s), var = mean((s - mu)^2),
//   out = (s - mu) * rsqrt(var + eps) * gamma + beta, computed in f32.
//
// Not a port of a TPU kernel: the reference leaves layernorm
// (src/repro/models/layers.py:72-80) and the residual adds around it
// (src/repro/models/transformer.py:62-71) to XLA, which fuses them.  It is
// a kernel here for the reason rmsnorm.cu is: PyTorch's CUDA mean picks its
// reduction split from the row count, so a row's norm would depend on the
// batch and chunk width and break the engine's bitwise oracle parity.  The
// add is fused so that a layer's two residual adds are not launches of
// their own.
//
// One block owns one row.  The row's s, gamma and beta are staged in shared
// memory with 16-byte loads issued together (x, h, gamma and beta read
// once, s written once where the caller keeps it), so gamma's and beta's
// latency hides behind x's.  Two passes over the staged row, as the
// reference computes it: the mean, then the mean of the squared deviations.
// In each pass every thread sums its strided elements t, t + 256, ... in
// order (the second pass as fmaf(c, c, sum): the first version of this
// kernel wrote sum += c * c and nvcc contracted it), the warps combine by
// butterfly and every thread adds the 8 warp sums in warp order; so its
// results are bitwise those of that first version on x + h.  The output is
// (s - mu) * r, times gamma, plus beta, each rounded alone, written with
// 16-byte stores.  The add rounds as PyTorch's does: one f32 add of the two
// values, one rounding to the activation type.  One body serves every
// model's width: a row of at most 64 KB (staged with gamma and beta in up
// to 192 KB, opted into once: d <= 32768 in bf16, 16384 in f32), a
// multiple of 16 bytes, on 16-byte aligned operands; the wrapper
// (kernels/layernorm.py) refuses anything else.
// What bounds it: bytes, one read of x, h, gamma and beta and one write of
// out (and of s).  At a decode tick's 4 rows it is a launch's latency.
#include "common.cuh"

REPRO_ERROR_STRING_FN

namespace {

using namespace repro;

constexpr int kNormThreads = 256;
constexpr int kMaxRowBytes = 64 * 1024;
constexpr int kStageBytes = 3 * kMaxRowBytes;   // s, gamma and beta

// The row sum of v over the block, the same value in every thread: the
// warps by butterfly, then the 8 warp sums in warp order.
__device__ __forceinline__ float block_sum(float v, float* warp_sums) {
  v = warp_sum(v);
  __syncthreads();                 // warp_sums free from the last pass
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int w = 0; w < kNormThreads / 32; ++w) total += warp_sums[w];
  return total;
}

// sum_out null: s is not written.
template <typename T, bool ADD>
__global__ void __launch_bounds__(kNormThreads)
    add_layernorm_kernel(const T* __restrict__ x, const T* __restrict__ h,
                         const T* __restrict__ gamma,
                         const T* __restrict__ beta, T* __restrict__ sum_out,
                         T* __restrict__ out, int d, float eps) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* srow = reinterpret_cast<T*>(smem_raw);
  T* sgamma = srow + d;
  T* sbeta = sgamma + d;
  __shared__ float warp_sums[kNormThreads / 32];
  const size_t base = (size_t)blockIdx.x * d;
  const uint4* xr = reinterpret_cast<const uint4*>(x + base);
  const uint4* hr = ADD ? reinterpret_cast<const uint4*>(h + base) : nullptr;
  uint4* sr = sum_out != nullptr ? reinterpret_cast<uint4*>(sum_out + base)
                                 : nullptr;
  uint4* orow = reinterpret_cast<uint4*>(out + base);
  for (int c = threadIdx.x; c < d / V; c += kNormThreads) {
    uint4 sv = xr[c];
    reinterpret_cast<uint4*>(sgamma)[c] =
        reinterpret_cast<const uint4*>(gamma)[c];
    reinterpret_cast<uint4*>(sbeta)[c] =
        reinterpret_cast<const uint4*>(beta)[c];
    if constexpr (ADD) {
      const uint4 hv = hr[c];
      T* se = reinterpret_cast<T*>(&sv);
      const T* he = reinterpret_cast<const T*>(&hv);
#pragma unroll
      for (int e = 0; e < V; ++e)
        se[e] = from_f32<T>(__fadd_rn(to_f32(se[e]), to_f32(he[e])));
      if (sr != nullptr) sr[c] = sv;
    }
    reinterpret_cast<uint4*>(srow)[c] = sv;
  }
  __syncthreads();
  float sum = 0.0f;
  for (int i = threadIdx.x; i < d; i += kNormThreads)
    sum = __fadd_rn(sum, to_f32(srow[i]));
  const float mu = block_sum(sum, warp_sums) / (float)d;
  float sq = 0.0f;
  for (int i = threadIdx.x; i < d; i += kNormThreads) {
    const float c = __fsub_rn(to_f32(srow[i]), mu);
    sq = __fmaf_rn(c, c, sq);
  }
  const float var = block_sum(sq, warp_sums) / (float)d;
  const float r = rsqrtf(var + eps);
  for (int c = threadIdx.x; c < d / V; c += kNormThreads) {
    const uint4 sv = reinterpret_cast<const uint4*>(srow)[c];
    const uint4 gv = reinterpret_cast<const uint4*>(sgamma)[c];
    const uint4 bv = reinterpret_cast<const uint4*>(sbeta)[c];
    uint4 ov;
    const T* se = reinterpret_cast<const T*>(&sv);
    const T* ge = reinterpret_cast<const T*>(&gv);
    const T* be = reinterpret_cast<const T*>(&bv);
    T* oe = reinterpret_cast<T*>(&ov);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float y = __fmul_rn(__fsub_rn(to_f32(se[e]), mu), r);
      oe[e] = from_f32<T>(
          __fadd_rn(__fmul_rn(y, to_f32(ge[e])), to_f32(be[e])));
    }
    orow[c] = ov;
  }
}

// Every body may stage up to kStageBytes, opted into once for all four.
int opt_in() {
  static bool done = false;
  if (done) return 0;
  const void* kernels[] = {
      (const void*)add_layernorm_kernel<__nv_bfloat16, false>,
      (const void*)add_layernorm_kernel<__nv_bfloat16, true>,
      (const void*)add_layernorm_kernel<float, false>,
      (const void*)add_layernorm_kernel<float, true>};
  for (const void* k : kernels) {
    const cudaError_t e = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, kStageBytes);
    if (e != cudaSuccess) return (int)e;
  }
  done = true;
  return 0;
}

template <typename T, bool ADD>
int launch(const void* x, const void* h, const void* gamma, const void* beta,
           void* sum_out, void* out, int rows, int d, float eps,
           cudaStream_t s) {
  const size_t row = (size_t)d * sizeof(T);
  if (row > (size_t)kMaxRowBytes || row % 16 != 0 ||
      ((uintptr_t)x | (uintptr_t)h | (uintptr_t)gamma | (uintptr_t)beta |
       (uintptr_t)sum_out | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (const int e = opt_in()) return e;
  add_layernorm_kernel<T, ADD><<<rows, kNormThreads, 3 * row, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(h),
      static_cast<const T*>(gamma), static_cast<const T*>(beta),
      static_cast<T*>(sum_out), static_cast<T*>(out), d, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// The one-time host call of the bodies' shared-memory opt-in, made before
// any CUDA graph capture (kernels/_build.prepare).
extern "C" int layernorm_prepare() { return opt_in(); }

extern "C" int layernorm_launch(const void* x, const void* gamma,
                                const void* beta, void* out, int rows, int d,
                                float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBF16)
    return launch<__nv_bfloat16, false>(x, nullptr, gamma, beta, nullptr, out,
                                        rows, d, eps, s);
  return launch<float, false>(x, nullptr, gamma, beta, nullptr, out, rows, d,
                              eps, s);
}

// x, h, gamma, beta, out: (rows, d) / (d,) of the activation type; sum_out
// the (rows, d) s, or null where the caller does not keep it.
extern "C" int add_layernorm_launch(const void* x, const void* h,
                                    const void* gamma, const void* beta,
                                    void* sum_out, void* out, int rows, int d,
                                    float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBF16)
    return launch<__nv_bfloat16, true>(x, h, gamma, beta, sum_out, out, rows,
                                       d, eps, s);
  return launch<float, true>(x, h, gamma, beta, sum_out, out, rows, d, eps,
                             s);
}
