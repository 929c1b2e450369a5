// RMSNorm with one fixed reduction order per row, and the residual add
// fused in front of it, for Hopper (sm_90a):
//   s = x + h, rounded to x's type (add_rmsnorm; rmsnorm takes s = x),
//   out = s * rsqrt(mean(s^2) + eps) * gamma, computed in f32.
//
// Not a port of a TPU kernel: the reference leaves rmsnorm
// (src/repro/models/layers.py:65) and the residual adds around it
// (src/repro/models/transformer.py:66) to XLA, which fuses them.  It is a
// kernel here because the engine's oracle parity needs each row's result to
// be bitwise independent of how many rows the call holds, and PyTorch's CUDA
// mean picks its reduction split from the output count (4 rows at decode and
// 256 rows in a prefill chunk reduce in different orders).  The add is fused
// so that a layer's two residual adds are not launches of their own.
//
// One block owns one row.  The row's s and gamma are staged in shared
// memory with 16-byte loads issued together (x, h and gamma read once, s
// written once where the caller keeps it), so gamma's latency hides behind
// x's instead of following the reduction; each thread then sums the
// squares of its strided elements t, t + 256, ... in order, the warps
// combine by butterfly and every thread adds the 8 warp sums in warp order
// (the order of the first version of this kernel, so its results are
// bitwise those of that kernel on x + h); the output is written with
// 16-byte stores.  The add rounds as PyTorch's does: one f32 add of the
// two values, one rounding to the activation type.  One body serves every
// model's width: a row and gamma of at most 47 KB together (staged without
// an opt-in: d <= 12032 in bf16, 6016 in f32), a multiple of 16 bytes, on
// 16-byte aligned operands; the wrapper (kernels/rmsnorm.py) refuses
// anything else.
// combine_add_rmsnorm takes an MoE layer's output in place of h: the k
// expert rows y[slot[t, j]] of the row's token, weighted by topw[t, j],
// summed as moe_route.cu's combine sums them (the weight and each product
// rounded to x's type with __fmul_rn / __fadd_rn, from zero in j order,
// slot < 0 adding nothing), read with 16-byte loads as they fill the staged
// row; then the one f32 add with x and one rounding, so s is bitwise
// moe_combine followed by add_rmsnorm's add, and the combined output is
// never written.  The reduction and the output loop are the same code.
// What bounds it: bytes, one read of x, h (or the k expert rows) and gamma
// and one write of out (and of s).  At a decode tick's 4 rows it is a
// launch's latency.
#include "common.cuh"

REPRO_ERROR_STRING_FN

namespace repro {

constexpr int kNormThreads = 256;
// s and gamma staged within the 48 KB a block takes without an opt-in, 1 KB
// of it left to the static warp sums
constexpr int kStageBytes = 47 * 1024;
constexpr int kMaxTopK = 32;
constexpr int kCombineLoads = 8;     // expert rows a thread keeps in flight

// What is added to x before the norm.
enum NormAdd : int { kAddNone = 0, kAddH = 1, kAddCombine = 2 };

// sum_out null: s is not written.  kAddCombine: h is y (rows, d), and slot
// and topw (rows of x, k) say which rows of y the row adds.
template <typename T, int ADD>
__global__ void __launch_bounds__(kNormThreads)
    add_rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ h,
                       const T* __restrict__ gamma, T* __restrict__ sum_out,
                       T* __restrict__ out, int d, float eps,
                       const int* __restrict__ slot,
                       const float* __restrict__ topw, int k) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* srow = reinterpret_cast<T*>(smem_raw);
  T* sgamma = srow + d;
  __shared__ float warp_sums[kNormThreads / 32];
  __shared__ int s_slot[ADD == kAddCombine ? kMaxTopK : 1];
  __shared__ float s_w[ADD == kAddCombine ? kMaxTopK : 1];
  const size_t base = (size_t)blockIdx.x * d;
  const uint4* xr = reinterpret_cast<const uint4*>(x + base);
  const uint4* hr = ADD == kAddH ? reinterpret_cast<const uint4*>(h + base)
                                 : nullptr;
  uint4* sr = sum_out != nullptr ? reinterpret_cast<uint4*>(sum_out + base)
                                 : nullptr;
  uint4* orow = reinterpret_cast<uint4*>(out + base);
  if constexpr (ADD == kAddCombine) {
    if (threadIdx.x < k) {
      s_slot[threadIdx.x] = slot[(size_t)blockIdx.x * k + threadIdx.x];
      s_w[threadIdx.x] =
          round_to<T>(topw[(size_t)blockIdx.x * k + threadIdx.x]);
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < d / V; c += kNormThreads) {
    uint4 sv = xr[c];
    reinterpret_cast<uint4*>(sgamma)[c] =
        reinterpret_cast<const uint4*>(gamma)[c];
    if constexpr (ADD == kAddH) {
      const uint4 hv = hr[c];
      T* se = reinterpret_cast<T*>(&sv);
      const T* he = reinterpret_cast<const T*>(&hv);
#pragma unroll
      for (int e = 0; e < V; ++e)
        se[e] = from_f32<T>(__fadd_rn(to_f32(se[e]), to_f32(he[e])));
      if (sr != nullptr) sr[c] = sv;
    } else if constexpr (ADD == kAddCombine) {
      const uint4* yr = reinterpret_cast<const uint4*>(h);
      const size_t row_chunks = d / V;
      float acc[V];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = 0.0f;
      for (int j0 = 0; j0 < k; j0 += kCombineLoads) {
        uint4 yv[kCombineLoads];
#pragma unroll
        for (int q = 0; q < kCombineLoads; ++q) {
          const int s = j0 + q < k ? s_slot[j0 + q] : -1;
          yv[q] = s >= 0 ? yr[(size_t)s * row_chunks + c]
                         : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int q = 0; q < kCombineLoads; ++q) {
          if (j0 + q >= k || s_slot[j0 + q] < 0) continue;
          const float w = s_w[j0 + q];
          const T* ye = reinterpret_cast<const T*>(&yv[q]);
#pragma unroll
          for (int e = 0; e < V; ++e)
            acc[e] = round_to<T>(
                __fadd_rn(acc[e], round_to<T>(__fmul_rn(to_f32(ye[e]), w))));
        }
      }
      T* se = reinterpret_cast<T*>(&sv);
#pragma unroll
      for (int e = 0; e < V; ++e)
        se[e] = from_f32<T>(__fadd_rn(to_f32(se[e]), acc[e]));
      if (sr != nullptr) sr[c] = sv;
    }
    reinterpret_cast<uint4*>(srow)[c] = sv;
  }
  __syncthreads();
  float ss = 0.0f;
  for (int i = threadIdx.x; i < d; i += kNormThreads) {
    const float v = to_f32(srow[i]);
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = ss;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int w = 0; w < kNormThreads / 32; ++w) total += warp_sums[w];
  const float r = rsqrtf(total / (float)d + eps);
  for (int c = threadIdx.x; c < d / V; c += kNormThreads) {
    const uint4 sv = reinterpret_cast<const uint4*>(srow)[c];
    const uint4 gv = reinterpret_cast<const uint4*>(sgamma)[c];
    uint4 ov;
    const T* se = reinterpret_cast<const T*>(&sv);
    const T* ge = reinterpret_cast<const T*>(&gv);
    T* oe = reinterpret_cast<T*>(&ov);
#pragma unroll
    for (int e = 0; e < V; ++e)
      oe[e] = from_f32<T>(to_f32(se[e]) * r * to_f32(ge[e]));
    orow[c] = ov;
  }
}

template <typename T, int ADD>
int launch(const void* x, const void* h, const void* gamma, void* sum_out,
           void* out, int rows, int d, float eps, cudaStream_t s,
           const int* slot = nullptr, const float* topw = nullptr,
           int k = 0) {
  const size_t bytes = 2 * (size_t)d * sizeof(T);
  if (bytes > (size_t)kStageBytes || (d * sizeof(T)) % 16 != 0 ||
      ((uintptr_t)x | (uintptr_t)h | (uintptr_t)gamma | (uintptr_t)sum_out |
       (uintptr_t)out) % 16 != 0 || k < 0 || k > kMaxTopK)
    return (int)cudaErrorInvalidValue;
  add_rmsnorm_kernel<T, ADD><<<rows, kNormThreads, bytes, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(h),
      static_cast<const T*>(gamma), static_cast<T*>(sum_out),
      static_cast<T*>(out), d, eps, slot, topw, k);
  return (int)cudaGetLastError();
}

}  // namespace repro

extern "C" int rmsnorm_launch(const void* x, const void* gamma, void* out,
                              int rows, int d, float eps, int dtype,
                              void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch<__nv_bfloat16, kAddNone>(x, nullptr, gamma, nullptr, out,
                                           rows, d, eps, s);
  return launch<float, kAddNone>(x, nullptr, gamma, nullptr, out, rows, d,
                                 eps, s);
}

// x, h, gamma, out: (rows, d) / (d,) of the activation type; sum_out the
// (rows, d) s, or null where the caller does not keep it.
extern "C" int add_rmsnorm_launch(const void* x, const void* h,
                                  const void* gamma, void* sum_out, void* out,
                                  int rows, int d, float eps, int dtype,
                                  void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch<__nv_bfloat16, kAddH>(x, h, gamma, sum_out, out, rows, d,
                                        eps, s);
  return launch<float, kAddH>(x, h, gamma, sum_out, out, rows, d, eps, s);
}

// x, gamma, out: (rows, d) / (d,) of the activation type; y (any rows, d)
// of that type, the experts' rows; slot (rows, k) int32 and topw (rows, k)
// f32 the row's token's assignments; sum_out the (rows, d) s, or null.
extern "C" int combine_add_rmsnorm_launch(const void* x, const void* y,
                                          const int* slot, const float* topw,
                                          const void* gamma, void* sum_out,
                                          void* out, int rows, int d, int k,
                                          float eps, int dtype,
                                          void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return launch<__nv_bfloat16, kAddCombine>(x, y, gamma, sum_out, out,
                                              rows, d, eps, s, slot, topw, k);
  return launch<float, kAddCombine>(x, y, gamma, sum_out, out, rows, d, eps,
                                    s, slot, topw, k);
}
