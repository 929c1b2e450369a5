// RMSNorm, backward, one row in flight a block: the first design of the
// RMSNorm backward, kept off the training path as the yardstick
// rmsnorm_bwd.cu is timed against.  With r = rsqrt(mean(x^2) + eps)
// (the forward's eps), x^ = x * r and g = gamma * dy, all in f32,
//   dx     = r * (g - x^ * mean(x^ * g))          (x's type)
//   dgamma = sum over rows of dy * x^              (f32)
//
// Replaces no Pallas kernel: the reference differentiates layers.rmsnorm
// (src/repro/models/layers.py:65) in XLA.  The port's training forward is
// the rmsnorm kernel (rmsnorm.cu), so its gradient is a kernel too: the
// norms of every block (ln_attn, ln_mlp, the q/k heads' norm) and ln_f.
//
// One block of 256 threads owns a block of rows.  TPR threads share a row
// (TPR = d / V for a row of up to 256 16-byte chunks, else 256; V the
// values in 16 bytes), so 256 / TPR rows are in flight at once, each
// thread holding CPT chunks of its row in registers; the row's two sums
// (x^2 and x * g) are a butterfly over the TPR lanes (and, above 32, the
// warps' sums added in warp order through shared memory).  Each thread
// keeps the f32 dgamma partial of its columns over the rows it visits;
// at the end the block adds its row groups' partials in group order and
// writes one partial row.  A second launch adds the blocks' partial rows
// in block order.  No atomics: every sum has one fixed order, so the
// backward is bitwise repeatable, and a row's dx depends on that row alone.
//
// What bounds it: bytes (x, dy and gamma read once, dx written once, the
// partial rows written and read once); a few operations per value.
// Widths: a row of d = TPR * V * CPT values, TPR a power of two up to 256
// and CPT 1, 2 or 4 (bf16: d = 8, 16, ..., 2048, 4096, 8192; f32: 4 ...
// 1024, 2048, 4096), on 16-byte aligned operands; the wrapper
// (kernels/rmsnorm_bwd.py) refuses any other.
#include "common.cuh"

REPRO_ERROR_STRING_FN

namespace repro {
// internal linkage: the kernel libraries are loaded into one process, and
// no two may bind each other's helpers
namespace {

constexpr int kRbThreads = 256;

template <int TPR>
__device__ __forceinline__ float row_sum(float v, float* red, int slot) {
  if constexpr (TPR <= 32) {
#pragma unroll
    for (int m = TPR / 2; m > 0; m >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, m);
    return v;
  } else {
    // the row's TPR / 32 warps: each warp's butterfly, then their sums in
    // warp order
    constexpr int W = TPR / 32;
    v = warp_sum(v);
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) red[slot * (kRbThreads / 32) + warp] = v;
    __syncthreads();
    const int first = warp / W * W;
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < W; ++w)
      total += red[slot * (kRbThreads / 32) + first + w];
    return total;
  }
}

template <typename T, int TPR, int CPT>
__global__ void __launch_bounds__(kRbThreads)
    rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                       const T* __restrict__ dy, T* __restrict__ dx,
                       float* __restrict__ partial, int rows,
                       int rows_per_block, float eps) {
  constexpr int V = 16 / (int)sizeof(T);
  constexpr int G = kRbThreads / TPR;          // rows in flight
  constexpr int D = TPR * V * CPT;
  __shared__ float red[2 * 2 * (kRbThreads / 32)];
  __shared__ float part[G * D];
  const int gr = threadIdx.x / TPR, tc = threadIdx.x % TPR;

  float gm[CPT][V], acc[CPT][V];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const uint4 gv =
        reinterpret_cast<const uint4*>(gamma)[c * TPR + tc];
    const T* ge = reinterpret_cast<const T*>(&gv);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      gm[c][e] = to_f32(ge[e]);
      acc[c][e] = 0.0f;
    }
  }

  const int row0 = blockIdx.x * rows_per_block;
  const int row_end = min(rows, row0 + rows_per_block);
  const int steps = (rows_per_block + G - 1) / G;
  for (int i = 0; i < steps; ++i) {              // uniform over the block
    const int row = row0 + i * G + gr;
    const bool live = row < row_end;
    float xv[CPT][V], gv[CPT][V];
    float s_xx = 0.0f, s_xg = 0.0f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      uint4 xr = make_uint4(0u, 0u, 0u, 0u), dr = xr;
      if (live) {
        xr = reinterpret_cast<const uint4*>(x + (size_t)row * D)[c * TPR + tc];
        dr = reinterpret_cast<const uint4*>(dy + (size_t)row * D)[c * TPR +
                                                                   tc];
      }
      const T* xe = reinterpret_cast<const T*>(&xr);
      const T* de = reinterpret_cast<const T*>(&dr);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        xv[c][e] = to_f32(xe[e]);
        gv[c][e] = to_f32(de[e]);              // dy, for now
        s_xx = fmaf(xv[c][e], xv[c][e], s_xx);
        s_xg = fmaf(xv[c][e], gm[c][e] * gv[c][e], s_xg);
      }
    }
    const int slot = i & 1;     // alternate the reduction slots: no barrier
                                // between one row step's reads and the
                                // next step's writes
    s_xx = row_sum<TPR>(s_xx, red, 2 * slot);
    s_xg = row_sum<TPR>(s_xg, red, 2 * slot + 1);
    const float r = rsqrtf(s_xx / (float)D + eps);
    const float c_mean = r * s_xg / (float)D;    // mean(x^ * g)
    if (live) {
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        uint4 out;
        T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float xh = xv[c][e] * r;
          acc[c][e] = fmaf(gv[c][e], xh, acc[c][e]);
          oe[e] = from_f32<T>(r * (gm[c][e] * gv[c][e] - xh * c_mean));
        }
        reinterpret_cast<uint4*>(dx + (size_t)row * D)[c * TPR + tc] = out;
      }
    }
  }

  // the block's partial row: its row groups' partials in group order
#pragma unroll
  for (int c = 0; c < CPT; ++c)
#pragma unroll
    for (int e = 0; e < V; ++e)
      part[gr * D + (c * TPR + tc) * V + e] = acc[c][e];
  __syncthreads();
  for (int col = threadIdx.x; col < D; col += kRbThreads) {
    float s = 0.0f;
#pragma unroll 4
    for (int q = 0; q < G; ++q) s += part[q * D + col];
    partial[(size_t)blockIdx.x * D + col] = s;
  }
}

// dgamma[col] = the blocks' partial rows added in block order.
__global__ void __launch_bounds__(kRbThreads)
    rmsnorm_bwd_reduce_kernel(const float* __restrict__ partial, int blocks,
                              int d, float* __restrict__ dgamma) {
  const int col = blockIdx.x * kRbThreads + threadIdx.x;
  if (col >= d) return;
  float s = 0.0f;
  for (int b = 0; b < blocks; ++b) s += partial[(size_t)b * d + col];
  dgamma[col] = s;
}

template <typename T, int TPR, int CPT>
int launch(const void* x, const void* gamma, const void* dy, void* dx,
           void* partial, void* dgamma, int rows, int rows_per_block,
           float eps, cudaStream_t s) {
  constexpr int D = TPR * (16 / (int)sizeof(T)) * CPT;
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  rmsnorm_bwd_kernel<T, TPR, CPT><<<blocks, kRbThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma),
      static_cast<const T*>(dy), static_cast<T*>(dx),
      static_cast<float*>(partial), rows, rows_per_block, eps);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  rmsnorm_bwd_reduce_kernel<<<(D + kRbThreads - 1) / kRbThreads, kRbThreads,
                              0, s>>>(static_cast<const float*>(partial),
                                      blocks, D, static_cast<float*>(dgamma));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int d, const void* x, const void* gamma, const void* dy,
             void* dx, void* partial, void* dgamma, int rows,
             int rows_per_block, float eps, cudaStream_t s) {
  constexpr int V = 16 / (int)sizeof(T);
#define REPRO_RB_CASE(TPR, CPT)                                              \
  case TPR * V * CPT:                                                        \
    return launch<T, TPR, CPT>(x, gamma, dy, dx, partial, dgamma, rows,     \
                               rows_per_block, eps, s);
  switch (d) {
    REPRO_RB_CASE(1, 1)
    REPRO_RB_CASE(2, 1)
    REPRO_RB_CASE(4, 1)
    REPRO_RB_CASE(8, 1)
    REPRO_RB_CASE(16, 1)
    REPRO_RB_CASE(32, 1)
    REPRO_RB_CASE(64, 1)
    REPRO_RB_CASE(128, 1)
    REPRO_RB_CASE(256, 1)
    REPRO_RB_CASE(256, 2)
    REPRO_RB_CASE(256, 4)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_RB_CASE
}

}  // namespace
}  // namespace repro

// x, dy, dx: (rows, d) of the activation type; gamma (d,) of that type;
// partial: (ceil(rows / rows_per_block), d) f32 scratch; dgamma (d,) f32.
extern "C" int rmsnorm_bwd_serial_launch(const void* x, const void* gamma,
                                  const void* dy, void* dx, void* partial,
                                  void* dgamma, int rows, int d,
                                  int rows_per_block, float eps, int dtype,
                                  void* stream) {
  using namespace repro;
  if (rows < 1 || rows_per_block < 1 ||
      ((uintptr_t)x | (uintptr_t)gamma | (uintptr_t)dy | (uintptr_t)dx) %
              16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return dispatch<__nv_bfloat16>(d, x, gamma, dy, dx, partial, dgamma,
                                   rows, rows_per_block, eps, s);
  return dispatch<float>(d, x, gamma, dy, dx, partial, dgamma, rows,
                         rows_per_block, eps, s);
}
