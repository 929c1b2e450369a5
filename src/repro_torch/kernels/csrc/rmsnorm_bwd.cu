// RMSNorm, backward, for Hopper (sm_90a): with r = rsqrt(mean(x^2) + eps)
// (the forward's eps), x^ = x * r and g = gamma * dy, all in f32,
//   dx     = r * (g - x^ * mean(x^ * g))          (x's type)
//   dgamma = sum over rows of dy * x^              (f32)
//
// Replaces no Pallas kernel: the reference differentiates layers.rmsnorm
// (src/repro/models/layers.py:65) in XLA.  The port's training forward is
// the rmsnorm kernel (rmsnorm.cu), so its gradient is a kernel too: the
// norms of every block (ln_attn, ln_mlp, the q/k heads' norm) and ln_f.
//
// One cooperative launch of one block of 256 threads a block of rows (one
// wave of blocks: two an SM, one at CPT 4; kernels/rmsnorm_bwd.py's plan,
// from the card's SM count).  TPR threads share a row (TPR = d / V for a
// row of up to 256 16-byte chunks, else 256; V the values in 16 bytes),
// so G = 256 / TPR rows are in flight at once, each thread holding CPT
// chunks of its row.  P steps' rows (P = 4, 2, 1 for CPT = 1, 2, 4) wait
// in registers (step i's in buffer i % P, the loop unrolled by P so no
// buffer moves), and a step reloads its buffer with step i + P's rows
// before it reduces, so every block keeps P steps of x and dy in flight
// through its reductions.  A row of up to 32 threads sums within its warp
// (a butterfly over its lanes); a wider row sums both of its sums (x^2
// and x * g) in one round: each warp's butterflies, then the row's warps'
// pairs in warp order through shared memory, one barrier a step (two
// slots, alternating, so the next step's writes need no second barrier).
// Each thread keeps the f32 dgamma partial of its columns over the rows it
// visits; the block adds its row groups' partials in group order and
// writes one partial row.  Then the grid waits for itself (the launch is
// cooperative: every block is resident) and adds the partial rows, 32
// columns a block: warp w adds the partial rows w, w + 8, ... in order,
// then warp 0 adds the 8 warps' sums in warp order.  No atomics in any
// sum: every sum has one fixed order, so the backward is bitwise
// repeatable, and a row's dx depends on that row alone.
//
// What bounds it: bytes (x, dy and gamma read once, dx written once; the
// partial rows, written and read once, stay in L2); a few operations per
// value.  Widths: a row of d = TPR * V * CPT values, TPR a power of two up
// to 256 and CPT 1, 2 or 4 (bf16: d = 8, 16, ..., 2048, 4096, 8192; f32:
// 4 ... 1024, 2048, 4096), on 16-byte aligned operands; the wrapper
// (kernels/rmsnorm_bwd.py) refuses any other.
#include <cooperative_groups.h>

#include "common.cuh"

REPRO_ERROR_STRING_FN

namespace repro {
// internal linkage: the kernel libraries are loaded into one process, and
// no two may bind each other's helpers
namespace {

constexpr int kRbThreads = 256;
constexpr int kRbReduceCols = 32;      // the dgamma pass: columns a block
constexpr int kRbReduceWarps = 8;

// CPT chunks of `row` (zeros past row_end)
template <typename T, int TPR, int CPT>
__device__ __forceinline__ void load_row(uint4 (&out)[CPT],
                                         const T* __restrict__ src, int row,
                                         int row_end, int tc) {
  constexpr int D = TPR * (16 / (int)sizeof(T)) * CPT;
#pragma unroll
  for (int c = 0; c < CPT; ++c)
    out[c] = row < row_end
                 ? reinterpret_cast<const uint4*>(src + (size_t)row * D)
                       [c * TPR + tc]
                 : make_uint4(0u, 0u, 0u, 0u);
}

template <typename T, int TPR, int CPT>
__global__ void __launch_bounds__(kRbThreads, CPT == 4 ? 1 : 2)
    rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                       const T* __restrict__ dy, T* __restrict__ dx,
                       float* __restrict__ partial,
                       float* __restrict__ dgamma, int rows,
                       int rows_per_block, float eps) {
  constexpr int V = 16 / (int)sizeof(T);
  constexpr int G = kRbThreads / TPR;          // rows in flight a step
  constexpr int D = TPR * V * CPT;
  constexpr int P = CPT == 1 ? 4 : CPT == 2 ? 2 : 1;   // steps in flight
  __shared__ float2 red[2][kRbThreads / 32];
  __shared__ float part[G > 1 ? G * D : 1];
  const int gr = threadIdx.x / TPR, tc = threadIdx.x % TPR;

  float gm[CPT][V], acc[CPT][V];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const uint4 gv = reinterpret_cast<const uint4*>(gamma)[c * TPR + tc];
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
  // P steps' x and dy in flight: step i's rows wait in buffer i % P, which
  // takes step i + P's rows as soon as step i has read it
  uint4 xb[P][CPT], db[P][CPT];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    load_row<T, TPR, CPT>(xb[j], x, row0 + j * G + gr, row_end, tc);
    load_row<T, TPR, CPT>(db[j], dy, row0 + j * G + gr, row_end, tc);
  }
  for (int i0 = 0; i0 < steps; i0 += P) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int i = i0 + j;
      if (i >= steps) break;                   // uniform over the block
      const int row = row0 + i * G + gr;
      uint4 xc[CPT], dc[CPT];                  // this step's rows, packed
      float s_xx = 0.0f, s_xg = 0.0f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        xc[c] = xb[j][c];
        dc[c] = db[j][c];
        const T* xe = reinterpret_cast<const T*>(&xc[c]);
        const T* de = reinterpret_cast<const T*>(&dc[c]);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float xf = to_f32(xe[e]);
          s_xx = fmaf(xf, xf, s_xx);
          s_xg = fmaf(xf, gm[c][e] * to_f32(de[e]), s_xg);
        }
      }
      load_row<T, TPR, CPT>(xb[j], x, row + P * G, row_end, tc);
      load_row<T, TPR, CPT>(db[j], dy, row + P * G, row_end, tc);
      if constexpr (TPR <= 32) {
#pragma unroll
        for (int m = TPR / 2; m > 0; m >>= 1) {
          s_xx += __shfl_xor_sync(0xffffffffu, s_xx, m);
          s_xg += __shfl_xor_sync(0xffffffffu, s_xg, m);
        }
      } else {
        // the row's TPR / 32 warps: each warp's butterflies, then their
        // pairs in warp order
        constexpr int W = TPR / 32;
        s_xx = warp_sum(s_xx);
        s_xg = warp_sum(s_xg);
        const int warp = threadIdx.x >> 5, slot = i & 1;
        if ((threadIdx.x & 31) == 0)
          red[slot][warp] = make_float2(s_xx, s_xg);
        __syncthreads();
        const int first = warp / W * W;
        s_xx = s_xg = 0.0f;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const float2 p = red[slot][first + w];
          s_xx += p.x;
          s_xg += p.y;
        }
      }
      const float r = rsqrtf(s_xx / (float)D + eps);
      const float c_mean = r * s_xg / (float)D;    // mean(x^ * g)
      if (row < row_end) {
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          uint4 out;
          T* oe = reinterpret_cast<T*>(&out);
          const T* xe = reinterpret_cast<const T*>(&xc[c]);
          const T* de = reinterpret_cast<const T*>(&dc[c]);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float xh = to_f32(xe[e]) * r, dyf = to_f32(de[e]);
            acc[c][e] = fmaf(dyf, xh, acc[c][e]);
            oe[e] = from_f32<T>(r * (gm[c][e] * dyf - xh * c_mean));
          }
          reinterpret_cast<uint4*>(dx + (size_t)row * D)[c * TPR + tc] = out;
        }
      }
    }
  }

  // the block's partial row: its row groups' partials in group order
  float* prow = partial + (size_t)blockIdx.x * D;
  if constexpr (G == 1) {
#pragma unroll
    for (int c = 0; c < CPT; ++c)
#pragma unroll
      for (int e = 0; e < V; e += 4)
        *reinterpret_cast<float4*>(prow + (c * TPR + tc) * V + e) =
            make_float4(acc[c][e], acc[c][e + 1], acc[c][e + 2],
                        acc[c][e + 3]);
  } else {
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
      prow[col] = s;
    }
  }

  // every block's partial row is written: the dgamma pass
  cooperative_groups::this_grid().sync();
  __shared__ float cred[kRbReduceWarps][kRbReduceCols];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int cb = blockIdx.x; cb * kRbReduceCols < D; cb += gridDim.x) {
    const int col = cb * kRbReduceCols + lane;
    float s = 0.0f;
    if (col < D) {
#pragma unroll 8
      for (int b = w; b < (int)gridDim.x; b += kRbReduceWarps)
        s += partial[(size_t)b * D + col];
    }
    cred[w][lane] = s;
    __syncthreads();
    if (w == 0 && col < D) {
      float t = 0.0f;
#pragma unroll
      for (int j = 0; j < kRbReduceWarps; ++j) t += cred[j][lane];
      dgamma[col] = t;
    }
    __syncthreads();
  }
}

template <typename T, int TPR, int CPT>
int launch(const void* x, const void* gamma, const void* dy, void* dx,
           void* partial, void* dgamma, int rows, int rows_per_block,
           float eps, cudaStream_t s) {
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(gamma);
  const T* dyp = static_cast<const T*>(dy);
  T* dxp = static_cast<T*>(dx);
  float* pp = static_cast<float*>(partial);
  float* dgp = static_cast<float*>(dgamma);
  void* args[] = {&xp, &gp, &dyp, &dxp, &pp, &dgp, &rows, &rows_per_block,
                  &eps};
  // cooperative: every block resident, so the grid can wait for itself
  // (a grid larger than the card holds is refused, not run)
  const int rc = (int)cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(rmsnorm_bwd_kernel<T, TPR, CPT>),
      dim3(blocks), dim3(kRbThreads), args, 0, s);
  if (rc) return rc;
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
// rows_per_block: a multiple of the rows a block has in flight, and so
// many that the blocks fit the card at once.
extern "C" int rmsnorm_bwd_launch(const void* x, const void* gamma,
                                  const void* dy, void* dx, void* partial,
                                  void* dgamma, int rows, int d,
                                  int rows_per_block, float eps, int dtype,
                                  void* stream) {
  using namespace repro;
  if (rows < 1 || rows_per_block < 1 ||
      ((uintptr_t)x | (uintptr_t)gamma | (uintptr_t)dy | (uintptr_t)dx |
       (uintptr_t)partial) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return dispatch<__nv_bfloat16>(d, x, gamma, dy, dx, partial, dgamma,
                                   rows, rows_per_block, eps, s);
  return dispatch<float>(d, x, gamma, dy, dx, partial, dgamma, rows,
                         rows_per_block, eps, s);
}
