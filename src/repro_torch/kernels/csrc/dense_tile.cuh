// The float32 tile of the 16-bit-weight kernels, on the CUDA cores, shared
// by dense_matmul.cu (one weight, optionally with an f32 bias) and
// ffn_fused_dense.cu (gate and up together, or up alone with its bias for
// the ungated gelu FFN, the activation in the epilogue).  Weights are plain
// row-major (in, out) float32 matrices; the epilogues are common.cuh's, as
// in w4a16_tile.cuh.  bfloat16 takes the tensor-core tile of
// dense_mma_tile.cuh; float32 stays here, in full f32 FMAs (TF32 would drop
// the precision the fp32 configs are held to).
//
// One block computes a tile of kDenseTok tokens x kDenseCols output
// columns; a warp's 32 lanes are 4 row quarters x 8 column quads.  Lane l
// owns columns [4 (l % 8), 4 (l % 8) + 4) of the tile and reads their four
// weights as one 16-byte load; its quarter l / 8 takes rows 32 q .. 32 q +
// 31 of every 128-row group the warp holds.  The groups are dealt to the 8
// warps round robin (warp w takes groups w, w + 8, ...), and each warp
// stages its group's x rows in shared memory (one row of 33 floats per
// quarter and token, so the four quarters read four banks).  A lane
// accumulates its rows in order with f32 FMAs; the four quarters of a warp
// are then added in quarter order by shuffles, and the 8 warp sums in warp
// order through shared memory.
//
// Batch invariance: every output element is reduced in an order fixed by
// in_features alone.  The tile never follows the token count, there is no
// split across blocks and no atomic, so a row's result is bitwise the same
// whatever the other rows and however many there are.
//
// What bounds it: at decode the weight bytes (32 columns a block give
// 4096 / 32 = 128 blocks for a 4096-wide output); at prefill widths the
// f32 FMAs (67 TFLOP/s on the H100).
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kDenseThreads = 256;
constexpr int kDenseWarps = kDenseThreads / 32;
constexpr int kDenseCols = 32;          // 8 column quads x 4
constexpr int kDenseTok = 8;            // tokens per block
constexpr int kDenseGroup = 128;        // rows a warp takes at a time
constexpr int kDenseQuarter = kDenseGroup / 4;   // rows of one lane quarter
constexpr int kDenseRowPad = kDenseQuarter + 1;  // smem row, bank-skewed
constexpr int kDenseXTile = kDenseTok * 4 * kDenseRowPad;   // floats a warp

// Shared memory: max(x tiles of every warp, the cross-warp sums).
template <int NW>
constexpr int dense_smem_bytes() {
  return (kDenseWarps * kDenseXTile > kDenseWarps * NW * kDenseTok * kDenseCols
              ? kDenseWarps * kDenseXTile
              : kDenseWarps * NW * kDenseTok * kDenseCols) *
         (int)sizeof(float);
}

// Four consecutive weights of one row.
__device__ __forceinline__ void load_quad(const float* p, float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

// NW = number of weight matrices read against the same x (1, or 2 for the
// gated FFN: w0 = gate, w1 = up).  out_f is a multiple of 4 and every weight
// pointer 4-element aligned (checked by the wrapper), so a lane's quad is
// either all inside the matrix or all past its edge.  in_f is any size:
// rows past it are neither loaded nor added.
template <int NW, int EPI>
__global__ void __launch_bounds__(kDenseThreads)
    dense_tile_kernel(const float* __restrict__ x, int n_tok, int in_f,
                      int out_f, const float* __restrict__ w0,
                      const float* __restrict__ w1,
                      const float* __restrict__ bias,
                      float* __restrict__ out) {
  extern __shared__ float smem[];
  constexpr int kBatch = 8 / NW;        // rows loaded ahead per weight
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int quarter = lane >> 3;
  const int t0 = blockIdx.y * kDenseTok;
  const int col0 = blockIdx.x * kDenseCols;
  const int col = col0 + (lane & 7) * 4;
  const bool col_ok = col < out_f;
  const int n_groups = (in_f + kDenseGroup - 1) / kDenseGroup;
  float* xs = smem + warp * kDenseXTile;
  const float* ws[2] = {w0, w1};

  float acc[NW][kDenseTok][4];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int t = 0; t < kDenseTok; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[w][t][c] = 0.0f;

  for (int g = warp; g < n_groups; g += kDenseWarps) {
    const int row0 = g * kDenseGroup;
    // this warp's x tile for group g (zeros past the last token and past
    // in_f)
    for (int i = lane; i < kDenseTok * kDenseGroup; i += 32) {
      const int t = i / kDenseGroup, k = i % kDenseGroup;
      const bool ok = t0 + t < n_tok && row0 + k < in_f;
      xs[t * 4 * kDenseRowPad + (k / kDenseQuarter) * kDenseRowPad +
         k % kDenseQuarter] =
          ok ? x[(size_t)(t0 + t) * in_f + row0 + k] : 0.0f;
    }
    __syncwarp();
    const int r_base = row0 + quarter * kDenseQuarter;
    const int n_rows = max(0, min(kDenseQuarter, in_f - r_base));
    const float* xq = xs + quarter * kDenseRowPad;
    if (col_ok) {
      for (int r0 = 0; r0 < n_rows; r0 += kBatch) {
        float wv[NW][kBatch][4];
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
#pragma unroll
          for (int w = 0; w < NW; ++w) {
            if (r0 + u < n_rows) {
              load_quad(ws[w] + (size_t)(r_base + r0 + u) * out_f + col,
                        wv[w][u]);
            } else {
#pragma unroll
              for (int c = 0; c < 4; ++c) wv[w][u][c] = 0.0f;
            }
          }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (r0 + u >= n_rows) break;
#pragma unroll
          for (int t = 0; t < kDenseTok; ++t) {
            const float xv = xq[t * 4 * kDenseRowPad + r0 + u];
#pragma unroll
            for (int w = 0; w < NW; ++w)
#pragma unroll
              for (int c = 0; c < 4; ++c)
                acc[w][t][c] = fmaf(xv, wv[w][u][c], acc[w][t][c]);
          }
        }
      }
    }
    __syncwarp();
  }

  // the four quarters of the warp, in quarter order (every lane computes
  // the same sum for its column quad)
  const int quad = lane & 7;
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int t = 0; t < kDenseTok; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float v = acc[w][t][c];
        float s = __shfl_sync(0xffffffffu, v, quad);
        s += __shfl_sync(0xffffffffu, v, quad + 8);
        s += __shfl_sync(0xffffffffu, v, quad + 16);
        s += __shfl_sync(0xffffffffu, v, quad + 24);
        acc[w][t][c] = s;
      }

  // the 8 warp sums in warp order, then the epilogue: one output a thread
  __syncthreads();                        // every warp is done with xs
  float* red = smem;                      // [warp][w][t][32 columns]
  if (quarter == 0) {
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int t = 0; t < kDenseTok; ++t)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          red[((warp * NW + w) * kDenseTok + t) * kDenseCols + quad * 4 + c] =
              acc[w][t][c];
  }
  __syncthreads();
  for (int o = threadIdx.x; o < kDenseTok * kDenseCols; o += kDenseThreads) {
    const int t = o / kDenseCols, cc = o % kDenseCols;
    const int gcol = col0 + cc;
    if (t0 + t >= n_tok || gcol >= out_f) continue;
    float s[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      s[w] = 0.0f;
      for (int k = 0; k < kDenseWarps; ++k)
        s[w] += red[((k * NW + w) * kDenseTok + t) * kDenseCols + cc];
    }
    out[(size_t)(t0 + t) * out_f + gcol] = epilogue<NW, EPI>(s, bias, gcol);
  }
}

template <int NW, int EPI>
int launch_dense_tile(const void* x, int n_tok, int in_f, int out_f,
                      const void* w0, const void* w1, const float* bias,
                      void* out, cudaStream_t stream) {
  constexpr int smem = dense_smem_bytes<NW>();
  auto kernel = dense_tile_kernel<NW, EPI>;
  REPRO_SMEM_OPT_IN(kernel, smem);
  dim3 grid((out_f + kDenseCols - 1) / kDenseCols,
            (n_tok + kDenseTok - 1) / kDenseTok);
  kernel<<<grid, kDenseThreads, smem, stream>>>(
      static_cast<const float*>(x), n_tok, in_f, out_f,
      static_cast<const float*>(w0), static_cast<const float*>(w1), bias,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace repro
