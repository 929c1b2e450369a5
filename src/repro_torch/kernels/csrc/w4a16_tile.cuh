// The W4A16 tile shared by w4a16_matmul.cu (one weight, optionally with a
// bias) and ffn_fused.cu (gate and up together, or up alone with its bias
// for the ungated gelu FFN, the activation in the epilogue).  Its
// cross-warp epilogue serves the block-sparse tile (sparse_tile.cuh) too.
//
// Layout read as the reference stores it (core/quant.py): packed uint8
// (in/2, out), where byte r of each 128-row group holds row r in its low
// nibble and row r + 64 in its high nibble; scales bf16 (in/128, out).
//
// One block computes a tile of kTok tokens x kCols output columns.  Lane l
// of every warp owns columns [4l, 4l + 4) of the tile and reads their four
// packed bytes as one 32-bit word (a warp reads 128 contiguous bytes per
// packed row).  The 128-row groups are dealt to the 8 warps round robin
// (warp w takes groups w, w + 8, ...).  For each group a warp accumulates
// the exact f32 dot over the group's 128 rows in a fixed order (row r, then
// row r + 64, for r = 0..63) and multiplies the finished partial sum by the
// group's scale (the paper's scale-after-accumulate).  The 8 warp sums are
// then added in warp order through shared memory.
//
// Batch invariance: every output element is reduced in an order fixed by
// in_features alone.  Tile shapes never follow the token count, there is no
// split across blocks and no atomic, so a row's result is bitwise the same
// whatever the other rows and however many there are.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kW4Threads = 256;
constexpr int kW4Warps = kW4Threads / 32;   // k-slices, one per warp
constexpr int kCols = 128;                  // 32 lanes x 4 columns
constexpr int kTok = 8;                     // tokens per block
constexpr int kGroup = 128;

// Shared memory: max(x tiles of every warp, the cross-warp sums).
template <int NW>
constexpr int w4a16_smem_bytes() {
  return (kW4Warps * kTok * kGroup > kW4Warps * NW * kTok * kCols
              ? kW4Warps * kTok * kGroup
              : kW4Warps * NW * kTok * kCols) *
         (int)sizeof(float);
}

// Adds the 8 warps' sums in warp order through shared memory (`red`, at
// least kW4Warps * NW * kTok * kCols floats, free once every warp is done
// with its x tiles), applies the epilogue (common.cuh; `bias` f32 per
// output column, for kEpiGeluBias and kEpiBias) and writes the block's
// tile: tokens t0.., columns col0.. of a row-major (n_tok, out_f) output,
// masked at n_tok and out_f.
template <typename T, int NW, int EPI>
__device__ __forceinline__ void w4a16_reduce_store(
    float (&acc)[NW][kTok][4], float* red, int t0, int n_tok,
    int col0, int out_f, T* __restrict__ out,
    const float* __restrict__ bias = nullptr) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int t = 0; t < kTok; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        red[((warp * NW + w) * kTok + t) * kCols + lane * 4 + c] =
            acc[w][t][c];
  __syncthreads();
  for (int o = threadIdx.x; o < kTok * kCols; o += kW4Threads) {
    const int t = o / kCols, cc = o % kCols;
    const int gcol = col0 + cc;
    if (t0 + t >= n_tok || gcol >= out_f) continue;
    float s[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      s[w] = 0.0f;
      for (int k = 0; k < kW4Warps; ++k)
        s[w] += red[((k * NW + w) * kTok + t) * kCols + cc];
    }
    out[(size_t)(t0 + t) * out_f + gcol] =
        from_f32<T>(epilogue<NW, EPI>(s, bias, gcol));
  }
}

// NW = number of weight matrices read against the same x (1, or 2 for the
// gated FFN); bias is read by the kEpiGeluBias and kEpiBias epilogues.  out_f is a multiple of 4 (checked by the wrapper), so a
// lane's 4 columns are either all inside the matrix or all past its edge.
template <typename T, int NW, int EPI>
__global__ void __launch_bounds__(kW4Threads)
    w4a16_tile_kernel(const T* __restrict__ x, int n_tok, int in_f, int out_f,
                      const uint8_t* __restrict__ pk0,
                      const __nv_bfloat16* __restrict__ sc0,
                      const uint8_t* __restrict__ pk1,
                      const __nv_bfloat16* __restrict__ sc1,
                      const float* __restrict__ bias,
                      T* __restrict__ out) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t0 = blockIdx.y * kTok;
  const int col = blockIdx.x * kCols + lane * 4;
  const bool col_ok = col < out_f;
  const int n_groups = in_f / kGroup;
  float* xs = smem + warp * (kTok * kGroup);
  const uint8_t* pks[2] = {pk0, pk1};
  const __nv_bfloat16* scs[2] = {sc0, sc1};

  float acc[NW][kTok][4];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int t = 0; t < kTok; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[w][t][c] = 0.0f;

  for (int g = warp; g < n_groups; g += kW4Warps) {
    // this warp's x tile for group g, as f32 (zeros past the last token)
    for (int i = lane; i < kTok * kGroup; i += 32) {
      const int t = i / kGroup, k = i % kGroup;
      xs[i] = (t0 + t < n_tok)
                  ? to_f32(x[(size_t)(t0 + t) * in_f + g * kGroup + k])
                  : 0.0f;
    }
    __syncwarp();
    if (col_ok) {
      float part[NW][kTok][4];
#pragma unroll
      for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int t = 0; t < kTok; ++t)
#pragma unroll
          for (int c = 0; c < 4; ++c) part[w][t][c] = 0.0f;
#pragma unroll 4
      for (int r = 0; r < kGroup / 2; ++r) {
        const size_t off = (size_t)(g * (kGroup / 2) + r) * out_f + col;
        float lo[NW][4], hi[NW][4];
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          const uint32_t bits = __ldg(reinterpret_cast<const uint32_t*>(
              pks[w] + off));
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int b = (bits >> (8 * c)) & 0xFF;
            lo[w][c] = (float)(((b & 0xF) ^ 8) - 8);   // sign-extend int4
            hi[w][c] = (float)(((b >> 4) ^ 8) - 8);
          }
        }
#pragma unroll
        for (int t = 0; t < kTok; ++t) {
          const float xa = xs[t * kGroup + r];
          const float xb = xs[t * kGroup + r + kGroup / 2];
#pragma unroll
          for (int w = 0; w < NW; ++w)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              part[w][t][c] = fmaf(xa, lo[w][c], part[w][t][c]);
              part[w][t][c] = fmaf(xb, hi[w][c], part[w][t][c]);
            }
        }
      }
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        float s[4];
#pragma unroll
        for (int c = 0; c < 4; ++c)
          s[c] = __bfloat162float(scs[w][(size_t)g * out_f + col + c]);
#pragma unroll
        for (int t = 0; t < kTok; ++t)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[w][t][c] = fmaf(part[w][t][c], s[c], acc[w][t][c]);
      }
    }
    __syncwarp();
  }

  w4a16_reduce_store<T, NW, EPI>(acc, smem, t0, n_tok, blockIdx.x * kCols,
                                 out_f, out, bias);
}

template <typename T, int NW, int EPI>
int launch_w4a16_tile(const void* x, int n_tok, int in_f, int out_f,
                      const void* pk0, const void* sc0, const void* pk1,
                      const void* sc1, const float* bias, void* out,
                      cudaStream_t stream) {
  constexpr int smem = w4a16_smem_bytes<NW>();
  auto kernel = w4a16_tile_kernel<T, NW, EPI>;
  REPRO_SMEM_OPT_IN(kernel, smem);
  dim3 grid((out_f + kCols - 1) / kCols, (n_tok + kTok - 1) / kTok);
  kernel<<<grid, kW4Threads, smem, stream>>>(
      static_cast<const T*>(x), n_tok, in_f, out_f,
      static_cast<const uint8_t*>(pk0),
      static_cast<const __nv_bfloat16*>(sc0),
      static_cast<const uint8_t*>(pk1),
      static_cast<const __nv_bfloat16*>(sc1), bias, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace repro
