// The float32 block-sparse W4A16 tile of sparse_w4a16.cu (one weight,
// optionally with a bias) and ffn_fused_sparse.cu (gate and up together, or
// up alone with its bias for the ungated gelu FFN, the activation in the
// epilogue), on the CUDA cores.  bfloat16 runs on the tensor-core tile of
// sparse_mma_tile.cuh.
//
// Layout read as the port stores it (core/sparsity.py): for output tile o
// (128 columns) the S kept 128-row blocks of the contraction axis are listed
// in block_idx (tiles, S); packed uint8 (tiles, S, 64, 128) holds kept block
// (o, s), where byte r of column c has row r in its low nibble and row
// r + 64 in its high nibble; scales bf16 (tiles, S, 128).
//
// One block computes kTok tokens x the 128 columns of one output tile,
// o = tile_map[blockIdx.x] (or blockIdx.x when tile_map is null), and reads
// only the kept blocks of that tile: a tile that is not in tile_map is
// never touched.  Lane l of every warp owns columns [4l, 4l + 4) and reads
// their four packed bytes as one 32-bit word.  The S kept blocks are dealt
// to the 8 warps round robin (warp w takes s = w, w + 8, ...).  For kept
// block s a warp stages the kTok x 128 activation sub-tile at columns
// block_idx[o][s] * 128 in shared memory (one per weight: gate and up keep
// their own blocks), accumulates the exact f32 dot over the block's 128
// rows in the dense tile's fixed order (row r, then row r + 64, for
// r = 0..63) and multiplies the finished partial sum by the block's scale.
// The 8 warp sums are then added in warp order (w4a16_reduce_store).
//
// The block loop repeats the dense tile's rather than sharing a helper with
// it: with one shared helper nvcc issued the dense kernel's fourth weight
// load of each unrolled step late, and the dense kernel became slower at
// decode (see PERF.md).
//
// Batch invariance: every output element is reduced in an order fixed by
// (S, block_idx) alone: no split that follows the token count, no atomics,
// so a row's result is bitwise the same whatever the other rows.
#pragma once

#include "w4a16_tile.cuh"

namespace repro {

// x sub-tiles of every warp and weight; the cross-warp sums take as much
// (w4a16_reduce_store)
template <int NW>
constexpr int sparse_smem_bytes() {
  return kW4Warps * NW * kTok * kGroup * (int)sizeof(float);
}

template <typename T, int NW, int EPI>
__global__ void __launch_bounds__(kW4Threads)
    sparse_tile_kernel(const T* __restrict__ x, int n_tok, int in_f,
                       int out_f, int n_kept,
                       const int* __restrict__ tile_map,
                       const int* __restrict__ idx0,
                       const uint8_t* __restrict__ pk0,
                       const __nv_bfloat16* __restrict__ sc0,
                       const int* __restrict__ idx1,
                       const uint8_t* __restrict__ pk1,
                       const __nv_bfloat16* __restrict__ sc1,
                       const float* __restrict__ bias,
                       T* __restrict__ out) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t0 = blockIdx.y * kTok;
  const int o = tile_map != nullptr ? tile_map[blockIdx.x] : blockIdx.x;
  float* xs = smem + warp * (NW * kTok * kGroup);
  const int* idxs[2] = {idx0, idx1};
  const uint8_t* pks[2] = {pk0, pk1};
  const __nv_bfloat16* scs[2] = {sc0, sc1};

  float acc[NW][kTok][4];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int t = 0; t < kTok; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[w][t][c] = 0.0f;

  for (int s = warp; s < n_kept; s += kW4Warps) {
    const size_t blk = (size_t)o * n_kept + s;   // kept block (o, s)
    // this warp's x sub-tiles for block s, as f32 (zeros past the last
    // token)
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const int col0 = idxs[w][blk] * kGroup;
      float* xw = xs + w * (kTok * kGroup);
      for (int i = lane; i < kTok * kGroup; i += 32) {
        const int t = i / kGroup, k = i % kGroup;
        xw[i] = (t0 + t < n_tok)
                    ? to_f32(x[(size_t)(t0 + t) * in_f + col0 + k])
                    : 0.0f;
      }
    }
    __syncwarp();
    float part[NW][kTok][4];
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int t = 0; t < kTok; ++t)
#pragma unroll
        for (int c = 0; c < 4; ++c) part[w][t][c] = 0.0f;
#pragma unroll 4
    for (int r = 0; r < kGroup / 2; ++r) {
      const size_t off = (blk * (kGroup / 2) + r) * kCols + lane * 4;
      float lo[NW][4], hi[NW][4];
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const uint32_t bits =
            __ldg(reinterpret_cast<const uint32_t*>(pks[w] + off));
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int b = (bits >> (8 * c)) & 0xFF;
          lo[w][c] = (float)(((b & 0xF) ^ 8) - 8);   // sign-extend int4
          hi[w][c] = (float)(((b >> 4) ^ 8) - 8);
        }
      }
#pragma unroll
      for (int t = 0; t < kTok; ++t)
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          const float xa = xs[(w * kTok + t) * kGroup + r];
          const float xb = xs[(w * kTok + t) * kGroup + r + kGroup / 2];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            part[w][t][c] = fmaf(xa, lo[w][c], part[w][t][c]);
            part[w][t][c] = fmaf(xb, hi[w][c], part[w][t][c]);
          }
        }
    }
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      float sc[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        sc[c] = __bfloat162float(scs[w][blk * kCols + lane * 4 + c]);
#pragma unroll
      for (int t = 0; t < kTok; ++t)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[w][t][c] = fmaf(part[w][t][c], sc[c], acc[w][t][c]);
    }
    __syncwarp();
  }
  w4a16_reduce_store<T, NW, EPI>(acc, smem, t0, n_tok, o * kCols, out_f,
                                 out, bias);
}

// n_tiles output tiles are computed: tile_map[0..n_tiles) when tile_map is
// given, else tiles 0..n_tiles; bias (f32 per output column) is read by
// kEpiBias and kEpiGeluBias.
template <typename T, int NW, int EPI>
int launch_sparse_tile(const void* x, int n_tok, int in_f, int out_f,
                       int n_tiles, int n_kept, const void* tile_map,
                       const void* idx0, const void* pk0, const void* sc0,
                       const void* idx1, const void* pk1, const void* sc1,
                       const float* bias, void* out, cudaStream_t stream) {
  constexpr int smem = sparse_smem_bytes<NW>();
  auto kernel = sparse_tile_kernel<T, NW, EPI>;
  REPRO_SMEM_OPT_IN(kernel, smem);
  dim3 grid(n_tiles, (n_tok + kTok - 1) / kTok);
  kernel<<<grid, kW4Threads, smem, stream>>>(
      static_cast<const T*>(x), n_tok, in_f, out_f, n_kept,
      static_cast<const int*>(tile_map), static_cast<const int*>(idx0),
      static_cast<const uint8_t*>(pk0),
      static_cast<const __nv_bfloat16*>(sc0), static_cast<const int*>(idx1),
      static_cast<const uint8_t*>(pk1),
      static_cast<const __nv_bfloat16*>(sc1), bias, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

}  // namespace repro
