// The bfloat16 log-scale block-sparse W4A16 tile of sparse_w4a16.cu (one
// weight, kernel 4) and of ffn_fused_sparse.cu (kernel 5's gate/up stage:
// gate and up, or up alone with its bias for the ungated gelu FFN), on
// Hopper's tensor cores.  float32 inputs keep the CUDA-core tile of
// sparse_tile.cuh.
//
// Layout read as the port stores it (core/sparsity.py), with no repack: for
// 128-column output tile o the S kept 128-row blocks of the contraction
// axis are listed in block_idx (tiles, S); packed uint8 (tiles, S, 64, 128)
// holds kept block (o, s), byte r of column c with row r in its low nibble
// and row r + 64 in its high nibble (the order of a dense group, so
// w4a16_mma_tile.cuh's fragment loader applies as it is); scales bf16
// (tiles, S, 128).
//
// Built from w4a16_mma_tile.cuh's parts: its ring of cp.async stages, its
// swizzled stage layout, its weight loader (kept block (o, s) is read as
// group s of a matrix whose row stride is 128 and whose first column is the
// block's strip inside tile o) and its stage (w4_mma_stage: mma.sync
// m16n8k16, the nibbles dequantized in registers into the B fragments).
// What differs from the dense tile:
//   * the k loop gathers: ring step s stages x's columns
//     block_idx[o][s] * 128 .. + 128 (a block reads its S indices into
//     shared memory once, before the ring starts);
//   * a block computes one BN-column strip (BN in {32, 64, 128}) inside
//     one output tile, o = tile_map[i] (kernel 5: the f-tiles a
//     tile_uniform down keeps; the other tiles are never read) or i;
//   * two weights (NW = 2, gate and up) keep their own kept blocks per
//     tile (core/sparsity.py picks them per matrix), so a stage holds one
//     x tile per weight: a stage is NW one-weight stages side by side, and
//     each weight runs the one-weight w4_mma_stage on its own half.
//
// The order of every sum: for each kept block, in increasing s, one warp's
// fragment sums the block's 8 k16 steps from +0 in order; the finished
// f32 partial is multiplied by the block's scale and added to the running
// f32 sum (one fmaf).  No split, no atomic.  So the order is fixed by
// (S, block_idx) alone: the configuration (picked below by the token count
// and the number of tiles) moves no bit, and a row's result is bitwise the
// same whatever the other rows and however many there are.
//
// What bounds it on the H100 (3.35 TB/s, 989 TFLOP/s bf16 dense): at
// decode the kept packed bytes (S * 128 * 128 / 2 per output tile, plus
// S * 256 of scales) read once, and a block's walk over its S kept blocks;
// 16 x 32 blocks give a 4096-wide output 128 of them.  At prefill widths the
// tensor cores, the in-register dequantization and the shared memory that
// feeds them, as for kernel 1.
//
// -Xptxas -v (sm_90a): no spills, no stack, one barrier in every
// instantiation; registers a thread (the same for every epilogue unless
// given) and the ring's dynamic shared memory (the S indices add 4 NW S
// bytes at launch):
//   one weight (kernel 4; kernel 5's gelu up)
//     16 x 32:    90 registers,  48.5 KB
//     64 x 64:    97 (no bias) / 118 (bias) registers, 80.5 KB
//     64 x 128:  163 registers,  72.75 KB
//     128 x 128: 254 registers, 161 KB
//   two weights (kernel 5's gate/up)
//     16 x 32:    90 registers,  97 KB
//     64 x 64:   126 registers, 161 KB
//     64 x 128:  165 registers, 145.5 KB
#pragma once

#include "w4a16_mma_tile.cuh"

namespace repro {

// One-weight configurations (W4MmaTile with NW = 1): a two-weight stage is
// two of these stages.  BN divides the 128-column output tile.
using SparseMmaDecode = W4MmaTile<16, 32, 1, 4, 2, 4>;    // T <= 16
using SparseMmaMid = W4MmaTile<64, 64, 2, 4, 1, 4>;       // T <= 128
using SparseMmaWide = W4MmaTile<64, 128, 2, 4, 1, 3>;     // T > 128
// one weight, once it gives every SM a block
using SparseMmaLarge = W4MmaTile<128, 128, 2, 4, 1, 4>;

// One weight's half of a ring stage: x rows t0.. (BM) at the gathered
// columns of kept blocks g0.. (G of them: chunk c of a row belongs to block
// g0 + c / 16), then the blocks' packed rows and scales of the strip c0..
// (BN columns) of the output tile whose blocks start at pk and sc.  Zeros
// past n_tok and past the last kept block.
template <class C>
__device__ __forceinline__ void sparse_mma_load(
    unsigned char* stage, const __nv_bfloat16* __restrict__ x,
    const int* sidx, const uint8_t* __restrict__ pk,
    const __nv_bfloat16* __restrict__ sc, int n_tok, int in_f, int n_kept,
    int t0, int c0, int g0, bool vec_w) {
  constexpr int kA = C::BM * C::RX;
  constexpr int kChunks = kW4MmaGroup / 8;   // 16-byte chunks of a block
#pragma unroll
  for (int j = 0; j < (kA + C::kThreads - 1) / C::kThreads; ++j) {
    const int i = threadIdx.x + j * C::kThreads;
    if (kA % C::kThreads != 0 && i >= kA) break;
    const int r = i / C::RX, c = i % C::RX;
    const int t = t0 + r, blk = g0 + c / kChunks;
    const bool ok = t < n_tok && blk < n_kept;
    const __nv_bfloat16* src =
        ok ? x + (size_t)t * in_f + sidx[blk] * kW4MmaGroup +
                 (c % kChunks) * 8
           : x;
    cp_async16(stage + (r * C::RX + swz<C::RX>(r, c)) * 16, src,
               ok ? 16 : 0);
  }
  // kept block s of the tile is group s of a (S * 128) x 128 matrix
  w4_mma_load_w<C>(stage + C::kXBytes, pk, sc, n_kept * kW4MmaGroup,
                   kW4MmaGroup, c0, g0, vec_w);
}

// C: a one-weight configuration; NW weights (1, or gate and up), each with
// its own index list, packed blocks and scales; bias (f32, per output
// column) for kEpiBias and kEpiGeluBias.  out is (n_tok, out_f) row-major;
// the block writes tokens t0.. of its strip of tile o.
template <class C, int NW, int EPI>
__global__ void __launch_bounds__(C::kThreads)
    sparse_mma_kernel(const __nv_bfloat16* __restrict__ x, int n_tok,
                      int in_f, int out_f, int n_kept,
                      const int* __restrict__ tile_map,
                      const int* __restrict__ idx0,
                      const uint8_t* __restrict__ pk0,
                      const __nv_bfloat16* __restrict__ sc0,
                      const int* __restrict__ idx1,
                      const uint8_t* __restrict__ pk1,
                      const __nv_bfloat16* __restrict__ sc1,
                      const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out, int vec_w) {
  static_assert(C::NW == 1, "a stage is NW one-weight stages");
  static_assert(kW4MmaGroup % C::BN == 0, "a strip lies inside one tile");
  extern __shared__ __align__(16) unsigned char sparse_mma_smem[];
  constexpr int kStrips = kW4MmaGroup / C::BN;
  constexpr int kStage = NW * C::kStage;
  const int t0 = blockIdx.x * C::BM;
  const int ti = blockIdx.y / kStrips, c0 = (blockIdx.y % kStrips) * C::BN;
  const int o = tile_map != nullptr ? tile_map[ti] : ti;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int n_st = (n_kept + C::G - 1) / C::G;

  // the tile's kept-block indices of every weight, after the ring
  int* sidx = reinterpret_cast<int*>(sparse_mma_smem + C::STAGES * kStage);
  const size_t blk0 = (size_t)o * n_kept;
  for (int i = threadIdx.x; i < NW * n_kept; i += C::kThreads)
    sidx[i] = (i < n_kept ? idx0 : idx1)[blk0 + i % n_kept];
  const uint8_t* pks[2] = {pk0 + blk0 * (kW4MmaGroup / 2) * kW4MmaGroup,
                           NW == 2 ? pk1 + blk0 * (kW4MmaGroup / 2) *
                                               kW4MmaGroup
                                   : nullptr};
  const __nv_bfloat16* scs[2] = {
      sc0 + blk0 * kW4MmaGroup,
      NW == 2 ? sc1 + blk0 * kW4MmaGroup : nullptr};
  __syncthreads();

  float acc[NW][1][C::kFragM][C::kNT][4];
#pragma unroll
  for (int wi = 0; wi < NW; ++wi)
#pragma unroll
    for (int i = 0; i < C::kFragM; ++i)
#pragma unroll
      for (int j = 0; j < C::kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[wi][0][i][j][e] = 0.0f;

  const auto load = [&](int st, int g0) {
    unsigned char* stage = sparse_mma_smem + (st % C::STAGES) * kStage;
#pragma unroll
    for (int wi = 0; wi < NW; ++wi)
      sparse_mma_load<C>(stage + wi * C::kStage, x, sidx + wi * n_kept,
                         pks[wi], scs[wi], n_tok, in_f, n_kept, t0, c0, g0,
                         vec_w);
  };
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < n_st) load(s, s * C::G);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_st; ++kt) {
    cp_async_wait<C::STAGES - 2>();    // stage kt has landed
    __syncthreads();                   // ... for every thread; and stage
                                       // kt - 1 is free again
    const int nk = kt + C::STAGES - 1;
    if (nk < n_st) load(nk, nk * C::G);
    cp_async_commit();
    const unsigned char* stage =
        sparse_mma_smem + (kt % C::STAGES) * kStage;
#pragma unroll
    for (int wi = 0; wi < NW; ++wi)
      w4_mma_stage<C>(stage + wi * C::kStage, kt * C::G, n_kept, wm, wn,
                      lane, acc[wi]);
  }
  cp_async_wait<0>();

  w4_mma_store<C, NW, EPI>(
      [&](int wi, int i, int j, int e) { return acc[wi][0][i][j][e]; }, bias,
      out, n_tok, out_f, t0, o * kW4MmaGroup + c0, wm, wn, lane);
}

template <class C, int NW, int EPI>
int launch_sparse_mma_cfg(const void* x, int n_tok, int in_f, int out_f,
                          int n_tiles, int n_kept, const void* tile_map,
                          const void* idx0, const void* pk0, const void* sc0,
                          const void* idx1, const void* pk1, const void* sc1,
                          const float* bias, void* out, int vec_w,
                          cudaStream_t stream) {
  const int smem = NW * C::kSmem + ((NW * n_kept * 4 + 15) / 16) * 16;
  auto kernel = sparse_mma_kernel<C, NW, EPI>;
  REPRO_SMEM_OPT_IN(kernel, smem);
  // token tiles fastest, so the blocks that share a weight strip run
  // together and read it from device memory once
  dim3 grid((n_tok + C::BM - 1) / C::BM,
            n_tiles * (kW4MmaGroup / C::BN));
  kernel<<<grid, C::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), n_tok, in_f, out_f, n_kept,
      static_cast<const int*>(tile_map), static_cast<const int*>(idx0),
      static_cast<const uint8_t*>(pk0),
      static_cast<const __nv_bfloat16*>(sc0), static_cast<const int*>(idx1),
      static_cast<const uint8_t*>(pk1),
      static_cast<const __nv_bfloat16*>(sc1), bias,
      static_cast<__nv_bfloat16*>(out), vec_w);
  return (int)cudaGetLastError();
}

// n_tiles output tiles are computed: tile_map[0..n_tiles) when tile_map is
// given, else tiles 0..n_tiles.  NW = 2: idx1/pk1/sc1 are the second
// weight's (up), else null.  x must be 16-byte aligned, the packed weights
// 4-byte and the scales 8-byte aligned (the wrappers see to it; 16-byte
// aligned weights take one cp.async a chunk).  The configuration follows
// the token count (and, for one weight, the grid it gives) here, and only
// here; the order of every sum does not.
template <int NW, int EPI>
int launch_sparse_mma(const void* x, int n_tok, int in_f, int out_f,
                      int n_tiles, int n_kept, const void* tile_map,
                      const void* idx0, const void* pk0, const void* sc0,
                      const void* idx1, const void* pk1, const void* sc1,
                      const float* bias, void* out, cudaStream_t stream) {
  const int align = w4_mma_alignment(x, kW4MmaGroup, pk0, sc0,
                                     NW == 2 ? pk1 : nullptr,
                                     NW == 2 ? sc1 : nullptr);
  if (align == 0) return (int)cudaErrorMisalignedAddress;
  const int vec_w = align - 1;
#define REPRO_SPARSE_MMA(CFG)                                                 \
  return launch_sparse_mma_cfg<CFG, NW, EPI>(                                 \
      x, n_tok, in_f, out_f, n_tiles, n_kept, tile_map, idx0, pk0, sc0, idx1, \
      pk1, sc1, bias, out, vec_w, stream)
  if (n_tok <= 16) REPRO_SPARSE_MMA(SparseMmaDecode);
  if (n_tok <= 128) REPRO_SPARSE_MMA(SparseMmaMid);
  if constexpr (NW == 1) {
    const long large_tiles =
        (long)((n_tok + SparseMmaLarge::BM - 1) / SparseMmaLarge::BM) *
        n_tiles;
    if (large_tiles >= kW4MmaSms) REPRO_SPARSE_MMA(SparseMmaLarge);
  }
  REPRO_SPARSE_MMA(SparseMmaWide);
#undef REPRO_SPARSE_MMA
}

}  // namespace repro
