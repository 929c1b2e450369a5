// Log-scale block-sparse W4A16 matmul for Hopper (sm_90a):
//   out = x @ sparse_dequant(st), with an optional f32 bias added to the f32
//   sum before the cast.
//
// Replaces src/repro/kernels/sparse_w4a16.py::sparse_w4a16_matmul_pallas
// (EdgeLLM §III-C).  Same contract: for each 128-wide output tile the S kept
// 128-row blocks listed in block_idx are contracted against the activation
// columns they name, each block's f32 partial sum is multiplied by its
// per-column scale, and the sum is cast to x's dtype.  The TPU kernel
// gathers the activation block in its DMA index map from scalar-prefetched
// indices; here a block reads its output tile's indices itself and gathers
// the x columns into its ring of stages.  The bias is a sparse down
// projection's (the ungated gelu FFN's down_bias), which the reference's
// fused kernel adds in f32 before its cast
// (src/repro/kernels/ffn_fused.py:443-448).
//
// bfloat16 runs on the tensor cores (sparse_mma_tile.cuh: mma.sync m16n8k16
// with the gathered x as A and the kept blocks' nibbles dequantized in
// registers as B, a tile configuration picked by T, every sum's order fixed
// by (S, block_idx); its note says what bounds each regime).  float32 keeps
// the CUDA-core tile of sparse_tile.cuh (f32 FMAs, 8 tokens x 128 columns a
// block).  out_f % 128 == 0 is a precondition of the sparse layout (checked
// by the wrapper), so no output edge is masked.
//
// -Xptxas -v (sm_90a): the bf16 tile's instantiations are listed in
// sparse_mma_tile.cuh; the f32 tile takes 128 registers and 32 KB of
// dynamic shared memory, no spills, with and without the bias.
#include "sparse_mma_tile.cuh"
#include "sparse_tile.cuh"

REPRO_ERROR_STRING_FN

extern "C" int sparse_w4a16_matmul_launch(const void* x, const void* block_idx,
                                          const void* packed,
                                          const void* scales,
                                          const void* bias, void* out,
                                          int n_tok, int in_f, int out_f,
                                          int n_kept, int dtype,
                                          void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const int n_tiles = out_f / kCols;
  if (dtype == kBF16) {
    if (b != nullptr)
      return launch_sparse_mma<1, kEpiBias>(
          x, n_tok, in_f, out_f, n_tiles, n_kept, nullptr, block_idx, packed,
          scales, nullptr, nullptr, nullptr, b, out, s);
    return launch_sparse_mma<1, kEpiNone>(
        x, n_tok, in_f, out_f, n_tiles, n_kept, nullptr, block_idx, packed,
        scales, nullptr, nullptr, nullptr, nullptr, out, s);
  }
  if (b != nullptr)
    return launch_sparse_tile<float, 1, kEpiBias>(
        x, n_tok, in_f, out_f, n_tiles, n_kept, nullptr, block_idx, packed,
        scales, nullptr, nullptr, nullptr, b, out, s);
  return launch_sparse_tile<float, 1, kEpiNone>(
      x, n_tok, in_f, out_f, n_tiles, n_kept, nullptr, block_idx, packed,
      scales, nullptr, nullptr, nullptr, nullptr, out, s);
}
