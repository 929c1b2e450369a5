// Log-scale block-sparse W4A16 matmul for Hopper (sm_90a):
//   out = x @ sparse_dequant(st).
//
// Replaces src/repro/kernels/sparse_w4a16.py::sparse_w4a16_matmul_pallas
// (EdgeLLM §III-C).  Same contract: for each 128-wide output tile the S kept
// 128-row blocks listed in block_idx are contracted against the activation
// columns they name, each block's f32 partial sum is multiplied by its
// per-column scale, and the sum is cast to x's dtype.  The TPU kernel
// gathers the activation block in its DMA index map from scalar-prefetched
// indices; here each warp reads the index and stages the gathered x
// sub-tile itself (sparse_tile.cuh).
//
// What bounds it on the card: at decode (a few tokens) the kept weight
// bytes, S * 128 * 128 / 2 packed plus S * 128 * 2 of scales per output
// tile (half the dense matrix at density 0.5); each weight byte is read once
// per 8-token tile.  At prefill widths it is f32 FMAs on the CUDA cores, as
// for the dense kernel.  out_f % 128 == 0 is a precondition of the sparse
// layout (checked by the wrapper), so no output edge is masked.
#include "sparse_tile.cuh"

REPRO_ERROR_STRING_FN

extern "C" int sparse_w4a16_matmul_launch(const void* x, const void* block_idx,
                                          const void* packed,
                                          const void* scales, void* out,
                                          int n_tok, int in_f, int out_f,
                                          int n_kept, int dtype,
                                          void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = out_f / kCols;
  if (dtype == kBF16)
    return launch_sparse_tile<__nv_bfloat16, 1, kEpiNone>(
        x, n_tok, in_f, out_f, n_tiles, n_kept, nullptr, block_idx, packed,
        scales, nullptr, nullptr, nullptr, out, s);
  return launch_sparse_tile<float, 1, kEpiNone>(
      x, n_tok, in_f, out_f, n_tiles, n_kept, nullptr, block_idx, packed,
      scales, nullptr, nullptr, nullptr, out, s);
}
