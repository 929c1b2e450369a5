// Gated log-scale-sparse W4A16 FFN, first half, for Hopper (sm_90a):
//   h[:, tile] = act(x @ sparse_dequant(gate)) * (x @ sparse_dequant(up)),
//   cast to x's dtype, for the hidden tiles the down projection reads.
//
// Replaces the gate/up/activation stage of
// src/repro/kernels/ffn_fused.py::ffn_fused_sparse_pallas.  gate and up are
// block-sparse with one kept-block list per 128-wide hidden tile (f-tile);
// each kept block's f32 partial sum is scaled after the dot and silu (or
// tanh-gelu) runs on the f32 sums.  The f-tiles computed are the ones the
// down projection keeps: with a tile_uniform sparse down, the f_tiles list
// is down's kept blocks (block_idx[0]); with a dense-quantized down, every
// f-tile.  A block computes exactly f-tile f_tiles[blockIdx.x], so the
// gate/up blocks of a dropped f-tile are never read and its hidden columns
// never written: the down projection (sparse_w4a16.cu with down's own
// block_idx, or w4a16_matmul.cu for a dense down) reads only the written
// ones.
//
// The TPU kernel contracts each hidden tile with down at once, inside the
// same launch; this port writes the hidden to device memory in x's dtype
// first.  The arithmetic is the same (the hidden is rounded to x's dtype
// before the down contraction in both); the cost is one more launch and
// 2 * tokens * kept_f * sizeof(x) bytes, which a single-launch fusion of a
// later PR removes.  What bounds it on the card: at decode the kept gate/up
// weight bytes of the kept f-tiles; at prefill widths f32 FMAs.
#include "sparse_tile.cuh"

REPRO_ERROR_STRING_FN

extern "C" int ffn_fused_sparse_launch(
    const void* x, const void* f_tiles, int n_f_tiles, const void* gate_idx,
    const void* gate_packed, const void* gate_scales, const void* up_idx,
    const void* up_packed, const void* up_scales, void* hidden, int n_tok,
    int d, int f, int n_kept, int activation, int dtype, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FFN_SPARSE(T, EPI)                                              \
  return launch_sparse_tile<T, 2, EPI>(x, n_tok, d, f, n_f_tiles, n_kept,     \
                                       f_tiles, gate_idx, gate_packed,        \
                                       gate_scales, up_idx, up_packed,        \
                                       up_scales, hidden, s)
  if (activation == kEpiSwiglu) {
    if (dtype == kBF16) REPRO_FFN_SPARSE(__nv_bfloat16, kEpiSwiglu);
    REPRO_FFN_SPARSE(float, kEpiSwiglu);
  }
  if (activation == kEpiGeglu) {
    if (dtype == kBF16) REPRO_FFN_SPARSE(__nv_bfloat16, kEpiGeglu);
    REPRO_FFN_SPARSE(float, kEpiGeglu);
  }
#undef REPRO_FFN_SPARSE
  return (int)cudaErrorInvalidValue;
}
