// Log-scale-sparse W4A16 FFN, first half, for Hopper (sm_90a):
//   gated:  h[:, tile] = act(x @ sparse_dequant(gate)) * (x @ sparse_dequant(up))
//           (swiglu, geglu)
//   gelu:   h[:, tile] = gelu_tanh(x @ sparse_dequant(up) + up_bias)
// cast to x's dtype, for the hidden tiles the down projection reads.
//
// Replaces the gate/up/activation stage of
// src/repro/kernels/ffn_fused.py::ffn_fused_sparse_pallas, gated and ungated
// (the up bias: :428).  gate and up are block-sparse with one kept-block
// list per 128-wide hidden tile (f-tile); each kept block's f32 partial sum
// is scaled after the dot, and the up bias (f32, the real hidden column's)
// and the activation act on the f32 sums.  The f-tiles computed are the
// ones the down projection keeps: with a tile_uniform sparse down, the
// f_tiles list is down's kept blocks (block_idx[0]); with a dense-quantized
// down, every f-tile.  A block computes exactly f-tile f_tiles[i], so the
// gate/up blocks of a dropped f-tile are never read and its hidden columns
// never written: the down projection (sparse_w4a16.cu with down's own
// block_idx, or w4a16_matmul.cu for a dense down, each with the down bias
// as its f32 epilogue for gelu) reads only the written ones.
//
// The TPU kernel contracts each hidden tile with down at once, inside the
// same launch; this port writes the hidden to device memory in x's dtype
// first.  The arithmetic is the same (the hidden is rounded to x's dtype
// before the down contraction in both); the cost is one more launch and
// 2 * tokens * kept_f * sizeof(x) bytes, which a single-launch fusion of a
// later PR removes.
//
// bfloat16 runs on the tensor cores (sparse_mma_tile.cuh): gated, gate and
// up each gather their own x columns into their half of every ring stage
// (two weights, NW = 2); gelu is the one-weight tile with the kEpiGeluBias
// epilogue.  float32 keeps the CUDA-core tile of sparse_tile.cuh.  What
// bounds it: at decode the kept gate/up weight bytes of the kept f-tiles;
// at prefill widths the tensor cores and the in-register dequantization
// (bf16), f32 FMAs (float32).
//
// -Xptxas -v (sm_90a): the bf16 tile's instantiations are listed in
// sparse_mma_tile.cuh; the f32 tile takes 243 registers and 64 KB of
// dynamic shared memory gated, 128 and 32 KB for gelu, no spills.
#include "sparse_mma_tile.cuh"
#include "sparse_tile.cuh"

REPRO_ERROR_STRING_FN

// gate_* are ignored for activation kEpiGeluBias (up alone); up_bias is
// read by it only (f32 over all d_ff columns, may be null).
extern "C" int ffn_fused_sparse_launch(
    const void* x, const void* f_tiles, int n_f_tiles, const void* gate_idx,
    const void* gate_packed, const void* gate_scales, const void* up_idx,
    const void* up_packed, const void* up_scales, const void* up_bias,
    void* hidden, int n_tok, int d, int f, int n_kept, int activation,
    int dtype, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ub = static_cast<const float*>(up_bias);
  const bool bf16 = dtype == kBF16;
#define REPRO_FFN_SPARSE(EPI)                                                 \
  return bf16 ? launch_sparse_mma<2, EPI>(x, n_tok, d, f, n_f_tiles, n_kept,  \
                                          f_tiles, gate_idx, gate_packed,     \
                                          gate_scales, up_idx, up_packed,     \
                                          up_scales, nullptr, hidden, s)      \
              : launch_sparse_tile<float, 2, EPI>(                            \
                    x, n_tok, d, f, n_f_tiles, n_kept, f_tiles, gate_idx,     \
                    gate_packed, gate_scales, up_idx, up_packed, up_scales,   \
                    nullptr, hidden, s)
  if (activation == kEpiSwiglu) REPRO_FFN_SPARSE(kEpiSwiglu);
  if (activation == kEpiGeglu) REPRO_FFN_SPARSE(kEpiGeglu);
#undef REPRO_FFN_SPARSE
  if (activation == kEpiGeluBias) {
    if (bf16)
      return launch_sparse_mma<1, kEpiGeluBias>(
          x, n_tok, d, f, n_f_tiles, n_kept, f_tiles, up_idx, up_packed,
          up_scales, nullptr, nullptr, nullptr, ub, hidden, s);
    return launch_sparse_tile<float, 1, kEpiGeluBias>(
        x, n_tok, d, f, n_f_tiles, n_kept, f_tiles, up_idx, up_packed,
        up_scales, nullptr, nullptr, nullptr, ub, hidden, s);
  }
  return (int)cudaErrorInvalidValue;
}
