// Gated W4A16 FFN, first half, for Hopper (sm_90a):
//   h = act(x @ dequant(gate)) * (x @ dequant(up)),  cast to x's dtype.
//
// Replaces the gate/up/activation stage of
// src/repro/kernels/ffn_fused.py::ffn_fused_w4a16_pallas (quant variant).
// The TPU kernel casts each 128-wide hidden tile to x's dtype and contracts
// it at once against the matching 128-row group of the down projection; this
// port writes the (tokens, d_ff) hidden to device memory in x's dtype and
// the down projection runs through w4a16_matmul.cu.  The arithmetic is the
// same (the hidden is rounded to x's dtype before the down contraction in
// both); the cost is one more launch and 2 * tokens * d_ff * sizeof(x)
// bytes, which the single-launch fusion of a later PR removes.
//
// Gate and up are accumulated in one pass over x (each x tile is staged
// once for both), with the per-group scale applied after each group's dot
// and silu (or tanh-gelu) applied to the f32 sums in the epilogue.
// What bounds it on the card: at decode the two packed weights
// (2 * d * f / 2 bytes + scales); at prefill widths f32 FMAs on the CUDA
// cores.
#include "w4a16_tile.cuh"

REPRO_ERROR_STRING_FN

extern "C" int ffn_gate_up_launch(const void* x, const void* gate_packed,
                                  const void* gate_scales,
                                  const void* up_packed,
                                  const void* up_scales, void* hidden,
                                  int n_tok, int d, int f, int activation,
                                  int dtype, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (activation == kEpiSwiglu) {
    if (dtype == kBF16)
      return launch_w4a16_tile<__nv_bfloat16, 2, kEpiSwiglu>(
          x, n_tok, d, f, gate_packed, gate_scales, up_packed, up_scales,
          hidden, s);
    return launch_w4a16_tile<float, 2, kEpiSwiglu>(
        x, n_tok, d, f, gate_packed, gate_scales, up_packed, up_scales,
        hidden, s);
  }
  if (activation == kEpiGeglu) {
    if (dtype == kBF16)
      return launch_w4a16_tile<__nv_bfloat16, 2, kEpiGeglu>(
          x, n_tok, d, f, gate_packed, gate_scales, up_packed, up_scales,
          hidden, s);
    return launch_w4a16_tile<float, 2, kEpiGeglu>(
        x, n_tok, d, f, gate_packed, gate_scales, up_packed, up_scales,
        hidden, s);
  }
  return (int)cudaErrorInvalidValue;
}
