// W4A16 FFN, first half, for Hopper (sm_90a):
//   gated:  h = act(x @ dequant(gate)) * (x @ dequant(up))   (swiglu, geglu)
//   gelu:   h = gelu_tanh(x @ dequant(up) + up_bias)
// cast to x's dtype.
//
// Replaces the gate/up/activation stage of
// src/repro/kernels/ffn_fused.py::ffn_fused_w4a16_pallas (quant variant,
// gated and ungated).  The TPU kernel casts each 128-wide hidden tile to x's
// dtype and contracts it at once against the matching 128-row group of the
// down projection; this port writes the (tokens, d_ff) hidden to device
// memory in x's dtype and the down projection runs through w4a16_matmul.cu
// (with the down bias as its f32 epilogue for gelu).  The arithmetic is the
// same (the hidden is rounded to x's dtype before the down contraction in
// both); the cost is one more launch and 2 * tokens * d_ff * sizeof(x)
// bytes, which the single-launch fusion of a later PR removes.
//
// Gate and up are accumulated in one pass over x (each x tile is staged
// once for both), with the per-group scale applied after each group's dot;
// the up bias (f32) is added to the f32 sum and silu (or tanh-gelu) applied
// to the f32 sums in the epilogue.
// What bounds it on the card: at decode the packed weights
// (d * f / 2 bytes + scales each); at prefill widths f32 FMAs on the CUDA
// cores.
#include "w4a16_tile.cuh"

REPRO_ERROR_STRING_FN

// gate_* are ignored for activation kEpiGeluBias (up alone); up_bias is
// read by it only (f32, may be null).
extern "C" int ffn_gate_up_launch(const void* x, const void* gate_packed,
                                  const void* gate_scales,
                                  const void* up_packed,
                                  const void* up_scales, const void* up_bias,
                                  void* hidden, int n_tok, int d, int f,
                                  int activation, int dtype, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ub = static_cast<const float*>(up_bias);
  const bool bf16 = dtype == kBF16;
#define REPRO_FFN_GATED(T, EPI)                                              \
  return launch_w4a16_tile<T, 2, EPI>(x, n_tok, d, f, gate_packed,          \
                                      gate_scales, up_packed, up_scales,    \
                                      nullptr, hidden, s)
  if (activation == kEpiSwiglu) {
    if (bf16) REPRO_FFN_GATED(__nv_bfloat16, kEpiSwiglu);
    REPRO_FFN_GATED(float, kEpiSwiglu);
  }
  if (activation == kEpiGeglu) {
    if (bf16) REPRO_FFN_GATED(__nv_bfloat16, kEpiGeglu);
    REPRO_FFN_GATED(float, kEpiGeglu);
  }
#undef REPRO_FFN_GATED
  if (activation == kEpiGeluBias) {
    if (bf16)
      return launch_w4a16_tile<__nv_bfloat16, 1, kEpiGeluBias>(
          x, n_tok, d, f, up_packed, up_scales, nullptr, nullptr, ub, hidden,
          s);
    return launch_w4a16_tile<float, 1, kEpiGeluBias>(
        x, n_tok, d, f, up_packed, up_scales, nullptr, nullptr, ub, hidden, s);
  }
  return (int)cudaErrorInvalidValue;
}
