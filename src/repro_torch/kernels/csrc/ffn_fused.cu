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
// bfloat16 runs on the tensor cores, on kernel 1's tile
// (w4a16_mma_tile.cuh): mma.sync m16n8k16 with x as A and the nibbles read
// in place and dequantized in registers into the B fragments, one warp's
// fragment per 128-row group summed from +0 over its k16 steps in order,
// scaled and added in group order.  Gated, gate and up stream against one
// staged x tile (two weights a ring stage, two accumulators and two
// per-group partials a warp, the A fragments shared); the activation is
// applied to the two f32 sums (common.cuh's epilogue) and the result cast
// once.  The ungated gelu is kernel 1's one-weight tile with the
// kEpiGeluBias epilogue (the f32 up bias added before the tanh-gelu).
// Each output's sum order is fixed by d alone, so the configuration (by
// token count) moves no bit.  Configurations (W4MmaGated*): T <= 16: 16 x 32
// blocks, 4 warps of 16 x 8, 4 stages of 2 groups; T <= 128: 64 x 64, 8
// warps of 32 x 16, 4 stages of 1 group; above: 64 x 128, 8 warps of
// 32 x 32, 3 stages.  (128 x 128, kernel 1's largest, would need 64 x 32
// warp tiles: four accumulators' worth of registers with two weights.)
//
// What bounds it: at decode the packed weights (2 * d * f / 2 bytes plus
// scales), read once; at prefill widths the tensor cores, the in-register
// dequantization and the shared memory that feeds them.
//
// -Xptxas -v (sm_90a), the gated configurations (the gelu variant: kernel
// 1's, listed in w4a16_mma_tile.cuh), the same for swiglu and geglu, no
// spills, one barrier; registers a thread and the ring's shared memory:
//   T <= 16, 16 x 32:  64 registers, 65 KB
//   T <= 128, 64 x 64: 128 registers, 97 KB
//   above, 64 x 128:   186 registers, 97.5 KB
// The f32 tile: 254 registers, no spills.
//
// float32 keeps the CUDA-core tile of w4a16_tile.cuh: gate and up
// accumulated in one pass over x with the per-group scale after each
// group's dot, f32 FMAs (a GEMV at decode).
#include "w4a16_mma_tile.cuh"
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
#define REPRO_FFN_GATED(EPI)                                                 \
  return bf16 ? launch_w4a16_mma_gated<EPI>(x, n_tok, d, f, gate_packed,     \
                                            gate_scales, up_packed,          \
                                            up_scales, hidden, s)            \
              : launch_w4a16_tile<float, 2, EPI>(                            \
                    x, n_tok, d, f, gate_packed, gate_scales, up_packed,     \
                    up_scales, nullptr, hidden, s)
  if (activation == kEpiSwiglu) REPRO_FFN_GATED(kEpiSwiglu);
  if (activation == kEpiGeglu) REPRO_FFN_GATED(kEpiGeglu);
#undef REPRO_FFN_GATED
  if (activation == kEpiGeluBias) {
    if (bf16)
      return launch_w4a16_mma<kEpiGeluBias>(x, n_tok, d, f, up_packed,
                                            up_scales, ub, hidden, s);
    return launch_w4a16_tile<float, 1, kEpiGeluBias>(
        x, n_tok, d, f, up_packed, up_scales, nullptr, nullptr, ub, hidden, s);
  }
  return (int)cudaErrorInvalidValue;
}
