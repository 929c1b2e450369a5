// Fused FFN with 16-bit weights, first half, for Hopper (sm_90a):
//   gated:  h = act(x @ gate) * (x @ up)          (swiglu, geglu)
//   gelu:   h = gelu_tanh(x @ up + up_bias)
// f32 sums, the activation on them, h cast once to x's dtype.
//
// Replaces src/repro/kernels/ffn_fused.py::ffn_fused_dense_pallas (TPU
// kernel 6, the fp variant of the fused FFN, :300), as two launches:
//   1. this kernel: gate and up (or up alone) accumulated in f32 in one
//      pass over x, the up bias added in f32, the activation on the f32
//      sums, the (tokens, d_ff) hidden written in x's dtype;
//   2. dense_matmul.cu: the down projection in f32 with the down bias as
//      its f32 epilogue, then the cast.
// The TPU kernel casts each 128-wide hidden tile to x's dtype and contracts
// it at once against the matching 128 rows of down, so the split changes
// no arithmetic; it costs one launch and the hidden's round trip through
// device memory (2 * tokens * d_ff * sizeof(x) bytes), which a single-
// launch fusion of a later PR removes.  The reference's contraction runs
// per 128-row group in group order; here the groups are dealt to 8 warps
// and added in a fixed order (dense_tile.cuh), so the sums agree to f32
// rounding and each row is bitwise independent of the others.
//
// What bounds it on the card: at decode the weight bytes (2 * d * f each
// of gate and up in bf16); at prefill widths f32 FMAs on the CUDA cores.
#include "dense_tile.cuh"

REPRO_ERROR_STRING_FN

// gate is ignored for activation kEpiGeluBias (up alone); up_bias is read
// by it only (f32, may be null).
extern "C" int ffn_dense_gate_up_launch(const void* x, const void* gate,
                                        const void* up, const void* up_bias,
                                        void* hidden, int n_tok, int d, int f,
                                        int activation, int dtype,
                                        void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ub = static_cast<const float*>(up_bias);
  const bool bf16 = dtype == kBF16;
#define REPRO_FFN_DENSE(T, NW, EPI, W0, W1)                                  \
  return launch_dense_tile<T, NW, EPI>(x, n_tok, d, f, W0, W1, ub, hidden, s)
  if (activation == kEpiSwiglu) {
    if (bf16) REPRO_FFN_DENSE(__nv_bfloat16, 2, kEpiSwiglu, gate, up);
    REPRO_FFN_DENSE(float, 2, kEpiSwiglu, gate, up);
  }
  if (activation == kEpiGeglu) {
    if (bf16) REPRO_FFN_DENSE(__nv_bfloat16, 2, kEpiGeglu, gate, up);
    REPRO_FFN_DENSE(float, 2, kEpiGeglu, gate, up);
  }
  if (activation == kEpiGeluBias) {
    if (bf16) REPRO_FFN_DENSE(__nv_bfloat16, 1, kEpiGeluBias, up, nullptr);
    REPRO_FFN_DENSE(float, 1, kEpiGeluBias, up, nullptr);
  }
#undef REPRO_FFN_DENSE
  return (int)cudaErrorInvalidValue;
}
