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
// launch fusion of a later PR removes.  The reference sums each output over
// 128-row groups in group order; here bfloat16 runs on the tensor cores
// (dense_mma_tile.cuh: mma.sync m16n8k16, f32 accumulation, gate and up
// fragments of one output in the same lane, each summed over the whole
// contraction in increasing k16 steps by one warp), float32 on the CUDA
// cores (dense_tile.cuh), so the sums agree to f32 rounding and each row is
// bitwise independent of the others and of the tile the token count picks.
//
// What bounds it on the card: at decode and up to T = 128 the weight bytes
// (2 * d * f each of gate and up in bf16); above, the tensor cores.
// -Xptxas -v: gate and up together 64-118 registers by bf16 configuration
// (dense_mma_tile.cuh lists them), 183 in the f32 tile; up alone as
// dense_matmul's; no spills.
#include "dense_mma_tile.cuh"
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
#define REPRO_FFN_DENSE(NW, EPI, W0, W1)                                      \
  return bf16 ? launch_dense_mma<NW, EPI>(x, n_tok, d, f, W0, W1, ub, hidden, \
                                          s)                                  \
              : launch_dense_tile<NW, EPI>(x, n_tok, d, f, W0, W1, ub, hidden, \
                                           s)
  if (activation == kEpiSwiglu) REPRO_FFN_DENSE(2, kEpiSwiglu, gate, up);
  if (activation == kEpiGeglu) REPRO_FFN_DENSE(2, kEpiGeglu, gate, up);
  if (activation == kEpiGeluBias)
    REPRO_FFN_DENSE(1, kEpiGeluBias, up, nullptr);
#undef REPRO_FFN_DENSE
  return (int)cudaErrorInvalidValue;
}
