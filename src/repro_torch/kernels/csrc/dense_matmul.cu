// 16-bit-weight matmul with a fixed reduction order, for Hopper (sm_90a):
//   out = x @ w (+ bias),  an f32 sum per output, cast once to x's dtype.
//
// Not a port of a TPU kernel: the reference leaves this product to XLA
// (src/repro/models/layers.py:43-61, `lax.dot_general` in x's dtype, f32
// accumulation).  It is a kernel here for the reason rmsnorm.cu is: cuBLAS
// may choose its split of the contraction from the row count, and then a
// row's result would depend on the batch and chunk width, which breaks the
// engine's bitwise mixed == sequential and oracle parity.  It also takes
// the down stage of kernel 6 (ffn_fused_dense.cu), whose f32 down bias is
// added to the f32 sum before the cast, as the reference's fused kernel
// does; `models/layers.linear` adds its bias after the cast instead (bias
// null here).  Ragged token, contraction and output edges are masked in
// the kernel, so qwen-7b's 151936-wide 16-bit lm_head runs here.  A tied
// LM head (x @ embed.T) reads the (V, d) embedding in place as the
// transposed weight (w_trans), at any V (granite-moe-3b-a800m's 49155),
// with the same sum order: no transposed copy of 151 MB a tick.
//
// bfloat16 runs on the tensor cores (dense_mma_tile.cuh): mma.sync
// m16n8k16 with f32 accumulation, each output one warp's fragment summed
// over the whole contraction in increasing k16 steps, so the order of
// every sum is fixed by in_features alone while the tile follows the token
// count.  What bounds it on the card: at decode (T <= 16) and up to
// T = 128 the weight bytes, 2 * in * out, read once; above, the tensor
// cores fed by mma.sync.  float32 keeps the CUDA-core tile
// (dense_tile.cuh): f32 FMAs, no TF32.  -Xptxas -v: the bf16 tiles 56-126
// registers by configuration (dense_mma_tile.cuh lists them), the f32 tile
// 127; no spills.
#include "dense_mma_tile.cuh"
#include "dense_tile.cuh"

REPRO_ERROR_STRING_FN

// w_trans: w is (out_f, in_f) row-major, read as its transpose in place
// (a tied embedding as the LM head; bf16, no bias: the wrapper checks),
// any out_f.
extern "C" int dense_matmul_launch(const void* x, const void* w,
                                   const void* bias, void* out, int n_tok,
                                   int in_f, int out_f, int dtype,
                                   int w_trans, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (w_trans) {
    if (dtype != kBF16 || bias != nullptr) return (int)cudaErrorInvalidValue;
    return launch_dense_mma<1, kEpiNone, true>(x, n_tok, in_f, out_f, w,
                                               nullptr, nullptr, out, s);
  }
  if (bias != nullptr) {
    if (dtype == kBF16)
      return launch_dense_mma<1, kEpiBias>(x, n_tok, in_f, out_f, w, nullptr,
                                           b, out, s);
    return launch_dense_tile<1, kEpiBias>(x, n_tok, in_f, out_f, w, nullptr, b,
                                          out, s);
  }
  if (dtype == kBF16)
    return launch_dense_mma<1, kEpiNone>(x, n_tok, in_f, out_f, w, nullptr,
                                         nullptr, out, s);
  return launch_dense_tile<1, kEpiNone>(x, n_tok, in_f, out_f, w, nullptr,
                                        nullptr, out, s);
}
