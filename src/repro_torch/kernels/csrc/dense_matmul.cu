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
// null here).  Ragged token and output edges are masked in the kernel, so
// qwen-7b's 151936-wide 16-bit lm_head runs here.
//
// What bounds it on the card: at decode (a few tokens) the weight bytes,
// 2 * in * out in bf16, each read once per 8-token tile: a GEMV; at prefill
// widths f32 FMAs on the CUDA cores (no tensor cores in this first
// version).  The tile is in dense_tile.cuh.
#include "dense_tile.cuh"

REPRO_ERROR_STRING_FN

extern "C" int dense_matmul_launch(const void* x, const void* w,
                                   const void* bias, void* out, int n_tok,
                                   int in_f, int out_f, int dtype,
                                   void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (bias != nullptr) {
    if (dtype == kBF16)
      return launch_dense_tile<__nv_bfloat16, 1, kEpiBias>(
          x, n_tok, in_f, out_f, w, nullptr, b, out, s);
    return launch_dense_tile<float, 1, kEpiBias>(x, n_tok, in_f, out_f, w,
                                                 nullptr, b, out, s);
  }
  if (dtype == kBF16)
    return launch_dense_tile<__nv_bfloat16, 1, kEpiNone>(
        x, n_tok, in_f, out_f, w, nullptr, nullptr, out, s);
  return launch_dense_tile<float, 1, kEpiNone>(x, n_tok, in_f, out_f, w,
                                               nullptr, nullptr, out, s);
}
