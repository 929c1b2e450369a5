// W4A16 block-quantized matmul for Hopper (sm_90a): out = x @ dequant(qt),
// with an optional f32 bias added to the f32 sum before the cast.
//
// Replaces src/repro/kernels/w4a16_matmul.py::w4a16_matmul_pallas (the
// paper's FP16 x INT4 MODE-1 unit).  Same contract: int4 values are exact,
// each 128-row group's f32 partial sum is multiplied by that group's
// per-column scale, the sum is cast to x's dtype.  Unlike the TPU kernel it
// masks ragged token and output edges itself, so the 151936-wide lm_head of
// qwen-7b runs here (the reference requires out % 512 == 0).  The bias is
// the down projection's of the ungated gelu FFN, which the reference's
// fused kernel adds in f32 before its cast
// (src/repro/kernels/ffn_fused.py:182-187).
//
// What bounds it on the card: at decode (a few tokens) the packed weights,
// in*out/2 bytes plus in*out/64 bytes of scales; each weight byte is read
// once per 8-token tile and the kernel is a GEMV.  At prefill widths it is
// bounded by f32 FMAs on the CUDA cores (no tensor cores yet).  The design
// reads the nibble layout in place with 32-bit coalesced loads and keeps all
// partial sums in registers; the tile is in w4a16_tile.cuh.
#include "w4a16_tile.cuh"

REPRO_ERROR_STRING_FN

extern "C" int w4a16_matmul_launch(const void* x, const void* packed,
                                   const void* scales, const void* bias,
                                   void* out, int n_tok, int in_f, int out_f,
                                   int dtype, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (bias != nullptr) {
    if (dtype == kBF16)
      return launch_w4a16_tile<__nv_bfloat16, 1, kEpiBias>(
          x, n_tok, in_f, out_f, packed, scales, nullptr, nullptr, b, out, s);
    return launch_w4a16_tile<float, 1, kEpiBias>(
        x, n_tok, in_f, out_f, packed, scales, nullptr, nullptr, b, out, s);
  }
  if (dtype == kBF16)
    return launch_w4a16_tile<__nv_bfloat16, 1, kEpiNone>(
        x, n_tok, in_f, out_f, packed, scales, nullptr, nullptr, nullptr, out,
        s);
  return launch_w4a16_tile<float, 1, kEpiNone>(
      x, n_tok, in_f, out_f, packed, scales, nullptr, nullptr, nullptr, out,
      s);
}
