// W4A16 block-quantized matmul for Hopper (sm_90a): out = x @ dequant(qt),
// with an optional f32 bias added to the f32 sum before the cast.
//
// Replaces src/repro/kernels/w4a16_matmul.py::w4a16_matmul_pallas (the
// paper's FP16 x INT4 MODE-1 unit).  Same contract: int4 values are exact,
// each quant group's f32 partial sum is multiplied by that group's
// per-column scale, the sum is cast to x's dtype.  The TPU kernel takes
// 128-row groups only; bf16 here also takes the MoE experts' 64 and 32.  Unlike the TPU kernel it
// masks ragged token and output edges itself, so the 151936-wide lm_head of
// qwen-7b runs here (the reference requires out % 512 == 0).  The bias is
// the down projection's of the ungated gelu FFN, which the reference's
// fused kernel adds in f32 before its cast
// (src/repro/kernels/ffn_fused.py:182-187).
//
// bfloat16 runs on the tensor cores (w4a16_mma_tile.cuh: mma.sync m16n8k16,
// the packed nibbles dequantized in registers, a tile configuration picked
// by T, every sum's order fixed by in_f; its note says what bounds each
// regime).  float32 keeps the CUDA-core tile of w4a16_tile.cuh, which
// reads the nibble layout in place with 32-bit coalesced loads and is a
// GEMV bounded by the packed bytes at decode and by f32 FMAs at prefill
// widths.
//
// -Xptxas -v (sm_90a): the bf16 tile's instantiations are listed in
// w4a16_mma_tile.cuh; the f32 tile takes 128 registers and 32 KB of
// dynamic shared memory, no spills, with and without the bias.
#include "w4a16_mma_tile.cuh"
#include "w4a16_tile.cuh"

REPRO_ERROR_STRING_FN

// group: the quant group's rows.  The bf16 tile takes 32, 64 and 128
// without the bias (the MoE experts' groups), 128 with it; float32 takes
// 128 (the wrapper refuses the rest).
extern "C" int w4a16_matmul_launch(const void* x, const void* packed,
                                   const void* scales, const void* bias,
                                   void* out, int n_tok, int in_f, int out_f,
                                   int group, int dtype, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (dtype == kBF16 && bias == nullptr) {
    if (group == 32)
      return launch_w4a16_mma<kEpiNone, 32>(x, n_tok, in_f, out_f, packed,
                                            scales, nullptr, out, s);
    if (group == 64)
      return launch_w4a16_mma<kEpiNone, 64>(x, n_tok, in_f, out_f, packed,
                                            scales, nullptr, out, s);
  }
  if (group != kW4MmaGroup) return (int)cudaErrorInvalidValue;
  if (dtype == kBF16)
    return bias != nullptr
               ? launch_w4a16_mma<kEpiBias>(x, n_tok, in_f, out_f, packed,
                                            scales, b, out, s)
               : launch_w4a16_mma<kEpiNone>(x, n_tok, in_f, out_f, packed,
                                            scales, nullptr, out, s);
  if (bias != nullptr)
    return launch_w4a16_tile<float, 1, kEpiBias>(
        x, n_tok, in_f, out_f, packed, scales, nullptr, nullptr, b, out, s);
  return launch_w4a16_tile<float, 1, kEpiNone>(
      x, n_tok, in_f, out_f, packed, scales, nullptr, nullptr, nullptr, out,
      s);
}
