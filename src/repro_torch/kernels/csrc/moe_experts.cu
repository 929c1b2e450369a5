// The experts of an MoE layer, grouped, for Hopper (sm_90a):
//   gate/up: hidden[o_e + r] = act(x[rows[o_e + r]] @ dequant(gate_e))
//                              * (x[rows[o_e + r]] @ dequant(up_e))
//   down:    y[o_e + r]      = hidden[o_e + r] @ dequant(down_e)
// for every expert e and each of its counts[e] kept rows r (o_e =
// offsets[e]; moe_route.cu lays the rows out), in x's dtype (bf16).
//
// Replaces the expert FFN of src/repro/models/moe.py:125-147, which runs
// ops.ffn_w4a16 (kernel 2, src/repro/kernels/ffn_fused.py:215, and kernel
// 1, src/repro/kernels/w4a16_matmul.py:78) under a jax.vmap over (batch
// row, expert) on a zero-padded capacity buffer of every expert, and on
// the TPU sends a group other than 128 rows to the blocked XLA twin
// (ffn_fused.py:697-708).  Here the expert is a grid axis: block (row tile,
// column strip, expert) runs kernel 2's two-weight tile (gate/up) or kernel
// 1's one-weight tile (down) of w4a16_mma_tile.cuh on that expert's
// weights, the gate/up tile gathering its x rows by index (rows[]), so
// each expert's weights stream once a tick for all the rows that chose it,
// not once per batch row; a row tile past the expert's count exits at once,
// so an expert with no rows does no work and reads no weight.  The quant
// group (32, 64 or 128 rows: granite-moe-3b-a800m's experts take 32,
// mixtral-8x22b's 128) is a template parameter.
//
// Batch invariance: each output is one warp's fragments over the whole
// contraction in the tile's fixed order (one fragment per group in step
// order, scaled and added in group order), the order of kernels 1 and 2,
// fixed by (in_f, group) alone.  How many rows share an expert, which tile
// configuration the launcher picks (by the host's bound on an expert's
// rows), the batch and the chunk width move no bit of a row.
//
// What bounds it: at decode the packed bytes of the experts that have
// rows (3 d d_ff / 2 bytes and the scales an expert, read once); with
// many rows an expert, the tensor cores as kernels 1 and 2.
#include "w4a16_mma_tile.cuh"

REPRO_ERROR_STRING_FN

namespace repro {

// Block (row tile, column strip, expert): rows t0.. of expert e's
// counts[e] (GATHER: x rows rows[offsets[e] + t]; else x rows offsets[e] +
// t), written to out rows offsets[e] + t.  pk/sc (and pk2/sc2) stack the
// experts: (E, in/2, out) and (E, in/GS, out).
template <class C, int EPI, bool GATHER>
__global__ void __launch_bounds__(C::kThreads)
    moe_grouped_kernel(const __nv_bfloat16* __restrict__ x,
                       const int* __restrict__ rows,
                       const int* __restrict__ counts,
                       const int* __restrict__ offsets, int in_f, int out_f,
                       const uint8_t* __restrict__ pk,
                       const __nv_bfloat16* __restrict__ sc,
                       const uint8_t* __restrict__ pk2,
                       const __nv_bfloat16* __restrict__ sc2,
                       __nv_bfloat16* __restrict__ out, int vec_w) {
  extern __shared__ __align__(16) unsigned char moe_smem[];
  __shared__ int xr[C::BM];
  const int e = blockIdx.z;
  const int cnt = counts[e];
  const int t0 = blockIdx.x * C::BM, n0 = blockIdx.y * C::BN;
  if (t0 >= cnt) return;
  const int off = offsets[e];
  for (int r = threadIdx.x; r < C::BM; r += C::kThreads) {
    const int t = t0 + r;
    xr[r] = t < cnt ? (GATHER ? rows[off + t] : off + t) : 0;
  }
  __syncthreads();
  const size_t pk_e = (size_t)e * (in_f / 2) * out_f;
  const size_t sc_e = (size_t)e * (in_f / C::GS) * out_f;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / C::WN, wn = warp % C::WN;

  float acc[C::NW][C::kFragM][C::kNT][4];
  w4_mma_mainloop<C>(moe_smem, x, cnt, in_f, out_f, pk + pk_e, sc + sc_e,
                     C::NW == 2 ? pk2 + pk_e : nullptr,
                     C::NW == 2 ? sc2 + sc_e : nullptr, t0, n0, vec_w != 0,
                     xr, wm, wn, lane, acc);

  w4_mma_store<C, C::NW, EPI>(
      [&](int wi, int i, int j, int q) { return acc[wi][i][j][q]; }, nullptr,
      out + (size_t)off * out_f, cnt, out_f, t0, n0, wm, wn, lane);
}

// max_rows: the host's bound on an expert's count (the grid's row tiles).
template <class C, int EPI, bool GATHER>
int launch_moe_cfg(const void* x, const int* rows, const int* counts,
                   const int* offsets, int n_experts, int max_rows, int in_f,
                   int out_f, const void* pk, const void* sc, const void* pk2,
                   const void* sc2, void* out, int vec_w,
                   cudaStream_t stream) {
  auto kernel = moe_grouped_kernel<C, EPI, GATHER>;
  REPRO_SMEM_OPT_IN(kernel, C::kSmem);
  dim3 grid((max_rows + C::BM - 1) / C::BM, (out_f + C::BN - 1) / C::BN,
            n_experts);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), rows, counts, offsets, in_f,
      out_f, static_cast<const uint8_t*>(pk),
      static_cast<const __nv_bfloat16*>(sc),
      static_cast<const uint8_t*>(pk2),
      static_cast<const __nv_bfloat16*>(sc2),
      static_cast<__nv_bfloat16*>(out), vec_w);
  return (int)cudaGetLastError();
}

// The configuration follows the host's bounds (max_rows; mean_rows = slots
// / experts), never a row's sum order: kernel 2's gated configurations
// for gate/up, kernel 1's one-weight ones for down.
template <int GS>
int launch_moe_gate_up(const void* x, const int* rows, const int* counts,
                       const int* offsets, int n_experts, int max_rows,
                       int mean_rows, int d, int f, const void* gpk,
                       const void* gsc, const void* upk, const void* usc,
                       void* hidden, int vec_w, cudaStream_t s) {
#define REPRO_MOE(CFG)                                                      \
  return launch_moe_cfg<CFG, kEpiSwiglu, true>(                             \
      x, rows, counts, offsets, n_experts, max_rows, d, f, gpk, gsc, upk,   \
      usc, hidden, vec_w, s)
  if (max_rows <= 16) REPRO_MOE(W4MmaGatedDecode<GS>);
  if (mean_rows <= 128) REPRO_MOE(W4MmaGatedMid<GS>);
  REPRO_MOE(W4MmaGatedWide<GS>);
#undef REPRO_MOE
}

template <int GS>
int launch_moe_down(const void* hidden, const int* counts,
                    const int* offsets, int n_experts, int max_rows,
                    int mean_rows, int f, int d, const void* pk,
                    const void* sc, void* y, int vec_w, cudaStream_t s) {
#define REPRO_MOE(CFG)                                                      \
  return launch_moe_cfg<CFG, kEpiNone, false>(                              \
      hidden, nullptr, counts, offsets, n_experts, max_rows, f, d, pk, sc,  \
      nullptr, nullptr, y, vec_w, s)
  if (max_rows <= 16) REPRO_MOE(W4MmaDecode<GS>);
  if (mean_rows <= 128) REPRO_MOE(W4MmaMid<GS>);
  REPRO_MOE(W4MmaWide<GS>);
#undef REPRO_MOE
}

}  // namespace repro

// n_slots: rows of the hidden (tokens x top_k).  activation: 1 = swiglu
// (the wrapper refuses others).  Weights 16-byte aligned and out % 16 ==
// 0 take one cp.async a chunk (vec_w), else 4- and 8-byte copies.
extern "C" int moe_gate_up_launch(const void* x, const int* rows,
                                  const int* counts, const int* offsets,
                                  const void* gate_packed,
                                  const void* gate_scales,
                                  const void* up_packed,
                                  const void* up_scales, void* hidden,
                                  int n_experts, int max_rows, int n_slots,
                                  int d, int f, int group, int activation,
                                  void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (activation != kEpiSwiglu) return (int)cudaErrorInvalidValue;
  const int align = w4_mma_alignment(x, f, gate_packed, gate_scales,
                                     up_packed, up_scales);
  if (align == 0) return (int)cudaErrorMisalignedAddress;
  const int mean_rows = (n_slots + n_experts - 1) / n_experts;
#define REPRO_MOE_GS(GS)                                                    \
  return launch_moe_gate_up<GS>(x, rows, counts, offsets, n_experts,        \
                                max_rows, mean_rows, d, f, gate_packed,     \
                                gate_scales, up_packed, up_scales, hidden,  \
                                align - 1, s)
  if (group == 32) REPRO_MOE_GS(32);
  if (group == 64) REPRO_MOE_GS(64);
  if (group == 128) REPRO_MOE_GS(128);
#undef REPRO_MOE_GS
  return (int)cudaErrorInvalidValue;
}

extern "C" int moe_down_launch(const void* hidden, const int* counts,
                               const int* offsets, const void* packed,
                               const void* scales, void* y, int n_experts,
                               int max_rows, int n_slots, int f, int d,
                               int group, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int align =
      w4_mma_alignment(hidden, d, packed, scales, nullptr, nullptr);
  if (align == 0) return (int)cudaErrorMisalignedAddress;
  const int mean_rows = (n_slots + n_experts - 1) / n_experts;
#define REPRO_MOE_GS(GS)                                                    \
  return launch_moe_down<GS>(hidden, counts, offsets, n_experts, max_rows,  \
                             mean_rows, f, d, packed, scales, y, align - 1, \
                             s)
  if (group == 32) REPRO_MOE_GS(32);
  if (group == 64) REPRO_MOE_GS(64);
  if (group == 128) REPRO_MOE_GS(128);
#undef REPRO_MOE_GS
  return (int)cudaErrorInvalidValue;
}
