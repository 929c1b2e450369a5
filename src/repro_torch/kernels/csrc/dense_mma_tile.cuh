// The bfloat16 tile of the 16-bit-weight kernels, on Hopper's tensor cores:
// dense_matmul.cu (one weight, optionally with an f32 bias) and
// ffn_fused_dense.cu (gate and up together, or up alone with its bias for
// the ungated gelu FFN, the activation in the epilogue).  Weights are plain
// row-major (in, out) bf16 matrices; the epilogues are common.cuh's.
// float32 inputs keep the CUDA-core tile of dense_tile.cuh.
//
// The product: mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, bf16
// operands, f32 accumulation, in every tile configuration.  A block streams
// its x rows and its weight columns through a ring of STAGES shared-memory
// stages filled by cp.async (16 bytes a thread; zero-filled past every
// edge), and a warp feeds its fragments with ldmatrix (.trans for the
// row-major weight, whose columns the B operand wants contiguous).  The
// 16-byte chunks of a stage row are XOR-swizzled so that the 8 rows one
// ldmatrix phase reads lie in 8 distinct bank groups.
//
// Batch invariance: every output element is one warp's accumulator
// fragment, which takes the whole contraction in increasing k16 steps
// (k = 0, 16, ..., 16 * (ceil(in_f / 16) - 1)), one mma each, starting
// from +0; the last step's lanes past in_f hold zeros in x and in the
// weight.  A step wholly past in_f is never issued, so the steps do not
// depend on the stage depth BK either.  There is no split of the
// contraction across warps or blocks and no atomic, and the epilogue is
// the same f32 arithmetic in every configuration.  The order of each sum
// is therefore fixed by in_f alone: the tile configuration may follow the
// token count (the launcher below picks it) without moving any row's bits,
// and a row's result is bitwise the same whatever the other rows and
// however many there are.  Rows past the last token are zero in the
// fragment and are not written.
//
// What bounds each regime on the H100 (3.35 TB/s, 989 TFLOP/s bf16 dense):
//   T <= 16  (decode): the weight bytes, 2 * in * out * NW, each read once:
//            a GEMV.  16 padded rows x 32 columns a block (128 blocks at
//            4096 outputs, 4748 at qwen-7b's 151936-wide lm_head), four
//            warps of one 16 x 8 fragment each, a 6-stage ring of 128 rows
//            (40 KB of weight in flight a block at NW = 1) to cover the
//            memory latency.  Without a split of the contraction a 4096-wide
//            output has only 128 column strips to stream in parallel.
//   T <= 128: still the weight bytes (under 128 operations a weight byte,
//            the card's ridge is ~295): 64 x 64 a block, eight warps of
//            16 x 32, a 4-stage ring of 64 rows.
//   T > 128: the tensor cores, and the shared-memory bandwidth and latency
//            that feed mma.sync: eight warps of 32 x 32 (64 x 128 a block,
//            a 3-stage ring of 64 rows), 64 x 32 each (128 x 128, when that
//            still gives every SM a block), and for two weights a 4-stage
//            ring of 32 rows (80 KB, so that two blocks share an SM).
// wgmma and TMA would reach more of the card; mixing wgmma with mma.sync
// between regimes would leave the invariant to the hardware, so they wait
// for a redesign of every regime at once.
//
// -Xptxas -v (sm_90a): no spills, no stack, one barrier in every
// instantiation; registers a thread and the dynamic shared memory of the
// ring, one weight / two:
//   decode 16 x 32:    56 / 72 registers,  72 / 120 KB
//   T <= 128, 64 x 64: 62 / 64 registers,  64 /  96 KB
//   64 x 128 (BK 64):  77 registers, 72 KB;  two weights (BK 32): 118, 80 KB
//   128 x 128:        126 registers, 96 KB
#pragma once

#include "mma.cuh"

namespace repro {

// BM x BN outputs a block, WM x WN warps of (BM / WM) x (BN / WN) outputs,
// a ring of STAGES stages of BK contraction rows.
template <int BM_, int BN_, int WM_, int WN_, int BK_, int STAGES_>
struct MmaTile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_, BK = BK_,
                       STAGES = STAGES_;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int kWarpM = BM / WM, kWarpN = BN / WN;
  static constexpr int kFragM = kWarpM / 16, kFragN = kWarpN / 8;
  static constexpr int RA = BK / 8, RB = BN / 8;   // 16-byte chunks a row
  static_assert(kWarpM % 16 == 0 && kWarpN % 8 == 0 && BK % 16 == 0, "");
  static_assert(kFragN == 1 || kFragN % 2 == 0, "");
  static_assert(RA >= 4 && RB >= 4, "swizzle needs 64-byte rows");
  template <int NW>
  __host__ __device__ static constexpr int stage_elems() {
    return BM * BK + NW * BK * BN;
  }
  template <int NW>
  __host__ __device__ static constexpr int smem_bytes() {
    return STAGES * stage_elems<NW>() * (int)sizeof(__nv_bfloat16);
  }
};

// The configurations the launcher picks from.  Each is a compromise across
// the served shapes that share it, not the best at every one.  On the H100,
// in tuning runs: a 64 x 32 tile with BK 128 beat Mid at T = 17 and 64 and
// lost at T = 128; a 64 x 64 tile beat Wide at starcoder2-7b's 4608-wide
// outputs at T = 256 and lost at 4096-wide ones; a two-warp decode tile
// beat Decode at qwen-7b's 151936-wide lm_head and lost at 4096 outputs.
using DenseMmaDecode = MmaTile<16, 32, 1, 4, 128, 6>;   // T <= 16
using DenseMmaMid = MmaTile<64, 64, 4, 2, 64, 4>;       // T <= 128
using DenseMmaGated = MmaTile<64, 128, 2, 4, 32, 4>;    // T > 128, NW = 2
using DenseMmaWide = MmaTile<64, 128, 2, 4, 64, 3>;     // T > 128, NW = 1
using DenseMmaLarge = MmaTile<128, 128, 2, 4, 64, 3>;   // ... >= 132 tiles
constexpr int kDenseMmaSms = 132;

// One ring stage: x rows t0.. (BM of them) and weight rows k0.. (BK) of
// columns n0.. (BN), zeros past n_tok, in_f and out_f.  vec_x: in_f % 8 == 0
// and x 16-byte aligned, so each x chunk is one cp.async (else a masked
// scalar path); vec_w: the same for out_f and the weights (else two 8-byte
// copies, which out_f % 4 == 0 and the wrapper's 4-element alignment
// allow).  Both paths fill the stage with the same bits.
template <class C, int NW>
__device__ __forceinline__ void dense_mma_load(
    __nv_bfloat16* stage, const __nv_bfloat16* __restrict__ x,
    const __nv_bfloat16* __restrict__ w0, const __nv_bfloat16* __restrict__ w1,
    int n_tok, int in_f, int out_f, int t0, int n0, int k0, bool vec_x,
    bool vec_w) {
  constexpr int kA = C::BM * C::RA, kB = C::BK * C::RB;
#pragma unroll
  for (int j = 0; j < (kA + C::kThreads - 1) / C::kThreads; ++j) {
    const int i = threadIdx.x + j * C::kThreads;
    if (kA % C::kThreads != 0 && i >= kA) break;
    const int r = i / C::RA, c = i % C::RA;
    __nv_bfloat16* dst = stage + r * C::BK + swz<C::RA>(r, c) * 8;
    const int t = t0 + r, k = k0 + c * 8;
    if (vec_x) {
      const bool ok = t < n_tok && k < in_f;
      cp_async16(dst, ok ? x + (size_t)t * in_f + k : x, ok ? 16 : 0);
    } else {
      const unsigned short* xr =
          reinterpret_cast<const unsigned short*>(x) + (size_t)t * in_f;
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ka = k + 2 * e;
        const uint32_t lo = t < n_tok && ka < in_f ? xr[ka] : 0u;
        const uint32_t hi = t < n_tok && ka + 1 < in_f ? xr[ka + 1] : 0u;
        v[e] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const __nv_bfloat16* wg = w == 0 ? w0 : w1;
    __nv_bfloat16* sb = stage + C::BM * C::BK + w * C::BK * C::BN;
#pragma unroll
    for (int j = 0; j < (kB + C::kThreads - 1) / C::kThreads; ++j) {
      const int i = threadIdx.x + j * C::kThreads;
      if (kB % C::kThreads != 0 && i >= kB) break;
      const int r = i / C::RB, c = i % C::RB;
      __nv_bfloat16* dst = sb + r * C::BN + swz<C::RB>(r, c) * 8;
      const int k = k0 + r, n = n0 + c * 8;
      const __nv_bfloat16* src = wg + (size_t)k * out_f + n;
      if (vec_w) {
        const bool ok = k < in_f && n < out_f;
        cp_async16(dst, ok ? src : wg, ok ? 16 : 0);
      } else {
        const bool ok0 = k < in_f && n < out_f;
        const bool ok1 = k < in_f && n + 4 < out_f;
        cp_async8(dst, ok0 ? src : wg, ok0 ? 8 : 0);
        cp_async8(dst + 4, ok1 ? src + 4 : wg, ok1 ? 8 : 0);
      }
    }
  }
}

// The k16 steps of one stage, in increasing k, for this warp's fragments.
template <class C, int NW>
__device__ __forceinline__ void dense_mma_stage(
    const __nv_bfloat16* stage, int k0, int in_f, int wm, int wn, int lane,
    float (&acc)[NW][C::kFragM][C::kFragN][4]) {
#pragma unroll
  for (int ks = 0; ks < C::BK / 16; ++ks) {
    if (k0 + ks * 16 >= in_f) break;   // past in_f: in every configuration
    uint32_t a[C::kFragM][4];
#pragma unroll
    for (int i = 0; i < C::kFragM; ++i) {
      const int r = wm * C::kWarpM + i * 16 + (lane & 15);
      const int c = ks * 2 + (lane >> 4);
      ldsm_x4(a[i], stage + r * C::BK + swz<C::RA>(r, c) * 8);
    }
    // the weight's 8 x 8 matrices: lanes 0-7 k rows 0-7, 8-15 rows 8-15,
    // 16-31 the same of the next 8 columns (x4)
    const int r = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const __nv_bfloat16* sb = stage + C::BM * C::BK + w * C::BK * C::BN;
      uint32_t b[C::kFragN][2];
      if constexpr (C::kFragN == 1) {
        uint32_t t2[2];
        ldsm_x2_trans(t2, sb + r * C::BN +
                              swz<C::RB>(r, wn * C::kWarpN / 8) * 8);
        b[0][0] = t2[0];
        b[0][1] = t2[1];
      } else {
#pragma unroll
        for (int j = 0; j < C::kFragN / 2; ++j) {
          const int c = wn * C::kWarpN / 8 + 2 * j + (lane >> 4);
          uint32_t t4[4];
          ldsm_x4_trans(t4, sb + r * C::BN + swz<C::RB>(r, c) * 8);
          b[2 * j][0] = t4[0];
          b[2 * j][1] = t4[1];
          b[2 * j + 1][0] = t4[2];
          b[2 * j + 1][1] = t4[3];
        }
      }
#pragma unroll
      for (int i = 0; i < C::kFragM; ++i)
#pragma unroll
        for (int j = 0; j < C::kFragN; ++j)
          mma_bf16(acc[w][i][j], a[i], b[j][0], b[j][1]);
    }
  }
}

// NW = number of weights read against the same x (1, or 2 for the gated
// FFN: w0 = gate, w1 = up).
template <class C, int NW, int EPI>
__global__ void __launch_bounds__(C::kThreads)
    dense_mma_kernel(const __nv_bfloat16* __restrict__ x, int n_tok,
                     int in_f, int out_f,
                     const __nv_bfloat16* __restrict__ w0,
                     const __nv_bfloat16* __restrict__ w1,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, int vec_x, int vec_w) {
  extern __shared__ __align__(16) unsigned char dense_mma_smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(dense_mma_smem);
  constexpr int kStage = C::template stage_elems<NW>();
  const int t0 = blockIdx.x * C::BM, n0 = blockIdx.y * C::BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int n_kt = (in_f + C::BK - 1) / C::BK;

  float acc[NW][C::kFragM][C::kFragN][4];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int i = 0; i < C::kFragM; ++i)
#pragma unroll
      for (int j = 0; j < C::kFragN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[w][i][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < n_kt)
      dense_mma_load<C, NW>(ring + s * kStage, x, w0, w1, n_tok, in_f, out_f,
                            t0, n0, s * C::BK, vec_x, vec_w);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<C::STAGES - 2>();    // stage kt has landed
    __syncthreads();                   // ... for every thread; and stage
                                       // kt - 1 is free again
    const int nk = kt + C::STAGES - 1;
    if (nk < n_kt)
      dense_mma_load<C, NW>(ring + (nk % C::STAGES) * kStage, x, w0, w1,
                            n_tok, in_f, out_f, t0, n0, nk * C::BK, vec_x,
                            vec_w);
    cp_async_commit();
    dense_mma_stage<C, NW>(ring + (kt % C::STAGES) * kStage, kt * C::BK,
                           in_f, wm, wn, lane, acc);
  }
  cp_async_wait<0>();

  // epilogue: a lane holds rows g and g + 8 (g = lane / 4) of columns
  // 2 (lane % 4) and + 1 of each fragment; out_f % 4 == 0 keeps the pair
  // inside the matrix and 4-byte aligned
#pragma unroll
  for (int i = 0; i < C::kFragM; ++i)
#pragma unroll
    for (int j = 0; j < C::kFragN; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = t0 + wm * C::kWarpM + i * 16 + (lane >> 2) + 8 * h;
        const int col = n0 + wn * C::kWarpN + j * 8 + 2 * (lane & 3);
        if (row >= n_tok || col >= out_f) continue;
        float s0[NW], s1[NW];
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          s0[w] = acc[w][i][j][2 * h];
          s1[w] = acc[w][i][j][2 * h + 1];
        }
        __nv_bfloat162 v;
        v.x = from_f32<__nv_bfloat16>(epilogue<NW, EPI>(s0, bias, col));
        v.y = from_f32<__nv_bfloat16>(epilogue<NW, EPI>(s1, bias, col + 1));
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * out_f + col) =
            v;
      }
}

template <class C, int NW, int EPI>
int launch_dense_mma_cfg(const void* x, int n_tok, int in_f, int out_f,
                         const void* w0, const void* w1, const float* bias,
                         void* out, int vec_x, int vec_w,
                         cudaStream_t stream) {
  constexpr int smem = C::template smem_bytes<NW>();
  auto kernel = dense_mma_kernel<C, NW, EPI>;
  REPRO_SMEM_OPT_IN(kernel, smem);
  // token tiles fastest, so the blocks that share a weight strip run
  // together and read it from device memory once
  dim3 grid((n_tok + C::BM - 1) / C::BM, (out_f + C::BN - 1) / C::BN);
  kernel<<<grid, C::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), n_tok, in_f, out_f,
      static_cast<const __nv_bfloat16*>(w0),
      static_cast<const __nv_bfloat16*>(w1), bias,
      static_cast<__nv_bfloat16*>(out), vec_x, vec_w);
  return (int)cudaGetLastError();
}

// The tile configuration follows the token count (and the grid it gives)
// here, and only here; the order of every sum does not (see the note at the
// top).
template <int NW, int EPI>
int launch_dense_mma(const void* x, int n_tok, int in_f, int out_f,
                     const void* w0, const void* w1, const float* bias,
                     void* out, cudaStream_t stream) {
  const int vec_x = in_f % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_w = out_f % 8 == 0 &&
                    reinterpret_cast<uintptr_t>(w0) % 16 == 0 &&
                    (NW == 1 || reinterpret_cast<uintptr_t>(w1) % 16 == 0);
#define REPRO_DENSE_MMA(CFG)                                              \
  return launch_dense_mma_cfg<CFG, NW, EPI>(x, n_tok, in_f, out_f, w0, w1, \
                                            bias, out, vec_x, vec_w, stream)
  if (n_tok <= 16) REPRO_DENSE_MMA(DenseMmaDecode);
  if (n_tok <= 128) REPRO_DENSE_MMA(DenseMmaMid);
  if constexpr (NW == 2) {
    REPRO_DENSE_MMA(DenseMmaGated);
  } else {
    const long large_tiles = (long)((n_tok + DenseMmaLarge::BM - 1) /
                                    DenseMmaLarge::BM) *
                             ((out_f + DenseMmaLarge::BN - 1) /
                              DenseMmaLarge::BN);
    if (large_tiles >= kDenseMmaSms) REPRO_DENSE_MMA(DenseMmaLarge);
    REPRO_DENSE_MMA(DenseMmaWide);
  }
#undef REPRO_DENSE_MMA
}

}  // namespace repro
