// The bfloat16 W4A16 tile of w4a16_matmul.cu (one weight) and of kernel 2's
// gate/up stage (ffn_fused.cu: gate and up as two weights against the same
// staged x, or up alone for the gelu variant), on Hopper's tensor cores.
// float32 inputs keep the CUDA-core tile of w4a16_tile.cuh.  Its weight
// loader, stage and epilogue also build the log-scale sparse tile
// (sparse_mma_tile.cuh).
//
// Layout read as the reference stores it (core/quant.py), with no repack:
// packed uint8 (in/2, out), where byte r of each g-row group holds row r
// in its low nibble and row r + g/2 in its high nibble; scales bf16
// (in/g, out).  The quant group g is a template parameter (GS): 128 rows,
// or 64 and 32 for MoE experts (core/compiler._moe_group), whose groups
// the reference keeps a multiple of 16 a matrix.
//
// The product: mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 with x
// as the A operand (16 token rows a fragment, zero past the last token)
// and the weight as B.  A block streams its x rows, its packed columns
// and their scales through a ring of STAGES shared-memory stages filled by
// cp.async (zero-filled past every edge).  The packed bytes cross device
// memory and shared memory at half the bytes of a bf16 weight and are
// dequantized in registers on their way into the B fragment: int4 values
// are exact in bf16 (the nibble XOR 8 becomes the mantissa of 128 + u,
// and one bf16x2 fma subtracts 136).
//
// The order of each sum.  k16 step s (s = 0..g/16-1) of a group takes the
// group's rows 8s..8s+7 (the low nibbles of packed rows 8s..8s+7) and
// rows g/2+8s..g/2+8s+7 (their high nibbles), so a lane's two B registers
// come from the same two packed bytes, and x's A fragment is two 16-byte
// chunks of the x row (columns 8s.. and g/2+8s..) that ldmatrix reads in
// place.  For each group, in increasing group order, one warp's fragment
// sums the group's g/16 steps from +0 in increasing s; the finished f32
// partial is multiplied by the group's scale and added to the running f32
// sum (one fmaf: the paper's scale-after-accumulate).  A stage moves whole
// 128-row chunks (one group of 128, or 128/g smaller ones); at g = 128
// the order is that of every kernel before the group became a parameter.  There is no
// split of the contraction across warps or blocks and no atomic, and the
// epilogue (common.cuh's; kEpiBias adds the f32 bias) is the same in every
// configuration.  So the order of every sum is fixed by in_f alone: the
// tile configuration follows the token count (the launcher below picks
// it) without moving any row's bits, and a row's result is bitwise the
// same whatever the other rows and however many there are.
//
// Columns: a warp owns kNT n8 fragments, and lane (g = lane / 4) of
// fragment j holds column kNT * g + j of the warp's strip, so a lane reads
// its kNT columns of a packed row as one 1-, 2- or 4-byte word and a lane
// of the accumulator holds 2 kNT adjacent output columns (one store).
//
// What bounds it on the H100 (3.35 TB/s, 989 TFLOP/s bf16 dense):
//   T <= 16  (decode): the packed bytes, in*out/2 plus in*out/64 of
//            scales, each read once: a GEMV.  Without a split of the
//            contraction a block walks all of in_f, so the time is that
//            walk's latency unless there are enough blocks: 16 padded rows
//            x 32 columns a block (128 blocks at 4096 outputs), four warps
//            of 8 columns, a 4-stage ring of two groups a stage, two
//            groups' fragment chains interleaved against the mma latency;
//            16 x 128 (eight warps of 16 columns) for the 151936-wide
//            lm_head.
//   T <= 128: still the packed bytes: 64 x 64 a block, eight warps of
//            32 x 16, a 4-stage ring of one group.
//   T > 128: the tensor cores, the dequantization in registers and the
//            shared memory that feeds them: eight warps of 32 x 32
//            (64 x 128 a block, a 3-stage ring), or of 64 x 32 (128 x 128,
//            a 4-stage ring) when that still gives every SM a block.
//
// Two weights (NW = 2): a stage holds x once and each weight's packed rows
// and scales; a warp keeps a partial and an accumulator per weight, the k16
// step's A fragments shared, each weight's sum in the order above.  The
// gated configurations (W4MmaGated*) and their registers: ffn_fused.cu.
//
// -Xptxas -v (sm_90a): no spills, no stack, one barrier in every
// instantiation, the same with and without the bias; registers a thread
// and the dynamic shared memory of the ring:
//   decode 16 x 32:    79 registers,  48.5 KB
//   decode 16 x 128:  116 registers,  98 KB
//   T <= 128, 64 x 64: 120 registers, 80.5 KB
//   64 x 128:         146 registers,  72.75 KB
//   128 x 128:        202 registers, 161 KB
#pragma once

#include "mma.cuh"

namespace repro {

// rows of a stage's chunk (64 packed rows): one 128-row scale group, or
// 128 / GS groups of GS rows
constexpr int kW4MmaGroup = 128;

// BM x BN outputs a block, WM x WN warps of (BM / WM) x (BN / WN) outputs,
// a ring of STAGES stages of G whole 128-row chunks each, NW weights (1, or
// gate and up) against the same x, quant groups of GS rows.
template <int BM_, int BN_, int WM_, int WN_, int G_, int STAGES_, int NW_ = 1,
          int GS_ = kW4MmaGroup>
struct W4MmaTile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_, G = G_,
                       STAGES = STAGES_, NW = NW_, GS = GS_;
  static constexpr int kQ = kW4MmaGroup / GS;  // quant groups a chunk
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int kWarpM = BM / WM, kWarpN = BN / WN;
  static constexpr int kFragM = kWarpM / 16, kNT = kWarpN / 8;
  static constexpr int KX = G * kW4MmaGroup;   // x columns a stage
  static constexpr int KP = KX / 2;            // packed rows a stage
  static constexpr int RX = KX / 8, RP = BN / 16;   // 16-byte chunks a row
  static constexpr int kXBytes = BM * KX * 2, kPBytes = KP * BN,
                       kSBytes = G * kQ * BN * 2;
  static constexpr int kWStage = kPBytes + kSBytes;   // one weight's part
  static constexpr int kStage = kXBytes + NW * kWStage;
  static constexpr int kSmem = STAGES * kStage;
  static_assert(kWarpM % 16 == 0 && kWarpN % 8 == 0, "");
  static_assert(kNT == 1 || kNT == 2 || kNT == 4, "a lane's word is 1-4 B");
  static_assert(RP >= 2, "swizzle needs 32-byte packed rows");
  static_assert(NW == 1 || NW == 2, "one weight, or gate and up");
  static_assert(GS == 32 || GS == 64 || GS == 128, "groups of 32-128 rows");
};

// The configurations the launcher picks from, each a compromise across the
// served shapes that share it (tuning runs on the H100 chose them; see
// PERF.md).  Decode: narrow column strips give a 4096-wide output 128
// blocks, and a block's time is its walk over the groups, not its bytes;
// the 151936-wide lm_head has blocks to spare and wider strips cost it
// fewer instructions a weight.
template <int GS = kW4MmaGroup>
using W4MmaDecode = W4MmaTile<16, 32, 1, 4, 2, 4, 1, GS>;      // T <= 16
template <int GS = kW4MmaGroup>                                // ... out_f
using W4MmaDecodeWide = W4MmaTile<16, 128, 1, 8, 2, 4, 1, GS>;  // > 33792
template <int GS = kW4MmaGroup>
using W4MmaMid = W4MmaTile<64, 64, 2, 4, 1, 4, 1, GS>;         // T <= 128
template <int GS = kW4MmaGroup>
using W4MmaWide = W4MmaTile<64, 128, 2, 4, 1, 3, 1, GS>;       // T > 128
template <int GS = kW4MmaGroup>                        // ... >= 132 tiles
using W4MmaLarge = W4MmaTile<128, 128, 2, 4, 1, 4, 1, GS>;
constexpr int kW4MmaSms = 132;
// Kernel 2's gate/up stage: two weights double a warp's accumulators and
// per-group partials, so the warp tiles stay at 32 x 16 (T <= 128) and
// 32 x 32 (above); 16 x 32 blocks at decode as kernel 1's.
template <int GS = kW4MmaGroup>
using W4MmaGatedDecode = W4MmaTile<16, 32, 1, 4, 2, 4, 2, GS>;  // T <= 16
template <int GS = kW4MmaGroup>
using W4MmaGatedMid = W4MmaTile<64, 64, 2, 4, 1, 4, 2, GS>;     // T <= 128
template <int GS = kW4MmaGroup>
using W4MmaGatedWide = W4MmaTile<64, 128, 2, 4, 1, 3, 2, GS>;   // T > 128

// One weight's part of a ring stage (see w4_mma_load below).
template <class C>
__device__ __forceinline__ void w4_mma_load_w(
    unsigned char* ps, const uint8_t* __restrict__ pk,
    const __nv_bfloat16* __restrict__ sc, int in_f, int out_f, int n0,
    int g0, bool vec_w) {
  const int n_groups = in_f / C::GS;
  constexpr int kB = C::KP * C::RP;
#pragma unroll
  for (int j = 0; j < (kB + C::kThreads - 1) / C::kThreads; ++j) {
    const int i = threadIdx.x + j * C::kThreads;
    if (kB % C::kThreads != 0 && i >= kB) break;
    const int r = i / C::RP, c = i % C::RP;
    const int prow = g0 * (kW4MmaGroup / 2) + r, n = n0 + c * 16;
    const bool row_ok = prow < in_f / 2;
    unsigned char* dst = ps + r * C::BN + swz<C::RP>(r, c) * 16;
    const uint8_t* src = pk + (size_t)prow * out_f + n;
    if (vec_w) {
      const bool ok = row_ok && n < out_f;
      cp_async16(dst, ok ? src : pk, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = row_ok && n + 4 * e < out_f;
        cp_async4(dst + 4 * e, ok ? src + 4 * e : pk, ok ? 4 : 0);
      }
    }
  }
  unsigned char* ss = ps + C::kPBytes;
  constexpr int kS = C::G * C::kQ * (C::BN / 8);
  for (int i = threadIdx.x; i < kS; i += C::kThreads) {
    const int r = i / (C::BN / 8), c = i % (C::BN / 8);
    const int g = g0 * C::kQ + r, n = n0 + c * 8;
    unsigned char* dst = ss + (r * C::BN + c * 8) * 2;
    const __nv_bfloat16* src = sc + (size_t)g * out_f + n;
    if (vec_w) {
      const bool ok = g < n_groups && n < out_f;
      cp_async16(dst, ok ? src : sc, ok ? 16 : 0);
    } else {
      const bool ok0 = g < n_groups && n < out_f;
      const bool ok1 = g < n_groups && n + 4 < out_f;
      cp_async8(dst, ok0 ? src : sc, ok0 ? 8 : 0);
      cp_async8(dst + 8, ok1 ? src + 4 : sc, ok1 ? 8 : 0);
    }
  }
}

// One ring stage: x rows t0.. (BM) and columns 128 g0.. (KX), then for each
// weight its packed rows 64 g0.. (KP) and scale rows kQ g0.. (G kQ) of
// columns n0.. (BN); zeros past n_tok, in_f and out_f.  XR, when given,
// maps a row of the tile to its x row (rows gathered by index: the MoE
// experts' tokens).  vec_w: out_f % 16 == 0 and
// 16-byte aligned weights, so each packed or scale chunk is one cp.async
// (else 4-byte packed and 8-byte scale copies, which out_f % 4 == 0
// allows); both paths fill the stage with the same bits.
template <class C>
__device__ __forceinline__ void w4_mma_load(
    unsigned char* stage, const __nv_bfloat16* __restrict__ x,
    const uint8_t* __restrict__ pk, const __nv_bfloat16* __restrict__ sc,
    const uint8_t* __restrict__ pk2, const __nv_bfloat16* __restrict__ sc2,
    int n_tok, int in_f, int out_f, int t0, int n0, int g0, bool vec_w,
    const int* xr = nullptr) {
  constexpr int kA = C::BM * C::RX;
#pragma unroll
  for (int j = 0; j < (kA + C::kThreads - 1) / C::kThreads; ++j) {
    const int i = threadIdx.x + j * C::kThreads;
    if (kA % C::kThreads != 0 && i >= kA) break;
    const int r = i / C::RX, c = i % C::RX;
    const int t = t0 + r, k = g0 * kW4MmaGroup + c * 8;
    const bool ok = t < n_tok && k < in_f;
    const size_t row = xr != nullptr ? (size_t)xr[r] : (size_t)t;
    cp_async16(stage + (r * C::RX + swz<C::RX>(r, c)) * 16,
               ok ? x + row * in_f + k : x, ok ? 16 : 0);
  }
  w4_mma_load_w<C>(stage + C::kXBytes, pk, sc, in_f, out_f, n0, g0, vec_w);
  if constexpr (C::NW == 2)
    w4_mma_load_w<C>(stage + C::kXBytes + C::kWStage, pk2, sc2, in_f, out_f,
                     n0, g0, vec_w);
}

// A lane's NT bytes of one packed row, as the low bytes of a word.
template <int NT>
__device__ __forceinline__ uint32_t w4_lane_word(const unsigned char* p) {
  if constexpr (NT == 4) {
    return *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (NT == 2) {
    return *reinterpret_cast<const uint16_t*>(p);
  } else {
    return *p;
  }
}

// Nibbles at bits 0-3 and 16-19 of q (two's-complement int4 n) as two
// exact bf16 values: nibble ^ 8 is n + 8, which in the mantissa of 128.0
// makes 136 + n; one bf16x2 fma (x * 1 - 136) leaves n.
__device__ __forceinline__ uint32_t w4_dequant_pair(uint32_t q) {
  const uint32_t v = (q & 0x000F000Fu) ^ 0x43084308u;
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));
  return d;
}

// The chunks of one stage, and in each its kQ quant groups, each weight's
// from +0 in increasing k16 steps, scaled and added to that weight's acc in
// increasing group order (see the note at the top); the weights share
// each step's A fragments.  n_groups counts 128-row chunks.
template <class C>
__device__ __forceinline__ void w4_mma_stage(
    const unsigned char* stage, int g0, int n_groups, int wm, int wn,
    int lane, float (&acc)[C::NW][C::kFragM][C::kNT][4]) {
  const unsigned char* xs = stage;
  const int t = lane & 3, col = wn * C::kWarpN + C::kNT * (lane >> 2);
  const int pcol = col & 15, pchunk = col >> 4;
  constexpr int kSteps = C::GS / 16, kHalf = C::GS / 2;
#pragma unroll
  for (int gi = 0; gi < C::G; ++gi) {
    if (g0 + gi >= n_groups) break;   // past in_f: in every configuration
#pragma unroll
    for (int q = 0; q < C::kQ; ++q) {
      float part[C::NW][C::kFragM][C::kNT][4];
#pragma unroll
      for (int wi = 0; wi < C::NW; ++wi)
#pragma unroll
        for (int i = 0; i < C::kFragM; ++i)
#pragma unroll
          for (int j = 0; j < C::kNT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[wi][i][j][e] = 0.0f;
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        uint32_t a[C::kFragM][4];
#pragma unroll
        for (int i = 0; i < C::kFragM; ++i) {
          const int r = wm * C::kWarpM + i * 16 + (lane & 15);
          const int c = gi * 16 + q * (C::GS / 8) +
                        ((lane >> 4) ? kSteps + s : s);
          ldsm_x4(a[i], xs + (r * C::RX + swz<C::RX>(r, c)) * 16);
        }
        const int prow = gi * (kW4MmaGroup / 2) + q * kHalf + 8 * s + 2 * t;
#pragma unroll
        for (int wi = 0; wi < C::NW; ++wi) {
          const unsigned char* ps = stage + C::kXBytes + wi * C::kWStage;
          const uint32_t w0 = w4_lane_word<C::kNT>(
              ps + prow * C::BN + swz<C::RP>(prow, pchunk) * 16 + pcol);
          const uint32_t w1 = w4_lane_word<C::kNT>(
              ps + (prow + 1) * C::BN + swz<C::RP>(prow + 1, pchunk) * 16 +
              pcol);
#pragma unroll
          for (int j = 0; j < C::kNT; ++j) {
            // bytes j of rows 2t and 2t + 1 at bits 0-7 and 16-23
            const uint32_t qb = __byte_perm(
                w0, w1, j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12));
            const uint32_t b0 = w4_dequant_pair(qb);       // rows 8s + 2t, +1
            const uint32_t b1 = w4_dequant_pair(qb >> 4);  // the same + g/2
#pragma unroll
            for (int i = 0; i < C::kFragM; ++i)
              mma_bf16(part[wi][i][j], a[i], b0, b1);
          }
        }
      }
      // the lane's output columns: kNT from col 2 kNT t (fragment column
      // 2t), then kNT more (2t + 1)
#pragma unroll
      for (int wi = 0; wi < C::NW; ++wi) {
        const __nv_bfloat16* ss = reinterpret_cast<const __nv_bfloat16*>(
            stage + C::kXBytes + wi * C::kWStage + C::kPBytes);
        const __nv_bfloat16* sg = ss + (gi * C::kQ + q) * C::BN +
                                  wn * C::kWarpN + 2 * C::kNT * t;
        float s_lo[C::kNT], s_hi[C::kNT];
#pragma unroll
        for (int j = 0; j < C::kNT; ++j) {
          s_lo[j] = __bfloat162float(sg[j]);
          s_hi[j] = __bfloat162float(sg[C::kNT + j]);
        }
        float(&ac)[C::kFragM][C::kNT][4] = acc[wi];
        float(&pa)[C::kFragM][C::kNT][4] = part[wi];
#pragma unroll
        for (int i = 0; i < C::kFragM; ++i)
#pragma unroll
          for (int j = 0; j < C::kNT; ++j) {
            ac[i][j][0] = fmaf(pa[i][j][0], s_lo[j], ac[i][j][0]);
            ac[i][j][1] = fmaf(pa[i][j][1], s_hi[j], ac[i][j][1]);
            ac[i][j][2] = fmaf(pa[i][j][2], s_lo[j], ac[i][j][2]);
            ac[i][j][3] = fmaf(pa[i][j][3], s_hi[j], ac[i][j][3]);
          }
      }
    }
  }
}

// The epilogue of a block (common.cuh's, on the f32 sums of every weight;
// gated: gate then up); acc(wi, i, j, e) is element e of weight wi's
// fragment (i, j), t0 and n0 the block's first row and column.  A lane holds
// rows g and g + 8 of 2 kNT adjacent columns, in two units of kNT; out_f %
// 4 == 0 keeps a unit inside the matrix or wholly past it, and each unit is
// one aligned store.
template <class C, int NW, int EPI, class Acc>
__device__ __forceinline__ void w4_mma_store(
    const Acc& acc, const float* __restrict__ bias,
    __nv_bfloat16* __restrict__ out, int n_tok, int out_f, int t0, int n0,
    int wm, int wn, int lane) {
#pragma unroll
  for (int i = 0; i < C::kFragM; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = t0 + wm * C::kWarpM + i * 16 + (lane >> 2) + 8 * h;
      if (row >= n_tok) continue;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int col = n0 + wn * C::kWarpN + 2 * C::kNT * (lane & 3) +
                        u * C::kNT;
        if (col >= out_f) continue;
        float f[C::kNT];
#pragma unroll
        for (int j = 0; j < C::kNT; ++j) {
          float s[NW];
#pragma unroll
          for (int wi = 0; wi < NW; ++wi) s[wi] = acc(wi, i, j, 2 * h + u);
          f[j] = epilogue<NW, EPI>(s, bias, col + j);
        }
        __nv_bfloat16* dst = out + (size_t)row * out_f + col;
        if constexpr (C::kNT == 4) {
          *reinterpret_cast<uint2*>(dst) =
              make_uint2(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]));
        } else if constexpr (C::kNT == 2) {
          *reinterpret_cast<uint32_t*>(dst) = pack_bf16x2(f[0], f[1]);
        } else {
          *dst = from_f32<__nv_bfloat16>(f[0]);
        }
      }
    }
}

// A block's walk over in_f: the ring filled by cp.async, each stage's
// chunks summed into acc in order (w4_mma_stage).  xr: the tile's x rows
// when gathered by index (w4_mma_load), else null.
template <class C>
__device__ __forceinline__ void w4_mma_mainloop(
    unsigned char* smem, const __nv_bfloat16* __restrict__ x, int n_tok,
    int in_f, int out_f, const uint8_t* __restrict__ pk,
    const __nv_bfloat16* __restrict__ sc, const uint8_t* __restrict__ pk2,
    const __nv_bfloat16* __restrict__ sc2, int t0, int n0, bool vec_w,
    const int* xr, int wm, int wn, int lane,
    float (&acc)[C::NW][C::kFragM][C::kNT][4]) {
  const int n_groups = in_f / kW4MmaGroup;
  const int n_st = (n_groups + C::G - 1) / C::G;
#pragma unroll
  for (int wi = 0; wi < C::NW; ++wi)
#pragma unroll
    for (int i = 0; i < C::kFragM; ++i)
#pragma unroll
      for (int j = 0; j < C::kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[wi][i][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < n_st)
      w4_mma_load<C>(smem + s * C::kStage, x, pk, sc, pk2, sc2, n_tok, in_f,
                     out_f, t0, n0, s * C::G, vec_w, xr);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_st; ++kt) {
    cp_async_wait<C::STAGES - 2>();    // stage kt has landed
    __syncthreads();                   // ... for every thread; and stage
                                       // kt - 1 is free again
    const int nk = kt + C::STAGES - 1;
    if (nk < n_st)
      w4_mma_load<C>(smem + (nk % C::STAGES) * C::kStage, x, pk, sc, pk2,
                     sc2, n_tok, in_f, out_f, t0, n0, nk * C::G, vec_w, xr);
    cp_async_commit();
    w4_mma_stage<C>(smem + (kt % C::STAGES) * C::kStage, kt * C::G,
                    n_groups, wm, wn, lane, acc);
  }
  cp_async_wait<0>();
}

template <class C, int EPI>
__global__ void __launch_bounds__(C::kThreads)
    w4a16_mma_kernel(const __nv_bfloat16* __restrict__ x, int n_tok,
                     int in_f, int out_f, const uint8_t* __restrict__ pk,
                     const __nv_bfloat16* __restrict__ sc,
                     const uint8_t* __restrict__ pk2,
                     const __nv_bfloat16* __restrict__ sc2,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, int vec_w) {
  extern __shared__ __align__(16) unsigned char w4_mma_smem[];
  const int t0 = blockIdx.x * C::BM, n0 = blockIdx.y * C::BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / C::WN, wn = warp % C::WN;

  float acc[C::NW][C::kFragM][C::kNT][4];
  w4_mma_mainloop<C>(w4_mma_smem, x, n_tok, in_f, out_f, pk, sc, pk2, sc2,
                     t0, n0, vec_w, nullptr, wm, wn, lane, acc);

  w4_mma_store<C, C::NW, EPI>(
      [&](int wi, int i, int j, int e) { return acc[wi][i][j][e]; }, bias,
      out, n_tok, out_f, t0, n0, wm, wn, lane);
}

// pk2, sc2: the second weight (up) of a two-weight tile, else null.
template <class C, int EPI>
int launch_w4a16_mma_cfg(const void* x, int n_tok, int in_f, int out_f,
                         const void* pk, const void* sc, const void* pk2,
                         const void* sc2, const float* bias, void* out,
                         int vec_w, cudaStream_t stream) {
  auto kernel = w4a16_mma_kernel<C, EPI>;
  REPRO_SMEM_OPT_IN(kernel, C::kSmem);
  // token tiles fastest, so the blocks that share a weight strip run
  // together and read it from device memory once
  dim3 grid((n_tok + C::BM - 1) / C::BM, (out_f + C::BN - 1) / C::BN);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), n_tok, in_f, out_f,
      static_cast<const uint8_t*>(pk), static_cast<const __nv_bfloat16*>(sc),
      static_cast<const uint8_t*>(pk2),
      static_cast<const __nv_bfloat16*>(sc2), bias,
      static_cast<__nv_bfloat16*>(out), vec_w);
  return (int)cudaGetLastError();
}

// 0 if x (16 bytes), a packed weight (4) or its scales (8) is misaligned
// for the copies, else 1 + vec_w (out_f % 16 == 0 and every weight 16-byte
// aligned: one cp.async a chunk).  pk2/sc2 may be null.
inline int w4_mma_alignment(const void* x, int out_f, const void* pk,
                            const void* sc, const void* pk2,
                            const void* sc2) {
  const auto at = [](const void* p, int n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  if (!at(x, 16) || !at(pk, 4) || !at(sc, 8) || !at(pk2, 4) || !at(sc2, 8))
    return 0;
  return 1 + (int)(out_f % 16 == 0 && at(pk, 16) && at(sc, 16) &&
                   at(pk2, 16) && at(sc2, 16));
}

// The tile configuration follows the token count (and the grid it gives)
// here, and only here; the order of every sum does not (see the note at
// the top).  x must be 16-byte aligned; without vec_w the packed weight
// must be 4-byte and the scales 8-byte aligned (the wrapper sees to both).
template <int EPI, int GS = kW4MmaGroup>
int launch_w4a16_mma(const void* x, int n_tok, int in_f, int out_f,
                     const void* pk, const void* sc, const float* bias,
                     void* out, cudaStream_t stream) {
  const int align = w4_mma_alignment(x, out_f, pk, sc, nullptr, nullptr);
  if (align == 0) return (int)cudaErrorMisalignedAddress;
  const int vec_w = align - 1;
#define REPRO_W4_MMA(CFG)                                                   \
  return launch_w4a16_mma_cfg<CFG, EPI>(x, n_tok, in_f, out_f, pk, sc,       \
                                        nullptr, nullptr, bias, out, vec_w,  \
                                        stream)
  if (n_tok <= 16) {
    // at most 8 narrow strips an SM
    if (out_f <= 8 * kW4MmaSms * W4MmaDecode<GS>::BN)
      REPRO_W4_MMA(W4MmaDecode<GS>);
    REPRO_W4_MMA(W4MmaDecodeWide<GS>);
  }
  if (n_tok <= 128) REPRO_W4_MMA(W4MmaMid<GS>);
  const long large_tiles =
      (long)((n_tok + W4MmaLarge<GS>::BM - 1) / W4MmaLarge<GS>::BM) *
      ((out_f + W4MmaLarge<GS>::BN - 1) / W4MmaLarge<GS>::BN);
  if (large_tiles >= kW4MmaSms) REPRO_W4_MMA(W4MmaLarge<GS>);
  REPRO_W4_MMA(W4MmaWide<GS>);
#undef REPRO_W4_MMA
}

// Kernel 2's gate/up stage: act(x @ gate) * (x @ up) with the activation
// EPI (kEpiSwiglu, kEpiGeglu) on the two f32 sums of each output, both
// weights streamed against one staged x tile; the configuration follows the
// token count, every sum's order does not.
template <int EPI, int GS = kW4MmaGroup>
int launch_w4a16_mma_gated(const void* x, int n_tok, int in_f, int out_f,
                           const void* gate_pk, const void* gate_sc,
                           const void* up_pk, const void* up_sc, void* out,
                           cudaStream_t stream) {
  const int align =
      w4_mma_alignment(x, out_f, gate_pk, gate_sc, up_pk, up_sc);
  if (align == 0) return (int)cudaErrorMisalignedAddress;
  const int vec_w = align - 1;
#define REPRO_W4_MMA(CFG)                                                   \
  return launch_w4a16_mma_cfg<CFG, EPI>(x, n_tok, in_f, out_f, gate_pk,      \
                                        gate_sc, up_pk, up_sc, nullptr, out, \
                                        vec_w, stream)
  if (n_tok <= 16) REPRO_W4_MMA(W4MmaGatedDecode<GS>);
  if (n_tok <= 128) REPRO_W4_MMA(W4MmaGatedMid<GS>);
  REPRO_W4_MMA(W4MmaGatedWide<GS>);
#undef REPRO_W4_MMA
}

}  // namespace repro
