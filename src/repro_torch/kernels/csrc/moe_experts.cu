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
// (ffn_fused.py:697-708).  Here each expert's weights stream once a tick
// for all the rows that chose it, not once per batch row, and an expert
// with no rows reads no weight.  The quant group (32, 64 or 128 rows:
// granite-moe-3b-a800m's experts take 32, mixtral-8x22b's 128) is a
// template parameter.
//
// What bounds it: at decode (a few rows an expert) the packed bytes of the
// experts that have rows (3 d d_ff / 2 bytes and the scales an expert,
// read once); with many rows an expert, the tensor cores as kernels 1 and
// 2.  Measured on the H100 (PERF.md), neither: at decode the
// consumers' instruction stream (~11 instructions an mma at 32-row groups,
// the scales' fmas included) and a small kernel's launch and first DRAM
// round trip; with many rows the same instructions at ~128 registers a
// thread.  The grid-per-expert kernel this replaces also lost time to its
// grid, sized by the host's bound on an expert's rows (three quarters of
// a 4 x 64 chunk's blocks, and those of every expert with no rows, ran
// only to exit), and to rings that drained at every block's end (granite's
// down walks two stages).
//
// The design (moe_mma_ring.cuh): a persistent grid of the blocks the card
// holds at once (capped by the host's bound on the work items); each block
// builds the work list -- (expert with rows, row tile, column strip) --
// from counts in shared memory and strides over it; a ring of STAGES
// slots stays filled across items (the packed strips and scales by TMA
// from maps encoded once a weight, the x rows gathered by cp.async), full
// and empty mbarriers pace it against the consumer warps, which run
// kernels 1 and 2's stage (w4_mma_stage) and epilogue (w4_mma_store)
// unchanged, a warp whose rows all lie past the count skipping the stage;
// the next item's loads overlap this one's stores.  TMA beat a cp.async
// loader of the same slots at every measured shape, granite's 32-byte
// strips included (PERF.md).
//
// Batch invariance: each output is one warp's fragments over the whole
// contraction in the tile's fixed order (one fragment per group in step
// order, scaled and added in group order), the order of kernels 1 and 2,
// fixed by (in_f, group) alone; no split of the contraction, no atomic.
// How many rows share an expert, the tile configuration, the grid's size,
// the batch and the chunk width move no bit of a row: a row is bitwise
// the grid-per-expert kernel's.
//
// -Xptxas -v (sm_90a, nvcc 12.9): no spills, no stack, one barrier in
// every instantiation; registers a thread at 32 / 64 / 128-row groups and
// the dynamic shared memory of the ring (the static part: 1.6 KB):
//   gate/up decode 16 x 32, 3 slots, 160 threads: 113 / 102 / 90,
//                                                  52 / 50.5 / 50.5 KB
//   gate/up mid 64 x 64, 4 slots, 256 threads:     128 / 128 / 125, 101 KB
//   down decode 16 x 32, 4 slots, 160 threads:     102 / 91 / 64,
//                                                  51 / 50 / 50 KB
//   down mid 32 x 128, 4 slots, 128 threads:       163 / 156 / 144, 69 KB
#include "moe_mma_ring.cuh"

REPRO_ERROR_STRING_FN

namespace repro {

// The ring configurations, kernel 2's gated tile for gate/up and kernel
// 1's one-weight tile for down (the launcher's choice: moe_tile).  Decode
// (16 x 32 items, four warps of few registers): a producer warp, several
// blocks an SM.  Mid: gate/up 64 x 64 (eight warps of 32 x 16 and ~128
// registers), down 32 x 128 (one row of four warps of 32 x 32, each weight
// dequantized once a block); the consumers fill the ring themselves, so
// two (gate/up) or three (down) blocks fit an SM's registers.
template <int GS>
using MoeGatedDecode = MoeRing<W4MmaGatedDecode<GS>, 3, false>;
template <int GS>
using MoeGatedMid = MoeRing<W4MmaGatedMid<GS>, 4, true, 2>;
template <int GS>
using MoeDecode = MoeRing<W4MmaDecode<GS>, 4, false>;
template <int GS>
using MoeMid = MoeRing<W4MmaTile<32, 128, 1, 4, 1, 4, 1, GS>, 4, true, 3>;

// Items (expert e, row tile, strip): rows t0.. of expert e's counts[e]
// (GATHER: x rows rows[offsets[e] + t]; else x rows offsets[e] + t),
// written to out rows offsets[e] + t.  tm_pk/tm_sc (and tm_pk2/tm_sc2)
// map the stacked experts' (E in/2, out) packed bytes and (E in/GS, out)
// scales.
template <class C, int EPI, bool GATHER>
__global__ void __launch_bounds__(C::kBlock, C::kMinBlocks)
    moe_ring_kernel(const __grid_constant__ CUtensorMap tm_pk,
                    const __grid_constant__ CUtensorMap tm_sc,
                    const __grid_constant__ CUtensorMap tm_pk2,
                    const __grid_constant__ CUtensorMap tm_sc2,
                    const __nv_bfloat16* __restrict__ x,
                    const int* __restrict__ rows,
                    const int* __restrict__ counts,
                    const int* __restrict__ offsets, int n_experts, int in_f,
                    int out_f, __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char moe_smem[];
  __shared__ __align__(8) uint64_t full[C::STAGES], empty[C::STAGES];
  __shared__ int start[kMoeMaxExperts + 1], cnt_s[kMoeMaxExperts],
      off_s[kMoeMaxExperts];
  unsigned char* ring =
      moe_smem + ((C::kAlign - (smem_u32(moe_smem) & (C::kAlign - 1))) &
                  (C::kAlign - 1));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int strips = (out_f + C::BN - 1) / C::BN;
  // who fills the ring: the producer warp's lanes, or (inline) every
  // consumer thread, thread 0 starting the weights' TMA loads
  constexpr int p_nthr = C::kInline ? C::kThreads : 32;
  const int p_tid = C::kInline ? threadIdx.x : lane;
  const bool p_lead = C::kInline ? threadIdx.x == 0 : lane == 0;
  if (threadIdx.x == (C::kInline ? 0 : C::kThreads)) {
    tma_prefetch_map(&tm_pk);
    tma_prefetch_map(&tm_sc);
    if constexpr (C::NW == 2) {
      tma_prefetch_map(&tm_pk2);
      tma_prefetch_map(&tm_sc2);
    }
  }
  if (warp == 1)
    moe_items_prefix<C::BM>(counts, offsets, n_experts, strips, lane, start,
                            cnt_s, off_s);
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], p_nthr + 1);   // each filler's copies + the lead
      mbar_init(&empty[s], C::kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int n_items = start[n_experts];
  const int n_groups = in_f / kW4MmaGroup;
  const int n_st = (n_groups + C::G - 1) / C::G;

  // The fillers' walk: stage p_kt of item p_item into slot p_slot.
  int p_item = blockIdx.x, p_kt = 0, p_e = 0, p_slot = 0;
  uint32_t p_phase = 0;
  int p_expert = 0, p_n0 = 0;
  MoeXRows<C, p_nthr, GATHER && C::NW * C::kFragM * C::kNT <= 8> xrows;
  auto produce = [&]() {
    if (p_kt == 0) {
      const MoeItem pw =
          moe_item<C::BM, C::BN>(p_item, p_e, start, cnt_s, off_s);
      p_expert = pw.e;
      p_n0 = pw.n0;
      xrows.set(GATHER ? rows : nullptr, pw.off + pw.t0, pw.cnt - pw.t0,
                p_tid);
    }
    mbar_wait(&empty[p_slot], p_phase ^ 1);
    unsigned char* st = ring + p_slot * C::kStage;
    unsigned char* ps = st + C::kXBytes;
    const int g0 = p_kt * C::G;
    xrows.load(st, x, in_f, g0, p_tid);
    if (p_lead) {
      mbar_arrive_tx(&full[p_slot], C::kTxBytes);
      moe_tma_w<C>(ps, &tm_pk, &tm_sc, p_expert, in_f, p_n0, g0,
                   &full[p_slot]);
      if constexpr (C::NW == 2)
        moe_tma_w<C>(ps + C::kWStage, &tm_pk2, &tm_sc2, p_expert, in_f, p_n0,
                     g0, &full[p_slot]);
    }
    mbar_cp_async_arrive(&full[p_slot]);
    if (++p_slot == C::STAGES) {
      p_slot = 0;
      p_phase ^= 1;
    }
    if (++p_kt == n_st) {
      p_kt = 0;
      p_item += gridDim.x;
    }
  };

  if constexpr (!C::kInline) {
    if (warp == C::kConsumerWarps) {
      while (p_item < n_items) produce();
      cp_async_wait<0>();
      return;
    }
  }

  const int wm = warp / C::WN, wn = warp % C::WN;
  int e = 0, slot = 0, it = 0, p_it = 0;
  uint32_t phase = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const MoeItem w = moe_item<C::BM, C::BN>(item, e, start, cnt_s, off_s);
    const bool live = w.cnt - w.t0 > wm * C::kWarpM;
    float acc[C::NW][C::kFragM][C::kNT][4];
#pragma unroll
    for (int wi = 0; wi < C::NW; ++wi)
#pragma unroll
      for (int i = 0; i < C::kFragM; ++i)
#pragma unroll
        for (int j = 0; j < C::kNT; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[wi][i][j][q] = 0.0f;
    for (int kt = 0; kt < n_st; ++kt, ++it) {
      if constexpr (C::kInline) {
        // every thread fills stages up to it + STAGES - 1, the slot of
        // stage it - 1 once every warp has left it (the grid-per-expert
        // loop's barrier a stage)
        while (p_item < n_items && p_it <= it + C::STAGES - 1) {
          produce();
          ++p_it;
        }
      }
      mbar_wait(&full[slot], phase);
      if (live)   // a warp whose rows all lie past the count computes none
        w4_mma_stage<C>(ring + slot * C::kStage, kt * C::G, n_groups, wm, wn,
                        lane, acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
      if (++slot == C::STAGES) {
        slot = 0;
        phase ^= 1;
      }
    }
    w4_mma_store<C, C::NW, EPI>(
        [&](int wi, int i, int j, int q) { return acc[wi][i][j][q]; },
        nullptr, out + (size_t)w.off * out_f, w.cnt, out_f, w.t0, w.n0, wm,
        wn, lane);
  }
}

// A launch's operands; max_rows bounds an expert's count, n_slots the
// rows of out (tokens x top_k).
struct MoeLaunch {
  const void *x;
  const int *rows, *counts, *offsets;
  int n_experts, max_rows, n_slots, in_f, out_f;
  const void *pk, *sc, *pk2, *sc2;
  void* out;
  int blocks;
  cudaStream_t stream;
};

// The persistent grid: the blocks the card holds at once, capped by the
// host's bound on the items (no more than min(E ceil(max_rows / BM),
// floor((n_slots + active (BM - 1)) / BM)) row tiles, times the strips);
// `blocks` > 0 sets it (a test of the grid's independence).
template <class C, int EPI, bool GATHER>
int launch_moe_ring(const MoeLaunch& a) {
  auto kernel = moe_ring_kernel<C, EPI, GATHER>;
  REPRO_SMEM_OPT_IN(kernel, C::kSmem);
  static const int resident = [&] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, C::kBlock,
                                                  C::kSmem);
    return per_sm * sms;
  }();
  const long strips = (a.out_f + C::BN - 1) / C::BN;
  const long active = a.n_experts < a.n_slots ? a.n_experts : a.n_slots;
  const long tiles = std::min<long>(
      (long)a.n_experts * ((a.max_rows + C::BM - 1) / C::BM),
      (a.n_slots + active * (C::BM - 1)) / C::BM);
  long grid = a.blocks > 0 ? a.blocks : std::min<long>(tiles * strips,
                                                       resident);
  if (grid < 1) grid = 1;

  CUtensorMap m[4] = {};
  const uint64_t pk_rows = (uint64_t)a.n_experts * (a.in_f / 2);
  const uint64_t sc_rows = (uint64_t)a.n_experts * (a.in_f / C::GS);
  const void* w[2][2] = {{a.pk, a.sc}, {a.pk2, a.sc2}};
  for (int wi = 0; wi < C::NW; ++wi) {
    int rc = tensor_map(&m[2 * wi], w[wi][0], false, pk_rows, a.out_f, C::BN,
                        C::KP);
    if (rc == 0)
      rc = tensor_map(&m[2 * wi + 1], w[wi][1], true, sc_rows, a.out_f,
                      C::BN, C::G * C::kQ);
    if (rc != 0) return rc;
  }
  kernel<<<(unsigned)grid, C::kBlock, C::kSmem, a.stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const __nv_bfloat16*>(a.x), a.rows,
      a.counts, a.offsets, a.n_experts, a.in_f, a.out_f,
      static_cast<__nv_bfloat16*>(a.out));
  return (int)cudaGetLastError();
}

// tile: 0 follows the host's bound on the mean rows an expert (slots /
// experts): up to 32 the decode tiles, above them mid; 1 decode, 2 mid
// (tests).  No configuration moves a row's sum order.
inline int moe_tile(int tile, const MoeLaunch& a) {
  if (tile != 0) return tile;
  return (a.n_slots + a.n_experts - 1) / a.n_experts <= 32 ? 1 : 2;
}

template <int GS>
int launch_moe_gate_up(const MoeLaunch& a, int tile) {
  switch (moe_tile(tile, a)) {
    case 1: return launch_moe_ring<MoeGatedDecode<GS>, kEpiSwiglu, true>(a);
    case 2: return launch_moe_ring<MoeGatedMid<GS>, kEpiSwiglu, true>(a);
  }
  return (int)cudaErrorInvalidValue;
}

template <int GS>
int launch_moe_down(const MoeLaunch& a, int tile) {
  switch (moe_tile(tile, a)) {
    case 1: return launch_moe_ring<MoeDecode<GS>, kEpiNone, false>(a);
    case 2: return launch_moe_ring<MoeMid<GS>, kEpiNone, false>(a);
  }
  return (int)cudaErrorInvalidValue;
}

// 0 unless x and every weight are 16-byte aligned (TMA's and the 16-byte
// copies' rule), out_f % 16 == 0 and 1 <= n_experts <= kMoeMaxExperts.
inline int moe_check(const MoeLaunch& a) {
  const auto at = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (a.n_experts < 1 || a.n_experts > kMoeMaxExperts)
    return (int)cudaErrorInvalidValue;
  if (!at(a.x) || !at(a.pk) || !at(a.sc) || !at(a.pk2) || !at(a.sc2) ||
      a.out_f % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  return 0;
}

}  // namespace repro

// n_slots: rows of the hidden (tokens x top_k).  activation: 1 = swiglu
// (the wrapper refuses others).  tile (0: by the bounds; 1 decode, 2 mid)
// and blocks (0: the persistent grid) are for tests and timing; the
// wrappers pass 0.
extern "C" int moe_gate_up_launch(const void* x, const int* rows,
                                  const int* counts, const int* offsets,
                                  const void* gate_packed,
                                  const void* gate_scales,
                                  const void* up_packed,
                                  const void* up_scales, void* hidden,
                                  int n_experts, int max_rows, int n_slots,
                                  int d, int f, int group, int activation,
                                  int tile, int blocks, void* stream) {
  using namespace repro;
  if (activation != kEpiSwiglu) return (int)cudaErrorInvalidValue;
  const MoeLaunch a{x, rows, counts, offsets, n_experts, max_rows, n_slots,
                    d, f, gate_packed, gate_scales, up_packed, up_scales,
                    hidden, blocks, static_cast<cudaStream_t>(stream)};
  if (const int rc = moe_check(a)) return rc;
  if (group == 32) return launch_moe_gate_up<32>(a, tile);
  if (group == 64) return launch_moe_gate_up<64>(a, tile);
  if (group == 128) return launch_moe_gate_up<128>(a, tile);
  return (int)cudaErrorInvalidValue;
}

extern "C" int moe_down_launch(const void* hidden, const int* counts,
                               const int* offsets, const void* packed,
                               const void* scales, void* y, int n_experts,
                               int max_rows, int n_slots, int f, int d,
                               int group, int tile, int blocks,
                               void* stream) {
  using namespace repro;
  const MoeLaunch a{hidden, nullptr, counts, offsets, n_experts, max_rows,
                    n_slots, f, d, packed, scales, packed, scales, y, blocks,
                    static_cast<cudaStream_t>(stream)};
  if (const int rc = moe_check(a)) return rc;
  if (group == 32) return launch_moe_down<32>(a, tile);
  if (group == 64) return launch_moe_down<64>(a, tile);
  if (group == 128) return launch_moe_down<128>(a, tile);
  return (int)cudaErrorInvalidValue;
}
