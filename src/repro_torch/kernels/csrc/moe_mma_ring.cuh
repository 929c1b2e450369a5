// The persistent ring of the grouped expert kernels (moe_experts.cu) on
// Hopper: a work list built on the device from the route's counts, a ring
// of shared-memory stages kept filled across work items (the weights by
// TMA, the x rows by cp.async), full and empty mbarriers between its
// fillers and the consumer warps, and the consumers' W4A16 tensor-core
// stage and epilogue of w4a16_mma_tile.cuh (w4_mma_stage, w4_mma_store),
// unchanged.
//
// Work items.  Expert e with counts[e] rows has ceil(counts[e] / BM) row
// tiles and ceil(out_f / BN) column strips; its items are (strip, tile)
// with the tile fastest, and expert e's first item is the sum of the
// earlier experts' tiles x strips (moe_items_torch in kernels/
// moe_experts.py is this enumeration's plain version).  Every block builds
// the list itself from counts (no host read, no extra launch) and takes
// items blockIdx.x, blockIdx.x + gridDim.x, ... (a static assignment, no
// atomics), so an expert with no rows, or a row tile past its count, costs
// nothing and the grid is fixed by host bounds alone (a graph replays it).
//
// The ring.  Stage slots keep w4a16_mma_tile.cuh's layout, so
// w4_mma_stage reads them unchanged: x rows (BM x KX bf16, 16-byte chunks
// XOR-swizzled by swz<RX>) and, per weight, the packed rows (KP x BN bytes,
// swizzled by swz<RP>) and the scale rows (G kQ x BN bf16, dense).  A
// packed tile's swz<RP> is TMA's 32-, 64- or 128-byte swizzle for a
// 32-, 64- or 128-byte row (the 16-byte chunk XOR address bits 7.. of a
// slot aligned to the swizzle's span), so TMA writes the bytes where the
// fragment loads already look; each weight's part of a slot starts on its
// swizzle's span (256, 512 or 1024 bytes).
//
// The fillers: one producer warp after the consumer warps (decode tiles:
// few registers a thread, so the extra warp costs no block an SM), or
// every consumer thread, STAGES - 1 stages ahead of its reads (INLINE: the
// mid tiles, whose registers fill the SM at two or three blocks).  They
// gather the x rows a stage needs with cp.async (only the item's rows: a
// row past the count is never stored, and an mma row reads no other row)
// and hand them to the stage's full barrier
// (cp.async.mbarrier.arrive.noinc); the lead thread adds the weights'
// bytes to the barrier's transaction count and starts one TMA load a
// packed tile and one a scale tile.  A consumer warp waits on the full
// barrier, runs the stage and arrives on the empty barrier; a slot is
// refilled when every consumer warp has arrived.  The fillers run ahead
// across the end of an item, so the next item's first stages load while
// the consumers store this one.
#pragma once

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>

#include "tma.cuh"
#include "w4a16_mma_tile.cuh"

namespace repro {

constexpr int kMoeMaxExperts = 128;

// A W4MmaTile run by the ring: STAGES slots, each weight's part padded to
// its swizzle's span.  INLINE: the consumer threads fill the ring
// themselves, STAGES - 1 stages ahead of their reads (the block keeps the
// tile's warps, so as many blocks fit an SM's registers as the
// grid-per-expert kernel's); else one producer warp follows the consumer
// warps.  MIN_BLOCKS: blocks an SM must hold.
template <class T, int STAGES_, bool INLINE, int MIN_BLOCKS = 1>
struct MoeRing : T {
  static constexpr int STAGES = STAGES_;
  static constexpr bool kInline = INLINE;
  static constexpr int kMinBlocks = MIN_BLOCKS;
  // the ring's base on the 128-byte swizzle's span, each TMA tile on its
  // own swizzle's (8 rows of BN bytes)
  static constexpr int kAlign = 1024, kSpan = T::BN * 8;
  static constexpr int kXBytes = (T::kXBytes + kSpan - 1) / kSpan * kSpan;
  static constexpr int kWStage = (T::kWStage + kSpan - 1) / kSpan * kSpan;
  static constexpr int kStage = kXBytes + T::NW * kWStage;
  static constexpr int kSmem = STAGES * kStage + kAlign;  // + the base's slack
  static constexpr int kConsumerWarps = T::kThreads / 32;
  static constexpr int kBlock = T::kThreads + (INLINE ? 0 : 32);
  static constexpr uint32_t kTxBytes = T::NW * (T::kPBytes + T::kSBytes);
  static_assert(T::kPBytes % kSpan == 0 && kStage % kSpan == 0,
                "every tile on its swizzle's span");
  static_assert(T::BN * (int)sizeof(__nv_bfloat16) <= 256 &&
                    T::G * T::kQ <= 256 && T::KP <= 256,
                "a TMA box is at most 256 a side");
};

// ---- the work list --------------------------------------------------------

// One warp: cnt_s/off_s the experts' counts and offsets, start[e] expert
// e's first item, start[n_experts] the number of items.
template <int BM>
__device__ __forceinline__ void moe_items_prefix(
    const int* __restrict__ counts, const int* __restrict__ offsets,
    int n_experts, int strips, int lane, int* start, int* cnt_s,
    int* off_s) {
  constexpr int kPer = kMoeMaxExperts / 32;
  int v[kPer], sum = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = lane * kPer + j;
    const int c = e < n_experts ? counts[e] : 0;
    if (e < n_experts) {
      cnt_s[e] = c;
      off_s[e] = offsets[e];
    }
    v[j] = (c + BM - 1) / BM * strips;
    sum += v[j];
  }
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  int run = incl - sum;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = lane * kPer + j;
    if (e < n_experts) start[e] = run;
    run += v[j];
  }
  if (lane == 31) start[n_experts] = incl;
}

struct MoeItem {
  int e, t0, n0, cnt, off;
};

// Item `item` (items ascending: e only moves forward).
template <int BM, int BN>
__device__ __forceinline__ MoeItem moe_item(int item, int& e,
                                            const int* start,
                                            const int* cnt_s,
                                            const int* off_s) {
  while (start[e + 1] <= item) ++e;
  const int cnt = cnt_s[e], tiles = (cnt + BM - 1) / BM;
  const int local = item - start[e];
  return {e, (local % tiles) * BM, (local / tiles) * BN, cnt, off_s[e]};
}

// ---- the producer's loads --------------------------------------------------

// The x rows one of NTHR filler threads copies for an item: chunk tid + k
// NTHR of the BM x RX tile reads tile row r's x row, rows[base + r] (rows
// gathered by index) or base + r, none past the item's rows (n, at most
// BM).  CACHE keeps
// the gathered indices in registers, read once an item, so a stage's
// copies wait on no index (the tiles whose accumulators leave the room).
template <class C, int NTHR, bool CACHE>
struct MoeXRows {
  static constexpr int kPer = (C::BM * C::RX + NTHR - 1) / NTHR;
  const int* rows;
  int base, nrows;
  int row[CACHE ? kPer : 1];

  __device__ __forceinline__ void set(const int* __restrict__ r_, int b,
                                      int n, int tid) {
    rows = r_;
    base = b;
    nrows = min(C::BM, n);
    if constexpr (CACHE) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int i = tid + k * NTHR;
        row[k] = i < nrows * C::RX ? r_[b + i / C::RX] : 0;
      }
    }
  }

  // The stage's columns 128 g0.. that lie inside in_f (chunks ascend with
  // rows, so the item's rows end the walk).
  __device__ __forceinline__ void load(unsigned char* st,
                                       const __nv_bfloat16* __restrict__ x,
                                       int in_f, int g0, int tid) const {
    const int k0 = g0 * kW4MmaGroup;
    const int rx = min(C::KX, in_f - k0) / 8;
    if constexpr (CACHE) {
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int i = tid + k * NTHR, r = i / C::RX, c = i % C::RX;
        if (i >= nrows * C::RX) break;
        if (c < rx)
          cp_async16(st + (r * C::RX + swz<C::RX>(r, c)) * 16,
                     x + (size_t)row[k] * in_f + k0 + c * 8, 16);
      }
    } else {
      for (int i = tid; i < nrows * C::RX; i += NTHR) {
        const int r = i / C::RX, c = i % C::RX;
        const int xrow = rows != nullptr ? rows[base + r] : base + r;
        if (c < rx)
          cp_async16(st + (r * C::RX + swz<C::RX>(r, c)) * 16,
                     x + (size_t)xrow * in_f + k0 + c * 8, 16);
      }
    }
  }
};

// One weight's packed and scale tiles by TMA (pk/sc: maps over the stacked
// (E in/2, out) bytes and (E in/GS, out) scales; past out_f TMA fills
// zeros, past the expert's in_f it reads rows the stage never uses).
template <class C>
__device__ __forceinline__ void moe_tma_w(unsigned char* ps,
                                          const CUtensorMap* pk,
                                          const CUtensorMap* sc, int e,
                                          int in_f, int n0, int g0,
                                          uint64_t* bar) {
  tma_load_2d(ps, pk, n0, e * (in_f / 2) + g0 * (kW4MmaGroup / 2), bar);
  tma_load_2d(ps + C::kPBytes, sc, n0, e * (in_f / C::GS) + g0 * C::kQ, bar);
}

// ---- host: tensor maps, encoded once a weight ------------------------------

// The map of a row-major (rows, cols) matrix of uint8 (packed: the box's
// row of box_c bytes swizzled as swz<box_c / 16>) or bf16 (scales: dense),
// box (box_c, box_r).  A map is a function of these arguments alone, so
// it is encoded the first time a weight is launched and reused after.
inline int tensor_map(CUtensorMap* out, const void* p, bool bf16,
                      uint64_t rows, uint64_t cols, uint32_t box_c,
                      uint32_t box_r) {
  using Key = std::tuple<const void*, bool, uint64_t, uint64_t, uint32_t,
                         uint32_t>;
  static std::mutex mu;
  static std::map<Key, CUtensorMap> cache;
  const Key key{p, bf16, rows, cols, box_c, box_r};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *out = it->second;
    return 0;
  }
  const TensorMapEncodeFn encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const uint32_t esize = bf16 ? 2 : 1;
  CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE;
  if (!bf16)
    swizzle = box_c == 32   ? CU_TENSOR_MAP_SWIZZLE_32B
              : box_c == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                            : CU_TENSOR_MAP_SWIZZLE_128B;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * esize};
  const cuuint32_t box[2] = {box_c, box_r};
  const cuuint32_t step[2] = {1, 1};
  CUtensorMap m;
  const CUresult r = encode(
      &m, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      2, const_cast<void*>(p), dims, strides, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  cache.emplace(key, m);
  *out = m;
  return 0;
}

}  // namespace repro
