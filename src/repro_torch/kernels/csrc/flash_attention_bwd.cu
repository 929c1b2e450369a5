// Full-sequence flash attention, backward, for Hopper (sm_90a): wgmma fed
// by TMA through mbarrier rings.
//
// Replaces no Pallas kernel: the reference's flash_attention_pallas
// (src/repro/kernels/flash_attention.py:101) has no VJP, and its training
// differentiates the XLA twin (src/repro/kernels/xla_attention.py:333,
// attention_chunked) instead.  The port's training forward is kernel 7
// (flash_attention.cu's flash_attention_lse_launch), so its gradient is a
// kernel too.  Contract: q, o, dO (B, hq, Sq, d), k, v (B, hkv, Skv, d) in
// bfloat16, lse (B, hq, Sq) f32 from the forward (natural log, +inf for a
// row that saw no key); the masks are the forward's (query i at position
// Skv - Sq + i; causal q_pos >= k_pos, window q_pos - k_pos < window, or
// neither).  With s = q.k * scale and P = exp(s - lse):
//   D_i  = sum_d dO_i * O_i                          (f32)
//   dP   = dO . V^T,   dS = P * (dP - D)
//   dV   = P^T . dO,   dK = scale * dS^T . Q,   dQ = scale * dS . K
// P and dS are rounded to bf16 as the A operands of the products (the
// forward rounds P before P.V the same way); every sum is f32.  dK and dV
// of a KV head sum over its hq / hkv query heads.
//
// Two launches, no atomics: every output element is written once by one
// block, and each of its sums runs in one fixed order, so the backward is
// bitwise repeatable and a batch row's gradients do not depend on the
// other rows.  Each block is a producer warpgroup and two consumer
// warpgroups (setmaxnreg moves the producer's registers to the consumers:
// 24 and 240 a thread).  The producer's lead threads keep TMA loads in
// flight into mbarrier rings (full barriers on the bytes, empty barriers
// on the consumers' arrivals); the consumers run every product on wgmma
// with f32 accumulators in registers, and the P and dS accumulators,
// rounded to bf16, are the A operands of the next products in registers.
// Tiles land with TMA's 128-byte swizzle (64-byte at head dim 32), which
// the wgmma descriptors read directly (wgmma.cuh); ragged rows past Sq or
// Skv arrive as zeros (3-D tensor maps over (d, S, B * heads)) and are
// masked, only in the tiles the mask or the edge cuts (a tile wholly
// inside and visible takes a path without it).  S and dP go out as two
// commit groups, so P (ex2 on the SFU) is computed while dP runs, and dS
// while the next product runs.  (Overlapping consecutive items inside a
// warpgroup, or making the two warpgroups take turns on the tensor cores,
// measured slower: the two free-running warpgroups already fill each
// other's gaps.)
//   1. dQ: a block per (128-row query tile, query head, batch row), the
//      latest query tile first; each consumer warpgroup owns 64 of the
//      rows.  It first computes its rows' D from O and dO (all 16 rows of
//      a warp in flight at once) and writes each 64-row tile's lse (in
//      log2 units) and D to the stats scratch, zeros past Sq.  Q and dO
//      stay in shared memory; K and V come through a three-stage ring over
//      the union of the two warpgroups' live 64-key tiles (the forward's
//      live-tile rule a 64-row tile, so exactly the tiles the forward
//      visited), ascending.  Per tile: S = Q.K^T and dP = dO.V^T (SS wgmma
//      m64n64k16, both operands K-major), then dQ += dS.K (RS wgmma
//      m64n(d)k16, K read MN-major); dQ is recomputed here rather than
//      added across key-tile blocks, whose f32 partials would be 528 tile
//      pairs x 32 KB a head at S = 2048.
//   2. dK, dV: a block per (64-key tile, KV head, batch row), key tile 0
//      (the most work under a causal mask) first, launched as a
//      programmatic dependent of the dQ grid: its blocks take the SMs the
//      dQ grid's last wave frees and load K and V at once, and only the
//      producers' stats copies wait (griddepcontrol.wait) for the dQ grid.
//      K and V stay in shared memory.  The KV head's (query head r, 64-row
//      query tile iq) items, r ascending and iq ascending among the live
//      ones, are split over the two consumer warpgroups by the parity of r
//      + iq, so the longest block walks half the items it would alone;
//      each warpgroup has its own two-stage ring of Q and dO tiles with
//      their lse and D (a bulk copy from the stats scratch) and its own
//      producer thread.  Per item: S^T = K.Q^T and dP^T = V.dO^T (SS),
//      then dV += P^T.dO and dK += dS^T.Q (RS, dO and Q read MN-major).
//      Each warpgroup keeps f32 dK and dV partials; at the end the second
//      one's pass through shared memory into the first's (an f32 add of
//      two, so the order is fixed) and the first writes the tile.
//
// Waves, 132 SMs and one block an SM (384 threads at 168 registers): at
// the training shape (B 8, 32 / 8 heads, S 256) dK/dV is 4 x 8 x 8 = 256
// blocks whose items are 16, 12, 8 and 4 by key tile (8, 6, 4, 2 a
// warpgroup): 2,560 items over 264 warpgroups, 9.7 each, the longest 8.
// At S = 2048, rep 4 (B 1) it is 256 blocks, key tile j 4 (32 - j) items:
// the longest warpgroup walks 64, the card's mean is 16,896 / 264 = 64
// (4 warps walking 128 against a mean of 66 before).  At rep 16 (32 / 2
// heads, S 2048) it is 64 blocks, under one wave: the longest warpgroup
// walks 256 items against a mean of 66, so that shape is bound by its
// longest block (splitting a KV head's query heads over blocks would need
// dK / dV partials and a second pass).  dQ at S = 2048 rep 4 is 16 x 32 =
// 512 blocks of 2 .. 32 key tiles, latest first; at the training shape 2
// x 32 x 8 = 512 blocks of 2 or 4.
//
// What bounds it: seven products of 2 d operations per visible (query
// head, key) pair (S and dP in both passes, dV, dK, dQ) against the five
// the bound counts, and one read of q, k, v, o, dO and lse and one write
// of dq, dk and dv; at training lengths it is operations.  Head dims 32,
// 64 and 128 in bfloat16.
#include "tma.cuh"
#include "wgmma.cuh"

REPRO_ERROR_STRING_FN

namespace repro {
// internal linkage: the kernel libraries are loaded into one process, and
// no two may bind each other's helpers
namespace {

constexpr int kFbTile = 64;             // keys of a dK/dV block; rows of a
                                        // consumer warpgroup
constexpr int kFbThreads = 3 * 128;     // producer + two consumer warpgroups
constexpr int kFbStages = 2;            // dK/dV: ring stages a warpgroup
constexpr int kFbDqStages = 3;          // dQ: the shared K/V ring
constexpr int kFbStats = 2 * kFbTile;   // a query tile's lse2 and D

// A 64-row tile of D bf16 values as TMA writes it: D / CB column blocks of
// CB values, each 64 rows of SPAN bytes under SPAN's swizzle.
template <int D>
struct FbTile {
  static constexpr int CB = D < 64 ? D : 64;
  static constexpr int SPAN = 2 * CB;
  static constexpr int NB = D / CB;
  static constexpr int BLOCK = kFbTile * SPAN;
  static constexpr int BYTES = NB * BLOCK;
  static_assert(BYTES % 1024 == 0, "tiles on the swizzle's 1024 bytes");

  // k16 step ks of the tile at `addr` read along its rows (K-major)
  static __device__ __forceinline__ uint64_t kmajor(uint32_t addr, int ks) {
    constexpr int kPer = CB / 16;
    return wgmma_desc(addr + (ks / kPer) * BLOCK + (ks % kPer) * 32, 16,
                      8 * SPAN, SPAN);
  }
  // rows 16 kk .. 16 kk + 15 of the tile at `addr` read across its rows
  // (MN-major), all D columns
  static __device__ __forceinline__ uint64_t mnmajor(uint32_t addr, int kk) {
    return wgmma_desc(addr + kk * 16 * SPAN, BLOCK, 8 * SPAN, SPAN);
  }
};

__device__ __forceinline__ bool visible(int q_pos, int k_pos, int causal,
                                        int window) {
  bool ok = true;
  if (causal) ok = q_pos >= k_pos;
  if (window > 0) ok = ok && q_pos - k_pos < window;
  return ok;
}

// The forward's live K/V tiles [t_lo, t_hi) of the 64-row query tile at q0.
__device__ __forceinline__ void live_tiles(int q0, int sq, int skv,
                                           int causal, int window, int& t_lo,
                                           int& t_hi) {
  const int q_first = skv - sq + q0;
  const int q_last = q_first + min(kFbTile, sq - q0) - 1;
  t_lo = 0;
  t_hi = (skv + kFbTile - 1) / kFbTile;
  if (causal) t_hi = q_last >= 0 ? min(t_hi, q_last / kFbTile + 1) : 0;
  if (window > 0) {
    const int floor_pos = q_first - window + 1;
    if (floor_pos > 0) t_lo = floor_pos / kFbTile;
  }
}

// Every pair of the tile (rows q_first .., keys k0 ..) visible and inside
// Sq and Skv: the mask can be skipped.
__device__ __forceinline__ bool tile_full(int q_first, int q_rows, int k0,
                                          int k_rows, int causal,
                                          int window) {
  bool full = q_rows == kFbTile && k_rows == kFbTile;
  if (causal) full = full && q_first >= k0 + kFbTile - 1;
  if (window > 0) full = full && q_first + kFbTile - 1 - k0 < window;
  return full;
}

// 2^x on the SFU alone (ex2.approx.ftz: results below 2^-126 flush to 0,
// far under P's bf16 rounding)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void setmaxnreg_producer() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
}
__device__ __forceinline__ void setmaxnreg_consumer() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
}
// the two consumer warpgroups
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// The A operands of four k16 steps from a 64 x 64 accumulator, rounded to
// bf16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4],
                                       const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16x2(s[8 * kk], s[8 * kk + 1]);
    a[kk][1] = pack_bf16x2(s[8 * kk + 2], s[8 * kk + 3]);
    a[kk][2] = pack_bf16x2(s[8 * kk + 4], s[8 * kk + 5]);
    a[kk][3] = pack_bf16x2(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.0f;
}

template <int D>
constexpr int dq_smem_bytes() {
  return 1024 + 4 * FbTile<D>::BYTES + kFbDqStages * 2 * FbTile<D>::BYTES +
         (1 + 2 * kFbDqStages) * 8;
}

template <int D>
constexpr int dkv_smem_bytes() {
  return 1024 + 2 * FbTile<D>::BYTES + 2 * kFbStages * 2 * FbTile<D>::BYTES +
         2 * kFbStages * kFbStats * 4 + (1 + 4 * kFbStages) * 8;
}

template <int D>
__global__ void __launch_bounds__(kFbThreads, 1)
    fb_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 const __grid_constant__ CUtensorMap map_do,
                 const __nv_bfloat16* __restrict__ o,
                 const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse,
                 float* __restrict__ stats, __nv_bfloat16* __restrict__ dq,
                 int hq, int hkv, int sq, int skv, float scale,
                 float scale_log2, int causal, int window) {
  using T = FbTile<D>;
  constexpr int S = kFbDqStages;
  extern __shared__ unsigned char fb_smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(fb_smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = smem;                       // warpgroup c: + c BYTES
  unsigned char* dos = qs + 2 * T::BYTES;
  unsigned char* ring = dos + 2 * T::BYTES;       // stage st: K, V
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + S * 2 * T::BYTES);
  uint64_t* qdo_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + S;

  const int iq = gridDim.z - 1 - blockIdx.z;     // latest query tile first
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (hq / hkv);
  const int q0 = iq * 2 * kFbTile;
  // each warpgroup's live key tiles and the union the block streams
  int lo[2], hi[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    lo[c] = hi[c] = 0;
    if (q0 + c * kFbTile < sq)
      live_tiles(q0 + c * kFbTile, sq, skv, causal, window, lo[c], hi[c]);
  }
  int t_lo = lo[0], t_hi = hi[0];
  if (lo[1] < hi[1]) {
    t_lo = t_lo < t_hi ? min(t_lo, lo[1]) : lo[1];
    t_hi = max(t_hi, hi[1]);
  }

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int st = 0; st < S; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 256);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the dK/dV grid may launch once every block of this one runs; it waits
  // for this grid's stats before reading them
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_producer();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&map_q);
      tma_prefetch_map(&map_do);
      tma_prefetch_map(&map_k);
      tma_prefetch_map(&map_v);
      mbar_arrive_tx(qdo_full, 4 * T::BYTES);
      for (int c = 0; c < 2; ++c)
        for (int hb = 0; hb < T::NB; ++hb) {
          tma_load_3d(qs + c * T::BYTES + hb * T::BLOCK, &map_q, hb * T::CB,
                      q0 + c * kFbTile, b * hq + h, qdo_full);
          tma_load_3d(dos + c * T::BYTES + hb * T::BLOCK, &map_do,
                      hb * T::CB, q0 + c * kFbTile, b * hq + h, qdo_full);
        }
      int st = 0;
      uint32_t ph = 0;
      for (int it = t_lo; it < t_hi; ++it) {
        mbar_wait(&empty[st], ph ^ 1);
        mbar_arrive_tx(&full[st], 2 * T::BYTES);
        unsigned char* ks = ring + st * 2 * T::BYTES;
        for (int hb = 0; hb < T::NB; ++hb) {
          tma_load_3d(ks + hb * T::BLOCK, &map_k, hb * T::CB, it * kFbTile,
                      b * hkv + kvh, &full[st]);
          tma_load_3d(ks + T::BYTES + hb * T::BLOCK, &map_v, hb * T::CB,
                      it * kFbTile, b * hkv + kvh, &full[st]);
        }
        if (++st == S) {
          st = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }
  setmaxnreg_consumer();
  const int c = wg - 1, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32, g = lane / 4, qd = lane % 4;
  const int r0 = q0 + c * kFbTile;                // the warpgroup's rows
  const size_t row_base = ((size_t)b * hq + h) * sq;
  const int n64 = (sq + kFbTile - 1) / kFbTile;

  // D of the warp's 16 rows: lanes 2 rr and 2 rr + 1 each sum half of row
  // rr (all 16 rows' loads in flight at once), then add their halves;
  // this lane keeps rows g and g + 8.  The 64-row tile's lse2 and D go to
  // the stats scratch for the dK/dV pass.
  float dl[2], lse2[2];
  {
    constexpr int H = D / 16;                     // 16-byte chunks a half
    const int rr = lane / 2, half = lane % 2;
    const int row = r0 + warp * 16 + rr;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int rg = r0 + warp * 16 + g + 8 * hh;
      lse2[hh] = rg < sq ? lse[row_base + rg] * kLog2e : 0.0f;
    }
    uint4 ov[H], dv[H];
#pragma unroll
    for (int u = 0; u < H; ++u) {
      ov[u] = dv[u] = make_uint4(0u, 0u, 0u, 0u);
      if (row < sq) {
        ov[u] = reinterpret_cast<const uint4*>(o + (row_base + row) * D)
            [half * H + u];
        dv[u] = reinterpret_cast<const uint4*>(dout + (row_base + row) * D)
            [half * H + u];
      }
    }
    float s = 0.0f;
#pragma unroll
    for (int u = 0; u < H; ++u) {
      const __nv_bfloat16* oe = reinterpret_cast<const __nv_bfloat16*>(&ov[u]);
      const __nv_bfloat16* de = reinterpret_cast<const __nv_bfloat16*>(&dv[u]);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        s = fmaf(__bfloat162float(de[e]), __bfloat162float(oe[e]), s);
    }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    dl[0] = __shfl_sync(0xffffffffu, s, 2 * g);
    dl[1] = __shfl_sync(0xffffffffu, s, 2 * (g + 8));
    if (r0 < sq && half == 0) {
      float* st_out = stats + ((size_t)(b * hq + h) * n64 + r0 / kFbTile) *
                                  kFbStats;
      st_out[warp * 16 + rr] = row < sq ? lse[row_base + row] * kLog2e : 0.0f;
      st_out[kFbTile + warp * 16 + rr] = row < sq ? s : 0.0f;
    }
  }

  const uint32_t q_addr = smem_u32(qs + c * T::BYTES);
  const uint32_t do_addr = smem_u32(dos + c * T::BYTES);
  const int q_rows = min(kFbTile, sq - r0);
  const int q_first = skv - sq + r0;
  float acc[D / 2];
  zero(acc);
  mbar_wait(qdo_full, 0);
  int st = 0;
  uint32_t ph = 0;
  for (int it = t_lo; it < t_hi; ++it) {
    mbar_wait(&full[st], ph);
    if (it >= lo[c] && it < hi[c]) {
      const uint32_t k_addr = smem_u32(ring + st * 2 * T::BYTES);
      const uint32_t v_addr = k_addr + T::BYTES;
      float s[32], dp[32];
      wgmma_fence_operand(s);
      wgmma_fence_operand(dp);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss_n64(s, T::kmajor(q_addr, ks), T::kmajor(k_addr, ks),
                     ks > 0);
      wgmma_commit();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss_n64(dp, T::kmajor(do_addr, ks), T::kmajor(v_addr, ks),
                     ks > 0);
      wgmma_commit();
      // rows 16 warp + g (+ 8): queries; columns 8 j + 2 qd (+ 1): keys
      const int k0 = it * kFbTile;
      wgmma_wait<1>();                      // S; P while dP runs
      wgmma_fence_operand(s);
      if (tile_full(q_first, q_rows, k0, min(kFbTile, skv - k0), causal,
                    window)) {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          s[i] = fast_exp2(s[i] * scale_log2 - lse2[(i % 4) >> 1]);
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = warp * 16 + g + 8 * ((i % 4) >> 1);
          const int kc = 8 * (i / 4) + 2 * qd + (i & 1);
          const bool ok = r < q_rows && k0 + kc < skv &&
                          visible(q_first + r, k0 + kc, causal, window);
          s[i] = ok ? fast_exp2(s[i] * scale_log2 - lse2[(i % 4) >> 1])
                    : 0.0f;
        }
      }
      wgmma_wait<0>();
      wgmma_fence_operand(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        dp[i] = s[i] * (dp[i] - dl[(i % 4) >> 1]);           // dS
      uint32_t da[4][4];
      pack_a(da, dp);
      wgmma_fence_operand(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<D>(acc, da[kk], T::mnmajor(k_addr, kk));   // dQ += dS.K
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_operand(da);
      wgmma_fence_operand(acc);
    }
    mbar_arrive(&empty[st]);
    if (++st == S) {
      st = 0;
      ph ^= 1;
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * 16 + g + 8 * hh;
    if (r >= q_rows) continue;
    __nv_bfloat16* row = dq + (row_base + r0 + r) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j + 2 * qd) = pack_bf16x2(
          acc[4 * j + 2 * hh] * scale, acc[4 * j + 2 * hh + 1] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kFbThreads, 1)
    fb_dkv_kernel(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_k,
                  const __grid_constant__ CUtensorMap map_v,
                  const __grid_constant__ CUtensorMap map_do,
                  const float* __restrict__ stats,
                  __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, int hq, int hkv,
                  int sq, int skv, float scale, float scale_log2,
                  int causal, int window) {
  using T = FbTile<D>;
  constexpr int S = kFbStages;
  extern __shared__ unsigned char fb_smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(fb_smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ks = smem;
  unsigned char* vs = ks + T::BYTES;
  unsigned char* ring = vs + T::BYTES;   // warpgroup c, stage st: Q, dO
  float* stat_s = reinterpret_cast<float*>(ring + 2 * S * 2 * T::BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(stat_s + 2 * S * kFbStats);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;             // [c * S + st]
  uint64_t* empty = bars + 1 + 2 * S;

  const int kvh = blockIdx.x, b = blockIdx.y, ik = blockIdx.z;
  const int rep = hq / hkv;
  const int n_qt = (sq + kFbTile - 1) / kFbTile;
  const int k0 = ik * kFbTile;
  const int k_rows = min(kFbTile, skv - k0);

  // item (r, iq) of warpgroup c: live for this key tile, r + iq of c's
  // parity
  auto mine = [&](int r, int iq, int c) {
    if (((r + iq) & 1) != c) return false;
    int lo, hi;
    live_tiles(iq * kFbTile, sq, skv, causal, window, lo, hi);
    return lo <= ik && ik < hi;
  };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int i = 0; i < 2 * S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_producer();
    // thread 0 feeds warpgroup 0 (and loads K, V), thread 32 warpgroup 1
    if (threadIdx.x % 32 == 0 && threadIdx.x < 64) {
      const int c = threadIdx.x / 32;
      tma_prefetch_map(&map_q);
      tma_prefetch_map(&map_do);
      if (c == 0) {
        tma_prefetch_map(&map_k);
        tma_prefetch_map(&map_v);
        mbar_arrive_tx(kv_full, 2 * T::BYTES);
        for (int hb = 0; hb < T::NB; ++hb) {
          tma_load_3d(ks + hb * T::BLOCK, &map_k, hb * T::CB, k0,
                      b * hkv + kvh, kv_full);
          tma_load_3d(vs + hb * T::BLOCK, &map_v, hb * T::CB, k0,
                      b * hkv + kvh, kv_full);
        }
      }
      // the stats are the dQ grid's (launched before this one, which may
      // start while it runs)
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      int st = 0;
      uint32_t ph = 0;
      for (int r = 0; r < rep; ++r)
        for (int iq = 0; iq < n_qt; ++iq) {
          if (!mine(r, iq, c)) continue;
          const int h = kvh * rep + r;
          const int slot = c * S + st;
          mbar_wait(&empty[slot], ph ^ 1);
          mbar_arrive_tx(&full[slot], 2 * T::BYTES + kFbStats * 4);
          unsigned char* qs_ = ring + slot * 2 * T::BYTES;
          for (int hb = 0; hb < T::NB; ++hb) {
            tma_load_3d(qs_ + hb * T::BLOCK, &map_q, hb * T::CB,
                        iq * kFbTile, b * hq + h, &full[slot]);
            tma_load_3d(qs_ + T::BYTES + hb * T::BLOCK, &map_do, hb * T::CB,
                        iq * kFbTile, b * hq + h, &full[slot]);
          }
          bulk_load(stat_s + slot * kFbStats,
                    stats + ((size_t)(b * hq + h) * n_qt + iq) * kFbStats,
                    kFbStats * 4, &full[slot]);
          if (++st == S) {
            st = 0;
            ph ^= 1;
          }
        }
    }
    return;
  }
  setmaxnreg_consumer();
  const int c = wg - 1, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32, g = lane / 4, qd = lane % 4;
  const uint32_t k_addr = smem_u32(ks), v_addr = smem_u32(vs);
  float dka[D / 2], dva[D / 2];
  zero(dka);
  zero(dva);
  mbar_wait(kv_full, 0);
  int st = 0;
  uint32_t ph = 0;
  for (int r = 0; r < rep; ++r)
    for (int iq = 0; iq < n_qt; ++iq) {
      if (!mine(r, iq, c)) continue;
      const int slot = c * S + st;
      mbar_wait(&full[slot], ph);
      const uint32_t q_addr = smem_u32(ring + slot * 2 * T::BYTES);
      const uint32_t do_addr = q_addr + T::BYTES;
      const float* sl = stat_s + slot * kFbStats;
      float s[32], dp[32];
      wgmma_fence_operand(s);
      wgmma_fence_operand(dp);
      wgmma_fence();
#pragma unroll
      for (int kq = 0; kq < D / 16; ++kq)
        wgmma_ss_n64(s, T::kmajor(k_addr, kq), T::kmajor(q_addr, kq),
                     kq > 0);
      wgmma_commit();
#pragma unroll
      for (int kq = 0; kq < D / 16; ++kq)
        wgmma_ss_n64(dp, T::kmajor(v_addr, kq), T::kmajor(do_addr, kq),
                     kq > 0);
      wgmma_commit();
      // rows 16 warp + g (+ 8): keys; columns 8 j + 2 qd (+ 1): queries
      const int q0 = iq * kFbTile;
      const int q_rows = min(kFbTile, sq - q0);
      const int q_first = skv - sq + q0;
      float l2[16];                          // the columns' lse2
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 v2 =
            *reinterpret_cast<const float2*>(sl + 8 * j + 2 * qd);
        l2[2 * j] = v2.x;
        l2[2 * j + 1] = v2.y;
      }
      wgmma_wait<1>();                      // S^T; P^T while dP^T runs
      wgmma_fence_operand(s);
      if (tile_full(q_first, q_rows, k0, k_rows, causal, window)) {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          s[i] = fast_exp2(s[i] * scale_log2 - l2[2 * (i / 4) + (i & 1)]);
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int kr = warp * 16 + g + 8 * ((i % 4) >> 1);
          const int qi = 8 * (i / 4) + 2 * qd + (i & 1);
          const bool ok = kr < k_rows && qi < q_rows &&
                          visible(q_first + qi, k0 + kr, causal, window);
          s[i] = ok ? fast_exp2(s[i] * scale_log2 -
                                l2[2 * (i / 4) + (i & 1)])
                    : 0.0f;
        }
      }
      uint32_t pa[4][4], da[4][4];
      pack_a(pa, s);
      wgmma_fence_operand(dva);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)                   // dV += P^T . dO
        wgmma_rs<D>(dva, pa[kk], T::mnmajor(do_addr, kk));
      wgmma_commit();
#pragma unroll
      for (int j = 0; j < 8; ++j) {                    // the columns' D
        const float2 v2 =
            *reinterpret_cast<const float2*>(sl + kFbTile + 8 * j + 2 * qd);
        l2[2 * j] = v2.x;
        l2[2 * j + 1] = v2.y;
      }
      wgmma_wait<1>();                      // dP^T; dS^T while dV runs
      wgmma_fence_operand(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        dp[i] = s[i] * (dp[i] - l2[2 * (i / 4) + (i & 1)]);
      pack_a(da, dp);
      wgmma_fence_operand(dka);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)                   // dK += dS^T . Q
        wgmma_rs<D>(dka, da[kk], T::mnmajor(q_addr, kk));
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_fence_operand(pa);
      wgmma_fence_operand(da);
      wgmma_fence_operand(dva);
      wgmma_fence_operand(dka);
      mbar_arrive(&empty[slot]);
      if (++st == S) {
        st = 0;
        ph ^= 1;
      }
    }

  // warpgroup 1's partials through its own (drained) ring into warpgroup
  // 0's, then warpgroup 0 writes the tile
  float* red = reinterpret_cast<float*>(ring + S * 2 * T::BYTES);
  if (c == 1) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      red[i * 128 + t] = dka[i];
      red[(D / 2 + i) * 128 + t] = dva[i];
    }
  }
  consumers_sync();
  if (c == 1) return;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dka[i] += red[i * 128 + t];
    dva[i] += red[(D / 2 + i) * 128 + t];
  }
  const size_t kv_base = ((size_t)b * hkv + kvh) * skv;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int kr = warp * 16 + g + 8 * hh;
    if (kr >= k_rows) continue;
    __nv_bfloat16* dkrow = dk + (kv_base + k0 + kr) * D;
    __nv_bfloat16* dvrow = dv + (kv_base + k0 + kr) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(dkrow + 8 * j + 2 * qd) = pack_bf16x2(
          dka[4 * j + 2 * hh] * scale, dka[4 * j + 2 * hh + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvrow + 8 * j + 2 * qd) =
          pack_bf16x2(dva[4 * j + 2 * hh], dva[4 * j + 2 * hh + 1]);
    }
  }
}

// The map of a (planes, rows, D) bf16 tensor, box (CB, 64, 1) under the
// tile's swizzle; rows past `rows` (and planes past `planes`) read zeros.
template <int D>
int fb_map(CUtensorMap* m, const void* p, int rows, int planes) {
  using T = FbTile<D>;
  const TensorMapEncodeFn encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)T::CB, (cuuint32_t)kFbTile, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(
      m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      T::SPAN == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D>
int launch_fb(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, void* stats, void* dq,
              void* dk, void* dv, int batch, int hq, int hkv, int sq,
              int skv, float scale, int causal, int window,
              cudaStream_t stream) {
  using bf = __nv_bfloat16;
  CUtensorMap mq, mk, mv, mdo;
  int rc = fb_map<D>(&mq, q, sq, batch * hq);
  if (!rc) rc = fb_map<D>(&mdo, dout, sq, batch * hq);
  if (!rc) rc = fb_map<D>(&mk, k, skv, batch * hkv);
  if (!rc) rc = fb_map<D>(&mv, v, skv, batch * hkv);
  if (rc) return rc;
  constexpr int dq_smem = dq_smem_bytes<D>();
  constexpr int dkv_smem = dkv_smem_bytes<D>();
  auto dqk = fb_dq_kernel<D>;
  auto dkv = fb_dkv_kernel<D>;
  REPRO_SMEM_OPT_IN(dqk, dq_smem);
  REPRO_SMEM_OPT_IN(dkv, dkv_smem);
  const float scale_log2 = scale * kLog2e;
  dqk<<<dim3(hq, batch, (sq + 2 * kFbTile - 1) / (2 * kFbTile)), kFbThreads,
        dq_smem, stream>>>(mq, mk, mv, mdo, static_cast<const bf*>(o),
                           static_cast<const bf*>(dout),
                           static_cast<const float*>(lse),
                           static_cast<float*>(stats), static_cast<bf*>(dq),
                           hq, hkv, sq, skv, scale, scale_log2, causal,
                           window);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  // a programmatic dependent launch: its blocks fill the SMs the dQ grid's
  // last wave frees, and wait for its stats in the kernel
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(hkv, batch, (skv + kFbTile - 1) / kFbTile);
  cfg.blockDim = dim3(kFbThreads);
  cfg.dynamicSmemBytes = dkv_smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = (int)cudaLaunchKernelEx(&cfg, dkv, mq, mk, mv, mdo,
                               static_cast<const float*>(stats),
                               static_cast<bf*>(dk), static_cast<bf*>(dv), hq,
                               hkv, sq, skv, scale, scale_log2, causal,
                               window);
  if (rc) return rc;
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro

// bfloat16 only, 16-byte aligned operands.  stats: (B * hq * ceil(Sq /
// 64) * 128) f32 scratch the call fills (each 64-row query tile's lse in
// log2 units and D).  window 0: no sliding window; causal 0: no causal
// mask.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* stats, void* dq, void* dk,
    void* dv, int batch, int hq, int hkv, int sq, int skv, int head_dim,
    float scale, int causal, int window, void* stream) {
  using namespace repro;
  if (batch < 1 || sq < 1 || skv < 1 || hkv < 1 || hq % hkv ||
      batch > 65535 || hq > 65535 ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout |
       (uintptr_t)stats) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch_fb<32>(q, k, v, o, dout, lse, stats, dq, dk, dv, batch,
                           hq, hkv, sq, skv, scale, causal, window, s);
    case 64:
      return launch_fb<64>(q, k, v, o, dout, lse, stats, dq, dk, dv, batch,
                           hq, hkv, sq, skv, scale, causal, window, s);
    case 128:
      return launch_fb<128>(q, k, v, o, dout, lse, stats, dq, dk, dv, batch,
                            hq, hkv, sq, skv, scale, causal, window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
