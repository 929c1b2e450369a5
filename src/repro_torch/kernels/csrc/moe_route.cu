// MoE routing and combine for Hopper (sm_90a).
//
// Not a port of a TPU kernel: the reference routes and combines in XLA
// (src/repro/models/moe.py:64-118, _route and _dispatch_compute's
// gather / scatter-add), with no Pallas kernel.  Both are kernels here so
// that a serving tick routes on the device, reads nothing back on the host
// and stays one CUDA graph replay.
//
// moe_route_kernel<T, PRODUCT>: one launch, one thread-block cluster of
// C CTAs, 16 tokens a CTA (C = 1 for a decode tick of up to 16 rows, 16 for
// a 4 x 64 chunk; at most 16, and then more tokens a CTA).  CTA r takes a
// contiguous range of tokens; the tokens form routing groups of S (a row's
// chunk).
//   1. The router's logits, PRODUCT only, 64 tokens at a time: bf16 on
//      dense_mma_tile.cuh's own ring and fragment code (the router (d, E)
//      and the tokens' x rows stream through cp.async stages; every
//      output is one warp's mma.sync m16n8k16 fragment summed from zero
//      over k16 steps in increasing order), its decode tile widened to
//      64 experts for a block of at most 16 tokens, its mid tile above, so
//      the logits are bitwise dense_matmul's; float32: each output's 32
//      fmaf chains and their sums in dense_tile.cuh's order, bitwise its
//      f32 tile.  They are written out in x's dtype (the aux loss reads
//      them) and kept in shared memory.  Without PRODUCT the kernel reads
//      the logits it is given.
//   2. A warp a token: f32 softmax (max, expf, a warp sum, one division),
//      the probabilities staged in shared memory, and top-k by rank: each
//      expert's lane counts the experts that route_better puts ahead of
//      it, ranks below k are the top-k in j order (ties to the lower
//      index, jax.lax.top_k's rule; NaN last), the k weights renormalised
//      by max(their sum in j order, 1e-9).
//   3. Positions.  pos = the group's earlier live assignments (flat (s, j)
//      order) of the same expert, keep = pos < capacity; dead tokens
//      (s >= q_lens[b]) take no place.  Each warp walks its span of the
//      CTA's assignments 32 at a time: __match_any_sync on (group, expert)
//      gives a lane its rank among the same keys, and a per-expert carry
//      in shared memory continues the span's open group.  A warp whose
//      span starts inside a group adds the earlier warps' counts of that
//      group; the CTA's first group adds the earlier CTAs' counts.
//   4. Layout, expert after expert and within an expert in flat order:
//      slot = offsets[e] + the kept assignments of e before it.  Each CTA
//      publishes three counts an expert in shared memory (its first
//      group's live ones, its last group's, and the kept ones outside its
//      first group, which do not depend on the other CTAs), the cluster
//      crosses ONE barrier, and each CTA reads the others' (distributed
//      shared memory) to get its carry, the kept assignments before it and
//      every expert's count; offsets by a warp scan; each warp's kept
//      ones are numbered by a second __match_any_sync walk.  A second
//      arrive / wait pair only keeps every CTA's shared memory alive until
//      the others have read it.  No global ticket, no atomic, no
//      __threadfence: every count is a __match_any_sync set's size, added
//      by its last lane; every sum is an integer count.  A lone
//      CTA with at most 32 assignments (a decode tick) does 3-4 in one
//      warp: one __match_any_sync for the positions, one for the rows.
// What bounds it: at decode, latency: the product's chain of dependent
// mma steps (96 at granite's d = 1536, 384 at mixtral's 6144; bitwise
// dense_matmul's forbids splitting it), then the routing's warp-serial
// steps; it reads x and the router once and writes O(T k) ints.  The ring
// keeps the chain off DRAM; more CTAs (16 tokens each) shorten the rest.
//
// moe_combine_kernel: a block a (token, 128-column strip), a thread a
// column:
//   out[t, c] = sum_j y[slot[t, j], c] * w[t, j]
// with the reference's roundings (moe.py:110-117): the weight and each
// product rounded to y's dtype, the sum from zero in that dtype in j
// order, a dropped assignment (slot < 0) adding nothing; no atomics
// (__fmul_rn / __fadd_rn: no FMA contraction in float32).  Served steps
// take the same sum inside rmsnorm.cu's combine_add_rmsnorm; this kernel
// stays as its yardstick.  What bounds it: the bytes, k rows of y read
// and one written a token.
#include <cooperative_groups.h>

#include <algorithm>
#include <climits>
#include <cmath>

#include "dense_mma_tile.cuh"

REPRO_ERROR_STRING_FN

namespace cg = cooperative_groups;

namespace repro {

constexpr int kRouteThreads = 256;
constexpr int kRouteWarps = kRouteThreads / 32;
constexpr int kMaxExperts = 64;      // two a lane
constexpr int kMaxCluster = 16;      // CTAs (non-portable above 8)
constexpr int kBlockTok = 64;        // tokens of one product block
constexpr int kCtaTok = 16;          // tokens a CTA takes by default
constexpr int kRouteSmemMax = 210 * 1024;

// a better than b: the higher weight, or the same and the lower index
__device__ __forceinline__ bool route_better(float ka, int ia, float kb,
                                             int ib) {
  return ka > kb || (ka == kb && ia < ib);
}

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The product's tiles: dense_matmul's decode tile widened to 64 experts
// (8 warps of one 16 x 8 fragment) for a block of at most 16 tokens, its
// mid tile (4 x 2 warps of 16 x 32) above.  Every output is the same
// fragment chain in either, so the logits are bitwise dense_matmul's.
using RouteMmaDecode = MmaTile<16, 64, 1, 8, 128, 6>;
using RouteMmaMid = MmaTile<64, 64, 4, 2, 64, 4>;
constexpr int kRingBytes =
    RouteMmaDecode::smem_bytes<1>() > RouteMmaMid::smem_bytes<1>()
        ? RouteMmaDecode::smem_bytes<1>()
        : RouteMmaMid::smem_bytes<1>();
static_assert(RouteMmaDecode::kThreads == kRouteThreads &&
                  RouteMmaMid::kThreads == kRouteThreads &&
                  RouteMmaDecode::BN == kMaxExperts &&
                  RouteMmaMid::BN == kMaxExperts && RouteMmaMid::BM ==
                  kBlockTok, "");

// The logits of tokens b0 .. b0 + nb - 1, bf16: dense_mma_tile.cuh's ring
// (cp.async stages, ldmatrix, mma.sync m16n8k16 from +0 in increasing k16
// steps), written out in x's dtype and kept in shared memory as f32.
template <class C>
__device__ __forceinline__ void route_product_tile(
    const __nv_bfloat16* __restrict__ x,
    const __nv_bfloat16* __restrict__ router,
    __nv_bfloat16* __restrict__ logits, float* s_logit, __nv_bfloat16* ring,
    int b0, int nb, int d, int n_exp, bool vec_x, bool vec_w) {
  constexpr int kStage = C::template stage_elems<1>();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int n_kt = (d + C::BK - 1) / C::BK;
  const int n_tok = b0 + nb;           // rows from here on load as zeros
  float acc[1][C::kFragM][C::kFragN][4];
#pragma unroll
  for (int i = 0; i < C::kFragM; ++i)
#pragma unroll
    for (int j = 0; j < C::kFragN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][i][j][e] = 0.0f;
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < n_kt)
      dense_mma_load<C, 1>(ring + s * kStage, x, router, router, n_tok, d,
                           n_exp, b0, 0, s * C::BK, vec_x, vec_w);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<C::STAGES - 2>();    // stage kt has landed
    __syncthreads();                   // ... for every thread; kt - 1 free
    const int nk = kt + C::STAGES - 1;
    if (nk < n_kt)
      dense_mma_load<C, 1>(ring + (nk % C::STAGES) * kStage, x, router,
                           router, n_tok, d, n_exp, b0, 0, nk * C::BK, vec_x,
                           vec_w);
    cp_async_commit();
    dense_mma_stage<C, 1>(ring + (kt % C::STAGES) * kStage, kt * C::BK, d,
                          wm, wn, lane, acc);
  }
  cp_async_wait<0>();
  __syncthreads();                     // the ring is free for the next block
  // a lane holds rows g and g + 8 (g = lane / 4) of columns 2 (lane % 4)
  // and + 1 of each fragment
#pragma unroll
  for (int i = 0; i < C::kFragM; ++i)
#pragma unroll
    for (int j = 0; j < C::kFragN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = wm * C::kWarpM + i * 16 + (lane >> 2) + 8 * (e >> 1);
        const int col = wn * C::kWarpN + j * 8 + 2 * (lane & 3) + (e & 1);
        if (row >= nb || col >= n_exp) continue;
        const __nv_bfloat16 v = from_f32<__nv_bfloat16>(acc[0][i][j][e]);
        logits[(size_t)(b0 + row) * n_exp + col] = v;
        s_logit[row * kMaxExperts + col] = to_f32(v);
      }
}

// bf16: the decode tile for a block of at most 16 tokens, as dense_matmul
// picks it at that count, else the mid tile.  vec: d % 8 == 0 and x 16-byte
// aligned (x's chunks), E % 8 == 0 and the router 16-byte aligned (its).
__device__ __forceinline__ void route_product_block(
    const __nv_bfloat16* __restrict__ x,
    const __nv_bfloat16* __restrict__ router,
    __nv_bfloat16* __restrict__ logits, float* s_logit, __nv_bfloat16* ring,
    int b0, int nb, int d, int n_exp) {
  const bool vec_x = d % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_w =
      n_exp % 8 == 0 && reinterpret_cast<uintptr_t>(router) % 16 == 0;
  if (nb <= RouteMmaDecode::BM)
    route_product_tile<RouteMmaDecode>(x, router, logits, s_logit, ring, b0,
                                       nb, d, n_exp, vec_x, vec_w);
  else
    route_product_tile<RouteMmaMid>(x, router, logits, s_logit, ring, b0, nb,
                                    d, n_exp, vec_x, vec_w);
}

// float32: an output a thread, in dense_tile.cuh's order: warp w's lane
// quarter q sums rows g * 128 + 32 q .. + 31 of the groups g = w, w + 8,
// ... in order by fmaf from +0; a warp adds its quarters in order, and the
// 8 warp sums are added in warp order from +0.
__device__ __forceinline__ void route_product_block(
    const float* __restrict__ x, const float* __restrict__ router,
    float* __restrict__ logits, float* s_logit, __nv_bfloat16*, int b0,
    int nb, int d, int n_exp) {
  const int n_groups = (d + 127) / 128;
  for (int o = threadIdx.x; o < nb * n_exp; o += kRouteThreads) {
    const int row = o / n_exp, e = o % n_exp;
    const float* xr = x + (size_t)(b0 + row) * d;
    float total = 0.0f;
    for (int w = 0; w < 8; ++w) {
      float sw = 0.0f;
      for (int q = 0; q < 4; ++q) {
        float part = 0.0f;
        for (int g = w; g < n_groups; g += 8) {
          const int r0 = g * 128 + q * 32;
          const int nr = max(0, min(32, d - r0));
          for (int r = 0; r < nr; ++r)
            part = fmaf(xr[r0 + r], router[(size_t)(r0 + r) * n_exp + e],
                        part);
        }
        sw = q == 0 ? part : sw + part;
      }
      total += sw;
    }
    logits[(size_t)(b0 + row) * n_exp + e] = total;
    s_logit[row * kMaxExperts + e] = total;
  }
}

struct RouteArgs {
  const void* x;           // (T, d) or null: the logits are given
  const void* router;      // (d, E) in x's dtype
  void* logits;            // (T, E): written with x, read without
  const int* q_lens;       // (T / S,) or null
  float* topw;
  int* topi;
  int* slot;
  int* counts;
  int* offsets;
  int* rows;
  int n_tok, d, group, n_exp, k, cap, tpc;   // tpc: tokens a CTA
};

template <typename T, bool PRODUCT>
__global__ void __launch_bounds__(kRouteThreads)
    moe_route_kernel(const RouteArgs args) {
  extern __shared__ __align__(16) unsigned char route_smem[];
  __shared__ float s_prob[kRouteWarps][kMaxExperts];
  __shared__ float s_selw[kRouteWarps][32];
  __shared__ int s_seli[kRouteWarps][32];
  __shared__ int s_carry[kRouteWarps][kMaxExperts];   // a span's open group
  __shared__ int s_first[kRouteWarps][kMaxExperts];   // its first group's
  __shared__ int s_cin[kRouteWarps][kMaxExperts];     // earlier warps' part
  __shared__ int s_kw[kRouteWarps][kMaxExperts];      // kept, then bases
  __shared__ int s_gf[kRouteWarps], s_gl[kRouteWarps];
  __shared__ int s_pub[3][kMaxExperts];   // what the cluster reads
  __shared__ int s_cc[kMaxExperts], s_kin[kMaxExperts], s_cnt[kMaxExperts],
      s_off[kMaxExperts];

  cg::cluster_group cluster = cg::this_cluster();
  const int n_cta = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int E = args.n_exp, K = args.k, S = args.group, cap = args.cap;
  const int tok0 = min(rank * args.tpc, args.n_tok);
  const int tok1 = min(tok0 + args.tpc, args.n_tok);
  const int n_a = (tok1 - tok0) * K;
  const int n_a_max = args.tpc * K;
  int* s_pos = reinterpret_cast<int*>(route_smem);
  unsigned char* s_topi =
      route_smem + ((4 * (size_t)n_a_max + 15) & ~(size_t)15);
  float* s_logit = reinterpret_cast<float*>(
      s_topi + ((n_a_max + 15) & ~15));
  __nv_bfloat16* ring =
      reinterpret_cast<__nv_bfloat16*>(s_logit + kBlockTok * kMaxExperts);
  const T* x = static_cast<const T*>(args.x);
  T* logits = static_cast<T*>(args.logits);

  for (int i = tid; i < kRouteWarps * kMaxExperts; i += kRouteThreads) {
    (&s_kw[0][0])[i] = 0;
    (&s_carry[0][0])[i] = 0;
    (&s_first[0][0])[i] = 0;
  }

  // 1-2. the logits and each token's top-k, kBlockTok tokens at a time
  for (int b0 = tok0; b0 < tok1; b0 += kBlockTok) {
    const int nb = min(kBlockTok, tok1 - b0);
    if constexpr (PRODUCT) {
      route_product_block(x, static_cast<const T*>(args.router), logits,
                          s_logit, ring, b0, nb, args.d, E);
      __syncthreads();
    }
    for (int s = warp; s < nb; s += kRouteWarps) {
      const size_t t = (size_t)b0 + s;
      const int e0 = lane, e1 = lane + 32;
      float v0 = -INFINITY, v1 = -INFINITY;
      if constexpr (PRODUCT) {
        if (e0 < E) v0 = s_logit[s * kMaxExperts + e0];
        if (e1 < E) v1 = s_logit[s * kMaxExperts + e1];
      } else {
        if (e0 < E) v0 = to_f32(logits[t * E + e0]);
        if (e1 < E) v1 = to_f32(logits[t * E + e1]);
      }
      const float m = warp_max(fmaxf(v0, v1));
      const float x0 = e0 < E ? expf(v0 - m) : 0.0f;
      const float x1 = e1 < E ? expf(v1 - m) : 0.0f;
      const float sum = warp_sum(x0 + x1);
      // a NaN weight (a poisoned row) ranks last but still gives an index
      float p0 = x0 / sum, p1 = x1 / sum;
      p0 = isnan(p0) ? -INFINITY : p0;
      p1 = isnan(p1) ? -INFINITY : p1;
      // staged with -inf past E, which ranks behind every expert
      float* prob = s_prob[warp];
      prob[e0] = e0 < E ? p0 : -INFINITY;
      prob[e1] = e1 < E ? p1 : -INFINITY;
      __syncwarp();
      int r0 = 0, r1 = 0;
#pragma unroll 4
      for (int e = 0; e < E; e += 4) {
        const float4 q = reinterpret_cast<const float4*>(prob)[e >> 2];
        r0 += route_better(q.x, e, p0, e0) + route_better(q.y, e + 1, p0, e0) +
              route_better(q.z, e + 2, p0, e0) +
              route_better(q.w, e + 3, p0, e0);
        r1 += route_better(q.x, e, p1, e1) + route_better(q.y, e + 1, p1, e1) +
              route_better(q.z, e + 2, p1, e1) +
              route_better(q.w, e + 3, p1, e1);
      }
      if (e0 < E && r0 < K) s_selw[warp][r0] = p0, s_seli[warp][r0] = e0;
      if (e1 < E && r1 < K) s_selw[warp][r1] = p1, s_seli[warp][r1] = e1;
      __syncwarp();
      float wsum = 0.0f;
#pragma unroll 8
      for (int j = 0; j < K; ++j) wsum = __fadd_rn(wsum, s_selw[warp][j]);
      if (lane < K) {
        const int i = s_seli[warp][lane];
        args.topw[t * K + lane] = s_selw[warp][lane] / fmaxf(wsum, 1e-9f);
        args.topi[t * K + lane] = i;
        s_topi[(t - tok0) * K + lane] = (unsigned char)i;
      }
      __syncwarp();                  // s_prob and s_sel free again
    }
    __syncthreads();
  }

  // 3. positions: each warp walks its span of the CTA's assignments
  auto group_of = [&](int i) { return (tok0 + i / K) / S; };
  auto live_of = [&](int i) {
    const int t = tok0 + i / K, g = t / S;
    const int len = args.q_lens != nullptr
                        ? min(max(args.q_lens[g], 0), S) : S;
    return t - g * S < len;
  };
  const unsigned lt = (1u << lane) - 1u;
  auto scan_offsets = [&]() {        // warp 0: s_off = exclusive scan of s_cnt
    const int a = 2 * lane < E ? s_cnt[2 * lane] : 0;
    const int b = 2 * lane + 1 < E ? s_cnt[2 * lane + 1] : 0;
    int v = a + b;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += n;
    }
    const int ex = v - a - b;
    if (2 * lane < E) s_off[2 * lane] = ex;
    if (2 * lane + 1 < E) s_off[2 * lane + 1] = ex + a;
  };
  if (n_cta == 1 && n_a <= 32) {     // one chunk (a decode tick): warp 0
    if (warp == 0) {                 // alone, the steps below in one walk
      const bool valid = lane < n_a;
      const int e = valid ? s_topi[lane] : 0;
      const bool live = valid && live_of(lane);
      const unsigned m = __match_any_sync(
          0xffffffffu, live ? (unsigned)group_of(lane) * kMaxExperts + e
                            : 0x80000000u | lane);
      const bool keep = live && __popc(m & lt) < cap;
      const unsigned mk = __match_any_sync(
          0xffffffffu, keep ? (unsigned)e : 0x80000000u | lane);
      s_cnt[lane] = 0;
      s_cnt[lane + 32] = 0;
      __syncwarp();
      if (keep && 31 - __clz(mk) == lane) s_cnt[e] = __popc(mk);
      __syncwarp();
      scan_offsets();
      __syncwarp();
      const int r = keep ? s_off[e] + __popc(mk & lt) : -1;
      if (valid) args.slot[lane] = r;
      if (keep) args.rows[r] = lane / K;
      for (int c = lane; c < E; c += 32) {
        args.counts[c] = s_cnt[c];
        args.offsets[c] = s_off[c];
      }
    }
    return;
  }
  const int n_ch = (n_a + 31) / 32, per = (n_ch + kRouteWarps - 1) /
                                          kRouteWarps;
  const int c0 = min(warp * per, n_ch), c1 = min(c0 + per, n_ch);
  {
    int* carry = s_carry[warp];
    int* first = s_first[warp];
    const int gF = c0 < c1 ? group_of(c0 * 32) : -1;
    int gC = gF;
    for (int c = c0; c < c1; ++c) {
      const int i = c * 32 + lane;
      const bool valid = i < n_a;
      const int e = valid ? s_topi[i] : 0;
      const int g = valid ? group_of(i) : INT_MAX;
      const bool live = valid && live_of(i);
      const unsigned key = live ? (unsigned)g * kMaxExperts + e
                                : 0x80000000u | lane;
      const unsigned m = __match_any_sync(0xffffffffu, key);
      const int pos = __popc(m & lt) + (g == gC ? carry[e] : 0);
      if (valid) s_pos[i] = live ? pos : INT_MAX;
      const int g_last = __shfl_sync(0xffffffffu, g, min(31, n_a - 1 - c * 32));
      const bool first_ends = g_last != gC && gC == gF;
      __syncwarp();
      if (first_ends) {
        first[lane] = carry[lane];
        first[lane + 32] = carry[lane + 32];
      }
      __syncwarp();
      if (g_last != gC) carry[lane] = 0, carry[lane + 32] = 0;
      __syncwarp();
      if (live && 31 - __clz(m) == lane) {   // the last lane of its key
        if (g == g_last) carry[e] = pos + 1;
        if (first_ends && g == gF) first[e] = pos + 1;
      }
      __syncwarp();
      gC = g_last;
    }
    if (c0 < c1 && gC == gF) {     // one group: the whole span
      first[lane] = carry[lane];
      first[lane + 32] = carry[lane + 32];
    }
    if (lane == 0) s_gf[warp] = gF, s_gl[warp] = gC;
  }
  __syncthreads();
  // a warp's carry-in: the earlier warps' counts of the group it starts in
  for (int o = tid; o < kRouteWarps * kMaxExperts; o += kRouteThreads) {
    const int w = o / kMaxExperts, e = o % kMaxExperts;
    int cin = 0;
    if (s_gf[w] >= 0)
      for (int v = w - 1; v >= 0 && s_gl[v] == s_gf[w]; --v) {
        cin += s_carry[v][e];
        if (s_gf[v] != s_gf[w]) break;
      }
    s_cin[w][e] = cin;
  }
  int w_last = 0;                    // the CTA's last warp with a span
  while (w_last + 1 < kRouteWarps && s_gf[w_last + 1] >= 0) ++w_last;
  const int gF_cta = s_gf[0], gL_cta = s_gl[w_last];
  if (tid < E) {                     // its first and last groups' counts
    int f = 0, l = 0;
    for (int w = 0; w <= w_last && s_gf[w] == gF_cta; ++w) {
      f += s_first[w][tid];
      if (s_gl[w] != gF_cta) break;
    }
    for (int w = w_last; w >= 0 && s_gl[w] == gL_cta; --w) {
      l += s_carry[w][tid];
      if (s_gf[w] != gL_cta) break;
    }
    s_pub[0][tid] = f;
    s_pub[1][tid] = l;
  }
  __syncthreads();
  // positions within the CTA, and each warp's kept ones outside the CTA's
  // first group (an expert's count by its last lane: no atomic)
  {
    int* kr = s_first[warp];         // free: the first groups are counted
    kr[lane] = 0;
    kr[lane + 32] = 0;
    __syncwarp();
    for (int c = c0; c < c1; ++c) {
      const int i = c * 32 + lane;
      int p = i < n_a ? s_pos[i] : INT_MAX;
      const int e = i < n_a ? s_topi[i] : 0;
      bool kept = false;
      if (p != INT_MAX) {
        const int g = group_of(i);
        p += g == s_gf[warp] ? s_cin[warp][e] : 0;
        s_pos[i] = p;
        kept = g != gF_cta && p < cap;
      }
      const unsigned m = __match_any_sync(
          0xffffffffu, kept ? (unsigned)e : 0x80000000u | lane);
      if (kept && 31 - __clz(m) == lane) kr[e] += __popc(m);
      __syncwarp();
    }
  }
  __syncthreads();
  if (tid < E) {
    int kr = 0;
    for (int w = 0; w < kRouteWarps; ++w) kr += s_first[w][tid];
    s_pub[2][tid] = kr;
  }
  __syncthreads();

  // 4. the cluster's one exchange
  cluster_arrive_release();
  cluster_wait();
  if (tid < E) {
    const int e = tid;
    int run = 0, open_g = -1, kin = 0;
    for (int c = 0; c < n_cta; ++c) {
      const int* pub = cluster.map_shared_rank(&s_pub[0][0], c);
      const int f = pub[e], l = pub[kMaxExperts + e],
                kr = pub[2 * kMaxExperts + e];
      const int ct0 = min(c * args.tpc, args.n_tok);
      const int ct1 = min(ct0 + args.tpc, args.n_tok);
      if (ct0 >= ct1) break;
      const int cF = ct0 / S, cL = (ct1 - 1) / S;
      const int carry = cF == open_g ? run : 0;
      if (c == rank) s_cc[e] = carry, s_kin[e] = kin;
      kin += min(cap, carry + f) - min(cap, carry) + kr;
      run = cL == cF ? carry + f : l;
      open_g = cL;
    }
    s_cnt[e] = kin;
  }
  cluster_arrive_relaxed();          // done reading the others' counts
  __syncthreads();
  if (warp == 0) scan_offsets();
  __syncthreads();
  if (rank == 0 && tid < E) {
    args.counts[tid] = s_cnt[tid];
    args.offsets[tid] = s_off[tid];
  }
  // keep, with the earlier CTAs' carry; each warp's kept ones an expert
  {
    int* kw = s_kw[warp];            // zeroed at the start
    for (int c = c0; c < c1; ++c) {
      const int i = c * 32 + lane;
      int p = i < n_a ? s_pos[i] : INT_MAX;
      const int e = i < n_a ? s_topi[i] : 0;
      if (p != INT_MAX && group_of(i) == gF_cta) p += s_cc[e];
      const bool keep = p < cap;
      if (i < n_a) s_pos[i] = keep;
      const unsigned m = __match_any_sync(
          0xffffffffu, keep ? (unsigned)e : 0x80000000u | lane);
      if (keep && 31 - __clz(m) == lane) kw[e] += __popc(m);
      __syncwarp();
    }
  }
  __syncthreads();
  if (tid < E) {                     // each warp's first row an expert
    int run = s_off[tid] + s_kin[tid];
    for (int w = 0; w < kRouteWarps; ++w) {
      const int c = s_kw[w][tid];
      s_kw[w][tid] = run;
      run += c;
    }
  }
  __syncthreads();
  {
    int* base = s_kw[warp];
    const size_t a0 = (size_t)tok0 * K;
    for (int c = c0; c < c1; ++c) {
      const int i = c * 32 + lane;
      const bool valid = i < n_a;
      const bool keep = valid && s_pos[i];
      const int e = valid ? s_topi[i] : 0;
      const unsigned m = __match_any_sync(0xffffffffu,
                                          keep ? (unsigned)e
                                               : 0x80000000u | lane);
      int r = -1;
      if (keep) {
        r = base[e] + __popc(m & lt);
        args.rows[r] = tok0 + i / K;
      }
      if (valid) args.slot[a0 + i] = r;
      __syncwarp();
      if (keep && 31 - __clz(m) == lane) base[e] = r + 1;
      __syncwarp();
    }
  }
  cluster_wait();                    // no CTA leaves while others read it
}

size_t route_smem_bytes(int n_a_max, bool product, bool bf16) {
  size_t b = ((4 * (size_t)n_a_max + 15) & ~(size_t)15) +
             ((n_a_max + 15) & ~15);
  if (product) b += kBlockTok * kMaxExperts * sizeof(float);
  if (product && bf16) b += kRingBytes;
  return b;
}

template <typename T, bool PRODUCT>
int route_prepare_one() {
  auto kernel = moe_route_kernel<T, PRODUCT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kRouteSmemMax);
  return (int)e;
}

int route_prepare() {
  static int done = 0;
  if (done) return 0;
  int e = route_prepare_one<__nv_bfloat16, true>();
  if (e == 0) e = route_prepare_one<__nv_bfloat16, false>();
  if (e == 0) e = route_prepare_one<float, true>();
  if (e == 0) e = route_prepare_one<float, false>();
  if (e == 0) done = 1;
  return e;
}

template <typename T, bool PRODUCT>
int launch_route(const RouteArgs& args, int ctas, cudaStream_t s) {
  const size_t smem =
      route_smem_bytes(args.tpc * args.k, PRODUCT, sizeof(T) == 2);
  if (smem > (size_t)kRouteSmemMax) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(ctas, 1, 1);
  cfg.blockDim = dim3(kRouteThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t le =
      cudaLaunchKernelEx(&cfg, moe_route_kernel<T, PRODUCT>, args);
  if (le != cudaSuccess) return (int)le;
  return (int)cudaGetLastError();
}

constexpr int kCombineThreads = 128;
constexpr int kCombineLoads = 8;     // y loads a thread keeps in flight

// Block (token, column strip): a thread a column; its token's slots and
// weights in shared memory, the y loads of kCombineLoads assignments issued
// before the in-order sum uses them.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
    moe_combine_kernel(const T* __restrict__ y, const int* __restrict__ slot,
                       const float* __restrict__ topw, T* __restrict__ out,
                       int k, int d) {
  __shared__ int s_slot[32];
  __shared__ float s_w[32];
  const size_t t = blockIdx.x;
  const int c = blockIdx.y * kCombineThreads + threadIdx.x;
  if (threadIdx.x < k) {
    s_slot[threadIdx.x] = slot[t * k + threadIdx.x];
    s_w[threadIdx.x] = round_to<T>(topw[t * k + threadIdx.x]);
  }
  __syncthreads();
  if (c >= d) return;
  float acc = 0.0f;
  for (int j0 = 0; j0 < k; j0 += kCombineLoads) {
    float v[kCombineLoads];
#pragma unroll
    for (int q = 0; q < kCombineLoads; ++q) {
      const int s = j0 + q < k ? s_slot[j0 + q] : -1;
      v[q] = s >= 0 ? to_f32(y[(size_t)s * d + c]) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kCombineLoads; ++q) {
      if (j0 + q >= k || s_slot[j0 + q] < 0) continue;
      const float p = round_to<T>(__fmul_rn(v[q], s_w[j0 + q]));
      acc = round_to<T>(__fadd_rn(acc, p));
    }
  }
  out[t * d + c] = from_f32<T>(acc);
}

}  // namespace repro

// Sets the route kernels' cluster and shared-memory attributes, once (the
// launcher calls it too; called ahead so that a graph capture makes no
// such call).
extern "C" int moe_route_prepare() { return repro::route_prepare(); }

// x (n_tok, d) and router (d, n_exp) in x's dtype, or x null: the logits
// (n_tok, n_exp) are given.  With x the logits are written.  q_lens
// (n_tok / group,) int32 or null (every token live).  n_exp <= 64,
// k <= min(n_exp, 32) (the wrapper checks).  ctas: the cluster's CTAs, 0
// to take kCtaTok tokens a CTA, up to 16.
extern "C" int moe_route_launch(const void* x, const void* router,
                                void* logits, const int* q_lens, float* topw,
                                int* topi, int* slot, int* counts,
                                int* offsets, int* rows, int n_tok, int d,
                                int group, int n_exp, int k, int cap,
                                int ctas, int dtype, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_exp > kMaxExperts || k > 32 || k > n_exp || n_tok < 1 || group < 1 ||
      n_tok % group != 0 || ctas < 0 || ctas > kMaxCluster)
    return (int)cudaErrorInvalidValue;
  const int e = route_prepare();
  if (e != 0) return e;
  const bool product = x != nullptr;
  if (ctas == 0)
    ctas = std::min(kMaxCluster, (n_tok + kCtaTok - 1) / kCtaTok);
  ctas = std::min(ctas, n_tok);
  RouteArgs args{x, router, logits, q_lens, topw, topi, slot, counts,
                 offsets, rows, n_tok, d, group, n_exp, k, cap, 0};
  args.tpc = (n_tok + ctas - 1) / ctas;
  ctas = (n_tok + args.tpc - 1) / args.tpc;   // no CTA without tokens
  if (dtype == kBF16)
    return product ? launch_route<__nv_bfloat16, true>(args, ctas, s)
                   : launch_route<__nv_bfloat16, false>(args, ctas, s);
  return product ? launch_route<float, true>(args, ctas, s)
                 : launch_route<float, false>(args, ctas, s);
}

extern "C" int moe_combine_launch(const void* y, const int* slot,
                                  const float* topw, void* out, int n_tok,
                                  int k, int d, int dtype, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k > 32) return (int)cudaErrorInvalidValue;
  const dim3 grid(n_tok, (d + kCombineThreads - 1) / kCombineThreads);
  if (dtype == kBF16)
    moe_combine_kernel<__nv_bfloat16><<<grid, kCombineThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(y), slot, topw,
        static_cast<__nv_bfloat16*>(out), k, d);
  else
    moe_combine_kernel<float><<<grid, kCombineThreads, 0, s>>>(
        static_cast<const float*>(y), slot, topw, static_cast<float*>(out),
        k, d);
  return (int)cudaGetLastError();
}
