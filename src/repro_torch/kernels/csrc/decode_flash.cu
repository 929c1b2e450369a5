// Mixed prefill/decode flash attention over the slot or paged KV cache, with
// a float or an int8 cache, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/decode_flash.py::mixed_flash_attention_pallas
// (and decode_flash_attention_pallas, its q_lens = 1 case), all four of its
// operand variants.  Same contract: q (B, hq, C, d); lengths[b] is the valid
// context including this step's chunk and q_lens[b] the live queries; query
// j of row b sits at position lengths[b] - q_lens[b] + j.  Masks:
// intra-chunk causal, optional window, length; dead queries (j >= q_lens[b])
// return exact zeros.  Softmax statistics m, l and the accumulator are f32;
// probabilities are rounded to the activation dtype before the P.V
// contraction, as in the reference.
//
// Layouts (template flag PAGED):
//   slot   K/V (B, hkv, MAX, d); the KV tile is bk = kv_block_size(MAX,
//          block_kv), and logical tile ik of row b is cache rows
//          ik*bk .. ik*bk+bk-1 of that row;
//   paged  K/V pools (P, hkv, bs, d) and page_table (B, MAX/bs) int32; the
//          tile is the page (bk = bs), and key position p of row b is pool
//          block page_table[b, p / bs] at offset p % bs.  Every mask, split
//          and step is computed on logical positions exactly as for the slot
//          layout, so the reduction order depends only on the row's lengths
//          and bk, and paged equals slot bit for bit at block_kv = bs.
// K/V type: the activation dtype, or int8 with f32 per-token scales (same
// leading shape as the cache, last axis 1).  An int8 value converts exactly
// (to f32, and to bf16); the score is (q.k) * k_scale * scale in that
// order; l sums the probabilities before the V scale, and p * v_scale is
// rounded to the activation dtype before P.V (scale-after-dot, as the
// reference).  No key at or past lengths[b] is read (its staged copy is
// zero-filled), so a paged row never reads the null block or a block it
// has not leased, and an int8 tile is read at 1 byte per value plus 8 bytes
// of scales per key.
//
// bfloat16: the tensor-core kernel (mixed_flash_mma_kernel below).
//
//   The split rule.  The key axis of each row is cut into splits of `span`
//   keys from key 0, span = bk * max(1, 128 / bk) (KV_SPLIT_KEYS in
//   decode_flash.py; 64 < span <= 128 for bk in 8..128), a function of the
//   tile alone and the same in both layouts.  A split is walked in
//   online-softmax steps of 64 keys from its first key (the second step of
//   a split shorter than 128 keys is partial, its tail masked).  Each split
//   keeps its own m, l and acc; a second kernel (mixed_flash_fold_kernel)
//   folds, for each query, the splits that hold a key it sees, in
//   increasing split order, by one fixed fold (m' = max(m, m_s), l' =
//   l a + l_s c, acc' = acc a + acc_s c, a = 2^(m - m'), c = 2^(m_s - m')),
//   then divides.  A split the query sees nothing of is not folded, which
//   is what folding its empty state would give (alpha = 1, contribution 0).
//
//   Work split.  One block of 4 warps per (split, 64 query rows, KV head,
//   batch row); GQA is packed as in the reference: query row r of a KV
//   head is (group head r / C, chunk position r % C), so each K/V byte
//   serves all rep heads, and a warp owns 16 rows: an m16 A fragment of Q,
//   loaded once with ldmatrix.  Q.K^T and P.V run on mma.sync m16n8k16
//   (bf16 operands, f32 accumulation), as kernel 7's bf16 kernel
//   (flash_attention.cu): K feeds the B fragments with ldmatrix, V with
//   ldmatrix.trans, and the score fragment of keys 16kk..16kk+15, rounded
//   to bf16 pairs in registers, is P.V's A fragment of k16 step kk.  Steps
//   and fragments are cut by key position, and a page is only where a
//   key's bytes live: a 16-token page is one k16 step of P.V and two n8
//   fragments of Q.K^T, an 8-token page half a step, and no lane idles
//   for a page size (pages of 8 to 128 tokens; nothing is masked for a
//   page below 16).  A block stages its whole split in shared memory
//   with cp.async, zero-filled outside the keys its rows see: Q with the
//   first step's K, then that step's V, then the second step's K and V, as
//   four commit groups, all in flight at once (a two-stage ring that never
//   wraps), so the first step's scores overlap the rest of the loads.  An
//   int8 step lands as int8 and is converted to bf16 in shared memory
//   (exact) before ldmatrix; its k_scale multiplies the score fragment per
//   key column after the dot and its v_scale p per key before the bf16
//   rounding.  A block whose rows see no key of its split exits at once,
//   and a warp skips a step none of its rows sees (fully masked: its
//   state would not change).
//
//   Why rows stay bitwise.  A query row's arithmetic depends only on its q
//   row, the K/V of the keys it sees, its [lo, hi) key range (from its
//   position, lengths, window) and the fixed split and step grid anchored
//   at key 0 -- never on B, C, the other rows, the SM count or the grid.
//   A tensor core's result for a row does not depend on the other rows of
//   its fragment, a masked key gives p = 0 whatever the staged value, and
//   a step or split with no visible key leaves m, l and acc bitwise
//   unchanged (alpha = 2^0 = 1, p = 0).  So query j of a C-wide chunk
//   equals the C = 1 decode at length q_pos + 1, and a row alone equals
//   the row inside any batch.
//
//   What bounds it.  At decode the live K/V bytes (2 * length * hkv * d *
//   sizeof(KV) per row, plus 8 bytes per key and head for int8) are a few
//   MB at most, a microsecond of the card's bandwidth: the time is the
//   latency of one split's loads into one SM plus two launches, so the
//   split spreads a row over up to MAX / span blocks.  At C = 64 the
//   operations (4 d per visible pair) are still far under a microsecond
//   of the tensor cores; the K/V a block stages is reread from L2 by the
//   rep * C / 64 row blocks of a head.
//
//   Scratch: f32 (m, l) and acc per (row, KV head, split, query row), in
//   buffers the wrapper allocates; a chunk whose scratch would pass the
//   wrapper's budget is launched in slices of its queries (the rows'
//   arithmetic does not move).  The wrapper counts the two kernels as one
//   launch.
//
//   Head dim 256 (gemma-2b).  The output accumulator is ND x 4 = 128 f32
//   registers a thread there; Q's KS = 16 A fragments held beside it (64
//   more, and the score tile's 32) would spill under the 128-thread
//   bound.  So at D > 128 each warp loads Q's A fragment of k16 step ks
//   from Q's shared region with ldmatrix right before that step's
//   products, every step of every live tile: the same operands and
//   products in the same order, so no bit moves.  Shared memory at 256:
//   fp 32 K (Q) + 2 x 64 K (a split's K and V) = 160 KB; int8 also 2 x 32
//   K of int8 rows and 1 K of scales, 230,400 B, which with the 96 bytes of
//   static arrays (warp_lo, warp_hi, pages) stays under the 232,448 B a
//   block may opt into: one block an SM.  The fold kernel takes kDpl = 8.
//   The float32 kernel would stage 2 x 128 x 260 x 4 B = 266 KB of K/V
//   tiles at 256 and is not instantiated there; its wrapper refuses it.
//
//   -Xptxas -v (sm_90a), registers a thread at d = 32 / 64 / 128 / 256,
//   one barrier, 128 bytes of static shared memory (the warps' key ranges
//   and the split's pages), and the dynamic shared memory of a split:
//     fp K/V:    96 / 128 / 168 / 255 registers, no spills at 256; 20 / 40
//                / 80 / 160 KB (2 blocks an SM at 128, 1 at 256)
//     int8 K/V:  the same registers to 128, 246 at 256 (slot int8 at d =
//                32: 4 bytes spilled); 29 / 57 / 113 / 225 KB
//     fold:      32 / 40 / 40 / 40 registers, no shared memory, no spills.
//
// float32: the CUDA-core kernel (mixed_flash_kernel): one block per (32
// query rows, KV head, batch row) walks the row's live KV tiles in order
// with one online softmax (natural exp, no split); K and V tiles are
// staged in shared memory with a 16-byte row pad; each warp owns 4 query
// rows, lane l scores keys l, l + 32, ... with a sequential f32 dot over d
// and owns d/32 output dimensions of the P.V product.  Its rows are
// bitwise batch- and chunk-invariant for the same reason (tiles anchored
// at key 0, masked tiles change nothing).  -Xptxas -v: 64 to 128
// registers; the d = 32 and the fp d = 128 slot instantiations spill 12 to
// 68 bytes.
#include <climits>
#include <type_traits>

#include "mma.cuh"

REPRO_ERROR_STRING_FN

namespace repro {

__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}

constexpr int kAttnThreads = 256;
constexpr int kAttnWarps = kAttnThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kAttnRows = kAttnWarps * kRowsPerWarp;   // query rows / block
constexpr int kMaxBk = 128;
constexpr int kKeysPerLane = kMaxBk / 32;
constexpr float kNegInf = -1e30f;

template <typename KV>
constexpr bool kIsInt8 = std::is_same<KV, int8_t>::value;

// K and V tiles (padded rows), the f32 query rows, and for int8 the tile's
// K and V scales.
template <typename KV, int D>
constexpr int attn_smem_bytes(int bk) {
  return 2 * bk * (D + 16 / (int)sizeof(KV)) * (int)sizeof(KV) +
         kAttnRows * D * (int)sizeof(float) +
         (kIsInt8<KV> ? 2 * bk * (int)sizeof(float) : 0);
}

template <typename T, typename KV, int D, bool PAGED>
__global__ void __launch_bounds__(kAttnThreads)
    mixed_flash_kernel(const T* __restrict__ q, const KV* __restrict__ k_cache,
                       const KV* __restrict__ v_cache,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ page_table,
                       const int* __restrict__ lengths,
                       const int* __restrict__ q_lens, T* __restrict__ out,
                       int hq, int hkv, int chunk, int max_len, int bk,
                       float scale, int window) {
  constexpr bool kQuant = kIsInt8<KV>;
  constexpr int kDpl = D / 32;                 // output dims per lane
  constexpr int kVec = 16 / (int)sizeof(KV);   // K/V values per 16 bytes
  constexpr int kStride = D + kVec;            // padded smem row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  KV* ks = reinterpret_cast<KV*>(smem_raw);
  KV* vs = ks + bk * kStride;
  float* qs = reinterpret_cast<float*>(vs + bk * kStride);
  float* kscale_s = qs + kAttnRows * D;        // int8 only: per-key scales
  float* vscale_s = kscale_s + bk;

  const int b = blockIdx.z, h = blockIdx.y;
  const int rep = hq / hkv, rows = rep * chunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int length = lengths[b], qlen = q_lens[b];
  const int valid_len = min(max(length, 1), max_len);
  const int lim = min(length, max_len);
  const int row0 = blockIdx.x * kAttnRows;
  const int n_tiles = max_len / bk;      // paged: pages per row

  for (int i = threadIdx.x; i < kAttnRows * D; i += kAttnThreads) {
    const int r = row0 + i / D, dd = i % D;
    float v = 0.0f;
    if (r < rows) {
      const int head = h * rep + r / chunk, j = r % chunk;
      v = to_f32(q[(((size_t)b * hq + head) * chunk + j) * D + dd]);
    }
    qs[i] = v;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDpl];
#pragma unroll
  for (int rw = 0; rw < kRowsPerWarp; ++rw) {
    m[rw] = kNegInf;
    l[rw] = 0.0f;
#pragma unroll
    for (int e = 0; e < kDpl; ++e) acc[rw][e] = 0.0f;
  }

  for (int ik = 0; ik < n_tiles; ++ik) {
    const int k_start = ik * bk;
    bool live = k_start < valid_len;
    if (window > 0) live = live && (k_start + bk > length - qlen - window + 1);
    if (!live) continue;                       // uniform over the block
    // index of the tile's first key in the (..., keys, D) leaf
    size_t tile;
    if (PAGED)
      tile = ((size_t)page_table[(size_t)b * n_tiles + ik] * hkv + h) * bk;
    else
      tile = ((size_t)b * hkv + h) * max_len + k_start;
    __syncthreads();                           // previous tile consumed
    constexpr int kVecsPerRow = D / kVec;
    for (int i = threadIdx.x; i < bk * kVecsPerRow; i += kAttnThreads) {
      const int key = i / kVecsPerRow, c = (i % kVecsPerRow) * kVec;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k_start + key < lim) {
        const size_t off = (tile + key) * D + c;
        kv = __ldg(reinterpret_cast<const uint4*>(k_cache + off));
        vv = __ldg(reinterpret_cast<const uint4*>(v_cache + off));
      }
      *reinterpret_cast<uint4*>(ks + key * kStride + c) = kv;
      *reinterpret_cast<uint4*>(vs + key * kStride + c) = vv;
    }
    if (kQuant) {
      for (int i = threadIdx.x; i < bk; i += kAttnThreads) {
        const bool in = k_start + i < lim;
        kscale_s[i] = in ? __ldg(k_scale + tile + i) : 0.0f;
        vscale_s[i] = in ? __ldg(v_scale + tile + i) : 0.0f;
      }
    }
    __syncthreads();

#pragma unroll
    for (int rw = 0; rw < kRowsPerWarp; ++rw) {
      const int r = row0 + warp * kRowsPerWarp + rw;
      if (r >= rows) break;                    // uniform over the warp
      const int j = r % chunk;
      const int q_pos = length - qlen + j;
      const float* qrow = qs + (warp * kRowsPerWarp + rw) * D;
      float s[kKeysPerLane];
      bool valid[kKeysPerLane];
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < kKeysPerLane; ++i) {
        const int key = lane + 32 * i;
        const int pos = k_start + key;
        bool ok = key < bk && pos < lim && pos <= q_pos && j < qlen;
        if (window > 0) ok = ok && pos > q_pos - window;
        float dot = 0.0f;
        if (key < bk) {
          const KV* krow = ks + key * kStride;
#pragma unroll 4
          for (int c = 0; c < D; c += kVec) {
            const uint4 raw = *reinterpret_cast<const uint4*>(krow + c);
            const KV* kvals = reinterpret_cast<const KV*>(&raw);
#pragma unroll
            for (int e = 0; e < kVec; ++e)
              dot = fmaf(qrow[c + e], to_f32(kvals[e]), dot);
          }
        }
        float si = kNegInf;
        if (ok) {
          if (kQuant) dot = dot * kscale_s[key];
          si = dot * scale;
        }
        valid[i] = ok;
        s[i] = si;
        mx = fmaxf(mx, si);
      }
      mx = warp_max(mx);
      const float m_new = fmaxf(m[rw], mx);
      const float alpha = expf(m[rw] - m_new);
      float psum = 0.0f;
      float pr[kKeysPerLane];
#pragma unroll
      for (int i = 0; i < kKeysPerLane; ++i) {
        float p = valid[i] ? expf(s[i] - m_new) : 0.0f;
        psum += p;
        if (kQuant && valid[i]) p = p * vscale_s[lane + 32 * i];
        pr[i] = round_to<T>(p);
      }
      psum = warp_sum(psum);
      l[rw] = l[rw] * alpha + psum;
      float pv[kDpl];
#pragma unroll
      for (int e = 0; e < kDpl; ++e) pv[e] = 0.0f;
#pragma unroll
      for (int i = 0; i < kKeysPerLane; ++i) {
        for (int kk = 0; kk < 32; ++kk) {
          const int key = 32 * i + kk;
          if (key >= bk) break;                // uniform over the warp
          const float pk = __shfl_sync(0xffffffffu, pr[i], kk);
          const KV* vrow = vs + key * kStride + lane * kDpl;
#pragma unroll
          for (int e = 0; e < kDpl; ++e) pv[e] = fmaf(pk, to_f32(vrow[e]), pv[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < kDpl; ++e) acc[rw][e] = acc[rw][e] * alpha + pv[e];
      m[rw] = m_new;
    }
  }

#pragma unroll
  for (int rw = 0; rw < kRowsPerWarp; ++rw) {
    const int r = row0 + warp * kRowsPerWarp + rw;
    if (r >= rows) break;
    const int head = h * rep + r / chunk, j = r % chunk;
    const float denom = (l[rw] == 0.0f) ? 1.0f : l[rw];
    T* orow = out + (((size_t)b * hq + head) * chunk + j) * D + lane * kDpl;
#pragma unroll
    for (int e = 0; e < kDpl; ++e) orow[e] = from_f32<T>(acc[rw][e] / denom);
  }
}

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;      // null: float K/V
  const float* v_scale;
  const int* page_table;     // null: slot layout
  const int* lengths;
  const int* q_lens;
  void* out;
  float* part_acc;           // bf16: the per-split states (scratch)
  float* part_ml;
  int batch, hq, hkv, chunk, max_len, bk, span, slice;
  float scale;
  int window;
};

template <typename T, typename KV, int D, bool PAGED>
int launch_mixed_flash(const AttnArgs& a, cudaStream_t stream) {
  auto kernel = mixed_flash_kernel<T, KV, D, PAGED>;
  REPRO_SMEM_OPT_IN(kernel, (attn_smem_bytes<KV, D>(kMaxBk)));
  const int rows = (a.hq / a.hkv) * a.chunk;
  dim3 grid((rows + kAttnRows - 1) / kAttnRows, a.hkv, a.batch);
  kernel<<<grid, kAttnThreads, attn_smem_bytes<KV, D>(a.bk), stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), a.k_scale, a.v_scale, a.page_table,
      a.lengths, a.q_lens, static_cast<T*>(a.out), a.hq, a.hkv, a.chunk,
      a.max_len, a.bk, a.scale, a.window);
  return (int)cudaGetLastError();
}

// ---- bfloat16 on the tensor cores ------------------------------------------

constexpr int kMfWarps = 4;
constexpr int kMfThreads = 32 * kMfWarps;
constexpr int kMfRows = 16 * kMfWarps;   // query rows a block, 16 a warp
constexpr int kMfSplit = 128;            // keys of a split, at most
constexpr int kMfStep = 64;              // keys of an online-softmax step
constexpr int kFoldWarps = 8;            // query rows a fold block
static_assert(kMfSplit == 2 * kMfStep, "two steps a split");

// Dynamic shared memory: Q (kMfRows rows), K and V of a whole split as bf16
// rows of swizzled 16-byte chunks; int8 K/V also land as int8 rows, with
// their f32 scales.
template <int D, bool QUANT>
struct MfSmem {
  static constexpr int kQ = kMfRows * staged_dim(D) * 2;
  static constexpr int kKV = kMfSplit * staged_dim(D) * 2;
  static constexpr int k8 = QUANT ? kMfSplit * D : 0;
  static constexpr int kSc = QUANT ? kMfSplit * 4 : 0;
  static constexpr int kK = kQ, kV = kQ + kKV, kK8 = kQ + 2 * kKV,
                       kV8 = kK8 + k8, kKs = kV8 + k8, kVs = kKs + kSc;
  static constexpr int kBytes = kVs + kSc;
};

// The keys query row r of a slice (rows = rep * cs, query j0 + r % cs) sees:
// [lo, hi); lo = INT_MAX, hi = INT_MIN when none (a dead query, a row past
// the slice, or nothing in range), neutral for min/max.
__device__ __forceinline__ void key_range(int r, int rows, int cs, int j0,
                                          int length, int qlen, int lim,
                                          int window, int& lo, int& hi) {
  lo = INT_MAX;
  hi = INT_MIN;
  if (r >= rows) return;
  const int j = j0 + r % cs;
  if (j >= qlen) return;
  const int q_pos = length - qlen + j;
  const int h = min(q_pos + 1, lim);
  const int l = window > 0 ? max(q_pos - window + 1, 0) : 0;
  if (l < h) {
    lo = l;
    hi = h;
  }
}

// Row index of key position p (split key p - s0) of row b, head h in a
// (..., keys, D) leaf or its scales; paged: `pages` holds the pool blocks
// of the split's pages, staged in shared memory.
template <bool PAGED>
__device__ __forceinline__ size_t key_row(int p, int s0, int b, int h,
                                          int hkv, int max_len, int bs,
                                          const int* pages) {
  if constexpr (PAGED) {
    return ((size_t)pages[p / bs - s0 / bs] * hkv + h) * bs + p % bs;
  } else {
    return ((size_t)b * hkv + h) * max_len + p;
  }
}

// cp.async keys k0 .. k0 + 63 of a K or V leaf into split rows r0 .. r0 + 63
// (bf16: swizzled chunks in rows staged_dim(D) wide; int8: plain rows of D
// bytes) and, for int8, their scales; a key outside [lo, hi) is zero-filled
// and never read.
template <int D, bool QUANT, bool PAGED>
__device__ __forceinline__ void mf_load_step(
    unsigned char* dst, float* sc_dst, const void* __restrict__ src,
    const float* __restrict__ sc_src, int k0, int r0, int lo, int hi,
    int s0, int b, int h, int hkv, int max_len, int bs, const int* pages) {
  constexpr int kElt = QUANT ? 1 : 2;
  constexpr int RC = D * kElt / 16;      // 16-byte chunks a key
  constexpr int RS = staged_dim(D) / 8;  // bf16: chunks a staged row
  const unsigned char* base = static_cast<const unsigned char*>(src);
  for (int i = threadIdx.x; i < kMfStep * RC; i += kMfThreads) {
    const int kr = i / RC, c = i % RC, p = k0 + kr, row = r0 + kr;
    const bool ok = p >= lo && p < hi;
    const unsigned char* from =
        ok ? base + (key_row<PAGED>(p, s0, b, h, hkv, max_len, bs, pages) *
                     D) * kElt + c * 16
           : base;
    unsigned char* to;
    if constexpr (QUANT)
      to = dst + row * D + c * 16;
    else
      to = dst + (row * RS + swz<RS>(row, c)) * 16;
    cp_async16(to, from, ok ? 16 : 0);
  }
  if constexpr (QUANT) {
    for (int i = threadIdx.x; i < kMfStep; i += kMfThreads) {
      const int p = k0 + i;
      const bool ok = p >= lo && p < hi;
      cp_async4(sc_dst + r0 + i,
                ok ? sc_src + key_row<PAGED>(p, s0, b, h, hkv, max_len, bs,
                                             pages)
                   : sc_src,
                ok ? 4 : 0);
    }
  }
}

// int8 split rows r0 .. r0 + 63 to bf16 rows of swizzled chunks (exact).
template <int D>
__device__ __forceinline__ void mf_convert_step(__nv_bfloat16* dst,
                                                const int8_t* src, int r0) {
  constexpr int R = staged_dim(D) / 8, R8 = D / 16;
  for (int i = threadIdx.x; i < kMfStep * R8; i += kMfThreads) {
    const int row = r0 + i / R8, c = i % R8;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + row * D + c * 16);
    const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
    uint32_t w[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      w[e] = pack_bf16x2(static_cast<float>(v[2 * e]),
                         static_cast<float>(v[2 * e + 1]));
    *reinterpret_cast<uint4*>(dst + (row * R + swz<R>(row, 2 * c)) * 8) =
        make_uint4(w[0], w[1], w[2], w[3]);
    *reinterpret_cast<uint4*>(dst + (row * R + swz<R>(row, 2 * c + 1)) * 8) =
        make_uint4(w[4], w[5], w[6], w[7]);
  }
}

// One block: split blockIdx.x of query rows blockIdx.y * 64.. of (batch
// row, KV head) blockIdx.z, for the queries j0 .. j0 + cs - 1 of the chunk.
// Writes each row's (m, l) and acc of the split to the scratch.
template <int D, bool QUANT, bool PAGED>
__global__ void __launch_bounds__(kMfThreads)
    mixed_flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const void* __restrict__ k_cache,
                           const void* __restrict__ v_cache,
                           const float* __restrict__ k_scale,
                           const float* __restrict__ v_scale,
                           const int* __restrict__ page_table,
                           const int* __restrict__ lengths,
                           const int* __restrict__ q_lens,
                           float* __restrict__ part_acc,
                           float* __restrict__ part_ml, int hq, int hkv,
                           int chunk, int j0, int cs, int max_len, int bk,
                           int span, float scale_log2, int window) {
  using S = MfSmem<D, QUANT>;
  static_assert(S::kBytes + 4 * (2 * kMfWarps + kMfSplit / 8) <= 232448,
                "a split's staging and the static arrays past the opt-in");
  constexpr int R = staged_dim(D) / 8;   // 16-byte chunks a staged row
  constexpr int RC = D / 8;              // ... of them holding the row
  constexpr int KS = D / 16;   // k16 steps of Q.K^T over d
  constexpr int ND = D / 8;    // n8 fragments of the output
  extern __shared__ __align__(128) unsigned char mf_smem[];
  __shared__ int warp_lo[kMfWarps], warp_hi[kMfWarps];
  __shared__ int pages[kMfSplit / 8];   // paged: the split's pool blocks
  const __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(mf_smem);
  __nv_bfloat16* ks_ = reinterpret_cast<__nv_bfloat16*>(mf_smem + S::kK);
  __nv_bfloat16* vs_ = reinterpret_cast<__nv_bfloat16*>(mf_smem + S::kV);
  float* ksc = reinterpret_cast<float*>(mf_smem + S::kKs);
  float* vsc = reinterpret_cast<float*>(mf_smem + S::kVs);

  const int split = blockIdx.x, bh = blockIdx.z;
  const int b = bh / hkv, h = bh % hkv;
  const int rep = hq / hkv, rows = rep * cs;
  const int row0 = blockIdx.y * kMfRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int length = lengths[b], qlen = q_lens[b];
  const int lim = min(length, max_len);
  const int s0 = split * span, s1 = min(s0 + span, max_len);

  // the keys of the split that this lane's rows g and g + 8 of the warp's
  // 16 see (the masks: a staged key outside them gets p = 0), and that any
  // row of the warp, and of the block, sees
  int lo[2], hi[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    key_range(row0 + warp * 16 + g + 8 * hh, rows, cs, j0, length, qlen, lim,
              window, lo[hh], hi[hh]);
    lo[hh] = max(lo[hh], s0);
    hi[hh] = min(hi[hh], s1);
  }
  int wlo = min(lo[0], lo[1]), whi = max(hi[0], hi[1]);
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    wlo = min(wlo, __shfl_xor_sync(0xffffffffu, wlo, o));
    whi = max(whi, __shfl_xor_sync(0xffffffffu, whi, o));
  }
  if (lane == 0) {
    warp_lo[warp] = wlo;
    warp_hi[warp] = whi;
  }
  if constexpr (PAGED) {
    // every page of the split that holds a live key of the row; the rest
    // are never addressed (nor read here)
    const int n_pages = max_len / bk, first = s0 / bk;
    const int i = threadIdx.x;
    if (i < (s1 - s0) / bk && (first + i) * bk < lim)
      pages[i] = page_table[(size_t)b * n_pages + first + i];
  }
  __syncthreads();
  int blo = INT_MAX, bhi = INT_MIN;
#pragma unroll
  for (int w = 0; w < kMfWarps; ++w)
    if (warp_lo[w] < warp_hi[w]) {
      blo = min(blo, warp_lo[w]);
      bhi = max(bhi, warp_hi[w]);
    }
  if (blo >= bhi) return;      // no row of the block sees a key of the split
  const bool warp_any = wlo < whi;

  // group 0: Q and step 0's K; 1: step 0's V; 2, 3: step 1's K, V
  for (int i = threadIdx.x; i < kMfRows * RC; i += kMfThreads) {
    const int rr = i / RC, c = i % RC, r = row0 + rr;
    const bool ok = r < rows;
    const __nv_bfloat16* from =
        ok ? q + (((size_t)b * hq + h * rep + r / cs) * chunk + j0 + r % cs) *
                     D + c * 8
           : q;
    cp_async16(mf_smem + (rr * R + swz<R>(rr, c)) * 16, from, ok ? 16 : 0);
  }
#pragma unroll
  for (int st = 0; st < 2; ++st) {
    unsigned char* kd = mf_smem + (QUANT ? S::kK8 : S::kK);
    unsigned char* vd = mf_smem + (QUANT ? S::kV8 : S::kV);
    mf_load_step<D, QUANT, PAGED>(kd, ksc, k_cache, k_scale,
                                  s0 + st * kMfStep, st * kMfStep, blo, bhi,
                                  s0, b, h, hkv, max_len, bk, pages);
    cp_async_commit();
    mf_load_step<D, QUANT, PAGED>(vd, vsc, v_cache, v_scale,
                                  s0 + st * kMfStep, st * kMfStep, blo, bhi,
                                  s0, b, h, hkv, max_len, bk, pages);
    cp_async_commit();
  }
  cp_async_wait<3>();   // Q and step 0's K
  __syncthreads();
  // this lane's address of Q's A fragment of k16 step ks (ldmatrix x4);
  // above head dim 128 Q is read from there at each step (registers)
  constexpr bool kQRegs = D <= 128;
  const int q_row = warp * 16 + (lane & 15);
  auto q_frag = [&](int ks) {
    const int c = 2 * ks + (lane >> 4);
    return qs + (q_row * R + swz<R>(q_row, c)) * 8;
  };
  uint32_t qf[kQRegs ? KS : 1][4];
  if constexpr (kQRegs) {
    if (warp_any) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) ldsm_x4(qf[ks], q_frag(ks));
    }
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f}, acc[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.0f;

#pragma unroll
  for (int st = 0; st < 2; ++st) {
    const int k0 = s0 + st * kMfStep, k1 = min(k0 + kMfStep, s1);
    if (k0 >= k1 || k0 >= bhi || k1 <= blo) continue;   // uniform
    const int r0 = st * kMfStep;
    if (st == 1) {
      cp_async_wait<1>();   // step 1's K
      __syncthreads();
    }
    if constexpr (QUANT) {
      mf_convert_step<D>(ks_, reinterpret_cast<const int8_t*>(mf_smem + S::kK8),
                         r0);
      __syncthreads();
    }
    const bool live = warp_any && k0 < whi && k1 > wlo;

    // S = Q.K^T over the step's 64 keys: 8 n8 fragments, each summed over
    // d in k16 steps from +0
    float s[8][4];
    if (live) {
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[jn][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t qa[4];
        if constexpr (kQRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) qa[e] = qf[ks][e];
        } else {
          ldsm_x4(qa, q_frag(ks));
        }
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int key = r0 + 16 * p + (lane & 7) + ((lane >> 4) & 1) * 8;
          const int c = 2 * ks + ((lane >> 3) & 1);
          uint32_t kf[4];
          ldsm_x4(kf, ks_ + (key * R + swz<R>(key, c)) * 8);
          mma_bf16(s[2 * p], qa, kf[0], kf[1]);
          mma_bf16(s[2 * p + 1], qa, kf[2], kf[3]);
        }
      }
      // scores to the log2 domain (int8: times k_scale first), masked to
      // each row's [lo, hi); the online softmax of the step
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kr = r0 + 8 * jn + 2 * t + (e & 1), p = s0 + kr;
          const int hh = e >> 1;
          float v = s[jn][e];
          if constexpr (QUANT) v = v * ksc[kr];
          v = (p >= lo[hh] && p < hi[hh]) ? v * scale_log2 : kNegInf;
          s[jn][e] = v;
          mx[hh] = fmaxf(mx[hh], v);
        }
      float alpha[2], psum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float m_new = fmaxf(m[hh], quad_max(mx[hh]));
        alpha[hh] = exp2f(m[hh] - m_new);
        m[hh] = m_new;
      }
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = s0 + r0 + 8 * jn + 2 * t + (e & 1), hh = e >> 1;
          const float pr = (p >= lo[hh] && p < hi[hh])
                               ? exp2f(s[jn][e] - m[hh]) : 0.0f;
          psum[hh] += pr;
          s[jn][e] = pr;
        }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        l[hh] = l[hh] * alpha[hh] + quad_sum(psum[hh]);
#pragma unroll
      for (int dn = 0; dn < ND; ++dn) {
        acc[dn][0] *= alpha[0];
        acc[dn][1] *= alpha[0];
        acc[dn][2] *= alpha[1];
        acc[dn][3] *= alpha[1];
      }
    }

    if (st == 0)
      cp_async_wait<2>();   // step 0's V
    else
      cp_async_wait<0>();   // step 1's V
    __syncthreads();
    if constexpr (QUANT) {
      mf_convert_step<D>(vs_, reinterpret_cast<const int8_t*>(mf_smem + S::kV8),
                         r0);
      __syncthreads();
    }
    if (live) {
      // acc += P.V: P's fragments 2 kk and 2 kk + 1 (keys 16 kk..) are the
      // A operand of k16 step kk; int8: p * v_scale before the rounding
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float p0[4], p1[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p0[e] = s[2 * kk][e];
          p1[e] = s[2 * kk + 1][e];
          if constexpr (QUANT) {
            const int kr = r0 + 16 * kk + 2 * t + (e & 1);
            p0[e] = p0[e] * vsc[kr];
            p1[e] = p1[e] * vsc[kr + 8];
          }
        }
        const uint32_t a[4] = {pack_bf16x2(p0[0], p0[1]),
                               pack_bf16x2(p0[2], p0[3]),
                               pack_bf16x2(p1[0], p1[1]),
                               pack_bf16x2(p1[2], p1[3])};
        const int key = r0 + 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int dp = 0; dp < KS; ++dp) {
          const int c = 2 * dp + (lane >> 4);
          uint32_t vf[4];
          ldsm_x4_trans(vf, vs_ + (key * R + swz<R>(key, c)) * 8);
          mma_bf16(acc[2 * dp], a, vf[0], vf[1]);
          mma_bf16(acc[2 * dp + 1], a, vf[2], vf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  if (!warp_any) return;
  const size_t slot = ((size_t)bh * gridDim.x + split) * rows;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row0 + warp * 16 + g + 8 * hh;
    if (r >= rows) continue;
    if (t == 0)
      *reinterpret_cast<float2*>(part_ml + 2 * (slot + r)) =
          make_float2(m[hh], l[hh]);
    float* pa = part_acc + (slot + r) * D + 2 * t;
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
      *reinterpret_cast<float2*>(pa + 8 * dn) =
          make_float2(acc[dn][2 * hh], acc[dn][2 * hh + 1]);
  }
}

// One warp a query row: folds the splits that hold a key the query sees,
// in increasing order, and writes acc / l in bf16 (exact zeros for a dead
// query or one that sees no key).
template <int D>
__global__ void __launch_bounds__(32 * kFoldWarps)
    mixed_flash_fold_kernel(const float* __restrict__ part_acc,
                            const float* __restrict__ part_ml,
                            const int* __restrict__ lengths,
                            const int* __restrict__ q_lens,
                            __nv_bfloat16* __restrict__ out, int hq, int hkv,
                            int chunk, int j0, int cs, int max_len, int span,
                            int n_split, int window) {
  constexpr int kDpl = (D + 31) / 32;    // output dims a lane (the last
                                         // lanes idle at D = 112)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const int rep = hq / hkv, rows = rep * cs;
  const int r = blockIdx.x * kFoldWarps + warp;
  if (r >= rows) return;
  const int length = lengths[b], qlen = q_lens[b];
  int lo, hi;
  key_range(r, rows, cs, j0, length, qlen, min(length, max_len), window, lo,
            hi);
  float m = kNegInf, l = 0.0f, acc[kDpl];
#pragma unroll
  for (int e = 0; e < kDpl; ++e) acc[e] = 0.0f;
  if (lo < hi) {
    const size_t slot0 = ((size_t)b * hkv + h) * n_split;
    for (int sp = lo / span; sp <= (hi - 1) / span; ++sp) {
      const size_t row = (slot0 + sp) * rows + r;
      const float2 ml = *reinterpret_cast<const float2*>(part_ml + 2 * row);
      const float m_new = fmaxf(m, ml.x);
      const float a = exp2f(m - m_new), c = exp2f(ml.x - m_new);
      l = fmaf(l, a, ml.y * c);
      const float* pa = part_acc + row * D + lane * kDpl;
#pragma unroll
      for (int e = 0; e < kDpl; ++e)
        if (D % 32 == 0 || lane * kDpl + e < D)
          acc[e] = fmaf(acc[e], a, pa[e] * c);
      m = m_new;
    }
  }
  const float denom = (l == 0.0f) ? 1.0f : l;
  __nv_bfloat16* orow =
      out + (((size_t)b * hq + h * rep + r / cs) * chunk + j0 + r % cs) * D +
      lane * kDpl;
#pragma unroll
  for (int e = 0; e < kDpl; ++e)
    if (D % 32 == 0 || lane * kDpl + e < D)
      orow[e] = __float2bfloat16_rn(acc[e] / denom);
}

template <int D, bool QUANT, bool PAGED>
int launch_mixed_mma(const AttnArgs& a, cudaStream_t stream) {
  auto kernel = mixed_flash_mma_kernel<D, QUANT, PAGED>;
  constexpr int smem = MfSmem<D, QUANT>::kBytes;
  REPRO_SMEM_OPT_IN(kernel, smem);
  const int rep = a.hq / a.hkv;
  const int n_split = (a.max_len + a.span - 1) / a.span;
  const float scale_log2 = a.scale * kLog2e;
  for (int j0 = 0; j0 < a.chunk; j0 += a.slice) {
    const int cs = min(a.slice, a.chunk - j0), rows = rep * cs;
    dim3 grid(n_split, (rows + kMfRows - 1) / kMfRows, a.batch * a.hkv);
    kernel<<<grid, kMfThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(a.q), a.k, a.v, a.k_scale,
        a.v_scale, a.page_table, a.lengths, a.q_lens, a.part_acc, a.part_ml,
        a.hq, a.hkv, a.chunk, j0, cs, a.max_len, a.bk, a.span, scale_log2,
        a.window);
    dim3 fgrid((rows + kFoldWarps - 1) / kFoldWarps, a.hkv, a.batch);
    mixed_flash_fold_kernel<D><<<fgrid, 32 * kFoldWarps, 0, stream>>>(
        a.part_acc, a.part_ml, a.lengths, a.q_lens,
        static_cast<__nv_bfloat16*>(a.out), a.hq, a.hkv, a.chunk, j0, cs,
        a.max_len, a.span, n_split, a.window);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

template <bool QUANT, bool PAGED>
int dispatch_head_dim_mma(int d, const AttnArgs& a, cudaStream_t s) {
  switch (d) {
    case 32:
      return launch_mixed_mma<32, QUANT, PAGED>(a, s);
    case 64:
      return launch_mixed_mma<64, QUANT, PAGED>(a, s);
    case 112:
      return launch_mixed_mma<112, QUANT, PAGED>(a, s);
    case 128:
      return launch_mixed_mma<128, QUANT, PAGED>(a, s);
    case 256:
      return launch_mixed_mma<256, QUANT, PAGED>(a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename KV, bool PAGED>
int dispatch_head_dim_f32(int d, const AttnArgs& a, cudaStream_t s) {
  switch (d) {
    case 32:
      return launch_mixed_flash<float, KV, 32, PAGED>(a, s);
    case 64:
      return launch_mixed_flash<float, KV, 64, PAGED>(a, s);
    case 128:
      return launch_mixed_flash<float, KV, 128, PAGED>(a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace repro

// k_scale/v_scale null: float K/V in the activation dtype; both set: int8
// K/V.  page_table null: slot layout with tile bk; set: paged pools whose
// page size is bk, max_len = n_pages * bk.  bfloat16 also takes the split
// span (a multiple of bk, at most 128 keys), the scratch part_acc (B, hkv,
// n_split, rep * slice, d) and part_ml (..., 2) in f32, and the queries a
// slice (the chunk is launched slice by slice); float32 ignores them.
extern "C" int mixed_flash_launch(const void* q, const void* k_cache,
                                  const void* v_cache, const void* k_scale,
                                  const void* v_scale, const void* page_table,
                                  const void* lengths, const void* q_lens,
                                  void* out, void* part_acc, void* part_ml,
                                  int batch, int hq, int hkv, int chunk,
                                  int head_dim, int max_len, int bk, int span,
                                  int slice, float scale, int window,
                                  int dtype, void* stream) {
  using namespace repro;
  if (bk < 1 || bk > kMaxBk || max_len % bk) return (int)cudaErrorInvalidValue;
  if ((k_scale == nullptr) != (v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  AttnArgs a{q, k_cache, v_cache, static_cast<const float*>(k_scale),
             static_cast<const float*>(v_scale),
             static_cast<const int*>(page_table),
             static_cast<const int*>(lengths), static_cast<const int*>(q_lens),
             out, static_cast<float*>(part_acc), static_cast<float*>(part_ml),
             batch, hq, hkv, chunk, max_len, bk, span, slice, scale, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool paged = a.page_table != nullptr, quant = a.k_scale != nullptr;
  if (dtype == kBF16) {
    if (span < bk || span > kMfSplit || span % bk || slice < 1 ||
        part_acc == nullptr || part_ml == nullptr || batch * hkv > 65535)
      return (int)cudaErrorInvalidValue;
    if (quant)
      return paged ? dispatch_head_dim_mma<true, true>(head_dim, a, s)
                   : dispatch_head_dim_mma<true, false>(head_dim, a, s);
    return paged ? dispatch_head_dim_mma<false, true>(head_dim, a, s)
                 : dispatch_head_dim_mma<false, false>(head_dim, a, s);
  }
  if (quant)
    return paged ? dispatch_head_dim_f32<int8_t, true>(head_dim, a, s)
                 : dispatch_head_dim_f32<int8_t, false>(head_dim, a, s);
  return paged ? dispatch_head_dim_f32<float, true>(head_dim, a, s)
               : dispatch_head_dim_f32<float, false>(head_dim, a, s);
}
