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
//          tile is the page (bk = bs), and logical tile ik of row b is pool
//          block page_table[b, ik].  The live range and the window floor are
//          computed on logical positions exactly as for the slot layout, so
//          the reduction order depends only on the row's lengths and bk, and
//          paged equals slot bit for bit at block_kv = bs.
// K/V type (template type KV): the activation dtype T, or int8 with f32
// per-token scales (same leading shape as the cache, last axis 1).  An int8
// value converts exactly to f32; the score is (q.k) * k_scale * scale in
// that order; l sums the probabilities before the V scale, and p * v_scale
// is rounded to T before P.V (scale-after-dot, as the reference).
//
// Work split: one block per (32 query rows, KV head, batch row).  GQA is
// packed as in the reference: query row r of a KV head is (group head
// r / C, chunk position r % C), so each K/V byte serves all rep heads.  The
// block walks KV tiles only up to the row's live range (tiles past
// lengths[b], or wholly before the window of the chunk's first query, are
// skipped, and no key at or past lengths[b] is read: its smem slot is
// zero-filled).  So a paged row never reads the null block or a block it
// has not leased, and an int8 tile is read at 1 byte per value plus 8 bytes
// of scales per key.  K and V tiles are staged in shared memory with a
// 16-byte row pad (conflict-free 16-byte reads: 8 bf16, 4 f32 or 16 int8
// values); each warp owns 4 query rows, lane l scores keys l, l + 32, ...
// with a sequential f32 dot over d, and owns d/32 output dimensions of the
// P.V product.  At bs = 16 half of each warp's lanes have no key to score:
// correct, and left for a later, faster kernel.
//
// Batch invariance: a query row's arithmetic depends only on its own row,
// the tile size and its (lengths, q_lens) — never on C, B, the other rows
// or where a row's pages lie in the pool.  A tile that is live for the
// block but fully masked for a row leaves that row's m, l and acc bitwise
// unchanged (alpha = exp(0) = 1, p = 0), so a query with q_lens = 1 inside a
// C-wide chunk gives the C = 1 result bit for bit.
//
// What bounds it on the card: at decode, the K/V bytes of the live range
// (2 * length * hkv * d * sizeof(KV) per row, plus 8 bytes per key and head
// for int8); a chunk amortises the same bytes over C queries and moves
// towards the f32 FMA bound of the CUDA cores (no tensor cores in this
// first version).
#include <type_traits>

#include "common.cuh"

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
  int batch, hq, hkv, chunk, max_len, bk;
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

template <typename T, typename KV, bool PAGED>
int dispatch_head_dim(int d, const AttnArgs& a, cudaStream_t s) {
  switch (d) {
    case 32:
      return launch_mixed_flash<T, KV, 32, PAGED>(a, s);
    case 64:
      return launch_mixed_flash<T, KV, 64, PAGED>(a, s);
    case 128:
      return launch_mixed_flash<T, KV, 128, PAGED>(a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_variant(int d, const AttnArgs& a, cudaStream_t s) {
  const bool paged = a.page_table != nullptr;
  if (a.k_scale != nullptr)
    return paged ? dispatch_head_dim<T, int8_t, true>(d, a, s)
                 : dispatch_head_dim<T, int8_t, false>(d, a, s);
  return paged ? dispatch_head_dim<T, T, true>(d, a, s)
               : dispatch_head_dim<T, T, false>(d, a, s);
}

}  // namespace repro

// k_scale/v_scale null: float K/V in the activation dtype; both set: int8
// K/V.  page_table null: slot layout with tile bk; set: paged pools whose
// page size is bk, max_len = n_pages * bk.
extern "C" int mixed_flash_launch(const void* q, const void* k_cache,
                                  const void* v_cache, const void* k_scale,
                                  const void* v_scale, const void* page_table,
                                  const void* lengths, const void* q_lens,
                                  void* out, int batch, int hq, int hkv,
                                  int chunk, int head_dim, int max_len,
                                  int bk, float scale, int window, int dtype,
                                  void* stream) {
  using namespace repro;
  if (bk < 1 || bk > kMaxBk || max_len % bk) return (int)cudaErrorInvalidValue;
  if ((k_scale == nullptr) != (v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  AttnArgs a{q, k_cache, v_cache, static_cast<const float*>(k_scale),
             static_cast<const float*>(v_scale),
             static_cast<const int*>(page_table),
             static_cast<const int*>(lengths), static_cast<const int*>(q_lens),
             out, batch, hq, hkv, chunk, max_len, bk, scale, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return dispatch_variant<__nv_bfloat16>(head_dim, a, s);
  return dispatch_variant<float>(head_dim, a, s);
}
