// Mixed prefill/decode flash attention over the slot KV cache, for Hopper
// (sm_90a).
//
// Replaces src/repro/kernels/decode_flash.py::mixed_flash_attention_pallas
// (and decode_flash_attention_pallas, its q_lens = 1 case) for the slot
// layout with a float cache.  Same contract: q (B, hq, C, d) against caches
// (B, hkv, MAX, d); lengths[b] is the valid context including this step's
// chunk and q_lens[b] the live queries; query j of row b sits at position
// lengths[b] - q_lens[b] + j.  Masks: intra-chunk causal, optional window,
// length; dead queries (j >= q_lens[b]) return exact zeros.  Softmax
// statistics m, l and the accumulator are f32; probabilities are rounded to
// the activation dtype before the P.V contraction, as in the reference.
//
// Work split: one block per (32 query rows, KV head, batch row).  GQA is
// packed as in the reference: query row r of a KV head is (group head
// r / C, chunk position r % C), so each K/V byte serves all rep heads.  The
// block walks KV tiles of bk = kv_block_size(MAX, 128) keys, only up to the
// row's live range (tiles past lengths[b], or wholly before the window of
// the chunk's first query, are skipped, and no cache row at or past
// lengths[b] is read).  K and V tiles are staged in shared memory with a
// 16-byte row pad (conflict-free 16-byte reads); each warp owns 4 query
// rows, lane l scores keys l, l + 32, ... with a sequential f32 dot over d,
// and owns d/32 output dimensions of the P.V product.
//
// Batch invariance: a query row's arithmetic depends only on its own row,
// the tile size and its (lengths, q_lens) — never on C, B or the other rows.
// A tile that is live for the block but fully masked for a row leaves that
// row's m, l and acc bitwise unchanged (alpha = exp(0) = 1, p = 0), so a
// query with q_lens = 1 inside a C-wide chunk gives the C = 1 result bit
// for bit.
//
// What bounds it on the card: at decode, the K/V bytes of the live range
// (2 * length * hkv * d * sizeof(T) per row); a chunk amortises the same
// bytes over C queries and moves towards the f32 FMA bound of the CUDA
// cores (no tensor cores in this first version).
#include "common.cuh"

REPRO_ERROR_STRING_FN

namespace repro {

constexpr int kAttnThreads = 256;
constexpr int kAttnWarps = kAttnThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kAttnRows = kAttnWarps * kRowsPerWarp;   // query rows / block
constexpr int kMaxBk = 128;
constexpr int kKeysPerLane = kMaxBk / 32;
constexpr float kNegInf = -1e30f;

template <typename T, int D>
constexpr int attn_smem_bytes(int bk) {
  return 2 * bk * (D + 16 / (int)sizeof(T)) * (int)sizeof(T) +
         kAttnRows * D * (int)sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kAttnThreads)
    mixed_flash_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                       const T* __restrict__ v_cache,
                       const int* __restrict__ lengths,
                       const int* __restrict__ q_lens, T* __restrict__ out,
                       int hq, int hkv, int chunk, int max_len, int bk,
                       float scale, int window) {
  constexpr int kDpl = D / 32;                 // output dims per lane
  constexpr int kVec = 16 / (int)sizeof(T);    // elements per 16 bytes
  constexpr int kStride = D + kVec;            // padded smem row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + bk * kStride;
  float* qs = reinterpret_cast<float*>(vs + bk * kStride);

  const int b = blockIdx.z, h = blockIdx.y;
  const int rep = hq / hkv, rows = rep * chunk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int length = lengths[b], qlen = q_lens[b];
  const int valid_len = min(max(length, 1), max_len);
  const int lim = min(length, max_len);
  const int row0 = blockIdx.x * kAttnRows;

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

  const size_t kv_base = ((size_t)b * hkv + h) * (size_t)max_len * D;
  const int n_blocks = max_len / bk;
  for (int ik = 0; ik < n_blocks; ++ik) {
    const int k_start = ik * bk;
    bool live = k_start < valid_len;
    if (window > 0) live = live && (k_start + bk > length - qlen - window + 1);
    if (!live) continue;                       // uniform over the block
    __syncthreads();                           // previous tile consumed
    const int vecs_per_row = D / kVec;
    for (int i = threadIdx.x; i < bk * vecs_per_row; i += kAttnThreads) {
      const int key = i / vecs_per_row, c = (i % vecs_per_row) * kVec;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k_start + key < lim) {
        const size_t off = kv_base + (size_t)(k_start + key) * D + c;
        kv = __ldg(reinterpret_cast<const uint4*>(k_cache + off));
        vv = __ldg(reinterpret_cast<const uint4*>(v_cache + off));
      }
      *reinterpret_cast<uint4*>(ks + key * kStride + c) = kv;
      *reinterpret_cast<uint4*>(vs + key * kStride + c) = vv;
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
          const T* krow = ks + key * kStride;
#pragma unroll 4
          for (int c = 0; c < D; c += kVec) {
            const uint4 raw = *reinterpret_cast<const uint4*>(krow + c);
            const T* kvals = reinterpret_cast<const T*>(&raw);
#pragma unroll
            for (int e = 0; e < kVec; ++e)
              dot = fmaf(qrow[c + e], to_f32(kvals[e]), dot);
          }
        }
        valid[i] = ok;
        s[i] = ok ? dot * scale : kNegInf;
        mx = fmaxf(mx, s[i]);
      }
      mx = warp_max(mx);
      const float m_new = fmaxf(m[rw], mx);
      const float alpha = expf(m[rw] - m_new);
      float psum = 0.0f;
      float pr[kKeysPerLane];
#pragma unroll
      for (int i = 0; i < kKeysPerLane; ++i) {
        const float p = valid[i] ? expf(s[i] - m_new) : 0.0f;
        psum += p;
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
          const T* vrow = vs + key * kStride + lane * kDpl;
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

template <typename T, int D>
int launch_mixed_flash(const void* q, const void* k, const void* v,
                       const int* lengths, const int* q_lens, void* out,
                       int batch, int hq, int hkv, int chunk, int max_len,
                       int bk, float scale, int window, cudaStream_t stream) {
  auto kernel = mixed_flash_kernel<T, D>;
  REPRO_SMEM_OPT_IN(kernel, (attn_smem_bytes<T, D>(kMaxBk)));
  const int rows = (hq / hkv) * chunk;
  dim3 grid((rows + kAttnRows - 1) / kAttnRows, hkv, batch);
  kernel<<<grid, kAttnThreads, attn_smem_bytes<T, D>(bk), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, q_lens, static_cast<T*>(out), hq,
      hkv, chunk, max_len, bk, scale, window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_head_dim(int d, const void* q, const void* k, const void* v,
                      const int* lengths, const int* q_lens, void* out,
                      int batch, int hq, int hkv, int chunk, int max_len,
                      int bk, float scale, int window, cudaStream_t s) {
  switch (d) {
    case 32:
      return launch_mixed_flash<T, 32>(q, k, v, lengths, q_lens, out, batch,
                                       hq, hkv, chunk, max_len, bk, scale,
                                       window, s);
    case 64:
      return launch_mixed_flash<T, 64>(q, k, v, lengths, q_lens, out, batch,
                                       hq, hkv, chunk, max_len, bk, scale,
                                       window, s);
    case 128:
      return launch_mixed_flash<T, 128>(q, k, v, lengths, q_lens, out, batch,
                                        hq, hkv, chunk, max_len, bk, scale,
                                        window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace repro

extern "C" int mixed_flash_launch(const void* q, const void* k_cache,
                                  const void* v_cache, const void* lengths,
                                  const void* q_lens, void* out, int batch,
                                  int hq, int hkv, int chunk, int head_dim,
                                  int max_len, int bk, float scale,
                                  int window, int dtype, void* stream) {
  using namespace repro;
  if (bk < 1 || bk > kMaxBk || max_len % bk) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  const int* ql = static_cast<const int*>(q_lens);
  if (dtype == kBF16)
    return dispatch_head_dim<__nv_bfloat16>(head_dim, q, k_cache, v_cache,
                                            len, ql, out, batch, hq, hkv,
                                            chunk, max_len, bk, scale,
                                            window, s);
  return dispatch_head_dim<float>(head_dim, q, k_cache, v_cache, len, ql,
                                  out, batch, hq, hkv, chunk, max_len, bk,
                                  scale, window, s);
}
