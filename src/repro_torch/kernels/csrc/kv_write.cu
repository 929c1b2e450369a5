// KV-cache write for Hopper (sm_90a), in two kernels:
//
// kv_write_kernel: one layer's new K/V (and, for an int8 cache, their
// per-token scales) copied in place into the slot cache (B, hkv, L, w) or,
// through the page table, into the shared pool (n_blocks + 1, hkv, bs, w),
// in one launch for every leaf.
//
// qkv_rope_write_kernel: the serving steps' q/k/v epilogue.  From the raw
// projections q (B, C, hq*hd), k and v (B, C, hkv*hd) it adds the biases,
// applies the per-head RMSNorm to q and k where the config has one
// (qk_norm), RoPE to q and k, quantizes k and v for an int8 cache, writes the
// live K/V positions into the cache as kv_write_kernel does, and writes q
// as the (B, hq, C, hd) the attention kernel reads: about 40 PyTorch
// operations a layer in one launch.
//
// Not a port of a TPU kernel: the reference writes its cache with XLA's
// dynamic-update-slice and selects (src/repro/models/attention.py:139,
// :153, :269), and leaves the bias, RoPE and quantizing to XLA
// (src/repro/models/attention.py:38-55, src/repro/models/layers.py:99-111,
// src/repro/models/attention.py:215-220), which fuses them into its
// neighbours.  It is a kernel here so that a serving step never reads a
// device value on the host: row b's live positions are j < q_lens[b] at
// logical positions starts[b] + j, read from the device, and a dead
// position writes nothing.  The grid's shape depends on (C, B) alone, so a
// captured CUDA graph replays it for any lengths.
#include <assert.h>

#include "common.cuh"

REPRO_ERROR_STRING_FN

namespace repro {

constexpr int kMaxLeaves = 4;
constexpr int kWriteThreads = 128;

// Everything a launch copies, passed by value (a captured graph keeps it).
struct KvLeaves {
  char* dst[kMaxLeaves];
  const char* src[kMaxLeaves];
  long long src_b[kMaxLeaves];  // byte strides of the new rows: row,
  long long src_h[kMaxLeaves];  // head and chunk position
  long long src_j[kMaxLeaves];
  int bytes[kMaxLeaves];        // bytes of one (token, head) row
  int vec[kMaxLeaves];          // copy width: 16, 8, 4, 2 or 1 bytes
  int n;
};

__device__ __forceinline__ void copy_piece(char* d, const char* s, int vec) {
  switch (vec) {
    case 16: *reinterpret_cast<int4*>(d) = *reinterpret_cast<const int4*>(s);
      break;
    case 8: *reinterpret_cast<int2*>(d) = *reinterpret_cast<const int2*>(s);
      break;
    case 4: *reinterpret_cast<int*>(d) = *reinterpret_cast<const int*>(s);
      break;
    case 2: *reinterpret_cast<short*>(d) = *reinterpret_cast<const short*>(s);
      break;
    default: *d = *s;
  }
}

// kv_write_kernel's design: one block per (chunk position j, row b).  A dead
// position's block returns at once; a live one copies, for each leaf, hkv
// rows of w bytes, each thread a 16-byte (or narrower, as the leaf's width
// and addresses allow) piece.  A copy has no arithmetic, so the result is
// bitwise the plain version's index writes.  What bounds it: bytes, each
// live (token, head) row read once and written once.
//
// page_table null: slot layout, span = L and row b's block is b.  Else the
// pool: span = bs and position p of row b lives in block
// page_table[b, p / bs] at offset p % bs.
__global__ void __launch_bounds__(kWriteThreads)
    kv_write_kernel(KvLeaves p, const int* __restrict__ starts,
                    const int* __restrict__ q_lens,
                    const int* __restrict__ page_table, int heads, int span,
                    int n_pages) {
  const int j = blockIdx.x;
  const int b = blockIdx.y;
  if (j >= q_lens[b]) return;  // a dead position writes nothing
  const int pos = starts[b] + j;
  long long block = b;
  int tok = pos;
  if (page_table != nullptr) {
    block = page_table[(long long)b * n_pages + pos / span];
    tok = pos % span;
  }
  for (int l = 0; l < p.n; ++l) {
    const int bytes = p.bytes[l];
    const int vec = p.vec[l];
    const int pieces = bytes / vec;
    const char* src = p.src[l] + b * p.src_b[l] + j * p.src_j[l];
    char* dst = p.dst[l] + (block * heads * span + tok) * (long long)bytes;
    for (int i = threadIdx.x; i < heads * pieces; i += kWriteThreads) {
      const int h = i / pieces;
      const int e = (i - h * pieces) * vec;
      copy_piece(dst + (long long)h * span * bytes + e,
                 src + h * p.src_h[l] + e, vec);
    }
  }
}


// -- the q/k/v epilogue -------------------------------------------------------
//
// Design: one warp per (token, head vector), four warps a block; the grid is
// (C, B, ceil((hq + 2 hkv) / 4)), a head vector u < hq being q's head u, then
// k's and v's heads.  Lane l owns the RoPE pairs (i, i + hd/2) for i = l,
// l + 32, ...: both halves of a pair are in one lane, so RoPE needs no
// exchange, and an int8 vector's absmax is one warp max.  Every number is
// rounded where the PyTorch chain it replaces rounds it on the card, so the
// results are bitwise that chain's (the plain version):
//   bias:  t = round_T(t + b)                      (linear's bias add)
//   norm:  t = round_T((t * r) * g), r = rsqrtf(ss / hd + 1e-6), on q and k
//          heads (qk_norm): rmsnorm.cu's arithmetic on a row of hd.  That
//          kernel gives a row one block of 256 threads, thread i the
//          square of element i (one fmaf from zero, the product rounded
//          once), a xor butterfly in each warp and the 8 warp sums added
//          from zero in warp order.  With hd / 2 a multiple of 32 its warp
//          w holds elements 32w .. 32w + 31, which are this warp's lo[w]
//          (w < hd / 64) or hi[w - hd / 64] at the same lanes: each is
//          squared and butterflied on its own, and the sums are added in
//          that order (at hd 128: lo[0], lo[1], hi[0], hi[1]).  At hd <= 32
//          rmsnorm's warp 0 holds the whole row, lane l element l: lanes
//          below hd / 2 their lo[0], the next ones hi[0] from lane l - hd / 2.
//          Other head dims are refused.
//   RoPE:  o1 = round_T(x1*cos - x2*sin), o2 = round_T(x1*sin + x2*cos),
//          each product and the sum rounded on their own (apply_rope's
//          separate f32 operations; __fmul_rn/__fsub_rn keep nvcc from
//          contracting them into an FMA), cos/sin from a table built with
//          apply_rope's own operations (rope.rope_table), row = position;
//   int8:  a = max|t| (exact in any order), scale = max(a * (1/127), 1e-10)
//          (PyTorch divides by a host scalar as a product by its f32
//          reciprocal), q = clamp(rint(t / scale), -127, 127) with a true
//          division (quantize_kv).
// The table holds the cache's logical span, so it covers every live
// position (j < q_lens[b]) of a step that keeps starts + q_lens <= span; a
// live position outside it is refused with a device-side assert (the
// launch fails, as PyTorch's index kernels fail on an index out of range)
// instead of rotating by a wrong angle.  A dead position's row index is
// clamped, so the table is never read out of bounds; its q is not the
// chain's there, and the attention kernel zeroes dead rows.  q is written
// at every position, k and v only at live positions.
// What bounds it: bytes, q, k and v read once, q written once, each live
// (token, head) K/V row written once; at a decode tick it is a launch's
// latency, and what it saves is the ~40 launches it replaces a layer.

constexpr int kEpiWarps = 4;
constexpr int kMaxPairsPerLane = 4;     // head_dim <= 256
constexpr float kQkNormEps = 1e-6f;     // layers.rmsnorm's

struct QkvArgs {
  const void* src[3];           // raw q, k, v: (B, C, heads * hd)
  long long stride_b[3];        // element strides of row and position
  long long stride_j[3];
  const void* bias[3];          // (heads * hd,) or null
  const void* norm[2];          // q's and k's (hd,) RMSNorm gammas, or null
  const float* cos_t;           // (rows, hd / 2), or null: no RoPE
  const float* sin_t;
  int rows;
  const int* rope_base;         // (B,): position of chunk column 0
  const int* starts;            // (B,): cache position of chunk column 0
  const int* q_lens;            // (B,): live chunk columns
  const int* page_table;        // (B, n_pages) or null: slot layout
  void* q_out;                  // (B, hq, C, hd)
  void* cache[2];               // k, v leaves: (blocks, hkv, span, hd)
  float* scale[2];              // int8: (blocks, hkv, span, 1), else null
  int hq, hkv, hd, chunk, span, n_pages;
};

template <typename T>
__device__ __forceinline__ float with_bias(const T* __restrict__ b, int i,
                                           float t) {
  return b != nullptr ? to_f32(from_f32<T>(__fadd_rn(t, to_f32(b[i])))) : t;
}

// The sum of squares of a head vector, as rmsnorm.cu sums its row (see the
// note above): lo[p] / hi[p] are elements lane + 32 p and hd/2 + lane + 32 p
// (zeros past hd / 2).  Every lane ends with the same value.
__device__ __forceinline__ float head_sum_squares(const float (&lo)[4],
                                                  const float (&hi)[4],
                                                  int half, int lane) {
  float total = 0.0f;
  if (half >= 32) {
#pragma unroll
    for (int p = 0; p < kMaxPairsPerLane; ++p)
      if (32 * p < half) total += warp_sum(__fmul_rn(lo[p], lo[p]));
#pragma unroll
    for (int p = 0; p < kMaxPairsPerLane; ++p)
      if (32 * p < half) total += warp_sum(__fmul_rn(hi[p], hi[p]));
  } else {
    const float h = __shfl_sync(0xffffffffu, __fmul_rn(hi[0], hi[0]),
                                (lane - half) & 31);
    total += warp_sum(lane < half ? __fmul_rn(lo[0], lo[0])
                                  : (lane < 2 * half ? h : 0.0f));
  }
  return total;
}

template <typename T, bool QUANT>
__global__ void __launch_bounds__(kEpiWarps * 32)
    qkv_rope_write_kernel(QkvArgs a) {
  const int j = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int u = blockIdx.z * kEpiWarps + (threadIdx.x >> 5);
  if (u >= a.hq + 2 * a.hkv) return;
  const int which = u < a.hq ? 0 : (u < a.hq + a.hkv ? 1 : 2);
  const int head = which == 0 ? u : (which == 1 ? u - a.hq : u - a.hq - a.hkv);
  const int half = a.hd / 2;
  const T* src = static_cast<const T*>(a.src[which]) + b * a.stride_b[which] +
                 j * a.stride_j[which] + (long long)head * a.hd;
  const T* bias = a.bias[which] != nullptr
                      ? static_cast<const T*>(a.bias[which]) + head * a.hd
                      : nullptr;
  const bool rope = which < 2 && a.cos_t != nullptr;
  // the index loads first, so their latency overlaps the data's
  const bool in_chunk = j < a.q_lens[b];
  int row = 0;
  if (rope) {
    const int p = a.rope_base[b] + j;
    assert((!in_chunk || (p >= 0 && p < a.rows)) &&
           "qkv_rope_write: a live position outside the RoPE table");
    row = min(max(p, 0), a.rows - 1);
  }
  const bool live = which > 0 && in_chunk;
  const int pos = live ? a.starts[b] + j : 0;
  long long block = b;
  int tok = pos;
  if (live && a.page_table != nullptr) {
    block = a.page_table[(long long)b * a.n_pages + pos / a.span];
    tok = pos % a.span;
  }
  const float* cr = rope ? a.cos_t + (long long)row * half : nullptr;
  const float* sr = rope ? a.sin_t + (long long)row * half : nullptr;
  float lo[kMaxPairsPerLane], hi[kMaxPairsPerLane];
#pragma unroll
  for (int p = 0; p < kMaxPairsPerLane; ++p) {
    const int i = lane + 32 * p;
    lo[p] = i < half ? with_bias(bias, i, to_f32(src[i])) : 0.0f;
    hi[p] = i < half ? with_bias(bias, i + half, to_f32(src[i + half]))
                     : 0.0f;
  }
  if (which < 2 && a.norm[which] != nullptr) {   // uniform over the warp
    const T* g = static_cast<const T*>(a.norm[which]);
    const float r = rsqrtf(head_sum_squares(lo, hi, half, lane) /
                               (float)a.hd + kQkNormEps);
#pragma unroll
    for (int p = 0; p < kMaxPairsPerLane; ++p) {
      const int i = lane + 32 * p;
      if (i < half) {
        lo[p] = round_to<T>(__fmul_rn(__fmul_rn(lo[p], r), to_f32(g[i])));
        hi[p] = round_to<T>(
            __fmul_rn(__fmul_rn(hi[p], r), to_f32(g[i + half])));
      }
    }
  }
  if (rope) {
#pragma unroll
    for (int p = 0; p < kMaxPairsPerLane; ++p) {
      const int i = lane + 32 * p;
      if (i < half) {
        const float x1 = lo[p], x2 = hi[p], c = cr[i], s = sr[i];
        const float o1 = __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s));
        const float o2 = __fadd_rn(__fmul_rn(x1, s), __fmul_rn(x2, c));
        lo[p] = round_to<T>(o1);
        hi[p] = round_to<T>(o2);
      }
    }
  }
  if (which == 0) {
    T* dst = static_cast<T*>(a.q_out) +
             (((long long)b * a.hq + head) * a.chunk + j) * a.hd;
#pragma unroll
    for (int p = 0; p < kMaxPairsPerLane; ++p) {
      const int i = lane + 32 * p;
      if (i < half) {
        dst[i] = from_f32<T>(lo[p]);
        dst[i + half] = from_f32<T>(hi[p]);
      }
    }
    return;
  }
  if (!live) return;  // a dead position writes no K/V
  const long long at = (block * a.hkv + head) * a.span + tok;
  const int leaf = which - 1;
  if constexpr (QUANT) {
    float m = 0.0f;
#pragma unroll
    for (int p = 0; p < kMaxPairsPerLane; ++p)
      if (lane + 32 * p < half) m = fmaxf(m, fmaxf(fabsf(lo[p]), fabsf(hi[p])));
    m = warp_max(m);
    const float scale = fmaxf(__fmul_rn(m, 1.0f / 127.0f), 1e-10f);
    int8_t* dst = static_cast<int8_t*>(a.cache[leaf]) + at * a.hd;
#pragma unroll
    for (int p = 0; p < kMaxPairsPerLane; ++p) {
      const int i = lane + 32 * p;
      if (i < half) {
        dst[i] = (int8_t)fminf(fmaxf(rintf(__fdiv_rn(lo[p], scale)), -127.0f),
                               127.0f);
        dst[i + half] = (int8_t)fminf(
            fmaxf(rintf(__fdiv_rn(hi[p], scale)), -127.0f), 127.0f);
      }
    }
    if (lane == 0) a.scale[leaf][at] = scale;
  } else {
    T* dst = static_cast<T*>(a.cache[leaf]) + at * a.hd;
#pragma unroll
    for (int p = 0; p < kMaxPairsPerLane; ++p) {
      const int i = lane + 32 * p;
      if (i < half) {
        dst[i] = from_f32<T>(lo[p]);
        dst[i + half] = from_f32<T>(hi[p]);
      }
    }
  }
}

template <typename T>
int launch_qkv(const QkvArgs& a, int batch, bool quant, cudaStream_t s) {
  const dim3 grid(a.chunk, batch,
                  (a.hq + 2 * a.hkv + kEpiWarps - 1) / kEpiWarps);
  if (quant)
    qkv_rope_write_kernel<T, true><<<grid, kEpiWarps * 32, 0, s>>>(a);
  else
    qkv_rope_write_kernel<T, false><<<grid, kEpiWarps * 32, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace repro

// dst/src: n_leaves pointers; src_strides: (row, head, position) byte
// strides of each leaf's new rows; bytes/vec: each leaf's row width and
// copy width.  starts, q_lens (B,) int32 and page_table (B, n_pages)
// int32 (null for the slot layout) live on the device.
extern "C" int kv_write_launch(void* const* dst, const void* const* src,
                               const long long* src_strides, const int* bytes,
                               const int* vec, int n_leaves, const void* starts,
                               const void* q_lens, const void* page_table,
                               int batch, int heads, int chunk, int span,
                               int n_pages, void* stream) {
  using namespace repro;
  if (n_leaves < 1 || n_leaves > kMaxLeaves) return (int)cudaErrorInvalidValue;
  KvLeaves p = {};
  p.n = n_leaves;
  for (int l = 0; l < n_leaves; ++l) {
    p.dst[l] = static_cast<char*>(dst[l]);
    p.src[l] = static_cast<const char*>(src[l]);
    p.src_b[l] = src_strides[3 * l];
    p.src_h[l] = src_strides[3 * l + 1];
    p.src_j[l] = src_strides[3 * l + 2];
    p.bytes[l] = bytes[l];
    p.vec[l] = vec[l];
  }
  kv_write_kernel<<<dim3(chunk, batch), kWriteThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const int*>(starts), static_cast<const int*>(q_lens),
      static_cast<const int*>(page_table), heads, span, n_pages);
  return (int)cudaGetLastError();
}

// src: raw q, k, v; strides: (row, position) element strides of each;
// bias: three pointers, each null for no bias; norm: q's and k's RMSNorm
// gammas (hd,) in the activation type, both null for none (hd / 2 a
// multiple of 32, or hd <= 32); cos_t/sin_t (rows, hd/2) f32,
// null for no RoPE; rope_base, starts, q_lens (B,) int32 and page_table
// (B, n_pages) int32 (null for the slot layout) on the device; cache: the k
// and v leaves, scale their f32 scales (null unless quant); dtype: the
// activation type (and the fp cache's).
extern "C" int qkv_rope_write_launch(
    const void* const* src, const long long* strides, const void* const* bias,
    const void* const* norm, const void* cos_t, const void* sin_t, int rows,
    const void* rope_base, const void* starts, const void* q_lens,
    const void* page_table,
    void* q_out, void* const* cache, void* const* scale, int batch, int chunk,
    int hq, int hkv, int hd, int span, int n_pages, int quant, int dtype,
    void* stream) {
  using namespace repro;
  if (hd % 2 != 0 || hd / 2 > 32 * kMaxPairsPerLane)
    return (int)cudaErrorInvalidValue;
  if ((norm[0] == nullptr) != (norm[1] == nullptr) ||
      (norm[0] != nullptr && hd > 32 && (hd / 2) % 32 != 0))
    return (int)cudaErrorInvalidValue;
  QkvArgs a = {};
  a.norm[0] = norm[0];
  a.norm[1] = norm[1];
  for (int l = 0; l < 3; ++l) {
    a.src[l] = src[l];
    a.stride_b[l] = strides[2 * l];
    a.stride_j[l] = strides[2 * l + 1];
    a.bias[l] = bias[l];
  }
  a.cos_t = static_cast<const float*>(cos_t);
  a.sin_t = static_cast<const float*>(sin_t);
  a.rows = rows;
  a.rope_base = static_cast<const int*>(rope_base);
  a.starts = static_cast<const int*>(starts);
  a.q_lens = static_cast<const int*>(q_lens);
  a.page_table = static_cast<const int*>(page_table);
  a.q_out = q_out;
  for (int l = 0; l < 2; ++l) {
    a.cache[l] = cache[l];
    a.scale[l] = static_cast<float*>(scale[l]);
  }
  a.hq = hq;
  a.hkv = hkv;
  a.hd = hd;
  a.chunk = chunk;
  a.span = span;
  a.n_pages = n_pages;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) return launch_qkv<__nv_bfloat16>(a, batch, quant, s);
  return launch_qkv<float>(a, batch, quant, s);
}
