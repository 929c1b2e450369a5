// KV-cache write for Hopper (sm_90a): one layer's new K/V (and, for an int8
// cache, their per-token scales) copied in place into the slot cache
// (B, hkv, L, w) or, through the page table, into the shared pool
// (n_blocks + 1, hkv, bs, w), in one launch for every leaf.
//
// Not a port of a TPU kernel: the reference writes its cache with XLA's
// dynamic-update-slice and selects (src/repro/models/attention.py:139,
// :153, :269).  It is a kernel here so that a serving step never reads a
// device value on the host: row b's live positions are j < q_lens[b] at
// logical positions starts[b] + j, read from the device, and a dead
// position writes nothing.  The grid's shape depends on (C, B) alone, so a
// captured CUDA graph replays it for any lengths.
//
// Design: one block per (chunk position j, row b).  A dead position's block
// returns at once; a live one copies, for each leaf, hkv rows of w bytes,
// each thread a 16-byte (or narrower, as the leaf's width and addresses
// allow) piece.  A copy has no arithmetic, so the result is bitwise the
// plain version's index writes.
// What bounds it: bytes, each live (token, head) row read once and written
// once.
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
