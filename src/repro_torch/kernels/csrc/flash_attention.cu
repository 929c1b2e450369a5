// Full-sequence flash attention (forward) for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention_pallas (the
// paper's FP16 x FP16 MODE-0 unit on the dynamically generated operands,
// Q.K^T and P.V).  Same contract: q (B, hq, Sq, d), k and v (B, hkv, Skv, d)
// in float32 or bfloat16, hq % hkv == 0 (query head h reads KV head
// h / (hq / hkv)); query i sits at position Skv - Sq + i.  Masks: causal
// (q_pos >= k_pos), optional sliding window (q_pos - k_pos < window), or
// neither (non-causal, Whisper's cross-attention).  Scores in f32 times
// `scale`; online softmax with m, l and the accumulator in f32;
// probabilities rounded to the activation dtype before P.V; output
// acc / l (l == 0 -> 1) in q's dtype.  A masked key contributes p = 0, so a
// row that sees no key at all (causal with Sq > Skv) returns zeros.
// flash_attention_lse_launch (bfloat16, the training forward) also writes
// each row's log-sum-exp ln(sum_j exp(s_j * scale)) in f32, +inf for a row
// that sees no key; the serving entry passes no lse pointer and its output
// is bitwise the same.
//
// Unlike the TPU kernel, which needs Sq % min(256, Sq) == 0 and
// Skv % min(512, Skv) == 0, this one masks ragged edges itself: rows past
// Sq are staged as zeros and never stored, keys past Skv are zero-filled in
// shared memory and masked, so any prompt length prefills.
//
// Work split: one block of 256 threads per (64-row query tile, query head,
// batch row); tiles are taken latest first (the causal tiles with the most
// keys start first).  The block walks 64-key tiles of K and V in ascending
// order over its live range only: tiles wholly above the causal diagonal of
// its last row, or wholly before the window of its first row, are never
// loaded (the reference's pl.when(live) skip).  Q, K and V tiles are
// converted to f32 once as they are staged in shared memory (rows padded by
// 4 floats: conflict-free 16-byte reads).  Threads form a 16 x 16 grid:
// thread (ty, tx) owns query rows ty + 16 i and, for Q.K^T, keys tx + 16 j
// (i, j < 4), a 4 x 4 register tile reduced over d in order; the row max and
// sum are butterflies over the 16 lanes that share the rows.  The rounded
// probabilities go through shared memory, and for P.V the same thread owns
// d / 16 output dimensions of its 4 rows.
//
// Batch invariance: a query row's arithmetic depends only on its own q row,
// the K/V rows and the fixed 64-key tile grid anchored at key 0 -- never on
// B, Sq, the other rows or the query tiling.  A tile that is live for the
// block but fully masked for a row leaves that row's m, l and acc bitwise
// unchanged (p = 0, alpha = exp(0) = 1), so a row of a batch of 3 equals the
// same row alone, and forward's last position equals prefill's.
//
// What bounds it on the card: 4 * d operations per (query head, visible
// key) pair against the bytes of q, k, v and out; at prefill lengths it is
// far above the card's ridge, so operations.  bfloat16 runs both
// contractions on the tensor cores (flash_attention_mma_kernel below);
// float32 keeps the kernel above it, f32 FMAs on the CUDA cores (about 67
// TFLOP/s at most).
//
// The bfloat16 kernel: the same blocks, masks, tile grid and live-tile
// skip, 128 threads.  Q.K^T and P.V go through mma.sync m16n8k16 (bf16
// operands, f32 accumulation).  Each of the 4 warps owns 16 query rows;
// their Q fragments are loaded once with ldmatrix and stay in registers.
// K and V tiles come through a two-stage cp.async ring in shared memory
// (16-byte chunks XOR-swizzled, zero-filled past Skv), the next tile in
// flight while the warps work on this one; K feeds the B fragments with
// ldmatrix, V with ldmatrix.trans.  The 16 x 64 score fragment stays in
// registers: scores are taken to the log2 domain (s * scale * log2 e,
// exp2), the row max and row sum are shuffles over the 4 lanes of a quad
// in a fixed order, and l sums the unrounded f32 p.  The probabilities,
// rounded to bf16, are repacked from the accumulator layout into the A
// fragments of P.V in registers (two n8 score fragments make one k16
// operand), never through shared memory.  A tile that every row of the
// block sees in full skips the mask arithmetic; that changes no value.
// Q is staged in the second ring stage before the first tile needs it.
//
// Head dim 256 (gemma-2b).  The output accumulator alone is ND x 4 = 128
// f32 registers a thread there, and Q's KS = 16 A fragments would add 64
// more on top of the score tile's 32: past what a thread of a 128-thread
// block keeps.  So at D > 128 Q stays in shared memory, in a 32 KB region
// of its own after the two K/V stages (160 KB in all, one block an SM),
// and each warp loads its A fragment of k16 step ks with ldmatrix right
// before that step's products.  Three more things keep the kernel out of
// local memory there (ptxas reported 256, then 72 and 40 bytes of spill
// stores before each): the k16 steps of Q.K^T run as a loop, not
// unrolled, so no later step's K fragments are loaded early; the next
// tile's copies are issued one at a time, so their addresses are not
// hoisted out of the tile loop; and P.V addresses a V fragment as a row
// base plus one of 4 swizzled offsets (the swizzle moves a chunk within
// its 8 by the key's low 3 bits, the same at every k16 step).  The
// operands, the products and their order are those of the register-
// resident Q: each score sums its k16 steps over d in order and each
// output its keys in tile order, so no result depends on the layout.
//
// -Xptxas -v (sm_90a), one barrier each; registers a thread and dynamic
// shared memory at d = 32 / 64 / 128 / 256:
//   bfloat16 (tensor cores): 113 / 163 / 228 / 248 registers, no spills;
//                            16 / 32 / 64 / 160 KB (2 blocks an SM at 128,
//                            1 at 256)
//   float32 (CUDA cores):    80 (56 bytes spilled) / 118 / 128 / 218
//                            registers; 44 / 68 / 116 / 212 KB
#include "mma.cuh"

REPRO_ERROR_STRING_FN

namespace repro {

constexpr int kFaThreads = 256;    // a 16 x 16 grid of threads
constexpr int kFaBq = 64;          // query rows per block
constexpr int kFaBk = 64;          // keys per K/V tile
constexpr int kFaPs = kFaBk + 4;   // padded row of the probability tile
constexpr float kFaNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

// Q, K and V tiles as f32 rows of D + 4, and the probability tile.
template <int D>
constexpr int fa_smem_bytes() {
  return ((kFaBq + 2 * kFaBk) * (D + 4) + kFaBq * kFaPs) * (int)sizeof(float);
}

// Stage rows row0 .. row0 + n_rows - 1 of a row-major (rows, D) operand
// into dst as f32 rows of D + 4; the block's remaining rows become zeros.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void fa_stage(float* dst, const T* __restrict__ src,
                                         int row0, int n_rows) {
  constexpr int kVec = 16 / (int)sizeof(T);    // 8 bf16 or 4 f32 per 16 B
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += kFaThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    float vals[kVec];
    if (r < n_rows) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
          src + (size_t)(row0 + r) * D + c));
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int t = 0; t < kVec; ++t) vals[t] = to_f32(e[t]);
    } else {
#pragma unroll
      for (int t = 0; t < kVec; ++t) vals[t] = 0.0f;
    }
#pragma unroll
    for (int t = 0; t < kVec; t += 4)
      *reinterpret_cast<float4*>(dst + r * (D + 4) + c + t) =
          make_float4(vals[t], vals[t + 1], vals[t + 2], vals[t + 3]);
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int m = 8; m > 0; m >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}

// Butterfly over the 16 lanes of a half warp: every lane ends with the same
// sum (each stage adds the same pair in both partners).
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int m = 8; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

__device__ __forceinline__ float f4(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

template <typename T, int D>
__global__ void __launch_bounds__(kFaThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int hq, int hkv, int sq, int skv, float scale,
                           int causal, int window) {
  constexpr int S = D + 4;
  constexpr int kDpt = D / 16;                 // P.V dims per thread
  constexpr int kCh = kDpt >= 4 ? 4 : kDpt;    // contiguous dims per chunk
  constexpr int kChunks = kDpt / kCh;
  extern __shared__ __align__(16) float fa_smem[];
  float* qs = fa_smem;
  float* ks = qs + kFaBq * S;
  float* vs = ks + kFaBk * S;
  float* ps = vs + kFaBk * S;

  const int iq = gridDim.x - 1 - blockIdx.x;   // latest query tile first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = iq * kFaBq;
  const int q_rows = min(kFaBq, sq - q0);
  const int q_first = skv - sq + q0;           // position of the tile's row 0
  const int q_last = q_first + q_rows - 1;

  const T* qb = q + ((size_t)b * hq + h) * sq * D;
  const T* kb = k + ((size_t)b * hkv + kvh) * skv * D;
  const T* vb = v + ((size_t)b * hkv + kvh) * skv * D;
  fa_stage<T, D, kFaBq>(qs, qb, q0, q_rows);

  float m[4], l[4], acc[4][kDpt];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kFaNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < kDpt; ++e) acc[i][e] = 0.0f;
  }

  // live K/V tiles [t_lo, t_hi): below the causal diagonal of the last row,
  // not wholly before the window of the first row
  int t_lo = 0, t_hi = (skv + kFaBk - 1) / kFaBk;
  if (causal) t_hi = q_last >= 0 ? min(t_hi, q_last / kFaBk + 1) : 0;
  if (window > 0) {
    const int floor_pos = q_first - window + 1;
    if (floor_pos > 0) t_lo = floor_pos / kFaBk;
  }

  for (int it = t_lo; it < t_hi; ++it) {
    const int k0 = it * kFaBk;
    __syncthreads();          // Q staged; the previous tile's readers done
    fa_stage<T, D, kFaBk>(ks, kb, k0, min(kFaBk, skv - k0));
    fa_stage<T, D, kFaBk>(vs, vb, k0, min(kFaBk, skv - k0));
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int dd = 0; dd < D; dd += 4) {
      float4 qf[4], kf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qf[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * S + dd);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kf[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * S + dd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qf[i].x, kf[j].x, s[i][j]);
          s[i][j] = fmaf(qf[i].y, kf[j].y, s[i][j]);
          s[i][j] = fmaf(qf[i].z, kf[j].z, s[i][j]);
          s[i][j] = fmaf(qf[i].w, kf[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q_first + ty + 16 * i;
      bool ok[4];
      float mx = kFaNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        bool valid = k_pos < skv;
        if (causal) valid = valid && q_pos >= k_pos;
        if (window > 0) valid = valid && q_pos - k_pos < window;
        ok[j] = valid;
        s[i][j] = valid ? s[i][j] * scale : kFaNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.0f;
        psum += p;
        ps[(ty + 16 * i) * kFaPs + tx + 16 * j] = round_to<T>(p);
      }
      psum = half_warp_sum(psum);
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < kDpt; ++e) acc[i][e] *= alpha;
    }
    __syncthreads();          // the probability tile is complete

#pragma unroll 2
    for (int kk = 0; kk < kFaBk; kk += 4) {
      float4 pf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pf[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * kFaPs +
                                                 kk);
#pragma unroll
      for (int e4 = 0; e4 < 4; ++e4) {
        const float* vrow = vs + (kk + e4) * S;
        float vv[kDpt];
#pragma unroll
        for (int u = 0; u < kChunks; ++u) {
          const int dim = (u * 16 + tx) * kCh;
          if constexpr (kCh == 4) {
            const float4 t = *reinterpret_cast<const float4*>(vrow + dim);
            vv[u * 4] = t.x;
            vv[u * 4 + 1] = t.y;
            vv[u * 4 + 2] = t.z;
            vv[u * 4 + 3] = t.w;
          } else {
            const float2 t = *reinterpret_cast<const float2*>(vrow + dim);
            vv[u * 2] = t.x;
            vv[u * 2 + 1] = t.y;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = f4(pf[i], e4);
#pragma unroll
          for (int e = 0; e < kDpt; ++e) acc[i][e] = fmaf(p, vv[e], acc[i][e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= q_rows) continue;
    const float denom = (l[i] == 0.0f) ? 1.0f : l[i];
    T* orow = out + (((size_t)b * hq + h) * sq + q0 + r) * D;
#pragma unroll
    for (int u = 0; u < kChunks; ++u)
#pragma unroll
      for (int e = 0; e < kCh; ++e)
        orow[(u * 16 + tx) * kCh + e] = from_f32<T>(acc[i][u * kCh + e] / denom);
  }
}

template <typename T, int D>
int launch_flash(const void* q, const void* k, const void* v, void* out,
                 int batch, int hq, int hkv, int sq, int skv, float scale,
                 int causal, int window, cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, D>;
  constexpr int smem = fa_smem_bytes<D>();
  REPRO_SMEM_OPT_IN(kernel, smem);
  dim3 grid((sq + kFaBq - 1) / kFaBq, hq, batch);
  kernel<<<grid, kFaThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), hq, hkv, sq, skv, scale,
      causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_head_dim(int d, const void* q, const void* k, const void* v,
                      void* out, int batch, int hq, int hkv, int sq, int skv,
                      float scale, int causal, int window, cudaStream_t s) {
  switch (d) {
    case 32:
      return launch_flash<T, 32>(q, k, v, out, batch, hq, hkv, sq, skv, scale,
                                 causal, window, s);
    case 64:
      return launch_flash<T, 64>(q, k, v, out, batch, hq, hkv, sq, skv, scale,
                                 causal, window, s);
    case 128:
      return launch_flash<T, 128>(q, k, v, out, batch, hq, hkv, sq, skv,
                                  scale, causal, window, s);
    case 256:
      return launch_flash<T, 256>(q, k, v, out, batch, hq, hkv, sq, skv,
                                  scale, causal, window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---- bfloat16 on the tensor cores ------------------------------------------

constexpr int kFmWarps = 4;       // 16 query rows a warp: kFaBq
constexpr int kFmThreads = 32 * kFmWarps;
static_assert(kFaBq == 16 * kFmWarps && kFaBk == 64,
              "a warp per 16 query rows, 8 n8 score fragments a key tile");

// Q's fragments stay in registers up to head dim 128; above, in shared
// memory (the register budget; see the note at the top).
template <int D>
constexpr bool kFaQInRegs = D <= 128;

// Two stages of a K tile and a V tile, 64 rows of D bf16 each; above head
// dim 128 also Q's own 64 rows.
template <int D>
constexpr int fa_mma_smem_bytes() {
  return (2 * 2 * kFaBk + (kFaQInRegs<D> ? 0 : kFaBq)) * staged_dim(D) *
         (int)sizeof(__nv_bfloat16);
}

// cp.async rows row0 .. row0 + n_rows - 1 of a row-major (rows, D) bf16
// operand into a ROWS-row tile of swizzled 16-byte chunks, rows
// staged_dim(D) wide; zeros past n_rows.
template <int D, int ROWS>
__device__ __forceinline__ void fa_mma_load(__nv_bfloat16* dst,
                                            const __nv_bfloat16* src,
                                            int row0, int n_rows) {
  constexpr int R = D / 8;                 // chunks a row holds
  constexpr int RS = staged_dim(D) / 8;    // chunks a staged row
  static_assert(ROWS * R % kFmThreads == 0, "whole copies a thread");
  auto load = [&](int j) {
    const int i = threadIdx.x + j * kFmThreads;
    const int r = i / R, c = i % R;
    const bool ok = r < n_rows;
    cp_async16(dst + (r * RS + swz<RS>(r, c)) * 8,
               ok ? src + (size_t)(row0 + r) * D + c * 8 : src, ok ? 16 : 0);
  };
  if constexpr (kFaQInRegs<D>) {
#pragma unroll
    for (int j = 0; j < ROWS * R / kFmThreads; ++j) load(j);
  } else {
    // one copy at a time above head dim 128: unrolled, the copies'
    // addresses are hoisted out of the tile loop and the registers spill
#pragma unroll 1
    for (int j = 0; j < ROWS * R / kFmThreads; ++j) load(j);
  }
}

// The online softmax of one 64-key tile for this lane's rows g (h = 0) and
// g + 8 (h = 1): s (the tile's Q.K^T fragment) becomes p, m, l and acc
// are rescaled.  MASK: evaluate the masks per element (else every key of
// the tile is visible to every row of the block).
template <int ND, bool MASK>
__device__ __forceinline__ void fa_mma_softmax(
    float (&s)[8][4], float (&m)[2], float (&l)[2], float (&acc)[ND][4],
    float scale_log2, int k0, int row_pos, int skv, int causal, int window,
    int t) {
  bool ok[8][4];
  float mx[2] = {kFaNegInf, kFaNegInf};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      bool valid = true;
      if constexpr (MASK) {
        const int k_pos = k0 + 8 * j + 2 * t + (e & 1);
        const int q_pos = row_pos + 8 * (e >> 1);
        valid = k_pos < skv;
        if (causal) valid = valid && q_pos >= k_pos;
        if (window > 0) valid = valid && q_pos - k_pos < window;
      }
      ok[j][e] = valid;
      s[j][e] = valid ? s[j][e] * scale_log2 : kFaNegInf;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
  float alpha[2], psum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m_new = fmaxf(m[h], quad_max(mx[h]));
    alpha[h] = exp2f(m[h] - m_new);
    m[h] = m_new;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ok[j][e] ? exp2f(s[j][e] - m[e >> 1]) : 0.0f;
      psum[e >> 1] += p;
      s[j][e] = p;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + quad_sum(psum[h]);
#pragma unroll
  for (int dn = 0; dn < ND; ++dn) {
    acc[dn][0] *= alpha[0];
    acc[dn][1] *= alpha[0];
    acc[dn][2] *= alpha[1];
    acc[dn][3] *= alpha[1];
  }
}

template <int D>
__global__ void __launch_bounds__(kFmThreads)
    flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                               const __nv_bfloat16* __restrict__ k,
                               const __nv_bfloat16* __restrict__ v,
                               __nv_bfloat16* __restrict__ out, int hq,
                               int hkv, int sq, int skv, float scale_log2,
                               int causal, int window,
                               float* __restrict__ lse) {
  constexpr int R = staged_dim(D) / 8;   // 16-byte chunks a staged row
  constexpr int KS = D / 16;       // k16 steps of Q.K^T over d
  constexpr int ND = D / 8;        // n8 fragments of the output
  constexpr int kTile = kFaBk * staged_dim(D);
  extern __shared__ __align__(16) unsigned char fa_mma_smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(fa_mma_smem);

  const int iq = gridDim.x - 1 - blockIdx.x;   // latest query tile first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int q0 = iq * kFaBq;
  const int q_rows = min(kFaBq, sq - q0);
  const int q_first = skv - sq + q0;           // position of the tile's row 0
  const int q_last = q_first + q_rows - 1;
  const int row_pos = q_first + warp * 16 + (lane >> 2);   // rows g, g + 8

  const __nv_bfloat16* qb = q + ((size_t)b * hq + h) * sq * D;
  const __nv_bfloat16* kb = k + ((size_t)b * hkv + kvh) * skv * D;
  const __nv_bfloat16* vb = v + ((size_t)b * hkv + kvh) * skv * D;

  // live K/V tiles [t_lo, t_hi), as in the f32 kernel
  int t_lo = 0, t_hi = (skv + kFaBk - 1) / kFaBk;
  if (causal) t_hi = q_last >= 0 ? min(t_hi, q_last / kFaBk + 1) : 0;
  if (window > 0) {
    const int floor_pos = q_first - window + 1;
    if (floor_pos > 0) t_lo = floor_pos / kFaBk;
  }

  // Q into stage 1 (free until the second live tile) or, above head dim
  // 128, into its own region; the first live tile into stage 0
  constexpr bool kQRegs = kFaQInRegs<D>;
  __nv_bfloat16* qs = ring + (kQRegs ? 2 : 4) * kTile;
  fa_mma_load<D, kFaBq>(qs, qb, q0, q_rows);
  cp_async_commit();
  if (t_lo < t_hi) {
    const int k0 = t_lo * kFaBk;
    fa_mma_load<D, kFaBk>(ring, kb, k0, min(kFaBk, skv - k0));
    fa_mma_load<D, kFaBk>(ring + kTile, vb, k0, min(kFaBk, skv - k0));
  }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  // this lane's address of Q's A fragment of k16 step ks (ldmatrix x4)
  const int q_row = warp * 16 + (lane & 15);
  auto q_frag = [&](int ks) {
    const int c = 2 * ks + (lane >> 4);
    return qs + (q_row * R + swz<R>(q_row, c)) * 8;
  };
  uint32_t qf[kQRegs ? KS : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) ldsm_x4(qf[ks], q_frag(ks));
  }

  float m[2] = {kFaNegInf, kFaNegInf}, l[2] = {0.0f, 0.0f}, acc[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.0f;

  for (int it = t_lo; it < t_hi; ++it) {
    const int st = (it - t_lo) & 1;
    cp_async_wait<0>();   // tile it has landed
    __syncthreads();      // ... for every thread; every warp is done with
                          // the other stage (tile it - 1, or Q)
    if (it + 1 < t_hi) {
      const int k1 = (it + 1) * kFaBk;
      __nv_bfloat16* nxt = ring + (st ^ 1) * 2 * kTile;
      fa_mma_load<D, kFaBk>(nxt, kb, k1, min(kFaBk, skv - k1));
      fa_mma_load<D, kFaBk>(nxt + kTile, vb, k1, min(kFaBk, skv - k1));
    }
    cp_async_commit();
    const __nv_bfloat16* ks_ = ring + st * 2 * kTile;
    const __nv_bfloat16* vs_ = ks_ + kTile;
    const int k0 = it * kFaBk;

    // S = Q.K^T: 8 fragments of 8 keys, each summed over d in k16 steps
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    auto qk_step = [&](const uint32_t (&qa)[4], int ks) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        // keys 16p.. 16p + 15: lanes 0-7 / 16-23 the first / second 8
        // keys at d chunk 2 ks, lanes 8-15 / 24-31 the same at 2 ks + 1
        const int key = 16 * p + (lane & 7) + ((lane >> 4) & 1) * 8;
        const int c = 2 * ks + ((lane >> 3) & 1);
        uint32_t kf[4];
        ldsm_x4(kf, ks_ + (key * R + swz<R>(key, c)) * 8);
        mma_bf16(s[2 * p], qa, kf[0], kf[1]);
        mma_bf16(s[2 * p + 1], qa, kf[2], kf[3]);
      }
    };
    if constexpr (kQRegs) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) qk_step(qf[ks], ks);
    } else {
      // one k16 step at a time: unrolled, the K fragments of later steps
      // are loaded early and the registers spill
#pragma unroll 1
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t qa[4];
        ldsm_x4(qa, q_frag(ks));
        qk_step(qa, ks);
      }
    }

    const bool full = k0 + kFaBk <= skv &&
                      (!causal || k0 + kFaBk - 1 <= q_first) &&
                      (window <= 0 || q_first + kFaBq - 1 - k0 < window);
    if (full)
      fa_mma_softmax<ND, false>(s, m, l, acc, scale_log2, k0, row_pos, skv,
                                causal, window, t);
    else
      fa_mma_softmax<ND, true>(s, m, l, acc, scale_log2, k0, row_pos, skv,
                               causal, window, t);

    // acc += P.V: P's fragments 2 kk and 2 kk + 1 (keys 16 kk..) are the
    // A operand of k16 step kk.  Above head dim 128 (R = 32) the chunk
    // 2 dp + (lane >> 4) of a V row sits at 8 (dp / 4) + cx[dp % 4]: the
    // swizzle only moves a chunk inside its 8, by the key's low 3 bits,
    // which are lane & 7 at every kk, so the 4 x KS fragment addresses are
    // 4 row bases and 4 offsets, not KS x 4 registers that spill
    int cx[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) cx[j] = swz<R>(lane & 7, 2 * j + (lane >> 4));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int key = 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int dp = 0; dp < KS; ++dp) {
        const int c = 2 * dp + (lane >> 4);
        uint32_t vf[4];
        if constexpr (kQRegs)
          ldsm_x4_trans(vf, vs_ + (key * R + swz<R>(key, c)) * 8);
        else
          ldsm_x4_trans(vf, vs_ + (key * R + 8 * (dp >> 2) + cx[dp & 3]) * 8);
        mma_bf16(acc[2 * dp], a, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], a, vf[2], vf[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * 16 + (lane >> 2) + 8 * hh;
    if (r >= q_rows) continue;
    const float denom = (l[hh] == 0.0f) ? 1.0f : l[hh];
    __nv_bfloat16* orow = out + (((size_t)b * hq + h) * sq + q0 + r) * D;
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
      *reinterpret_cast<uint32_t*>(orow + 8 * dn + 2 * t) =
          pack_bf16x2(acc[dn][2 * hh] / denom, acc[dn][2 * hh + 1] / denom);
    // the row's log-sum-exp in the natural domain (m is in log2 units);
    // +inf for a row that saw no key, so the backward's p = exp(s - lse)
    // is 0 there.  The quad's 4 lanes hold the same m and l.
    if (lse != nullptr && t == 0)
      lse[((size_t)b * hq + h) * sq + q0 + r] =
          l[hh] == 0.0f ? __int_as_float(0x7f800000)
                       : (m[hh] + log2f(l[hh])) * kLn2;
  }
}

template <int D>
int launch_flash_mma(const void* q, const void* k, const void* v, void* out,
                     float* lse, int batch, int hq, int hkv, int sq, int skv,
                     float scale, int causal, int window,
                     cudaStream_t stream) {
  auto kernel = flash_attention_mma_kernel<D>;
  constexpr int smem = fa_mma_smem_bytes<D>();
  REPRO_SMEM_OPT_IN(kernel, smem);
  dim3 grid((sq + kFaBq - 1) / kFaBq, hq, batch);
  kernel<<<grid, kFmThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      hq, hkv, sq, skv, scale * kLog2e, causal, window, lse);
  return (int)cudaGetLastError();
}

// lse null: the serving forward (no log-sum-exp written)
int dispatch_head_dim_mma(int d, const void* q, const void* k, const void* v,
                          void* out, float* lse, int batch, int hq, int hkv,
                          int sq, int skv, float scale, int causal,
                          int window, cudaStream_t s) {
  switch (d) {
    case 32:
      return launch_flash_mma<32>(q, k, v, out, lse, batch, hq, hkv, sq, skv,
                                  scale, causal, window, s);
    case 64:
      return launch_flash_mma<64>(q, k, v, out, lse, batch, hq, hkv, sq, skv,
                                  scale, causal, window, s);
    case 112:
      return launch_flash_mma<112>(q, k, v, out, lse, batch, hq, hkv, sq,
                                   skv, scale, causal, window, s);
    case 128:
      return launch_flash_mma<128>(q, k, v, out, lse, batch, hq, hkv, sq,
                                   skv, scale, causal, window, s);
    case 256:
      return launch_flash_mma<256>(q, k, v, out, lse, batch, hq, hkv, sq,
                                   skv, scale, causal, window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace repro

// window 0: no sliding window.  causal 0: every key of the row is visible
// (the window, if any, still bounds it from below).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int batch,
                                      int hq, int hkv, int sq, int skv,
                                      int head_dim, float scale, int causal,
                                      int window, int dtype, void* stream) {
  using namespace repro;
  if (batch < 1 || sq < 1 || skv < 1 || hkv < 1 || hq % hkv || batch > 65535 ||
      hq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return dispatch_head_dim_mma(head_dim, q, k, v, out, nullptr, batch, hq,
                                 hkv, sq, skv, scale, causal, window, s);
  return dispatch_head_dim<float>(head_dim, q, k, v, out, batch, hq, hkv, sq,
                                  skv, scale, causal, window, s);
}

// The training forward: the bfloat16 kernel above, which also writes each
// query row's log-sum-exp (B, hq, Sq) f32 for the backward
// (flash_attention_bwd.cu).  The output is bitwise the serving call's.
extern "C" int flash_attention_lse_launch(const void* q, const void* k,
                                          const void* v, void* out,
                                          void* lse, int batch, int hq,
                                          int hkv, int sq, int skv,
                                          int head_dim, float scale,
                                          int causal, int window,
                                          void* stream) {
  using namespace repro;
  if (batch < 1 || sq < 1 || skv < 1 || hkv < 1 || hq % hkv || batch > 65535 ||
      hq > 65535 || lse == nullptr)
    return (int)cudaErrorInvalidValue;
  return dispatch_head_dim_mma(head_dim, q, k, v, out,
                               static_cast<float*>(lse), batch, hq, hkv, sq,
                               skv, scale, causal, window,
                               static_cast<cudaStream_t>(stream));
}
