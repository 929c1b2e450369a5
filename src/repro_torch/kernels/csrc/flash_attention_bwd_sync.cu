// Full-sequence flash attention, backward, on mma.sync: the first design
// of kernel 7's backward, kept off the training path as the yardstick the
// wgmma kernel (flash_attention_bwd.cu) is timed against.
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
//   D_i  = sum_d dO_i * O_i                          (f32, first launch)
//   dP   = dO . V^T,   dS = P * (dP - D)
//   dV   = P^T . dO,   dK = scale * dS^T . Q,   dQ = scale * dS . K
// P and dS are rounded to bf16 as the A operands of the products (the
// forward rounds P before P.V the same way); every sum is f32.  dK and dV
// of a KV head sum over its hq / hkv query heads.
//
// Work split, no atomics: every output element is written once by one
// block, and each of its sums runs in one fixed order, so the backward is
// bitwise repeatable and a batch row's gradients do not depend on the
// other rows.
//   dK, dV: one block of 4 warps per (64-key tile, KV head, batch row); each
//     warp owns 16 keys.  K and V stay in shared memory; the block walks
//     the rep query heads in order and, in each, the live 64-row query
//     tiles ascending (the forward's live-tile rule, so exactly the tiles
//     the forward visited), 32 queries at a time.  Q and dO tiles (with
//     their rows' lse and D) come through a two-stage cp.async ring.
//   dQ: one block of 4 warps per (64-row query tile, query head, batch
//     row); each warp owns 16 rows.  Q and dO stay in shared memory; the
//     block walks the live 64-key tiles ascending, 32 keys at a time,
//     through the same ring.
// S^T = K.Q^T and dP^T = V.dO^T (or S = Q.K^T and dP = dO.V^T) are mma.sync
// m16n8k16 products read with ldmatrix from 16-byte-chunk XOR-swizzled
// tiles, as in the forward; P and dS are repacked from the accumulator
// layout into A fragments in registers and multiplied with the other
// operand read by ldmatrix.trans.  Ragged Sq and Skv are zero-filled in
// shared memory and masked.
//
// What bounds it: seven products of 2 d operations per visible (query
// head, key) pair (S and dP twice, once in each kernel, and dV, dK, dQ
// once) against one read of q, k, v, o, dO and lse and one write of dq,
// dk and dv; at training lengths it is operations.  Head dims 32, 64 and
// 128 in bfloat16.
#include "mma.cuh"

REPRO_ERROR_STRING_FN

namespace repro {
// internal linkage: the kernel libraries are loaded into one process, and
// no two may bind each other's helpers
namespace {

constexpr int kBwWarps = 4;
constexpr int kBwThreads = 32 * kBwWarps;
constexpr int kBwTile = 64;          // query rows or keys a tile

// cp.async rows row0 .. row0 + n_rows - 1 of a row-major (rows, D) bf16
// operand into a 64-row tile of swizzled 16-byte chunks; zeros past n_rows.
template <int D>
__device__ __forceinline__ void bw_load(__nv_bfloat16* dst,
                                        const __nv_bfloat16* src, int row0,
                                        int n_rows) {
  constexpr int R = D / 8;
  static_assert(kBwTile * R % kBwThreads == 0, "whole copies a thread");
#pragma unroll
  for (int j = 0; j < kBwTile * R / kBwThreads; ++j) {
    const int i = threadIdx.x + j * kBwThreads;
    const int r = i / R, c = i % R;
    const bool ok = r < n_rows;
    cp_async16(dst + (r * R + swz<R>(r, c)) * 8,
               ok ? src + (size_t)(row0 + r) * D + c * 8 : src, ok ? 16 : 0);
  }
}

// acc (16 x 8 NJ) += A (rows a_row0 .. + 15 of tile a) . B^T (rows b_row0 ..
// + 8 NJ - 1 of tile b), both (rows, D) swizzled, summed over d in k16
// steps in order (the forward's Q.K^T fragments).
template <int D, int NJ>
__device__ __forceinline__ void mma_abt(float (&acc)[NJ][4],
                                        const __nv_bfloat16* a, int a_row0,
                                        const __nv_bfloat16* b, int b_row0,
                                        int lane) {
  constexpr int R = D / 8;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t af[4];
    const int ar = a_row0 + (lane & 15);
    const int ac = 2 * ks + (lane >> 4);
    ldsm_x4(af, a + (ar * R + swz<R>(ar, ac)) * 8);
#pragma unroll
    for (int p = 0; p < NJ / 2; ++p) {
      const int br = b_row0 + 16 * p + (lane & 7) + ((lane >> 4) & 1) * 8;
      const int bc = 2 * ks + ((lane >> 3) & 1);
      uint32_t bf[4];
      ldsm_x4(bf, b + (br * R + swz<R>(br, bc)) * 8);
      mma_bf16(acc[2 * p], af, bf[0], bf[1]);
      mma_bf16(acc[2 * p + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 x D) += A (16 x 16 KK, fragments a[kk] from registers) . B (rows
// b_row0 .. + 16 KK - 1 of tile b, (rows, D) swizzled), summed over the
// rows in k16 steps in order (the forward's P.V fragments).
template <int D, int KK>
__device__ __forceinline__ void mma_pb(float (&acc)[D / 8][4],
                                       uint32_t (&a)[KK][4],
                                       const __nv_bfloat16* b, int b_row0,
                                       int lane) {
  constexpr int R = D / 8;
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    const int row = b_row0 + 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      const int c = 2 * dp + (lane >> 4);
      uint32_t bf[4];
      ldsm_x4_trans(bf, b + (row * R + swz<R>(row, c)) * 8);
      mma_bf16(acc[2 * dp], a[kk], bf[0], bf[1]);
      mma_bf16(acc[2 * dp + 1], a[kk], bf[2], bf[3]);
    }
  }
}

// Two n8 accumulator fragments (16 x 16) as the A fragments of a k16 step,
// rounded to bf16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[2][4],
                                       float (&s)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    a[kk][0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
    a[kk][1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
    a[kk][2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[kk][3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

__device__ __forceinline__ bool visible(int q_pos, int k_pos, int causal,
                                        int window) {
  bool ok = true;
  if (causal) ok = q_pos >= k_pos;
  if (window > 0) ok = ok && q_pos - k_pos < window;
  return ok;
}

// The forward's live K/V tiles [t_lo, t_hi) of the query tile at q0.
__device__ __forceinline__ void live_tiles(int q0, int sq, int skv,
                                           int causal, int window, int& t_lo,
                                           int& t_hi) {
  const int q_first = skv - sq + q0;
  const int q_last = q_first + min(kBwTile, sq - q0) - 1;
  t_lo = 0;
  t_hi = (skv + kBwTile - 1) / kBwTile;
  if (causal) t_hi = q_last >= 0 ? min(t_hi, q_last / kBwTile + 1) : 0;
  if (window > 0) {
    const int floor_pos = q_first - window + 1;
    if (floor_pos > 0) t_lo = floor_pos / kBwTile;
  }
}

// D_i = sum_d dO_i,d * O_i,d in f32: one warp a row, each lane D / 32
// neighbouring dims, then the warp's butterfly.
template <int D>
__global__ void __launch_bounds__(256)
    fa_bwd_dot_kernel(const __nv_bfloat16* __restrict__ o,
                      const __nv_bfloat16* __restrict__ dout,
                      float* __restrict__ delta, int rows) {
  constexpr int E = D / 32;
  const long row = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;               // whole warps leave together
  const __nv_bfloat16* orow = o + row * D + lane * E;
  const __nv_bfloat16* drow = dout + row * D + lane * E;
  float s = 0.0f;
#pragma unroll
  for (int e = 0; e < E; ++e)
    s = fmaf(__bfloat162float(drow[e]), __bfloat162float(orow[e]), s);
  s = warp_sum(s);
  if (lane == 0) delta[row] = s;
}

template <int D>
constexpr int bw_smem_bytes() {
  // two resident tiles, a two-stage ring of two tiles, and the ring's
  // per-row lse and D (dK/dV only; the dQ kernel keeps its rows' in
  // registers)
  return 6 * kBwTile * D * (int)sizeof(__nv_bfloat16) +
         2 * 2 * kBwTile * (int)sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kBwThreads)
    fa_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dk,
                      __nv_bfloat16* __restrict__ dv, int hq, int hkv,
                      int sq, int skv, float scale, float scale_log2,
                      int causal, int window) {
  constexpr int ND = D / 8;
  constexpr int kTile = kBwTile * D;
  extern __shared__ __align__(16) unsigned char bw_smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(bw_smem);
  __nv_bfloat16* vs = ks + kTile;
  __nv_bfloat16* ring = vs + kTile;      // stage st: Q, dO
  float* stats = reinterpret_cast<float*>(ring + 4 * kTile);   // lse2, D

  const int ik = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int rep = hq / hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = ik * kBwTile;
  const int k_rows = min(kBwTile, skv - k0);
  const int n_qt = (sq + kBwTile - 1) / kBwTile;
  const int total = rep * n_qt;          // (query head, query tile) items

  const size_t kv_base = ((size_t)b * hkv + kvh) * skv;
  bw_load<D>(ks, k + kv_base * D, k0, k_rows);
  bw_load<D>(vs, v + kv_base * D, k0, k_rows);

  auto live = [&](int idx) {
    int t_lo, t_hi;
    live_tiles((idx % n_qt) * kBwTile, sq, skv, causal, window, t_lo, t_hi);
    return t_lo <= ik && ik < t_hi;
  };
  auto next_live = [&](int idx) {
    while (idx < total && !live(idx)) ++idx;
    return idx;
  };
  // item idx's Q and dO tiles into stage st (cp.async), its rows' lse (in
  // log2 units) and D into the stage's stats (zeros past Sq)
  auto load_item = [&](int idx, int st) {
    const int h = kvh * rep + idx / n_qt;
    const int q0 = (idx % n_qt) * kBwTile;
    const int q_rows = min(kBwTile, sq - q0);
    const size_t row_base = ((size_t)b * hq + h) * sq;
    __nv_bfloat16* qs_ = ring + st * 2 * kTile;
    bw_load<D>(qs_, q + row_base * D, q0, q_rows);
    bw_load<D>(qs_ + kTile, dout + row_base * D, q0, q_rows);
    float* sl = stats + st * 2 * kBwTile;
    const int r = threadIdx.x & (kBwTile - 1);
    if (threadIdx.x < kBwTile)
      sl[r] = r < q_rows ? lse[row_base + q0 + r] * kLog2e : 0.0f;
    else
      sl[kBwTile + r] = r < q_rows ? delta[row_base + q0 + r] : 0.0f;
  };

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dn][e] = dv_acc[dn][e] = 0.0f;

  int cur = next_live(0), st = 0;
  if (cur < total) load_item(cur, 0);
  cp_async_commit();
  while (cur < total) {
    cp_async_wait<0>();    // K, V and this item's tiles have landed
    __syncthreads();       // ... for every thread; every warp is done with
                           // the other stage
    const int nxt = next_live(cur + 1);
    if (nxt < total) load_item(nxt, st ^ 1);
    cp_async_commit();

    const int q0 = (cur % n_qt) * kBwTile;
    const int q_rows = min(kBwTile, sq - q0);
    const int q_first = skv - sq + q0;
    const __nv_bfloat16* qs_ = ring + st * 2 * kTile;
    const __nv_bfloat16* dos_ = qs_ + kTile;
    const float* sl = stats + st * 2 * kBwTile;
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      // S^T and dP^T for the warp's 16 keys x 32 queries
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
      mma_abt<D, 4>(s, ks, warp * 16, qs_, 32 * half, lane);
      mma_abt<D, 4>(dp, vs, warp * 16, dos_, 32 * half, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kr = warp * 16 + g + 8 * (e >> 1);
          const int qi = 32 * half + 8 * j + 2 * t + (e & 1);
          const bool ok = kr < k_rows && qi < q_rows &&
                          visible(q_first + qi, k0 + kr, causal, window);
          const float p = ok ? exp2f(s[j][e] * scale_log2 - sl[qi]) : 0.0f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - sl[kBwTile + qi]);    // dS
        }
      uint32_t pa[2][4], da[2][4];
      pack_a(pa, s);
      pack_a(da, dp);
      mma_pb<D, 2>(dv_acc, pa, dos_, 32 * half, lane);   // dV += P^T . dO
      mma_pb<D, 2>(dk_acc, da, qs_, 32 * half, lane);    // dK += dS^T . Q
    }
    cur = nxt;
    st ^= 1;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int kr = warp * 16 + g + 8 * hh;
    if (kr >= k_rows) continue;
    __nv_bfloat16* dkrow = dk + (kv_base + k0 + kr) * D;
    __nv_bfloat16* dvrow = dv + (kv_base + k0 + kr) * D;
#pragma unroll
    for (int dn = 0; dn < ND; ++dn) {
      *reinterpret_cast<uint32_t*>(dkrow + 8 * dn + 2 * t) = pack_bf16x2(
          dk_acc[dn][2 * hh] * scale, dk_acc[dn][2 * hh + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvrow + 8 * dn + 2 * t) =
          pack_bf16x2(dv_acc[dn][2 * hh], dv_acc[dn][2 * hh + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kBwThreads)
    fa_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dq, int hq, int hkv, int sq,
                     int skv, float scale, float scale_log2, int causal,
                     int window) {
  constexpr int ND = D / 8;
  constexpr int kTile = kBwTile * D;
  extern __shared__ __align__(16) unsigned char bw_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(bw_smem);
  __nv_bfloat16* dos = qs + kTile;
  __nv_bfloat16* ring = dos + kTile;     // stage st: K, V

  const int iq = gridDim.x - 1 - blockIdx.x;   // latest query tile first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = iq * kBwTile;
  const int q_rows = min(kBwTile, sq - q0);
  const int q_first = skv - sq + q0;
  const size_t row_base = ((size_t)b * hq + h) * sq;
  const size_t kv_base = ((size_t)b * hkv + kvh) * skv;

  // this lane's rows g and g + 8 of the warp's 16: lse in log2 units, D
  float lse2[2], dl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * 16 + g + 8 * hh;
    lse2[hh] = r < q_rows ? lse[row_base + q0 + r] * kLog2e : 0.0f;
    dl[hh] = r < q_rows ? delta[row_base + q0 + r] : 0.0f;
  }
  int t_lo, t_hi;
  live_tiles(q0, sq, skv, causal, window, t_lo, t_hi);

  bw_load<D>(qs, q + row_base * D, q0, q_rows);
  bw_load<D>(dos, dout + row_base * D, q0, q_rows);
  auto load_tile = [&](int it, int st) {
    const int kt0 = it * kBwTile;
    __nv_bfloat16* kst = ring + st * 2 * kTile;
    bw_load<D>(kst, k + kv_base * D, kt0, min(kBwTile, skv - kt0));
    bw_load<D>(kst + kTile, v + kv_base * D, kt0, min(kBwTile, skv - kt0));
  };
  if (t_lo < t_hi) load_tile(t_lo, 0);
  cp_async_commit();

  float acc[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.0f;

  for (int it = t_lo; it < t_hi; ++it) {
    const int st = (it - t_lo) & 1;
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < t_hi) load_tile(it + 1, st ^ 1);
    cp_async_commit();
    const __nv_bfloat16* ks_ = ring + st * 2 * kTile;
    const __nv_bfloat16* vs_ = ks_ + kTile;
    const int k0 = it * kBwTile;
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      // S and dP for the warp's 16 rows x 32 keys
      float s[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
      mma_abt<D, 4>(s, qs, warp * 16, ks_, 32 * half, lane);
      mma_abt<D, 4>(dp, dos, warp * 16, vs_, 32 * half, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = warp * 16 + g + 8 * (e >> 1);
          const int k_pos = k0 + 32 * half + 8 * j + 2 * t + (e & 1);
          const bool ok = r < q_rows && k_pos < skv &&
                          visible(q_first + r, k_pos, causal, window);
          const float p =
              ok ? exp2f(s[j][e] * scale_log2 - lse2[e >> 1]) : 0.0f;
          dp[j][e] = p * (dp[j][e] - dl[e >> 1]);          // dS
        }
      uint32_t da[2][4];
      pack_a(da, dp);
      mma_pb<D, 2>(acc, da, ks_, 32 * half, lane);        // dQ += dS . K
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * 16 + g + 8 * hh;
    if (r >= q_rows) continue;
    __nv_bfloat16* row = dq + (row_base + q0 + r) * D;
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
      *reinterpret_cast<uint32_t*>(row + 8 * dn + 2 * t) = pack_bf16x2(
          acc[dn][2 * hh] * scale, acc[dn][2 * hh + 1] * scale);
  }
}

template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const void* lse, void* delta, void* dq,
               void* dk, void* dv, int batch, int hq, int hkv, int sq,
               int skv, float scale, int causal, int window,
               cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const int rows = batch * hq * sq;
  fa_bwd_dot_kernel<D><<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const bf*>(o), static_cast<const bf*>(dout),
      static_cast<float*>(delta), rows);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  constexpr int smem = bw_smem_bytes<D>();
  auto dkv = fa_bwd_dkv_kernel<D>;
  auto dqk = fa_bwd_dq_kernel<D>;
  REPRO_SMEM_OPT_IN(dkv, smem);
  REPRO_SMEM_OPT_IN(dqk, smem);
  const float scale_log2 = scale * kLog2e;
  dkv<<<dim3((skv + kBwTile - 1) / kBwTile, hkv, batch), kBwThreads, smem,
        stream>>>(static_cast<const bf*>(q), static_cast<const bf*>(k),
                  static_cast<const bf*>(v), static_cast<const bf*>(dout),
                  static_cast<const float*>(lse),
                  static_cast<const float*>(delta), static_cast<bf*>(dk),
                  static_cast<bf*>(dv), hq, hkv, sq, skv, scale, scale_log2,
                  causal, window);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  dqk<<<dim3((sq + kBwTile - 1) / kBwTile, hq, batch), kBwThreads, smem,
        stream>>>(static_cast<const bf*>(q), static_cast<const bf*>(k),
                  static_cast<const bf*>(v), static_cast<const bf*>(dout),
                  static_cast<const float*>(lse),
                  static_cast<const float*>(delta), static_cast<bf*>(dq), hq,
                  hkv, sq, skv, scale, scale_log2, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro

// bfloat16 only.  delta: (B * hq * Sq) f32 scratch the call fills.  window
// 0: no sliding window; causal 0: no causal mask.
extern "C" int flash_attention_bwd_sync_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int batch, int hq, int hkv, int sq, int skv, int head_dim,
    float scale, int causal, int window, void* stream) {
  using namespace repro;
  if (batch < 1 || sq < 1 || skv < 1 || hkv < 1 || hq % hkv ||
      batch > 65535 || hq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch_bwd<32>(q, k, v, o, dout, lse, delta, dq, dk, dv, batch,
                            hq, hkv, sq, skv, scale, causal, window, s);
    case 64:
      return launch_bwd<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, batch,
                            hq, hkv, sq, skv, scale, causal, window, s);
    case 128:
      return launch_bwd<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, batch,
                             hq, hkv, sq, skv, scale, causal, window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
