// Mamba2 decode cell for Hopper (sm_90a): one token of every row, from the
// in_proj row to the readout before the gated norm.
//
// Not a port of a TPU kernel: the reference leaves this step of
// src/repro/models/ssm.py::mamba_decode (:152-176) to XLA.  It is a kernel
// here because the engine's oracle parity needs each row's result to be
// bitwise independent of how many rows the call holds, and PyTorch's CUDA
// products and sums pick their reduction split from the row count.
//
// Operands: proj (B, 2 di + 2 n + h) in the activation type T, the in_proj
// row (z | xBC | dt); the conv window (B, K - 1, C) and conv_w (K, C),
// conv_b (C,) in T, C = di + 2 n; A_log, D, dt_bias (h,) f32; the state
// (B, h, n, P) f32; active (B,) bool or null.  Writes y (B, di) in T and,
// for an active row, the shifted window and the new state in place.
//
// Pass 1, the conv (mamba_conv_kernel): one thread a channel of a row.  It
// reads the K - 1 taps of the window and the row's new xBC value, sums the
// products rounded to T in tap order in f32 (the window times conv_w in T,
// then summed over the taps, as the reference's sum rounds), adds conv_b
// in T, applies silu in f32 and rounds to T into a scratch row xbc (B, C);
// an active row's window is shifted in place (tap i takes tap i + 1, the
// last tap the new value).  The B and C channels (xBC[di:]) are read by
// every head of a row: were the conv done by a block a head, the block
// that shifts them would race the blocks still reading the old window.
// A pass of its own, ordered before pass 2 on the stream, resolves that,
// and stays capturable in a CUDA graph (the scratch is one allocation of
// the wrapper's at a static address).
//
// Pass 2, the state (mamba_state_kernel): one block of 256 threads a
// (row, head).  x (the head's P channels), B and C (n each) are read from
// the scratch row into shared memory; dt = softplus(dt + dt_bias) (x for
// x > 20, else log1p(exp(x)), as PyTorch's), decay = exp(dt * -exp(A_log)).
// Thread t owns 4 adjacent columns p (t % (P / 4)) of the state rows n =
// t / (P / 4) + G i, G = 256 / (P / 4), read and written as float4:
//   h = h * decay + (dt * B_n) * x_p   (__fmul_rn / __fadd_rn: no
//                                       contraction, two roundings as the
//                                       plain version's two ops)
// and keeps y_p's partial sum over its rows n in increasing order; the
// G partials (at most n of them) are then added in increasing order by one
// thread a column, and D * x_p added last.  The order is a function of
// (n, P) alone, never of B or of the grid.  What bounds it: bytes, the
// state read and written once (2 * n * P * 4 bytes a (row, head): 1.835 MB
// a row at zamba2-7b's 112 heads of 64 x 64), the rest is a few KB.
//
// The served step is the third kernel, mamba_cell_gated_kernel: the two
// passes and the gated norm after them (rmsnorm.cu's rmsnorm_gated,
// src/repro/models/ssm.py:177) in one launch, bitwise those three
// kernels.  One block of 256 threads a (row, head), as pass 2:
//   1. one thread issues the block's state tile (n x P f32, 16 KB at
//      zamba2-7b, at an address that depends on nothing the kernel
//      computes) as one 1-D bulk async copy into shared memory, completing
//      on an mbarrier, and the tile flies while the prologue runs;
//   2. the prologue convolves the head's own P x-channels and, redundantly
//      in every block of the row, the row's 2 n B and C channels, from the
//      old taps, with pass 1's roundings (a channel's taps and weights are
//      loaded together, at static indices); the xbc scratch row is gone.
//      Each block shifts its own x-channels' window (no other block reads
//      them); dt and decay as pass 2.  Each block also writes its head's
//      slice of the gate silu(z) (rounded to T, as the chain rounds it)
//      into the output row, and asks L2 for its slice of gamma: the row's
//      last block reads both;
//   3. the state update and readout of pass 2, from the tile in shared
//      memory, in pass 2's order; the new state is written into the tile
//      and goes back to device memory by one bulk async copy (an active
//      row's), which flies while y is summed and the row's blocks arrive;
//      y_p (rounded to T) goes to a scratch row in device memory;
//   4. a per-row arrival counter (after a barrier, one thread's atomic
//      increment a block, with release and acquire semantics at device
//      scope) picks the last block of the row to finish, which
//        - shifts the shared B / C window, now that every block of the row
//          has read it,
//        - stages the row's y, gate and gamma in shared memory (y and the
//          gate read through L2: every head's block wrote its slice), and
//          runs rmsnorm.cu's gated norm on it in that kernel's order
//          (thread t sums elements t, t + 256, ... with fmaf, a butterfly
//          within the warp, the 8 warp sums in warp order; the chain's
//          three roundings), writing the gated row over the gate in place.
//      The increment wraps at H - 1 (atom.inc), so the last arrival itself
//      puts the counter back at 0 for the next launch (a graph replay
//      too): no store resets it, and whatever launches share the counter,
//      it is back at 0 once they have all ended.
// The registers are capped so that 4 blocks fit an SM: a decode tick's
// 4 x 112 blocks run in one wave (a second wave costs the launch a whole
// block's time again).  Launches that share a counter array must not
// overlap in time: the wrapper gives each stream an array of its own (a
// graph's launches the array of the stream it was captured on).  What
// bounds it: bytes, as pass 2; the gated norm adds a few d T-values of
// reads and writes a row, and is one block's latency at the end of the
// launch (its silu, an exp and a division a value, is spread over the head
// blocks).
#include "common.cuh"

REPRO_ERROR_STRING_FN

namespace repro {

constexpr int kConvThreads = 256;
constexpr int kStateThreads = 256;
constexpr int kMaxConv = 8;
// The fused step's last block stages the row's y, gate and gamma in shared
// memory; the three must fit in this (a row of 8032 bf16 values)
constexpr int kTailStageBytes = 46 * 1024;
// its shared memory, without an opt-in (1 KB left to the static arrays)
constexpr int kGatedSmemBytes = 47 * 1024;
// The fused step's blocks resident on an SM at once (its registers capped
// to fit): 4 x 132 SMs hold a decode tick's 4 x 112 blocks in one wave
constexpr int kGatedBlocksPerSM = 4;

template <typename T>
__global__ void __launch_bounds__(kConvThreads)
    mamba_conv_kernel(const T* __restrict__ proj, T* __restrict__ window,
                      const T* __restrict__ conv_w,
                      const T* __restrict__ conv_b, T* __restrict__ xbc,
                      const bool* __restrict__ active, int C, int K, int di,
                      int proj_stride) {
  const int c = blockIdx.x * kConvThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= C) return;
  T* w = window + (size_t)b * (K - 1) * C + c;
  T taps[kMaxConv];
  for (int i = 0; i < K - 1; ++i) taps[i] = w[(size_t)i * C];
  taps[K - 1] = proj[(size_t)b * proj_stride + di + c];
  float acc = 0.0f;
  for (int i = 0; i < K; ++i)
    acc = __fadd_rn(acc, round_to<T>(__fmul_rn(to_f32(taps[i]),
                                               to_f32(conv_w[(size_t)i * C + c]))));
  const float pre = round_to<T>(__fadd_rn(round_to<T>(acc),
                                          to_f32(conv_b[c])));
  xbc[(size_t)b * C + c] = from_f32<T>(silu(pre));
  if (active == nullptr || active[b]) {
    for (int i = 0; i < K - 1; ++i) w[(size_t)i * C] = taps[i + 1];
  }
}

__device__ __forceinline__ float softplus(float v) {
  return v > 20.0f ? v : log1pf(expf(v));
}

// Dynamic shared memory: B, C (n f32 each), x (P f32), and the partial
// sums of y (min(G, n) rows of P f32).
template <typename T>
__global__ void __launch_bounds__(kStateThreads)
    mamba_state_kernel(const T* __restrict__ proj, const T* __restrict__ xbc,
                       const float* __restrict__ A_log,
                       const float* __restrict__ D,
                       const float* __restrict__ dt_bias,
                       float* __restrict__ state, T* __restrict__ y,
                       const bool* __restrict__ active, int H, int P, int N,
                       int proj_stride) {
  extern __shared__ __align__(16) float ms_smem[];
  const int head = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int di = H * P, C = di + 2 * N;
  const int P4 = P / 4, G = kStateThreads / P4, rows = min(G, N);
  float* bs = ms_smem;
  float* cs = bs + N;
  float* xs = cs + N;
  float* part = xs + P;
  const T* xr = xbc + (size_t)b * C;
  for (int i = t; i < N; i += kStateThreads) {
    bs[i] = to_f32(xr[di + i]);
    cs[i] = to_f32(xr[di + N + i]);
  }
  for (int p = t; p < P; p += kStateThreads) xs[p] = to_f32(xr[head * P + p]);
  const float dt = softplus(__fadd_rn(
      to_f32(proj[(size_t)b * proj_stride + di + C + head]), dt_bias[head]));
  const float decay = expf(__fmul_rn(dt, -expf(A_log[head])));
  const bool write = active == nullptr || active[b];
  __syncthreads();

  const int pc = t % P4, g = t / P4;
  float4* hbase = reinterpret_cast<float4*>(
      state + ((size_t)b * H + head) * N * P);
  const float x0 = xs[4 * pc], x1 = xs[4 * pc + 1], x2 = xs[4 * pc + 2],
              x3 = xs[4 * pc + 3];
  float y0 = 0.0f, y1 = 0.0f, y2 = 0.0f, y3 = 0.0f;
#pragma unroll 4
  for (int n = g; n < N; n += G) {
    float4 hv = hbase[(size_t)n * P4 + pc];
    const float dtb = __fmul_rn(dt, bs[n]), c = cs[n];
    hv.x = __fadd_rn(__fmul_rn(hv.x, decay), __fmul_rn(dtb, x0));
    hv.y = __fadd_rn(__fmul_rn(hv.y, decay), __fmul_rn(dtb, x1));
    hv.z = __fadd_rn(__fmul_rn(hv.z, decay), __fmul_rn(dtb, x2));
    hv.w = __fadd_rn(__fmul_rn(hv.w, decay), __fmul_rn(dtb, x3));
    if (write) hbase[(size_t)n * P4 + pc] = hv;
    y0 = __fadd_rn(y0, __fmul_rn(c, hv.x));
    y1 = __fadd_rn(y1, __fmul_rn(c, hv.y));
    y2 = __fadd_rn(y2, __fmul_rn(c, hv.z));
    y3 = __fadd_rn(y3, __fmul_rn(c, hv.w));
  }
  if (g < rows) {
    float* pr = part + (size_t)g * P + 4 * pc;
    pr[0] = y0;
    pr[1] = y1;
    pr[2] = y2;
    pr[3] = y3;
  }
  __syncthreads();
  const float dh = D[head];
  for (int p = t; p < P; p += kStateThreads) {
    float acc = 0.0f;
    for (int r = 0; r < rows; ++r) acc = __fadd_rn(acc, part[(size_t)r * P + p]);
    acc = __fadd_rn(acc, __fmul_rn(dh, xs[p]));
    y[(size_t)b * di + head * P + p] = from_f32<T>(acc);
  }
}

// ---- the fused step: the bulk copy of the state tile (PTX) -----------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// bar expects one arrival and `bytes` of the copy; src and dst 16-byte
// aligned, bytes a multiple of 16.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_wait(uint64_t* bar) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
  } while (!done);
}

// The tile back to device memory by one bulk async copy (the writes of
// every thread to it fenced for the async proxy and barriered first).
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          reinterpret_cast<uint64_t>(dst)),
      "r"(smem_addr(src)), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until the bulk stores issued so far have read their shared memory.
__device__ __forceinline__ void bulk_store_read_wait() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// One arrival on a row's counter, with release (the block's writes before
// the barrier that precedes it, cumulatively) and acquire (the other
// blocks' released writes) semantics at device scope: the count before it,
// the counter wrapping to 0 at the arrival that finds it at `last`.
__device__ __forceinline__ unsigned arrive_acq_rel(unsigned* counter,
                                                   unsigned last) {
  unsigned before;
  asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;\n"
               : "=r"(before)
               : "l"(counter), "r"(last)
               : "memory");
  return before;
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// 16 bytes of the gated row, as rmsnorm.cu's gated output loop computes
// them: rmsnorm(y) rounded to T times the gate silu(z), already rounded to
// T, their product rounded to T.
template <typename T>
__device__ __forceinline__ uint4 gate_chunk(uint4 sv, uint4 gv, uint4 av,
                                            float r) {
  constexpr int V = 16 / sizeof(T);
  uint4 ov;
  const T* se = reinterpret_cast<const T*>(&sv);
  const T* ge = reinterpret_cast<const T*>(&gv);
  const T* ae = reinterpret_cast<const T*>(&av);
  T* oe = reinterpret_cast<T*>(&ov);
#pragma unroll
  for (int e = 0; e < V; ++e)
    oe[e] = from_f32<T>(__fmul_rn(
        round_to<T>(to_f32(se[e]) * r * to_f32(ge[e])), to_f32(ae[e])));
  return ov;
}

// Dynamic shared memory: the state tile (N x P f32), B, C (N f32 each), x
// (P f32) and the partial sums of y (min(G, N) rows of P f32); the row's
// last block reuses it for the staged y row, the row's gate and gamma (d
// values of T each).
template <typename T>
__global__ void __launch_bounds__(kStateThreads, kGatedBlocksPerSM)
    mamba_cell_gated_kernel(const T* __restrict__ proj, T* __restrict__ window,
                            const T* __restrict__ conv_w,
                            const T* __restrict__ conv_b,
                            const float* __restrict__ A_log,
                            const float* __restrict__ D,
                            const float* __restrict__ dt_bias,
                            float* __restrict__ state,
                            const T* __restrict__ gamma, T* __restrict__ out,
                            T* __restrict__ ys,
                            unsigned* __restrict__ arrivals,
                            const bool* __restrict__ active, int H, int P,
                            int N, int K, int proj_stride, float eps) {
  extern __shared__ __align__(128) float mg_smem[];
  __shared__ __align__(8) uint64_t bar;
  __shared__ float warp_sums[kStateThreads / 32];
  __shared__ int is_last;
  const int head = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int di = H * P, C = di + 2 * N;
  const int P4 = P / 4, G = kStateThreads / P4, rows = min(G, N);
  float* tile = mg_smem;
  float* bs = tile + (size_t)N * P;
  float* cs = bs + N;
  float* xs = cs + N;
  float* part = xs + P;
  float* hglob = state + ((size_t)b * H + head) * N * P;
  if (t == 0) bulk_load(tile, hglob, (uint32_t)(N * P * sizeof(float)), &bar);

  const bool write = active == nullptr || active[b];
  const T* prow = proj + (size_t)b * proj_stride;
  T* wrow = window + (size_t)b * (K - 1) * C;
  T* orow = out + (size_t)b * di;
  constexpr int V = 16 / sizeof(T);
  for (int j = t; j < P / V; j += kStateThreads)
    prefetch_l2(gamma + head * P + j * V);
  // j < P: the conv of the head's x-channels; then the row's B and C
  // channels; then the gate silu(z) of the head's P columns, rounded to T
  // as the chain rounds it, into the output row (the last block multiplies
  // the normed row into it)
  for (int j = t; j < 2 * P + 2 * N; j += kStateThreads) {
    if (j >= P + 2 * N) {
      const int col = head * P + (j - P - 2 * N);
      orow[col] = from_f32<T>(silu(to_f32(prow[col])));
      continue;
    }
    const int c = j < P ? head * P + j : di + (j - P);
    // every tap and weight loaded before the sum (static indices: the
    // loads are in flight together, not one round trip a tap)
    T taps[kMaxConv], wts[kMaxConv];
#pragma unroll
    for (int i = 0; i < kMaxConv; ++i) {
      if (i < K - 1) taps[i] = wrow[(size_t)i * C + c];
      if (i == K - 1) taps[i] = prow[di + c];
      if (i < K) wts[i] = conv_w[(size_t)i * C + c];
    }
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < kMaxConv; ++i)
      if (i < K)
        acc = __fadd_rn(acc, round_to<T>(__fmul_rn(to_f32(taps[i]),
                                                   to_f32(wts[i]))));
    const float pre = round_to<T>(__fadd_rn(round_to<T>(acc),
                                            to_f32(conv_b[c])));
    const float v = round_to<T>(silu(pre));
    if (j < P) {
      xs[j] = v;
      if (write) {
#pragma unroll
        for (int i = 0; i < kMaxConv - 1; ++i)
          if (i < K - 1) wrow[(size_t)i * C + c] = taps[i + 1];
      }
    } else if (j < P + N) {
      bs[j - P] = v;
    } else {
      cs[j - P - N] = v;
    }
  }
  const float dt = softplus(__fadd_rn(to_f32(prow[di + C + head]),
                                      dt_bias[head]));
  const float decay = expf(__fmul_rn(dt, -expf(A_log[head])));
  __syncthreads();
  bulk_wait(&bar);

  const int pc = t % P4, g = t / P4;
  float4* htile = reinterpret_cast<float4*>(tile);
  const float x0 = xs[4 * pc], x1 = xs[4 * pc + 1], x2 = xs[4 * pc + 2],
              x3 = xs[4 * pc + 3];
  float y0 = 0.0f, y1 = 0.0f, y2 = 0.0f, y3 = 0.0f;
#pragma unroll 4
  for (int n = g; n < N; n += G) {
    float4 hv = htile[(size_t)n * P4 + pc];
    const float dtb = __fmul_rn(dt, bs[n]), c = cs[n];
    hv.x = __fadd_rn(__fmul_rn(hv.x, decay), __fmul_rn(dtb, x0));
    hv.y = __fadd_rn(__fmul_rn(hv.y, decay), __fmul_rn(dtb, x1));
    hv.z = __fadd_rn(__fmul_rn(hv.z, decay), __fmul_rn(dtb, x2));
    hv.w = __fadd_rn(__fmul_rn(hv.w, decay), __fmul_rn(dtb, x3));
    htile[(size_t)n * P4 + pc] = hv;
    y0 = __fadd_rn(y0, __fmul_rn(c, hv.x));
    y1 = __fadd_rn(y1, __fmul_rn(c, hv.y));
    y2 = __fadd_rn(y2, __fmul_rn(c, hv.z));
    y3 = __fadd_rn(y3, __fmul_rn(c, hv.w));
  }
  if (g < rows) {
    float* pr = part + (size_t)g * P + 4 * pc;
    pr[0] = y0;
    pr[1] = y1;
    pr[2] = y2;
    pr[3] = y3;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  // the new state goes back while y is summed and the row's blocks arrive
  if (t == 0 && write)
    bulk_store(hglob, tile, (uint32_t)(N * P * sizeof(float)));
  const float dh = D[head];
  T* yrow = ys + (size_t)b * di;
  for (int p = t; p < P; p += kStateThreads) {
    float acc = 0.0f;
    for (int r = 0; r < rows; ++r) acc = __fadd_rn(acc, part[(size_t)r * P + p]);
    acc = __fadd_rn(acc, __fmul_rn(dh, xs[p]));
    yrow[head * P + p] = from_f32<T>(acc);
  }

  // the row's last block to arrive takes the shared window and the norm:
  // one thread's acq_rel arrival after the barrier releases the block's y
  // and gate writes and, in the last block, acquires the other blocks'
  // (the last arrival wraps the counter back to 0)
  __syncthreads();
  if (t == 0) {
    is_last = arrive_acq_rel(&arrivals[b], H - 1) == (unsigned)(H - 1);
    if (write) bulk_store_read_wait();   // the tile's shared memory is free
  }
  __syncthreads();
  if (!is_last) return;
  // rmsnorm.cu's add_rmsnorm_kernel<T, kGate> on the staged y row, the
  // row's gate and gamma staged with it
  const int chunks = di / V;
  uint4* sy = reinterpret_cast<uint4*>(mg_smem);
  uint4* sa = sy + chunks;
  uint4* sg = sa + chunks;
  const uint4* yv = reinterpret_cast<const uint4*>(yrow);
  const uint4* ar = reinterpret_cast<const uint4*>(orow);
  const uint4* gr = reinterpret_cast<const uint4*>(gamma);
#pragma unroll 4
  for (int c = t; c < chunks; c += kStateThreads) {
    sy[c] = __ldcg(yv + c);
    sa[c] = __ldcg(ar + c);
    sg[c] = gr[c];
  }
  if (write) {
    for (int j = t; j < 2 * N; j += kStateThreads) {
      const int c = di + j;
      T taps[kMaxConv];
#pragma unroll
      for (int i = 1; i < kMaxConv; ++i) {
        if (i < K - 1) taps[i] = wrow[(size_t)i * C + c];
        if (i == K - 1) taps[i] = prow[di + c];
      }
#pragma unroll
      for (int i = 0; i < kMaxConv - 1; ++i)
        if (i < K - 1) wrow[(size_t)i * C + c] = taps[i + 1];
    }
  }
  __syncthreads();
  const T* srow = reinterpret_cast<const T*>(sy);
  float ss = 0.0f;
#pragma unroll 8
  for (int i = t; i < di; i += kStateThreads) {
    const float v = to_f32(srow[i]);
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  if ((t & 31) == 0) warp_sums[t >> 5] = ss;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int w = 0; w < kStateThreads / 32; ++w) total += warp_sums[w];
  const float r = rsqrtf(total / (float)di + eps);
  uint4* ov4 = reinterpret_cast<uint4*>(orow);
#pragma unroll 4
  for (int c = t; c < chunks; c += kStateThreads)
    ov4[c] = gate_chunk<T>(sy[c], sg[c], sa[c], r);
}

// Shared memory of the fused step: the state pass's, or the tail's three
// staged rows, whichever is larger.
inline size_t gated_smem(int H, int P, int N, int elem) {
  const int P4 = P / 4, G = kStateThreads / P4, rows = G < N ? G : N;
  const size_t front = (size_t)(N * P + 2 * N + P + rows * P) * sizeof(float);
  const size_t tail = 3 * (size_t)H * P * elem;
  return front > tail ? front : tail;
}

template <typename T>
int launch_gated(const void* proj, void* window, const void* conv_w,
                 const void* conv_b, const float* A_log, const float* D,
                 const float* dt_bias, float* state, const void* gamma,
                 void* out, void* ys, unsigned* arrivals, int B, int H,
                 int P,
                 int N, int K, int proj_stride, float eps,
                 const bool* active, cudaStream_t s) {
  const int P4 = P / 4;
  const int di = H * P;
  if (B < 1 || H < 1 || N < 1 || P % 4 || P4 < 1 || P4 > kStateThreads ||
      kStateThreads % P4 || K < 2 || K > kMaxConv || B > 65535 ||
      H > 65535 || proj_stride < 2 * di + 2 * N + H ||
      (di * sizeof(T)) % 16 || (proj_stride * sizeof(T)) % 16 ||
      ((uintptr_t)state | (uintptr_t)proj | (uintptr_t)gamma |
       (uintptr_t)out | (uintptr_t)ys) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = gated_smem(H, P, N, (int)sizeof(T));
  if (smem > (size_t)kGatedSmemBytes ||
      3 * (size_t)di * sizeof(T) > (size_t)kTailStageBytes)
    return (int)cudaErrorInvalidValue;
  mamba_cell_gated_kernel<T><<<dim3(H, B), kStateThreads, smem, s>>>(
      static_cast<const T*>(proj), static_cast<T*>(window),
      static_cast<const T*>(conv_w), static_cast<const T*>(conv_b), A_log, D,
      dt_bias, state, static_cast<const T*>(gamma), static_cast<T*>(out),
      static_cast<T*>(ys), arrivals, active, H, P, N, K, proj_stride, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* proj, void* window, const void* conv_w,
           const void* conv_b, const float* A_log, const float* D,
           const float* dt_bias, float* state, void* xbc, void* y, int B,
           int H, int P, int N, int K, int proj_stride, const bool* active,
           cudaStream_t s) {
  const int P4 = P / 4;
  if (B < 1 || H < 1 || N < 1 || P % 4 || P4 < 1 || P4 > kStateThreads ||
      kStateThreads % P4 || K < 2 || K > kMaxConv || B > 65535 ||
      H > 65535 || ((uintptr_t)state % 16) != 0)
    return (int)cudaErrorInvalidValue;
  const int di = H * P, C = di + 2 * N;
  if (proj_stride < di + C + H) return (int)cudaErrorInvalidValue;
  dim3 cgrid((C + kConvThreads - 1) / kConvThreads, B);
  mamba_conv_kernel<T><<<cgrid, kConvThreads, 0, s>>>(
      static_cast<const T*>(proj), static_cast<T*>(window),
      static_cast<const T*>(conv_w), static_cast<const T*>(conv_b),
      static_cast<T*>(xbc), active, C, K, di, proj_stride);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int G = kStateThreads / P4, rows = G < N ? G : N;
  const size_t smem = (size_t)(2 * N + P + rows * P) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  mamba_state_kernel<T><<<dim3(H, B), kStateThreads, smem, s>>>(
      static_cast<const T*>(proj), static_cast<const T*>(xbc), A_log, D,
      dt_bias, state, static_cast<T*>(y), active, H, P, N, proj_stride);
  return (int)cudaGetLastError();
}

}  // namespace repro

// proj (B, proj_stride) whose row is z | xBC | dt; window (B, K - 1, C),
// conv_w (K, C), conv_b (C,) and the scratch xbc (B, C) in the activation
// type; A_log, D, dt_bias (H,) f32; state (B, H, N, P) f32; y (B, H * P);
// active (B,) bool, or null for every row.
extern "C" int mamba_cell_launch(const void* proj, void* window,
                                 const void* conv_w, const void* conv_b,
                                 const void* A_log, const void* D,
                                 const void* dt_bias, void* state, void* xbc,
                                 void* y, int B, int H, int P, int N, int K,
                                 int proj_stride, int dtype,
                                 const void* active, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a_log = static_cast<const float*>(A_log);
  const float* d = static_cast<const float*>(D);
  const float* dtb = static_cast<const float*>(dt_bias);
  float* st = static_cast<float*>(state);
  const bool* act = static_cast<const bool*>(active);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(proj, window, conv_w, conv_b, a_log, d, dtb,
                                 st, xbc, y, B, H, P, N, K, proj_stride, act,
                                 s);
  return launch<float>(proj, window, conv_w, conv_b, a_log, d, dtb, st, xbc, y,
                       B, H, P, N, K, proj_stride, act, s);
}

// The fused step.  proj (B, proj_stride) whose row is z | xBC | dt (z, the
// first H * P columns, gates the norm); window, conv_w, conv_b, A_log, D,
// dt_bias, state and active as mamba_cell_launch; gamma (H * P,) the norm's
// weight, out (B, H * P) and the scratch ys (B, H * P, the readout before
// the norm) in the activation type; arrivals (B,) u32, zero, left zero.
extern "C" int mamba_cell_gated_launch(const void* proj, void* window,
                                       const void* conv_w, const void* conv_b,
                                       const void* A_log, const void* D,
                                       const void* dt_bias, void* state,
                                       const void* gamma, void* out,
                                       void* ys, void* arrivals, int B,
                                       int H, int P, int N, int K,
                                       int proj_stride, float eps, int dtype,
                                       const void* active, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a_log = static_cast<const float*>(A_log);
  const float* d = static_cast<const float*>(D);
  const float* dtb = static_cast<const float*>(dt_bias);
  float* st = static_cast<float*>(state);
  unsigned* arr = static_cast<unsigned*>(arrivals);
  const bool* act = static_cast<const bool*>(active);
  if (dtype == kBF16)
    return launch_gated<__nv_bfloat16>(proj, window, conv_w, conv_b, a_log, d,
                                       dtb, st, gamma, out, ys, arr, B, H, P,
                                       N, K, proj_stride, eps, act, s);
  return launch_gated<float>(proj, window, conv_w, conv_b, a_log, d, dtb, st,
                             gamma, out, ys, arr, B, H, P, N, K, proj_stride,
                             eps, act, s);
}
