// sLSTM recurrence for Hopper (sm_90a): hidden states of the xLSTM's sLSTM
// block over a whole sequence, or one decode step from a carried state.
//
// Replaces src/repro/kernels/slstm_scan.py::slstm_scan_pallas (body
// `_kernel`, :36-74).  For each (batch row, head) and t = 0 .. L-1:
//   gates = (gx_t + h_{t-1} . R_head) + b      (4 dh columns: z, i, f, o)
//   z = tanh, o = sigmoid, logf = log_sigmoid(f), m' = max(logf + m, i),
//   i' = exp(i - m'), f' = exp(logf + m - m'), c = f' c + i' z,
//   n = max(f' n + i', exp(-m')), h = o c / n,
// all in f32, the reference's `_slstm_step` (src/repro/models/xlstm.py:249).
//
// Every output gate column of every row is one thread's fmaf chain over
// d = 0 .. dh-1 from +0, then (gx + sum) + b: the same order in both
// kernels below, so they agree bitwise, a row's result depends on nothing
// but its own inputs (rows are bitwise independent of the batch), and L
// steps in one call equal L calls of one step with the state carried.
//
// Two kernels, chosen by (heads, dh, R's dtype) in the wrapper
// (slstm_scan.py::scan_plan), never by the batch:
//
// * slstm_scan_cluster_kernel (bf16 R, dh a multiple of 32 up to 512;
//   xlstm-1.3b's 4 heads of 512).  A cluster of dh/32 CTAs per head (16 at
//   dh = 512) and per group of up to 4 rows.  A CTA owns 32 hidden units,
//   so 128 gate columns, one thread each, and keeps their slice of R in
//   shared memory for the whole call (dh x 128 bf16, 128 KB at dh = 512),
//   8 consecutive d of one column in each 16-byte chunk, XOR-swizzled so
//   the transposing copy and the per-step reads are free of bank
//   conflicts.  A step reads R from shared memory only: each thread runs
//   its column's chain for every row of the group, reading h_{t-1}
//   (broadcast float4s) from a double-buffered h array that holds the
//   whole head; warp shuffles bring a unit's four gates to one lane, which
//   owns that (row, unit)'s c, n, m in registers and loads the next
//   step's gx ahead.  The lane writes h_t into the h array of every CTA
//   of the cluster (distributed shared memory), and the cluster crosses
//   one barrier (arrive.release / wait.acquire): h_t goes to the other
//   buffer,
//   so no second barrier is needed, and the last step's barrier is the one
//   every CTA crosses before it exits.
// * slstm_scan_kernel (f32 R, and bf16 R at other widths): one block per
//   (head, row), one thread per hidden unit, R read from global memory
//   (it stays in the 50 MB L2 across steps), two barriers a step.
//
// Beyond the reference's signature, and the same function: any L (no time
// chunk: the reference refuses L not a multiple of min(256, L)); a state
// (c, n, h, m) read at the start and written back at the end, which lets
// one decode step run at L = 1 on the serving cache; and a per-row `active`
// mask (nullable) whose false rows keep their state.
//
// What bounds it on this card: the chain of L dependent steps, each a
// dh-long dependent fmaf chain (the order above) plus one cluster barrier;
// the byte bound (gates_x and hs once, R once) and the operations bound are
// far below it.  At L = 1 a call is the cluster launch, the copy of R into
// shared memory and one step.  Built without fast math: expf, log1pf and
// tanhf keep it within 2e-4 of the f32 scan.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

REPRO_ERROR_STRING_FN

namespace repro {

constexpr int kScanMaxThreads = 1024;
// the cluster kernel: hidden units a CTA owns, one thread per gate column,
// rows a cluster serves, CTAs a cluster may have (non-portable above 8)
constexpr int kUnits = 32;
constexpr int kClusterThreads = 4 * kUnits;
constexpr int kClusterRows = 4;
constexpr int kMaxCluster = 16;

enum ScanKernel : int { kScanCudaCore = 0, kScanCluster = 1 };

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// log(sigmoid(x)) without overflow for either sign
__device__ __forceinline__ float log_sigmoid_f(float x) {
  return fminf(x, 0.0f) - log1pf(expf(-fabsf(x)));
}

// One (row, unit)'s update from its four gate pre-activations; returns h.
__device__ __forceinline__ float slstm_update(float zg, float ig, float fg,
                                              float og, float& c, float& n,
                                              float& m) {
  const float z = tanhf(zg);
  const float o = sigmoid_f(og);
  const float logf_ = log_sigmoid_f(fg);
  const float m_new = fmaxf(logf_ + m, ig);
  const float i_act = expf(ig - m_new);
  const float f_act = expf(logf_ + m - m_new);
  c = f_act * c + i_act * z;
  n = fmaxf(f_act * n + i_act, expf(-m_new));
  m = m_new;
  return o * c / n;
}

template <typename TR>
__global__ void __launch_bounds__(kScanMaxThreads)
    slstm_scan_kernel(const float* __restrict__ gx, const TR* __restrict__ r,
                      const float* __restrict__ bias, float* __restrict__ hs,
                      float* c_st, float* n_st, float* h_st, float* m_st,
                      const uint8_t* __restrict__ active, int L, int heads,
                      int dh) {
  extern __shared__ float h_prev[];
  const int head = blockIdx.x, row = blockIdx.y, j = threadIdx.x;
  const int g4 = 4 * dh;
  const size_t sidx = ((size_t)row * heads + head) * dh + j;
  float c = c_st[sidx], n = n_st[sidx], m = m_st[sidx];
  float h = h_st[sidx];
  h_prev[j] = h;
  const TR* rh = r + (size_t)head * dh * g4 + j;
  const float* bh = bias + (size_t)head * g4;
  const float bz = bh[j], bi = bh[dh + j], bf = bh[2 * dh + j],
              bo = bh[3 * dh + j];
  __syncthreads();
  for (int t = 0; t < L; ++t) {
    const float* g = gx + (((size_t)row * L + t) * heads + head) * g4;
    float az = 0.0f, ai = 0.0f, af = 0.0f, ao = 0.0f;
    const TR* rp = rh;
#pragma unroll 4
    for (int d = 0; d < dh; ++d, rp += g4) {
      const float hd = h_prev[d];
      az = fmaf(hd, to_f32(rp[0]), az);
      ai = fmaf(hd, to_f32(rp[dh]), ai);
      af = fmaf(hd, to_f32(rp[2 * dh]), af);
      ao = fmaf(hd, to_f32(rp[3 * dh]), ao);
    }
    h = slstm_update((g[j] + az) + bz, (g[dh + j] + ai) + bi,
                     (g[2 * dh + j] + af) + bf, (g[3 * dh + j] + ao) + bo, c,
                     n, m);
    hs[(((size_t)row * L + t) * heads + head) * dh + j] = h;
    __syncthreads();  // every thread has read h_{t-1}
    h_prev[j] = h;
    __syncthreads();
  }
  if (active == nullptr || active[row]) {
    c_st[sidx] = c;
    n_st[sidx] = n;
    h_st[sidx] = h;
    m_st[sidx] = m;
  }
}

// -- the cluster kernel --------------------------------------------------------

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// Shared-memory slot of R chunk (d-block k, local column c = 8 s + cc):
// the low three bits of c are XORed with s's, so that 8 lanes reading 8
// consecutive columns, and 8 lanes writing the cc-th column of 8
// consecutive segments s, each hit 8 different 16-byte bank groups.
__device__ __forceinline__ int r_slot(int c) {
  return (c & ~7) | ((c & 7) ^ ((c >> 3) & 7));
}

// 8 bf16 (two per word, the lower address in the low half) widened exactly
__device__ __forceinline__ void widen8(const uint4 w, float (&f)[8]) {
  const uint32_t v[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(v[i] << 16);
    f[2 * i + 1] = __uint_as_float(v[i] & 0xffff0000u);
  }
}

// Copy the CTA's slice of R (columns g*dh + j0 + 0..31 of each gate g)
// into shared memory, transposed into 8-d chunks per column.  Task (k, s):
// the 16-byte segment s = 4 w + g (units 8w .. 8w+7 of gate g, local
// columns 8s .. 8s+7) of rows 8k .. 8k+7; its 8 x 8 block is transposed
// in registers.
__device__ __forceinline__ void load_r_slice(const __nv_bfloat16* __restrict__ r,
                                             uint4* __restrict__ rs, int head,
                                             int dh, int j0) {
  constexpr int kBatch = 4;  // tasks a thread keeps in flight
  const int g4 = 4 * dh;
  const int tasks = (dh / 8) * 16;
  const uint4* rh = reinterpret_cast<const uint4*>(r + (size_t)head * dh * g4);
  for (int base = threadIdx.x; base < tasks;
       base += kBatch * kClusterThreads) {
    uint4 a[kBatch][8];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int id = base + b * kClusterThreads;
      if (id < tasks) {
        const int k = id >> 4, s = id & 15;
        const int col = (s & 3) * dh + j0 + (s >> 2) * 8;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          a[b][i] = rh[((size_t)(8 * k + i) * g4 + col) / 8];
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int id = base + b * kClusterThreads;
      if (id < tasks) {
        const int k = id >> 4, s = id & 15;
        uint4* dst = rs + (size_t)k * kClusterThreads;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t lo[4], hi[4];
#pragma unroll
          for (int mm = 0; mm < 4; ++mm) {
            const uint32_t x = word(a[b][2 * mm], j);
            const uint32_t y = word(a[b][2 * mm + 1], j);
            lo[mm] = __byte_perm(x, y, 0x5410);  // column 2j: rows 2mm, +1
            hi[mm] = __byte_perm(x, y, 0x7632);  // column 2j + 1
          }
          dst[r_slot(8 * s + 2 * j)] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
          dst[r_slot(8 * s + 2 * j + 1)] =
              make_uint4(hi[0], hi[1], hi[2], hi[3]);
        }
      }
    }
  }
}

// The time loop for a group of NR rows.  Thread t: local column t (gate
// g = lane / 8 of unit u = 8 warp + lane % 8); after the dots, lane L owns
// (row L / 8, unit u) when L / 8 < NR.
template <int NR>
__device__ __forceinline__ void scan_rows(
    const float* __restrict__ gx, const float* __restrict__ bias,
    float* __restrict__ hs, float* c_st, float* n_st, float* h_st,
    float* m_st, const uint8_t* __restrict__ active, const uint4* rs,
    float* hbuf, int row0, int L, int heads, int dh, int head, int j0,
    int cl) {
  cg::cluster_group cluster = cg::this_cluster();
  const int t = threadIdx.x, lane = t & 31;
  const int u = (t >> 5) * 8 + (lane & 7);  // unit of this lane's column
  const int er = lane >> 3;                 // this lane's row after the dots
  const bool owner = er < NR;
  const int row = row0 + (owner ? er : 0);
  const int j = j0 + u;
  const int g4 = 4 * dh;
  const int slot = r_slot(t);
  const size_t sidx = ((size_t)row * heads + head) * dh + j;
  float c = 0.0f, n = 0.0f, m = 0.0f, h = 0.0f;
  float gnext[4] = {0.0f, 0.0f, 0.0f, 0.0f}, b4[4];
  const float* bh = bias + (size_t)head * g4 + j;
#pragma unroll
  for (int gg = 0; gg < 4; ++gg) b4[gg] = bh[gg * dh];
  if (owner) {
    c = c_st[sidx];
    n = n_st[sidx];
    m = m_st[sidx];
    h = h_st[sidx];
    const float* g = gx + (((size_t)row * L) * heads + head) * g4 + j;
#pragma unroll
    for (int gg = 0; gg < 4; ++gg) gnext[gg] = g[gg * dh];
  }
  for (int i = t; i < NR * dh; i += kClusterThreads)
    hbuf[i] = h_st[((size_t)(row0 + i / dh) * heads + head) * dh + i % dh];
  __syncthreads();
  cluster_barrier();  // every CTA has started; R and h_0 are in place

  for (int step = 0; step < L; ++step) {
    const float* hb = hbuf + (step & 1) * kClusterRows * dh;
    float* hn = hbuf + ((step + 1) & 1) * kClusterRows * dh;
    float gcur[4];
#pragma unroll
    for (int gg = 0; gg < 4; ++gg) gcur[gg] = gnext[gg];
    if (owner && step + 1 < L) {
      const float* g =
          gx + (((size_t)row * L + step + 1) * heads + head) * g4 + j;
#pragma unroll
      for (int gg = 0; gg < 4; ++gg) gnext[gg] = g[gg * dh];
    }
    float acc[NR];
#pragma unroll
    for (int rr = 0; rr < NR; ++rr) acc[rr] = 0.0f;
    const uint4* rp = rs + slot;
#pragma unroll 8
    for (int k = 0; k < dh / 8; ++k, rp += kClusterThreads) {
      float rv[8];
      widen8(*rp, rv);
#pragma unroll
      for (int rr = 0; rr < NR; ++rr) {
        const float4 h0 = *reinterpret_cast<const float4*>(hb + rr * dh + 8 * k);
        const float4 h1 =
            *reinterpret_cast<const float4*>(hb + rr * dh + 8 * k + 4);
        float a = acc[rr];
        a = fmaf(h0.x, rv[0], a);
        a = fmaf(h0.y, rv[1], a);
        a = fmaf(h0.z, rv[2], a);
        a = fmaf(h0.w, rv[3], a);
        a = fmaf(h1.x, rv[4], a);
        a = fmaf(h1.y, rv[5], a);
        a = fmaf(h1.z, rv[6], a);
        a = fmaf(h1.w, rv[7], a);
        acc[rr] = a;
      }
    }
    // gate gg of (row rr, unit u) sits in lane 8 gg + lane % 8
    float pre[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int gg = 0; gg < 4; ++gg) {
#pragma unroll
      for (int rr = 0; rr < NR; ++rr) {
        const float v = __shfl_sync(0xffffffffu, acc[rr], 8 * gg + (lane & 7));
        if (er == rr) pre[gg] = v;
      }
    }
    if (owner) {
      h = slstm_update((gcur[0] + pre[0]) + b4[0], (gcur[1] + pre[1]) + b4[1],
                       (gcur[2] + pre[2]) + b4[2], (gcur[3] + pre[3]) + b4[3],
                       c, n, m);
      float* local = hn + er * dh + j;
      for (int q = 0; q < cl; ++q) *cluster.map_shared_rank(local, q) = h;
      hs[(((size_t)row * L + step) * heads + head) * dh + j] = h;
    }
    // h_t is in every CTA; the other buffer is free to be written next step
    cluster_barrier();
  }
  if (owner && (active == nullptr || active[row])) {
    c_st[sidx] = c;
    n_st[sidx] = n;
    h_st[sidx] = h;
    m_st[sidx] = m;
  }
}

__global__ void __launch_bounds__(kClusterThreads)
    slstm_scan_cluster_kernel(const float* __restrict__ gx,
                              const __nv_bfloat16* __restrict__ r,
                              const float* __restrict__ bias,
                              float* __restrict__ hs, float* c_st,
                              float* n_st, float* h_st, float* m_st,
                              const uint8_t* __restrict__ active, int batch,
                              int L, int heads, int dh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int head = blockIdx.x / cl;
  const int j0 = rank * kUnits;
  const int row0 = blockIdx.y * kClusterRows;
  const int nr = min(kClusterRows, batch - row0);
  uint4* rs = reinterpret_cast<uint4*>(smem_raw);
  float* hbuf = reinterpret_cast<float*>(rs + (size_t)dh / 8 * kClusterThreads);
  load_r_slice(r, rs, head, dh, j0);
#define REPRO_SCAN_ROWS(NR)                                                  \
  scan_rows<NR>(gx, bias, hs, c_st, n_st, h_st, m_st, active, rs, hbuf,     \
                row0, L, heads, dh, head, j0, cl)
  switch (nr) {
    case 1: REPRO_SCAN_ROWS(1); break;
    case 2: REPRO_SCAN_ROWS(2); break;
    case 3: REPRO_SCAN_ROWS(3); break;
    default: REPRO_SCAN_ROWS(4); break;
  }
#undef REPRO_SCAN_ROWS
}

// The least a step of the cluster kernel can take with its order kept: one
// dh-long dependent fmaf chain over shared memory and one cluster barrier.
__global__ void __launch_bounds__(kClusterThreads)
    slstm_chain_floor_kernel(float* __restrict__ out, int L, int dh) {
  extern __shared__ float hv[];
  for (int i = threadIdx.x; i < dh; i += kClusterThreads) hv[i] = 1e-3f * i;
  __syncthreads();
  cluster_barrier();
  const float w = 0.5f + 1e-3f * threadIdx.x;
  float acc = 0.0f;
  for (int step = 0; step < L; ++step) {
    for (int d = 0; d < dh; d += 4) {
      const float4 hq = *reinterpret_cast<const float4*>(hv + d);
      acc = fmaf(hq.x, w, acc);
      acc = fmaf(hq.y, w, acc);
      acc = fmaf(hq.z, w, acc);
      acc = fmaf(hq.w, w, acc);
    }
    cluster_barrier();
  }
  out[blockIdx.x * kClusterThreads + threadIdx.x] = acc;
}

size_t cluster_smem_bytes(int dh) {
  return (size_t)dh * kClusterThreads * sizeof(__nv_bfloat16) +
         2 * (size_t)kClusterRows * dh * sizeof(float);
}

// Opts the cluster kernels in to a non-portable cluster size and to their
// shared memory, and asks how many clusters of dh/32 CTAs the card can
// hold at once (cached per cluster size); 0 if none fits.
int cluster_capacity(int dh, int* clusters) {
  static int cached[kMaxCluster + 1] = {0};
  const int cl = dh / kUnits;
  if (cached[cl] > 0) {
    *clusters = cached[cl];
    return 0;
  }
  const size_t smem = cluster_smem_bytes(dh);
  cudaError_t e = cudaFuncSetAttribute(
      slstm_scan_cluster_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
      1);
  if (e == cudaSuccess)  // the widest slice, so any width may launch after
    e = cudaFuncSetAttribute(
        slstm_scan_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)cluster_smem_bytes(kMaxCluster * kUnits));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(slstm_chain_floor_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(cl, 1, 1);
  cfg.blockDim = dim3(kClusterThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, slstm_scan_cluster_kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  cached[cl] = n;
  *clusters = n;
  return 0;
}

bool cluster_shape_ok(int dh) {
  return dh % kUnits == 0 && dh / kUnits >= 1 && dh / kUnits <= kMaxCluster;
}

}  // namespace repro

// How many clusters of the cluster kernel at head width dh the card holds
// at once (written to *clusters); a CUDA error code, or 0.
extern "C" int slstm_scan_cluster_capacity(int dh, int* clusters) {
  using namespace repro;
  if (!cluster_shape_ok(dh)) return (int)cudaErrorInvalidValue;
  return cluster_capacity(dh, clusters);
}

extern "C" int slstm_scan_launch(const void* gx, const void* r,
                                 const void* bias, void* hs, void* c, void* n,
                                 void* h, void* m, const void* active,
                                 int batch, int L, int heads, int dh,
                                 int r_dtype, int kernel, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st[4] = {static_cast<float*>(c), static_cast<float*>(n),
                  static_cast<float*>(h), static_cast<float*>(m)};
  const uint8_t* act = static_cast<const uint8_t*>(active);
  const float* g = static_cast<const float*>(gx);
  const float* b = static_cast<const float*>(bias);
  float* out = static_cast<float*>(hs);
  if (kernel == kScanCluster) {
    if (r_dtype != kBF16 || !cluster_shape_ok(dh))
      return (int)cudaErrorInvalidValue;
    int capacity = 0;
    const int e = cluster_capacity(dh, &capacity);
    if (e != 0) return e;
    if (capacity < 1) return (int)cudaErrorLaunchOutOfResources;
    const int cl = dh / kUnits;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cl;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim =
        dim3(heads * cl, (batch + kClusterRows - 1) / kClusterRows, 1);
    cfg.blockDim = dim3(kClusterThreads, 1, 1);
    cfg.dynamicSmemBytes = cluster_smem_bytes(dh);
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t le = cudaLaunchKernelEx(
        &cfg, slstm_scan_cluster_kernel, g,
        static_cast<const __nv_bfloat16*>(r), b, out, st[0], st[1], st[2],
        st[3], act, batch, L, heads, dh);
    if (le != cudaSuccess) return (int)le;
    return (int)cudaGetLastError();
  }
  if (kernel != kScanCudaCore || dh < 1 || dh > kScanMaxThreads)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(heads, batch);
  const size_t smem = (size_t)dh * sizeof(float);
  if (r_dtype == kBF16)
    slstm_scan_kernel<__nv_bfloat16><<<grid, dh, smem, s>>>(
        g, static_cast<const __nv_bfloat16*>(r), b, out, st[0], st[1], st[2],
        st[3], act, L, heads, dh);
  else
    slstm_scan_kernel<float><<<grid, dh, smem, s>>>(
        g, static_cast<const float*>(r), b, out, st[0], st[1], st[2], st[3],
        act, L, heads, dh);
  return (int)cudaGetLastError();
}

// The chain floor: L steps of slstm_chain_floor_kernel on one cluster of
// dh/32 CTAs (out: dh * 4 floats).
extern "C" int slstm_chain_floor_launch(void* out, int L, int dh,
                                        void* stream) {
  using namespace repro;
  if (!cluster_shape_ok(dh)) return (int)cudaErrorInvalidValue;
  int capacity = 0;
  const int e = cluster_capacity(dh, &capacity);
  if (e != 0) return e;
  const int cl = dh / kUnits;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(cl, 1, 1);
  cfg.blockDim = dim3(kClusterThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)dh * sizeof(float);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t le = cudaLaunchKernelEx(
      &cfg, slstm_chain_floor_kernel, static_cast<float*>(out), L, dh);
  if (le != cudaSuccess) return (int)le;
  return (int)cudaGetLastError();
}
