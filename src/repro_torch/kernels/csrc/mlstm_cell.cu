// mLSTM decode cell for Hopper (sm_90a): one token's update of the matrix
// memory and its readout, for every (row, head).
//
// Not a port of a TPU kernel: the reference leaves this step of
// `mlstm_decode` (src/repro/models/xlstm.py:205-217) to XLA.  It is a
// kernel here for the same reason as csrc/rmsnorm.cu: the engine's oracle
// parity needs each row's result bitwise independent of the batch, and the
// step holds three reductions whose PyTorch split would depend on the row
// count: the 16-bit gate projections xp . w_i and xp . w_f (a cuBLAS
// (B, 2d) x (2d, heads) product), the readouts q . C' and q . n', and the
// outer-product update they read.  With the gates g = round(xp . w) + b in
// f32 (rounded to the model dtype first, as the reference's `linear` does):
//   logf = log_sigmoid(f), m' = max(logf + m, i), i' = exp(i - m'),
//   f' = exp(logf + m - m'), k_s = k / sqrt(dh),
//   C' = C f' + i' (k_s v^T),  n' = n f' + i' k_s,
//   y = (q . C') / max(|q . n'|, exp(-m')).
//
// Design.  A cluster of 4 CTAs per (row, head, 1024-column tile of C), one
// CTA per quarter of the rows d of C; 256 threads, each owning 4 adjacent
// columns (16-byte loads and stores when dh % 4 == 0, else scalar ones),
// so a CTA reads whole 4 KB rows at xlstm-1.3b's dh = 1024 (narrower
// tiles, which split each row between CTAs, were slower on the card).  A
// thread walks its quarter's rows in order, reading C and writing C' in
// place, with 8 to 16 rows of loads in flight in registers ahead of the
// rows it updates (deeper rings, in registers or in shared memory, were no
// faster on the card); the first 16 rows are asked for before the gate
// dots, whose strided reads of w_i / w_f hide behind them.  Each column sums
// q_d C'[d, e] over its quarter in d order; after one cluster barrier,
// rank q folds columns [256 q, 256 q + 256) of the tile, reading the four
// quarters' sums from distributed shared memory and adding them in quarter
// order, and a second barrier keeps every CTA's shared memory alive until
// the folds are done.  Every CTA of a head computes the gate dots and
// q . n' the same way (each thread sums a strided share in order, warps by
// butterfly, warp sums in warp order), so all tiles and quarters agree
// bitwise, and C', n', m' and y keep the order of the one-CTA-a-tile
// kernel this one replaced, bitwise.  n' and m' go to separate outputs,
// written by the first CTA (tile 0, quarter 0): other CTAs still read n
// and m.  Rows where `active` (nullable) is false keep C, n and m.
//
// What bounds it: bytes, C read and written once (4 MB a head and row at
// xlstm-1.3b's dh = 1024, 128 MB a call at B = 4).  The order above gives
// one 4-column chain per quarter and column group, so 64 CTAs at B = 4,
// 4 heads: half the SMs stream the whole of C.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

REPRO_ERROR_STRING_FN

namespace repro {

constexpr int kCellThreads = 256;
constexpr int kCellWarps = kCellThreads / 32;
constexpr int kCols = 4;                          // columns a thread owns
constexpr int kTileE = kCellThreads * kCols;      // 1024
constexpr int kQuarters = 4;                      // CTAs of a cluster
constexpr int kAhead = 8;                         // rows a load batch holds
constexpr int kBufs = 2;                          // load batches in flight

__device__ __forceinline__ float log_sigmoid_f(float x) {
  return fminf(x, 0.0f) - log1pf(expf(-fabsf(x)));
}

// Rows d .. d + kAhead - 1 (those below d1) of this thread's columns.
template <bool VEC>
__device__ __forceinline__ void load_rows(float4 (&a)[kAhead],
                                          const float* ce, int d, int d1,
                                          int dh, int ncols) {
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    a[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (d + i < d1) {
      const float* p = ce + (size_t)(d + i) * dh;
      if constexpr (VEC) {
        if (ncols > 0) a[i] = *reinterpret_cast<const float4*>(p);
      } else {
        if (ncols > 0) a[i].x = p[0];
        if (ncols > 1) a[i].y = p[1];
        if (ncols > 2) a[i].z = p[2];
        if (ncols > 3) a[i].w = p[3];
      }
    }
  }
}

// C' = C f' + i' (k_s v^T) on rows d .. d + kAhead - 1, stored when the row
// is live, and q_d C'[d, e] summed into num in d order.
template <bool VEC>
__device__ __forceinline__ void update_rows(
    const float4 (&a)[kAhead], float* ce, int d, int d1, int dh, int ncols,
    const float* q_s, const float* ks_s, const float (&ve)[kCols],
    float f_act, float i_act, bool live, float (&num)[kCols]) {
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    if (d + i < d1) {
      const int dd = d + i;
      const float cv[kCols] = {a[i].x, a[i].y, a[i].z, a[i].w};
      float cn[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        cn[c] = cv[c] * f_act + i_act * (ks_s[dd] * ve[c]);
        num[c] = fmaf(q_s[dd], cn[c], num[c]);
      }
      float* p = ce + (size_t)dd * dh;
      if (live) {
        if constexpr (VEC) {
          if (ncols > 0)
            *reinterpret_cast<float4*>(p) =
                make_float4(cn[0], cn[1], cn[2], cn[3]);
        } else {
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            if (c < ncols) p[c] = cn[c];
        }
      }
    }
  }
}

template <typename T, bool VEC>
__global__ void __cluster_dims__(kQuarters, 1, 1)
    __launch_bounds__(kCellThreads, 1)
    mlstm_cell_kernel(const T* __restrict__ xp, const T* __restrict__ q,
                      const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ w_i, const T* __restrict__ w_f,
                      const float* __restrict__ b_i,
                      const float* __restrict__ b_f, float* C,
                      const float* __restrict__ n_in,
                      const float* __restrict__ m_in, float* __restrict__ y,
                      float* __restrict__ n_out, float* __restrict__ m_out,
                      const uint8_t* __restrict__ active, int heads, int dh,
                      float sqrt_dh) {
  extern __shared__ float smem[];  // q (dh), k / sqrt(dh) (dh)
  float* q_s = smem;
  float* ks_s = smem + dh;
  __shared__ float red[3][kCellWarps];   // i, f, q . n'
  __shared__ float part[kTileE];         // this quarter's q . C' per column
  cg::cluster_group cluster = cg::this_cluster();
  const int quarter = (int)cluster.block_rank();
  const int tile = blockIdx.x / kQuarters, head = blockIdx.y,
            row = blockIdx.z;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int di = heads * dh;
  const size_t rh = (size_t)row * heads + head;
  const bool live = active == nullptr || active[row] != 0;
  const bool first = tile == 0 && quarter == 0;

  // this thread's columns and this CTA's quarter of the rows
  const int e0 = tile * kTileE + kCols * t;
  const int ncols = max(0, min(kCols, dh - e0));
  const int rows = (dh + kQuarters - 1) / kQuarters;
  const int d0 = quarter * rows, d1 = min(dh, d0 + rows);
  float* ce = C + rh * dh * dh + (ncols > 0 ? e0 : 0);
  float4 buf[kBufs][kAhead];
#pragma unroll
  for (int j = 0; j < kBufs; ++j)
    load_rows<VEC>(buf[j], ce, d0 + j * kAhead, d1, dh, ncols);

  // gate pre-activations xp[row] . w[:, head]
  const T* x = xp + (size_t)row * di;
  float si = 0.0f, sf = 0.0f;
#pragma unroll 4
  for (int kk = t; kk < di; kk += kCellThreads) {
    const float xv = to_f32(x[kk]);
    si = fmaf(xv, to_f32(w_i[(size_t)kk * heads + head]), si);
    sf = fmaf(xv, to_f32(w_f[(size_t)kk * heads + head]), sf);
  }
  si = warp_sum(si);
  sf = warp_sum(sf);
  if (lane == 0) {
    red[0][warp] = si;
    red[1][warp] = sf;
  }
  for (int d = t; d < dh; d += kCellThreads) {
    q_s[d] = to_f32(q[rh * dh + d]);
    ks_s[d] = to_f32(k[rh * dh + d]) / sqrt_dh;
  }
  __syncthreads();
  float ig = 0.0f, fg = 0.0f;
#pragma unroll
  for (int w = 0; w < kCellWarps; ++w) {
    ig += red[0][w];
    fg += red[1][w];
  }
  ig = round_to<T>(ig) + b_i[head];
  fg = round_to<T>(fg) + b_f[head];
  const float m_old = m_in[rh];
  const float logf_ = log_sigmoid_f(fg);
  const float m_new = fmaxf(logf_ + m_old, ig);
  const float i_act = expf(ig - m_new);
  const float f_act = expf(logf_ + m_old - m_new);

  // normalizer n' and q . n'
  const float* nh = n_in + rh * dh;
  float qn = 0.0f;
  for (int d = t; d < dh; d += kCellThreads) {
    const float nn = nh[d] * f_act + i_act * ks_s[d];
    qn = fmaf(q_s[d], nn, qn);
    if (first) n_out[rh * dh + d] = live ? nn : nh[d];
  }
  qn = warp_sum(qn);
  if (lane == 0) red[2][warp] = qn;

  // this thread's columns of C' over the quarter, loads kept ahead
  float ve[kCols], num[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    ve[c] = c < ncols ? to_f32(v[rh * dh + e0 + c]) : 0.0f;
    num[c] = 0.0f;
  }
  for (int d = d0; d < d1; d += kBufs * kAhead) {
#pragma unroll
    for (int j = 0; j < kBufs; ++j) {
      update_rows<VEC>(buf[j], ce, d + j * kAhead, d1, dh, ncols, q_s, ks_s,
                       ve, f_act, i_act, live, num);
      load_rows<VEC>(buf[j], ce, d + (j + kBufs) * kAhead, d1, dh, ncols);
    }
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c) part[kCols * t + c] = num[c];
  cluster.sync();  // every quarter's sums (and red[2]) are in place

  // fold: rank `quarter` finishes columns [128 quarter, 128 quarter + 128)
  const int col = quarter * kCellThreads + t;
  const int e = tile * kTileE + col;
  if (e < dh) {
    float qnt = 0.0f;
#pragma unroll
    for (int w = 0; w < kCellWarps; ++w) qnt += red[2][w];
    const float den = fmaxf(fabsf(qnt), expf(-m_new));
    float s = cluster.map_shared_rank(part, 0)[col];
#pragma unroll
    for (int p = 1; p < kQuarters; ++p)
      s += cluster.map_shared_rank(part, p)[col];
    y[rh * dh + e] = s / den;
  }
  if (first && t == 0) m_out[rh] = live ? m_new : m_old;
  cluster.sync();  // no CTA leaves while another reads its sums
}

template <typename T, bool VEC>
int launch_cell(const void* xp, const void* q, const void* k, const void* v,
                const void* w_i, const void* w_f, const float* bi,
                const float* bf, float* c, const float* ni, const float* mi,
                float* yo, float* no, float* mo, const uint8_t* act,
                int batch, int heads, int dh, float sqrt_dh,
                cudaStream_t s) {
  const dim3 grid((dh + kTileE - 1) / kTileE * kQuarters, heads, batch);
  const size_t smem = 2 * (size_t)dh * sizeof(float);  // <= 32 KB
  mlstm_cell_kernel<T, VEC><<<grid, kCellThreads, smem, s>>>(
      static_cast<const T*>(xp), static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w_i), static_cast<const T*>(w_f), bi, bf, c, ni,
      mi, yo, no, mo, act, heads, dh, sqrt_dh);
  return (int)cudaGetLastError();
}

}  // namespace repro

// vec: 16-byte rows of C (the wrapper's cell_plan sets it when dh % 4 == 0)
extern "C" int mlstm_cell_launch(const void* xp, const void* q, const void* k,
                                 const void* v, const void* w_i,
                                 const void* w_f, const void* b_i,
                                 const void* b_f, void* C, const void* n_in,
                                 const void* m_in, void* y, void* n_out,
                                 void* m_out, const void* active, int batch,
                                 int heads, int dh, float sqrt_dh, int dtype,
                                 int vec, void* stream) {
  using namespace repro;
  if (vec && dh % 4 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bi = static_cast<const float*>(b_i);
  const float* bf = static_cast<const float*>(b_f);
  float* c = static_cast<float*>(C);
  const float* ni = static_cast<const float*>(n_in);
  const float* mi = static_cast<const float*>(m_in);
  float* yo = static_cast<float*>(y);
  float* no = static_cast<float*>(n_out);
  float* mo = static_cast<float*>(m_out);
  const uint8_t* act = static_cast<const uint8_t*>(active);
#define REPRO_CELL(T, VEC)                                                   \
  return launch_cell<T, VEC>(xp, q, k, v, w_i, w_f, bi, bf, c, ni, mi, yo,  \
                             no, mo, act, batch, heads, dh, sqrt_dh, s)
  if (dtype == kBF16) {
    if (vec) REPRO_CELL(__nv_bfloat16, true);
    REPRO_CELL(__nv_bfloat16, false);
  }
  if (vec) REPRO_CELL(float, true);
  REPRO_CELL(float, false);
#undef REPRO_CELL
}
