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
// Design.  One block per (row, head, 64-column tile of C), 256 threads:
// thread t owns column e = tile*64 + t%64 and the t/64-th quarter of the
// rows d, walks them in order (read C once, write C' once, in place) and
// sums q_d C'[d, e]; the four quarters' sums are added in quarter order.
// Every block computes the gate dots and q . n' the same way (each thread
// sums a strided share in order, warps by butterfly, warp sums in warp
// order), so all tiles of a head agree bitwise.  n' and m' go to separate
// outputs, written by tile 0: other tiles still read n and m.  Rows where
// `active` (nullable) is false keep C, n and m.
//
// What bounds it: bytes, C read and written once (4 MB a head and row at
// xlstm-1.3b's dh = 1024).
#include "common.cuh"

REPRO_ERROR_STRING_FN

namespace repro {

constexpr int kCellThreads = 256;
constexpr int kTileE = 64;
constexpr int kQuarters = kCellThreads / kTileE;
constexpr int kCellWarps = kCellThreads / 32;

__device__ __forceinline__ float log_sigmoid_f(float x) {
  return fminf(x, 0.0f) - log1pf(expf(-fabsf(x)));
}

template <typename T>
__global__ void __launch_bounds__(kCellThreads)
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
  __shared__ float red[2][kCellWarps];
  __shared__ float part[kQuarters][kTileE];
  const int tile = blockIdx.x, head = blockIdx.y, row = blockIdx.z;
  const int t = threadIdx.x;
  const int di = heads * dh;
  const size_t rh = (size_t)row * heads + head;
  const bool live = active == nullptr || active[row] != 0;

  // gate pre-activations xp[row] . w[:, head]
  const T* x = xp + (size_t)row * di;
  float si = 0.0f, sf = 0.0f;
  for (int kk = t; kk < di; kk += kCellThreads) {
    const float xv = to_f32(x[kk]);
    si = fmaf(xv, to_f32(w_i[(size_t)kk * heads + head]), si);
    sf = fmaf(xv, to_f32(w_f[(size_t)kk * heads + head]), sf);
  }
  si = warp_sum(si);
  sf = warp_sum(sf);
  if ((t & 31) == 0) {
    red[0][t >> 5] = si;
    red[1][t >> 5] = sf;
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
    if (tile == 0) n_out[rh * dh + d] = live ? nn : nh[d];
  }
  qn = warp_sum(qn);
  __syncthreads();  // every thread has read red[0]
  if ((t & 31) == 0) red[0][t >> 5] = qn;

  // this tile's columns of C' and their q . C'
  const int col = t % kTileE, quarter = t / kTileE;
  const int e = tile * kTileE + col;
  const int rows = (dh + kQuarters - 1) / kQuarters;
  const int d0 = quarter * rows, d1 = min(dh, d0 + rows);
  float num = 0.0f;
  if (e < dh) {
    const float ve = to_f32(v[rh * dh + e]);
    float* ce = C + rh * dh * dh + e;
    for (int d = d0; d < d1; ++d) {
      const float cn = ce[(size_t)d * dh] * f_act + i_act * (ks_s[d] * ve);
      if (live) ce[(size_t)d * dh] = cn;
      num = fmaf(q_s[d], cn, num);
    }
  }
  part[quarter][col] = num;
  __syncthreads();
  if (t < kTileE && e < dh) {
    float qnt = 0.0f;
#pragma unroll
    for (int w = 0; w < kCellWarps; ++w) qnt += red[0][w];
    const float den = fmaxf(fabsf(qnt), expf(-m_new));
    float s = part[0][col];
#pragma unroll
    for (int p = 1; p < kQuarters; ++p) s += part[p][col];
    y[rh * dh + e] = s / den;
  }
  if (tile == 0 && t == 0) m_out[rh] = live ? m_new : m_old;
}

}  // namespace repro

extern "C" int mlstm_cell_launch(const void* xp, const void* q, const void* k,
                                 const void* v, const void* w_i,
                                 const void* w_f, const void* b_i,
                                 const void* b_f, void* C, const void* n_in,
                                 const void* m_in, void* y, void* n_out,
                                 void* m_out, const void* active, int batch,
                                 int heads, int dh, float sqrt_dh, int dtype,
                                 void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((dh + kTileE - 1) / kTileE, heads, batch);
  const size_t smem = 2 * (size_t)dh * sizeof(float);  // <= 32 KB
  const float* bi = static_cast<const float*>(b_i);
  const float* bf = static_cast<const float*>(b_f);
  float* c = static_cast<float*>(C);
  const float* ni = static_cast<const float*>(n_in);
  const float* mi = static_cast<const float*>(m_in);
  float* yo = static_cast<float*>(y);
  float* no = static_cast<float*>(n_out);
  float* mo = static_cast<float*>(m_out);
  const uint8_t* act = static_cast<const uint8_t*>(active);
  if (dtype == kBF16) {
    using T = __nv_bfloat16;
    mlstm_cell_kernel<T><<<grid, kCellThreads, smem, s>>>(
        static_cast<const T*>(xp), static_cast<const T*>(q),
        static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(w_i), static_cast<const T*>(w_f), bi, bf, c, ni,
        mi, yo, no, mo, act, heads, dh, sqrt_dh);
  } else {
    using T = float;
    mlstm_cell_kernel<T><<<grid, kCellThreads, smem, s>>>(
        static_cast<const T*>(xp), static_cast<const T*>(q),
        static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(w_i), static_cast<const T*>(w_f), bi, bf, c, ni,
        mi, yo, no, mo, act, heads, dh, sqrt_dh);
  }
  return (int)cudaGetLastError();
}
