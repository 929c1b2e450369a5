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
// Design.  One block per (head, row), one thread per hidden unit j, which
// owns the four gate columns j, dh+j, 2dh+j, 3dh+j, so the elementwise
// update stays in the thread.  h_{t-1} sits in shared memory; each thread
// sums its four dots over d = 0 .. dh-1 in that one order, reading R from
// global memory (2 MB a head at xlstm-1.3b's dh = 512 in bf16, which stays
// in the 50 MB L2 across steps).  Two barriers a step separate the reads of
// h_{t-1} from the write of h_t.  A row's result depends on nothing but its
// own inputs, so rows are bitwise independent of the batch.
//
// Beyond the reference's signature, and the same function: any L (no time
// chunk: the reference refuses L not a multiple of min(256, L)); a state
// (c, n, h, m) read at the start and written back at the end, which lets
// one decode step run at L = 1 on the serving cache; and a per-row `active`
// mask (nullable) whose false rows keep their state.
//
// What bounds it on this card: the chain of L dependent steps.  The byte
// bound (gates_x and hs once, R once) is far below the time one block takes
// to stream its head's R from L2 every step; a cluster that keeps R in
// distributed shared memory is later speed work.  Built without fast math:
// expf, log1pf and tanhf keep it within 2e-4 of the f32 scan.
#include "common.cuh"

REPRO_ERROR_STRING_FN

namespace repro {

constexpr int kScanMaxThreads = 1024;

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// log(sigmoid(x)) without overflow for either sign
__device__ __forceinline__ float log_sigmoid_f(float x) {
  return fminf(x, 0.0f) - log1pf(expf(-fabsf(x)));
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
    const float z = tanhf((g[j] + az) + bz);
    const float ig = (g[dh + j] + ai) + bi;
    const float fg = (g[2 * dh + j] + af) + bf;
    const float o = sigmoid_f((g[3 * dh + j] + ao) + bo);
    const float logf_ = log_sigmoid_f(fg);
    const float m_new = fmaxf(logf_ + m, ig);
    const float i_act = expf(ig - m_new);
    const float f_act = expf(logf_ + m - m_new);
    c = f_act * c + i_act * z;
    n = fmaxf(f_act * n + i_act, expf(-m_new));
    m = m_new;
    h = o * c / n;
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

}  // namespace repro

extern "C" int slstm_scan_launch(const void* gx, const void* r,
                                 const void* bias, void* hs, void* c, void* n,
                                 void* h, void* m, const void* active,
                                 int batch, int L, int heads, int dh,
                                 int r_dtype, void* stream) {
  using namespace repro;
  if (dh < 1 || dh > kScanMaxThreads) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(heads, batch);
  const size_t smem = (size_t)dh * sizeof(float);
  float* st[4] = {static_cast<float*>(c), static_cast<float*>(n),
                  static_cast<float*>(h), static_cast<float*>(m)};
  const uint8_t* act = static_cast<const uint8_t*>(active);
  if (r_dtype == kBF16)
    slstm_scan_kernel<__nv_bfloat16><<<grid, dh, smem, s>>>(
        static_cast<const float*>(gx),
        static_cast<const __nv_bfloat16*>(r),
        static_cast<const float*>(bias), static_cast<float*>(hs), st[0],
        st[1], st[2], st[3], act, L, heads, dh);
  else
    slstm_scan_kernel<float><<<grid, dh, smem, s>>>(
        static_cast<const float*>(gx), static_cast<const float*>(r),
        static_cast<const float*>(bias), static_cast<float*>(hs), st[0],
        st[1], st[2], st[3], act, L, heads, dh);
  return (int)cudaGetLastError();
}
