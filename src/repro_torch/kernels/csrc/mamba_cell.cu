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
#include "common.cuh"

REPRO_ERROR_STRING_FN

namespace repro {

constexpr int kConvThreads = 256;
constexpr int kStateThreads = 256;
constexpr int kMaxConv = 8;

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
