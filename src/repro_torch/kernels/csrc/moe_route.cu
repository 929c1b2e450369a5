// MoE routing and combine for Hopper (sm_90a).
//
// Not a port of a TPU kernel: the reference routes and combines in XLA
// (src/repro/models/moe.py:64-118, _route and _dispatch_compute's
// gather / scatter-add), with no Pallas kernel.  Both are kernels here so
// that a serving tick routes on the device, reads nothing back on the host
// and stays one CUDA graph replay.
//
// moe_route_kernel: one block a routing group (a row's S tokens).
//   1. A warp a token: the router's logits (x's dtype) to f32, softmax
//      (max, expf, a warp sum, one division), then top-k by k rounds of a
//      warp argmax whose ties go to the lower expert index
//      (jax.lax.top_k's rule; torch.topk promises none), the k weights
//      renormalised by max(their sum in j order, 1e-9).
//   2. Positions: the group's live assignments in flat (token, j) order
//      split into one contiguous run a thread; each thread counts its
//      run's experts, an exclusive scan over the threads a expert gives
//      each run its start, and a second walk numbers the assignments:
//      pos = earlier assignments of the group to the same expert, as the
//      reference's cumsum of one-hots.  keep = pos < capacity.  Dead
//      tokens (s >= q_lens[b]) take no place; they follow the live ones.
//   3. The last block to finish (a ticket: one atomicAdd a block, the
//      sync pattern of CUDA's threadFenceReduction sample; no sum goes
//      through an atomic) lays the kept assignments out expert after
//      expert, group after group: counts, offsets, each assignment's slot
//      (-1 if dropped) and the token of each slot (rows).  It resets the
//      ticket for the next launch.
// What bounds it: latency; it reads T E logits and writes O(T k) ints.
//
// moe_combine_kernel: a block a (token, 128-column strip), a thread a
// column:
//   out[t, c] = sum_j y[slot[t, j], c] * w[t, j]
// with the reference's roundings (moe.py:110-117): the weight and each
// product rounded to y's dtype, the sum from zero in that dtype in j
// order, a dropped assignment (slot < 0) adding nothing; no atomics
// (__fmul_rn / __fadd_rn: no FMA contraction in float32).  What bounds it:
// the bytes, k rows of y read and one written a token.
#include <climits>
#include <cmath>

#include "common.cuh"

REPRO_ERROR_STRING_FN

namespace repro {

constexpr int kRouteThreads = 256;
constexpr int kRouteWarps = kRouteThreads / 32;
constexpr int kMaxExperts = 64;      // two a lane

__device__ unsigned int moe_route_ticket = 0;

// a better than b: the higher weight, or the same and the lower index
__device__ __forceinline__ bool route_better(float ka, int ia, float kb,
                                             int ib) {
  return ka > kb || (ka == kb && ia < ib);
}

template <typename T>
__global__ void __launch_bounds__(kRouteThreads)
    moe_route_kernel(const T* __restrict__ logits,
                     const int* __restrict__ q_lens, float* topw, int* topi,
                     int* slot, int* counts, int* offsets, int* rows,
                     int* per_group, int group, int n_exp, int k, int cap) {
  extern __shared__ int run_count[];   // [kRouteThreads][n_exp]
  __shared__ int total[kMaxExperts], start[kMaxExperts];
  __shared__ int is_last;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int live = q_lens != nullptr ? min(max(q_lens[b], 0), group) : group;
  const size_t a_base = (size_t)b * group * k;

  // 1. softmax and top-k, a warp a token
  for (int s = warp; s < group; s += kRouteWarps) {
    const size_t t = (size_t)b * group + s;
    const int e0 = lane, e1 = lane + 32;
    const float v0 = e0 < n_exp ? to_f32(logits[t * n_exp + e0]) : -INFINITY;
    const float v1 = e1 < n_exp ? to_f32(logits[t * n_exp + e1]) : -INFINITY;
    const float m = warp_max(fmaxf(v0, v1));
    const float x0 = e0 < n_exp ? expf(v0 - m) : 0.0f;
    const float x1 = e1 < n_exp ? expf(v1 - m) : 0.0f;
    const float sum = warp_sum(x0 + x1);
    // a NaN weight (a poisoned row) ranks last but still gives an index
    float p0 = x0 / sum, p1 = x1 / sum;
    p0 = isnan(p0) ? -INFINITY : p0;
    p1 = isnan(p1) ? -INFINITY : p1;
    bool taken0 = e0 >= n_exp, taken1 = e1 >= n_exp;
    float my_w = 0.0f;
    int my_i = 0;
    for (int j = 0; j < k; ++j) {
      float kb = -INFINITY;
      int ib = INT_MAX;
      if (!taken0) kb = p0, ib = e0;
      if (!taken1 && route_better(p1, e1, kb, ib)) kb = p1, ib = e1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ko = __shfl_xor_sync(0xffffffffu, kb, o);
        const int io = __shfl_xor_sync(0xffffffffu, ib, o);
        if (route_better(ko, io, kb, ib)) kb = ko, ib = io;
      }
      taken0 |= ib == e0;
      taken1 |= ib == e1;
      if (lane == j) my_w = kb, my_i = ib;
    }
    float wsum = 0.0f;
    for (int j = 0; j < k; ++j)
      wsum = __fadd_rn(wsum, __shfl_sync(0xffffffffu, my_w, j));
    if (lane < k) {
      topw[t * k + lane] = my_w / fmaxf(wsum, 1e-9f);
      topi[t * k + lane] = my_i;
    }
  }
  __syncthreads();   // the group's topi, written above, for every thread

  // 2. positions of the live assignments in flat order, in n_runs runs
  // (at most one a thread, so a decode group's scan is short)
  const int n_live = live * k;
  const int n_runs = max(min(kRouteThreads, n_live), 1);
  const int per = (n_live + n_runs - 1) / n_runs;
  const int a0 = min(tid * per, n_live), a1 = min(a0 + per, n_live);
  int* mine = run_count + tid * n_exp;
  if (tid < n_runs) {
    for (int e = 0; e < n_exp; ++e) mine[e] = 0;
    for (int a = a0; a < a1; ++a) ++mine[topi[a_base + a]];
  }
  __syncthreads();
  if (tid < n_exp) {
    int run = 0;
    for (int r = 0; r < n_runs; ++r) {
      const int c = run_count[r * n_exp + tid];
      run_count[r * n_exp + tid] = run;
      run += c;
    }
    per_group[b * n_exp + tid] = min(run, cap);
  }
  __syncthreads();
  for (int a = a0; a < a1; ++a) slot[a_base + a] = mine[topi[a_base + a]]++;
  for (int a = n_live + tid; a < group * k; a += kRouteThreads)
    slot[a_base + a] = INT_MAX;        // a dead token: no place

  // 3. the last block lays the rows out
  __threadfence();
  __syncthreads();
  if (tid == 0)
    is_last = atomicAdd(&moe_route_ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const int n_groups = gridDim.x;
  if (tid < n_exp) {
    int tot = 0;
    for (int g = 0; g < n_groups; ++g)
      tot += __ldcg(per_group + g * n_exp + tid);
    total[tid] = tot;
  }
  __syncthreads();
  if (tid == 0) {
    int run = 0;
    for (int e = 0; e < n_exp; ++e) start[e] = run, run += total[e];
  }
  __syncthreads();
  if (tid < n_exp) {
    counts[tid] = total[tid];
    offsets[tid] = start[tid];
    int run = start[tid];
    for (int g = 0; g < n_groups; ++g) {    // per_group becomes each
      const int c = __ldcg(per_group + g * n_exp + tid);   // group's base
      __stcg(per_group + g * n_exp + tid, run);
      run += c;
    }
  }
  __syncthreads();
  const int n_all = n_groups * group * k;
  for (int a = tid; a < n_all; a += kRouteThreads) {
    const int pos = __ldcg(slot + a);
    if (pos < cap) {
      const int g = a / (group * k), e = __ldcg(topi + a);
      const int r = __ldcg(per_group + g * n_exp + e) + pos;
      slot[a] = r;
      rows[r] = a / k;
    } else {
      slot[a] = -1;
    }
  }
  if (tid == 0) moe_route_ticket = 0;
}

constexpr int kCombineThreads = 128;
constexpr int kCombineLoads = 8;     // y loads a thread keeps in flight

// Block (token, column strip): a thread a column; its token's slots and
// weights in shared memory, the y loads of kCombineLoads assignments issued
// before the in-order sum uses them.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
    moe_combine_kernel(const T* __restrict__ y, const int* __restrict__ slot,
                       const float* __restrict__ topw, T* __restrict__ out,
                       int k, int d) {
  __shared__ int s_slot[32];
  __shared__ float s_w[32];
  const size_t t = blockIdx.x;
  const int c = blockIdx.y * kCombineThreads + threadIdx.x;
  if (threadIdx.x < k) {
    s_slot[threadIdx.x] = slot[t * k + threadIdx.x];
    s_w[threadIdx.x] = round_to<T>(topw[t * k + threadIdx.x]);
  }
  __syncthreads();
  if (c >= d) return;
  float acc = 0.0f;
  for (int j0 = 0; j0 < k; j0 += kCombineLoads) {
    float v[kCombineLoads];
#pragma unroll
    for (int q = 0; q < kCombineLoads; ++q) {
      const int s = j0 + q < k ? s_slot[j0 + q] : -1;
      v[q] = s >= 0 ? to_f32(y[(size_t)s * d + c]) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kCombineLoads; ++q) {
      if (j0 + q >= k || s_slot[j0 + q] < 0) continue;
      const float p = round_to<T>(__fmul_rn(v[q], s_w[j0 + q]));
      acc = round_to<T>(__fadd_rn(acc, p));
    }
  }
  out[t * d + c] = from_f32<T>(acc);
}

template <typename T>
int launch_route(const void* logits, const int* q_lens, float* topw,
                 int* topi, int* slot, int* counts, int* offsets, int* rows,
                 int* per_group, int n_groups, int group, int n_exp, int k,
                 int cap, cudaStream_t s) {
  auto kernel = moe_route_kernel<T>;
  const int smem = kRouteThreads * n_exp * (int)sizeof(int);
  REPRO_SMEM_OPT_IN(kernel, kRouteThreads * kMaxExperts * (int)sizeof(int));
  kernel<<<n_groups, kRouteThreads, smem, s>>>(
      static_cast<const T*>(logits), q_lens, topw, topi, slot, counts,
      offsets, rows, per_group, group, n_exp, k, cap);
  return (int)cudaGetLastError();
}

}  // namespace repro

// logits (n_groups * group, n_exp) in x's dtype; q_lens (n_groups,) int32
// or null (every token live).  n_exp <= 64, k <= min(n_exp, 32) (the
// wrapper checks).  per_group: (n_groups, n_exp) int32 scratch.
extern "C" int moe_route_launch(const void* logits, const int* q_lens,
                                float* topw, int* topi, int* slot,
                                int* counts, int* offsets, int* rows,
                                int* per_group, int n_groups, int group,
                                int n_exp, int k, int cap, int dtype,
                                void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_exp > kMaxExperts || k > 32 || k > n_exp)
    return (int)cudaErrorInvalidValue;
  if (dtype == kBF16)
    return launch_route<__nv_bfloat16>(logits, q_lens, topw, topi, slot,
                                       counts, offsets, rows, per_group,
                                       n_groups, group, n_exp, k, cap, s);
  return launch_route<float>(logits, q_lens, topw, topi, slot, counts,
                             offsets, rows, per_group, n_groups, group,
                             n_exp, k, cap, s);
}

extern "C" int moe_combine_launch(const void* y, const int* slot,
                                  const float* topw, void* out, int n_tok,
                                  int k, int d, int dtype, void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k > 32) return (int)cudaErrorInvalidValue;
  const dim3 grid(n_tok, (d + kCombineThreads - 1) / kCombineThreads);
  if (dtype == kBF16)
    moe_combine_kernel<__nv_bfloat16><<<grid, kCombineThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(y), slot, topw,
        static_cast<__nv_bfloat16*>(out), k, d);
  else
    moe_combine_kernel<float><<<grid, kCombineThreads, 0, s>>>(
        static_cast<const float*>(y), slot, topw, static_cast<float*>(out),
        k, d);
  return (int)cudaGetLastError();
}
