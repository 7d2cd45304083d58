// Sparse lazy AdamW for Hopper: update only the rows a batch touched.
//
// Not a TPU kernel: it replaces the gathers and drop-mode scatters that XLA
// fuses out of repro/optim/sparse.py (sparse_adamw_update). A table's
// parameters, first and second moments are (n_rows, d); a step hands over
// the batch's distinct row ids, padded with the out-of-range sentinel
// n_rows, and their gradients in float32: per slot (slots, d), or the
// table gradient itself (n_rows, d), read at each live slot's row. One
// launch updates, in place, each touched row:
//
//   m = b1 m + (1 - b1) g            (float32; stored as the moment type)
//   v = b2 v + (1 - b2) g^2
//   u = (m / c1) / (sqrt(v / c2) + eps)   with m, v as computed, unrounded
//   u = u + wd p                     (only when wd != 0)
//   p = p - lr u
//
// in the sparse form's own order (repro/optim/sparse.py:117-130), with the
// arithmetic of adam_math.cuh (shared with adamw.cu) and c1 = 1 - b1^count,
// c2 = 1 - b2^count from the device-resident step count, already advanced.
// With a predicate (pred != null: the non-finite guard's "this step is
// finite" and a sweep's "this replica still trains", one byte on the
// device) that holds 0, the launch writes nothing; the caller advances
// the count by the predicate.
// Norm mode (partials != null), for a sweep's telemetry: the launch also
// sums, in double, one partial per block, p'^2 - p^2 over the touched
// elements, where p' is what the step *would* write, whether or not it
// writes it; the caller adds the table's sum of squares from before the
// step. The would-be step runs where `apply` (the guard's "this step is
// finite", or null: always) holds, with the count the caller passes for it
// (the count plus apply), and is written only where `pred` (apply and "this
// replica still trains") holds too, as JAX's vmapped step takes its
// telemetry before the active mask.
// A slot whose id is the sentinel (or any id outside [0, n_rows)) is
// skipped: it reads and writes nothing past its id, so padding can never
// alias a real row. The ids are distinct, so no two threads write one row
// and there is no race.
//
// The live run. Every caller's live slots are one contiguous run: the
// dedupe's ascending ids, then the sentinel (one device), or sentinels on
// both sides of an ascending run (a row-sharded mesh, whose rows outside
// this rank's block map to the local sentinel). The caller hands that
// run's start and end as int64s on the device (the dedupe's [0, count) on
// one device, a search on a mesh; no host sync), and the launch walks
// those slots only; without them it walks every slot.
//
// What bounds it: bytes, in 32-byte sectors. Each touched row costs one
// scattered sector each of p, m and v read and written (six sectors for
// d = 1, when no other touched row shares them); every slot its 8-byte id,
// and each live slot its 4 d bytes of gradient, read in order (per-slot
// form) or its row's sector of the table gradient (table form). At the
// paper-width DBN's 655,360 slots per table that is at most 131 MB, 0.039
// ms at 3.35 TB/s, per table.
//
// Design. The run's elements (slot, column), slot-major, are cut into
// chunks of 32 x kPer; a warp takes a chunk, lane l its elements l, l + 32,
// ..., so each load instruction reads 32 consecutive ids or gradients. A
// lane issues its kPer id loads, then all their p, m, v and g loads, and
// only then does arithmetic: kPer independent gathers in flight a thread.
// The grid is sized to the card (kernels/sparse_adamw.py launch_plan: a
// few blocks an SM, fewer when every slot fits in fewer chunks) and chunks
// go round the blocks first (chunk c to block c mod blocks), so a short
// run spreads over every SM rather than filling the first few. The bias
// corrections are taken once a block, by one thread, into shared memory,
// while the block's first loads are in flight.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libsparse_adamw.so sparse_adamw.cu
// (repro_torch/kernels/build.py). Plain C interface, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "adam_math.cuh"

namespace {

using adam::Hyper;

constexpr int kThreads = 256;  // a block; kernels/sparse_adamw.py: THREADS
constexpr int kPer = 2;        // elements a lane takes at once: PER_LANE

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename M>
__device__ __forceinline__ M from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The step of one element from its loaded values: writes it when store and
// returns p'^2 - p^2 of its would-be step.
template <typename M>
__device__ __forceinline__ double update_element(
    float* __restrict__ p, M* __restrict__ m, M* __restrict__ v,
    long long at, float g, float p0, float m0, float v0, const Hyper& h,
    const adam::Step& st, bool store) {
  const float m1 = adam::first_moment(m0, g, h);
  const float v1 = adam::second_moment(v0, g, h);
  // p - lr u, the sparse form's own order, from the unrounded moments
  const float p1 = __fsub_rn(p0, __fmul_rn(h.lr, adam::update(p0, m1, v1, h,
                                                              st)));
  if (store) {
    p[at] = p1;
    m[at] = from_float<M>(m1);
    v[at] = from_float<M>(v1);
  }
  return static_cast<double>(p1) * p1 - static_cast<double>(p0) * p0;
}

template <typename M, bool kNorm, bool kTableGrad>
__global__ void __launch_bounds__(kThreads)
sparse_adamw_kernel(float* __restrict__ p, M* __restrict__ m,
                    M* __restrict__ v, const long long* __restrict__ ids,
                    const float* __restrict__ grads, long long slots, int d,
                    long long n_rows, Hyper h,
                    const int* __restrict__ count,
                    const long long* __restrict__ run_start,
                    const long long* __restrict__ run_end,
                    const unsigned char* __restrict__ pred,
                    const unsigned char* __restrict__ apply,
                    double* __restrict__ partials) {
  __shared__ adam::Step step_s;
  const bool write = pred == nullptr || *pred != 0;
  if (!kNorm && !write) return;  // a skipped or frozen step
  const bool step = !kNorm || apply == nullptr || *apply != 0;
  // thread 0 takes the bias corrections while every lane issues its first
  // loads: the block waits for them only before its first arithmetic
  if (threadIdx.x == 0) step_s = adam::step_constants(h, count);
  const long long lo =
      run_start == nullptr ? 0 : min(max(*run_start, 0LL), slots);
  const long long hi =
      run_end == nullptr ? slots : min(max(*run_end, lo), slots);
  const long long first = lo * d;
  const long long n = (hi - lo) * d;
  const int lane = threadIdx.x & 31;
  // chunks go round the blocks first: chunk c to block c mod gridDim.x
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  const long long warp =
      static_cast<long long>(threadIdx.x >> 5) * gridDim.x + blockIdx.x;
  adam::Step st;
  bool waited = false;
  double delta = 0.0;
  // every thread runs the first round (and its one __syncthreads)
  for (long long base = warp * 32 * kPer;; base += warps * 32 * kPer) {
    const bool active = step && base < n;
    long long elem[kPer], row[kPer];
    int col[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {  // every id load first
      const long long e = base + j * 32 + lane;
      elem[j] = first + e;
      const long long slot = elem[j] / d;
      col[j] = static_cast<int>(elem[j] - slot * d);
      row[j] = active && e < n ? ids[slot] : -1;
    }
    long long at[kPer];
    float g[kPer], p0[kPer], m0[kPer], v0[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {  // then every gather
      // a sentinel (or past the run): a no-op
      at[j] = row[j] >= 0 && row[j] < n_rows ? row[j] * d + col[j] : -1;
      if (at[j] >= 0) {
        g[j] = grads[kTableGrad ? at[j] : elem[j]];
        p0[j] = p[at[j]];
        m0[j] = to_float(m[at[j]]);
        v0[j] = to_float(v[at[j]]);
      }
    }
    if (!waited) {
      __syncthreads();
      st = step_s;
      waited = true;
    }
    if (!active) break;
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (at[j] >= 0)
        delta += update_element(p, m, v, at[j], g[j], p0[j], m0[j], v0[j], h,
                                st, write);
  }
  if (kNorm) {
    const double block = adam::block_sum(delta);
    if (threadIdx.x == 0) partials[blockIdx.x] = block;
  }
}

Hyper make_hyper(float b1, float b2, float one_minus_b1, float one_minus_b2,
                 float eps, float weight_decay, float lr) {
  Hyper h;
  h.b1 = b1;
  h.b2 = b2;
  h.one_minus_b1 = one_minus_b1;
  h.one_minus_b2 = one_minus_b2;
  h.eps = eps;
  h.weight_decay = weight_decay;
  h.lr = lr;
  return h;
}

template <typename M, bool kNorm>
void launch(float* p, M* m, M* v, const long long* ids, const float* g,
            long long slots, int d, long long n_rows, const Hyper& h,
            const int* count, const long long* run_start,
            const long long* run_end, bool table_grad,
            const unsigned char* pred, const unsigned char* apply,
            double* partials, unsigned blocks, cudaStream_t s) {
  if (table_grad)
    sparse_adamw_kernel<M, kNorm, true><<<blocks, kThreads, 0, s>>>(
        p, m, v, ids, g, slots, d, n_rows, h, count, run_start, run_end,
        pred, apply, partials);
  else
    sparse_adamw_kernel<M, kNorm, false><<<blocks, kThreads, 0, s>>>(
        p, m, v, ids, g, slots, d, n_rows, h, count, run_start, run_end,
        pred, apply, partials);
}

}  // namespace

extern "C" {

// Updates the touched rows of p, m and v ((n_rows, d), contiguous) in place
// on `stream` and returns cudaGetLastError() (0 on success). ids are slots
// int64 row ids, distinct apart from the sentinel, whose live slots lie in
// [*run_start, *run_end) (int64s on the device; a null start is slot 0, a
// null end the last slot); grads float32, (slots, d) per slot or, with
// table_grad, the (n_rows, d) table gradient; m and v float32
// (moment_dtype 0) or bfloat16 (1); count points to the int32 step count,
// already advanced; pred to the step's one-byte predicate, or null: when it
// holds 0 nothing is written.
// one_minus_b1 and one_minus_b2 are 1 - b rounded once from double, as the
// plain version's scalars. blocks is the grid (kernels/sparse_adamw.py
// launch_plan). With partials (one double per block) the launch runs in
// norm mode (see the top of this file): count is then the would-be step's
// count and apply its one-byte predicate or null. Does not synchronise.
int sparse_adamw_step(void* p, void* m, void* v, const void* ids,
                      const void* grads, long long slots, int d,
                      long long n_rows, int moment_dtype, float b1, float b2,
                      float one_minus_b1, float one_minus_b2, float eps,
                      float weight_decay, float lr, const void* count,
                      const void* run_start, const void* run_end,
                      int table_grad, const void* pred,
                      const void* apply, void* partials, unsigned blocks,
                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Hyper h = make_hyper(b1, b2, one_minus_b1, one_minus_b2, eps,
                             weight_decay, lr);
  const long long* i = static_cast<const long long*>(ids);
  const float* g = static_cast<const float*>(grads);
  const int* c = static_cast<const int*>(count);
  const long long* r0 = static_cast<const long long*>(run_start);
  const long long* r1 = static_cast<const long long*>(run_end);
  const unsigned char* k = static_cast<const unsigned char*>(pred);
  const unsigned char* a = static_cast<const unsigned char*>(apply);
  double* out = static_cast<double*>(partials);
  float* pp = static_cast<float*>(p);
  const bool tg = table_grad != 0;
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (moment_dtype == 0) {
    float* mp = static_cast<float*>(m);
    float* vp = static_cast<float*>(v);
    if (out == nullptr)
      launch<float, false>(pp, mp, vp, i, g, slots, d, n_rows, h, c, r0, r1,
                           tg, k, a, out, blocks, s);
    else
      launch<float, true>(pp, mp, vp, i, g, slots, d, n_rows, h, c, r0, r1,
                          tg, k, a, out, blocks, s);
  } else if (moment_dtype == 1) {
    __nv_bfloat16* mp = static_cast<__nv_bfloat16*>(m);
    __nv_bfloat16* vp = static_cast<__nv_bfloat16*>(v);
    if (out == nullptr)
      launch<__nv_bfloat16, false>(pp, mp, vp, i, g, slots, d, n_rows, h, c,
                                   r0, r1, tg, k, a, out, blocks, s);
    else
      launch<__nv_bfloat16, true>(pp, mp, vp, i, g, slots, d, n_rows, h, c,
                                  r0, r1, tg, k, a, out, blocks, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* sparse_adamw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
