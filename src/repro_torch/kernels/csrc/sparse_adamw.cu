// Sparse lazy AdamW for Hopper: update only the rows a batch touched.
//
// Not a TPU kernel: it replaces the gathers and drop-mode scatters that XLA
// fuses out of repro/optim/sparse.py (sparse_adamw_update). A table's
// parameters, first and second moments are (n_rows, d); a step hands over
// the batch's distinct row ids, padded with the out-of-range sentinel
// n_rows, and their gradient rows (slots, d) in float32. One launch updates,
// in place, each touched row:
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
// What bounds it: bytes, in 32-byte sectors. Each touched row costs one
// scattered sector each of p, m and v read and written (six sectors for
// d = 1, when no other touched row shares them); every slot its 8-byte id,
// and each live slot its 4 d bytes of gradient, read in order. At the
// paper-width DBN's 655,360 slots per table that is at most 131 MB, 0.039
// ms at 3.35 TB/s, per table.
//
// Design. One thread per (slot, column) element, slot-major, so a warp's
// gradient loads are consecutive and its ids come from one or two sectors;
// the gathers of p, m and v are independent and issued together. The bias
// corrections are computed once per thread.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libsparse_adamw.so sparse_adamw.cu
// (repro_torch/kernels/build.py). Plain C interface, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "adam_math.cuh"

namespace {

using adam::Hyper;

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

// One (slot, column) element: updates it (when store) and returns p'^2 -
// p^2 of its would-be step (0 for padding and where step is false).
template <typename M>
__device__ __forceinline__ double element(
    float* __restrict__ p, M* __restrict__ m, M* __restrict__ v,
    const long long* __restrict__ ids, const float* __restrict__ grads,
    long long i, long long slots, int d, long long n_rows, const Hyper& h,
    const int* __restrict__ count, bool step, bool store) {
  if (!step || i >= slots * d) return 0.0;
  const long long slot = i / d;
  const int col = static_cast<int>(i - slot * d);
  const long long row = ids[slot];
  if (row < 0 || row >= n_rows) return 0.0;  // sentinel padding: a no-op
  const long long at = row * d + col;
  const float g = grads[i];
  const float p0 = p[at];
  const float m0 = to_float(m[at]);
  const float v0 = to_float(v[at]);
  const adam::Step st = adam::step_constants(h, count);
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

template <typename M, bool kNorm>
__global__ void __launch_bounds__(256)
sparse_adamw_kernel(float* __restrict__ p, M* __restrict__ m,
                    M* __restrict__ v, const long long* __restrict__ ids,
                    const float* __restrict__ grads, long long slots, int d,
                    long long n_rows, Hyper h,
                    const int* __restrict__ count,
                    const unsigned char* __restrict__ pred,
                    const unsigned char* __restrict__ apply,
                    double* __restrict__ partials) {
  const bool write = pred == nullptr || *pred != 0;
  if (!kNorm && !write) return;  // a skipped or frozen step
  const bool step = !kNorm || apply == nullptr || *apply != 0;
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const double delta = element(p, m, v, ids, grads, i, slots, d, n_rows, h,
                               count, step, write && step);
  if (kNorm) {
    const double block = adam::block_sum(delta);
    if (threadIdx.x == 0) partials[blockIdx.x] = block;
  }
}

}  // namespace

extern "C" {

// Updates the touched rows of p, m and v ((n_rows, d), contiguous) in place
// on `stream` and returns cudaGetLastError() (0 on success). ids are slots
// int64 row ids, distinct apart from the sentinel; grads (slots, d) float32;
// m and v float32 (moment_dtype 0) or bfloat16 (1); count points to the
// int32 step count, already advanced; pred to the step's one-byte
// predicate, or null: when it holds 0 nothing is written. one_minus_b1 and
// one_minus_b2 are 1 - b rounded once from double, as the plain version's
// scalars. With partials (one double per block of 256 elements) the launch
// runs in norm mode (see the top of this file): count is then the would-be
// step's count and apply its one-byte predicate or null. Does not
// synchronise.
int sparse_adamw_step(void* p, void* m, void* v, const void* ids,
                      const void* grads, long long slots, int d,
                      long long n_rows, int moment_dtype, float b1, float b2,
                      float one_minus_b1, float one_minus_b2, float eps,
                      float weight_decay, float lr, const void* count,
                      const void* pred, const void* apply, void* partials,
                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Hyper h;
  h.b1 = b1;
  h.b2 = b2;
  h.one_minus_b1 = one_minus_b1;
  h.one_minus_b2 = one_minus_b2;
  h.eps = eps;
  h.weight_decay = weight_decay;
  h.lr = lr;
  const long long n = slots * d;
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  const long long* i = static_cast<const long long*>(ids);
  const float* g = static_cast<const float*>(grads);
  const int* c = static_cast<const int*>(count);
  const unsigned char* k = static_cast<const unsigned char*>(pred);
  const unsigned char* a = static_cast<const unsigned char*>(apply);
  double* out = static_cast<double*>(partials);
  float* pp = static_cast<float*>(p);
  if (moment_dtype == 0) {
    float* mp = static_cast<float*>(m);
    float* vp = static_cast<float*>(v);
    if (out == nullptr)
      sparse_adamw_kernel<float, false><<<blocks, 256, 0, s>>>(
          pp, mp, vp, i, g, slots, d, n_rows, h, c, k, a, out);
    else
      sparse_adamw_kernel<float, true><<<blocks, 256, 0, s>>>(
          pp, mp, vp, i, g, slots, d, n_rows, h, c, k, a, out);
  } else if (moment_dtype == 1) {
    __nv_bfloat16* mp = static_cast<__nv_bfloat16*>(m);
    __nv_bfloat16* vp = static_cast<__nv_bfloat16*>(v);
    if (out == nullptr)
      sparse_adamw_kernel<__nv_bfloat16, false><<<blocks, 256, 0, s>>>(
          pp, mp, vp, i, g, slots, d, n_rows, h, c, k, a, out);
    else
      sparse_adamw_kernel<__nv_bfloat16, true><<<blocks, 256, 0, s>>>(
          pp, mp, vp, i, g, slots, d, n_rows, h, c, k, a, out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* sparse_adamw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
