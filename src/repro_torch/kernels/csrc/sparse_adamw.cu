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

template <typename M>
__global__ void __launch_bounds__(256)
sparse_adamw_kernel(float* __restrict__ p, M* __restrict__ m,
                    M* __restrict__ v, const long long* __restrict__ ids,
                    const float* __restrict__ grads, long long slots, int d,
                    long long n_rows, Hyper h,
                    const int* __restrict__ count,
                    const unsigned char* __restrict__ pred) {
  if (pred != nullptr && *pred == 0) return;  // a skipped or frozen step
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= slots * d) return;
  const long long slot = i / d;
  const int col = static_cast<int>(i - slot * d);
  const long long row = ids[slot];
  if (row < 0 || row >= n_rows) return;  // sentinel padding: a true no-op
  const long long at = row * d + col;
  const float g = grads[i];
  const float p0 = p[at];
  const float m0 = to_float(m[at]);
  const float v0 = to_float(v[at]);
  const adam::Step st = adam::step_constants(h, count);
  const float m1 = adam::first_moment(m0, g, h);
  const float v1 = adam::second_moment(v0, g, h);
  // p - lr u, the sparse form's own order, from the unrounded moments
  p[at] = __fsub_rn(p0, __fmul_rn(h.lr, adam::update(p0, m1, v1, h, st)));
  m[at] = from_float<M>(m1);
  v[at] = from_float<M>(v1);
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
// scalars. Does not synchronise.
int sparse_adamw_step(void* p, void* m, void* v, const void* ids,
                      const void* grads, long long slots, int d,
                      long long n_rows, int moment_dtype, float b1, float b2,
                      float one_minus_b1, float one_minus_b2, float eps,
                      float weight_decay, float lr, const void* count,
                      const void* pred, void* stream) {
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
  if (moment_dtype == 0)
    sparse_adamw_kernel<float><<<blocks, 256, 0, s>>>(
        static_cast<float*>(p), static_cast<float*>(m),
        static_cast<float*>(v), i, g, slots, d, n_rows, h, c, k);
  else if (moment_dtype == 1)
    sparse_adamw_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        static_cast<float*>(p), static_cast<__nv_bfloat16*>(m),
        static_cast<__nv_bfloat16*>(v), i, g, slots, d, n_rows, h, c, k);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

const char* sparse_adamw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
