// The Adam arithmetic that adamw.cu and sparse_adamw.cu share, and their
// norm mode's block sum.
//
// Both forms compute, per element,
//
//   m = b1 m + (1 - b1) g
//   v = b2 v + (1 - b2) g^2
//   u = (m / c1) / (sqrt(v / c2) + eps)
//   u = u + wd p                     (only when wd != 0)
//
// with c1 = 1 - b1^count and c2 = 1 - b2^count in float32, and differ only
// in their last line (dense p + u (-lr), sparse p - lr u) and in which
// moments the quotient reads (dense: as stored; sparse: unrounded). Every
// product, sum, quotient and root is its round-to-nearest intrinsic, so nvcc
// contracts nothing into an FMA and the bits are those of the plain forms'
// separately rounded operations. b^count is taken in double and rounded once
// to float32: the correctly rounded value, which the plain forms' powf also
// gives in all but rare cases.
#pragma once

#include <cuda_runtime.h>

namespace adam {

// one_minus_b1 and one_minus_b2 are 1 - b taken in double and rounded once
// on the host, as the plain forms' Python scalars are (not 1.f - b1, which
// differs in the last bit).
struct Hyper {
  float b1, b2, one_minus_b1, one_minus_b2, eps, weight_decay, lr;
};

// The bias corrections, from the step count already advanced for this step
// (device memory, so a captured step replays correctly).
struct Step {
  float c1, c2;
};

__device__ __forceinline__ Step step_constants(const Hyper& h,
                                               const int* count) {
  const double k = static_cast<double>(*count);
  Step s;
  s.c1 = __fsub_rn(1.f, static_cast<float>(pow(static_cast<double>(h.b1), k)));
  s.c2 = __fsub_rn(1.f, static_cast<float>(pow(static_cast<double>(h.b2), k)));
  return s;
}

__device__ __forceinline__ float first_moment(float m, float g,
                                              const Hyper& h) {
  return __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.one_minus_b1, g));
}

__device__ __forceinline__ float second_moment(float v, float g,
                                               const Hyper& h) {
  return __fadd_rn(__fmul_rn(h.b2, v),
                   __fmul_rn(__fmul_rn(g, g), h.one_minus_b2));
}

// The decayed update u of parameter p from the moments m and v.
__device__ __forceinline__ float update(float p, float m, float v,
                                        const Hyper& h, const Step& s) {
  float u = __fdiv_rn(__fdiv_rn(m, s.c1),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.c2)), h.eps));
  if (h.weight_decay != 0.f) u = __fadd_rn(u, __fmul_rn(h.weight_decay, p));
  return u;
}

// The norm mode's block sum of a double (a sweep's telemetry), valid in
// thread 0; blockDim a multiple of 32, at most 256. A fixed order, so a
// launch gives the same bits each time.
__device__ __forceinline__ double block_sum(double x) {
  __shared__ double warps[8];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = x;
  __syncthreads();
  x = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) x += warps[w];
  return x;
}

}  // namespace adam
