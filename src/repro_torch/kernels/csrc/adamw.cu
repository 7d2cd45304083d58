// Dense AdamW in one pass, for Hopper.
//
// Not a TPU kernel: it replaces the loop that XLA fuses out of the JAX
// package's chain repro/optim/optimizers.py (scale_by_adam,
// add_decayed_weights, scale(-lr) or inject_lr, then apply_updates), which
// the port otherwise runs as some sixteen torch._foreach_* passes. One
// launch updates one parameter tensor in place:
//
//   m = b1 m + (1 - b1) g            (float32, then stored as the moment type)
//   v = b2 v + (1 - b2) g^2
//   u = (m / c1) / (sqrt(v / c2) + eps)   with m, v read back as stored
//   u = u + wd p                     (only when wd != 0, as add_decayed_weights)
//   p = p + u (-lr)
//
// with c1 = 1 - b1^count and c2 = 1 - b2^count in float32; the arithmetic
// is adam_math.cuh's, shared with sparse_adamw.cu, and only the last line is
// this form's own. The step count, already advanced for this step, is read
// from device memory, and so is the learning rate when it is injected
// (lr_ptr != null); nothing of the step lives on the host, so a captured
// step replays correctly. So is the step's predicate, when there is one
// (pred != null): the non-finite guard's "this step is finite" and a
// replica sweep's "this replica still trains", one byte on the device. A
// predicate of 0 makes the launch write nothing, as JAX's
// where(ok, new, old) keeps p, m and v; the caller advances the count by
// the predicate.
//
// Norm mode (partials != null), for a sweep's telemetry: the launch also
// sums the squares of the parameters the step *would* write, in double, one
// partial per block, whether or not it writes them. JAX's vmapped step takes
// its telemetry before the active mask is applied, so a frozen replica
// reports the norm of its would-be update. The would-be step runs where
// `apply` (the guard's "this step is finite", or null: always) holds, with
// the count the caller passes for it (the count plus apply); where it does
// not, the parameter counts as it stands. It is written only where `pred`
// (apply and "this replica still trains") holds too. A frozen replica then
// reads its tensors once and writes nothing.
//
// What bounds it: bytes. Per element it reads p, g, m and v and writes p, m
// and v, 28 bytes with float32 moments (20 with bfloat16), for about 15
// operations. At the paper-width DBN (2 x 214,748,672 table rows) that is
// 12.0 GB, 3.59 ms at 3.35 TB/s. Norm mode adds a double add per element
// and a block sum; a frozen replica's launch reads 16 bytes an element and
// writes nothing (6.9 GB, 2.05 ms, at the DBN).
//
// Design. A grid-stride loop over 4-element vectors: a thread loads its
// 16-byte p, g, m and v vectors (8-byte for bfloat16 moments) before any
// arithmetic, and the grid is sized by the wrapper to a few waves of
// resident blocks, so every SM keeps many loads in flight. The bias
// corrections are computed once per thread, not per element. The n % 4
// tail, and every element of a tensor whose pointers are not aligned for
// the vector loads, take the same arithmetic one element at a time. No
// temporary: the tensor is read once and written once.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libadamw.so adamw.cu
// (repro_torch/kernels/build.py). Plain C interface, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "adam_math.cuh"

namespace {

using adam::Hyper;
using adam::Step;

__device__ __forceinline__ float load_moment(const float* q, long long i) {
  return q[i];
}
__device__ __forceinline__ float load_moment(const __nv_bfloat16* q,
                                             long long i) {
  return __bfloat162float(q[i]);
}
__device__ __forceinline__ float store_moment(float* q, long long i,
                                              float x) {
  q[i] = x;
  return x;
}
// Stores the bfloat16 moment and returns it as stored: the update reads the
// moment back from its own type, as the JAX chain does.
__device__ __forceinline__ float store_moment(__nv_bfloat16* q, long long i,
                                              float x) {
  const __nv_bfloat16 r = __float2bfloat16_rn(x);
  q[i] = r;
  return __bfloat162float(r);
}

// The moment as store_moment would store it, without storing it (a step
// that is not written: the would-be parameter reads the rounded moment).
__device__ __forceinline__ float rounded_moment(const float*, float x) {
  return x;
}
__device__ __forceinline__ float rounded_moment(const __nv_bfloat16*,
                                                float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One element: returns the new parameter, p + u (-lr), the dense form's own
// order; m and v are the moments as stored (already rounded to their type).
__device__ __forceinline__ float adamw_element(float p, float m, float v,
                                               const Hyper& h, const Step& s,
                                               float neg_lr) {
  return __fadd_rn(p, __fmul_rn(adam::update(p, m, v, h, s), neg_lr));
}

// Four moments of type M as one load: float4 for float32, 8 bytes for
// bfloat16.
template <typename M>
struct Vec;
template <>
struct Vec<float> {
  using T = float4;
  __device__ static void split(const T& x, float out[4]) {
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  }
  __device__ static T join(const float in[4], float rounded[4]) {
    for (int q = 0; q < 4; ++q) rounded[q] = in[q];
    return make_float4(in[0], in[1], in[2], in[3]);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  using T = uint2;
  __device__ static void split(const T& x, float out[4]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
    const float2 a = __bfloat1622float2(h[0]);
    const float2 b = __bfloat1622float2(h[1]);
    out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
  }
  __device__ static T join(const float in[4], float rounded[4]) {
    T x;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
    h[0] = __floats2bfloat162_rn(in[0], in[1]);
    h[1] = __floats2bfloat162_rn(in[2], in[3]);
    const float2 a = __bfloat1622float2(h[0]);
    const float2 b = __bfloat1622float2(h[1]);
    rounded[0] = a.x; rounded[1] = a.y; rounded[2] = b.x; rounded[3] = b.y;
    return x;
  }
};

__device__ __forceinline__ double square(float x) {
  return static_cast<double>(x) * static_cast<double>(x);
}

template <typename M, bool kNorm>
__global__ void __launch_bounds__(256)
adamw_kernel(float* __restrict__ p, const float* __restrict__ g,
             M* __restrict__ m, M* __restrict__ v, long long n, int vector,
             Hyper h, const int* __restrict__ count,
             const float* __restrict__ lr_ptr,
             const unsigned char* __restrict__ pred,
             const unsigned char* __restrict__ apply,
             double* __restrict__ partials) {
  const bool write = pred == nullptr || *pred != 0;
  if (!kNorm && !write) return;  // a skipped or frozen step
  // kNorm: the would-be step runs where apply holds, and is stored only
  // where pred holds too.
  const bool step = !kNorm || apply == nullptr || *apply != 0;
  const bool store = write && step;
  const Step s = adam::step_constants(h, count);
  const float neg_lr = -(lr_ptr != nullptr ? *lr_ptr : h.lr);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long n_vec = vector ? n / 4 : 0;
  double sumsq = 0.0;
  using V = typename Vec<M>::T;
  for (long long j = first; j < n_vec; j += stride) {
    const float4 pv = reinterpret_cast<const float4*>(p)[j];
    float ps[4] = {pv.x, pv.y, pv.z, pv.w};
    if (step) {
      const float4 gv = reinterpret_cast<const float4*>(g)[j];
      const V mv = reinterpret_cast<const V*>(m)[j];
      const V vv = reinterpret_cast<const V*>(v)[j];
      const float gs[4] = {gv.x, gv.y, gv.z, gv.w};
      float ms[4], vs[4], mr[4], vr[4];
      Vec<M>::split(mv, ms);
      Vec<M>::split(vv, vs);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        ms[q] = adam::first_moment(ms[q], gs[q], h);
        vs[q] = adam::second_moment(vs[q], gs[q], h);
      }
      const V mo = Vec<M>::join(ms, mr);
      const V vo = Vec<M>::join(vs, vr);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        ps[q] = adamw_element(ps[q], mr[q], vr[q], h, s, neg_lr);
      if (store) {
        reinterpret_cast<V*>(m)[j] = mo;
        reinterpret_cast<V*>(v)[j] = vo;
        reinterpret_cast<float4*>(p)[j] =
            make_float4(ps[0], ps[1], ps[2], ps[3]);
      }
    }
    if (kNorm)
      sumsq += square(ps[0]) + square(ps[1]) + square(ps[2]) + square(ps[3]);
  }
  // The tail after the vectors, or the whole tensor when it is unaligned.
  for (long long i = n_vec * 4 + first; i < n; i += stride) {
    float pi = p[i];
    if (step) {
      const float gi = g[i];
      const float mi = adam::first_moment(load_moment(m, i), gi, h);
      const float vi = adam::second_moment(load_moment(v, i), gi, h);
      float mr = mi, vr = vi;
      if (store) {
        mr = store_moment(m, i, mi);
        vr = store_moment(v, i, vi);
      } else {
        mr = rounded_moment(m, mi);
        vr = rounded_moment(v, vi);
      }
      pi = adamw_element(pi, mr, vr, h, s, neg_lr);
      if (store) p[i] = pi;
    }
    if (kNorm) sumsq += square(pi);
  }
  if (kNorm) {
    const double block = adam::block_sum(sumsq);
    if (threadIdx.x == 0) partials[blockIdx.x] = block;
  }
}

}  // namespace

extern "C" {

// Updates p, m and v (n elements each, contiguous) in place on `stream` and
// returns cudaGetLastError() (0 on success). p and g are float32; m and v
// are float32 (moment_dtype 0) or bfloat16 (1). count points to the int32
// step count, already advanced for this step; lr_ptr to a float32 learning
// rate, or is null to use lr; pred to the step's one-byte predicate (a
// bool), or is null: when it holds 0 nothing is written. one_minus_b1 and
// one_minus_b2 are 1 - b taken in double and rounded once, as the plain
// chain's scalars are (not 1.f - b1, which differs in the last bit).
// vector != 0 promises 16-byte aligned p and g and 16-byte (float32) or
// 8-byte (bfloat16) aligned m and v. With partials (blocks doubles) the
// launch runs in norm mode (see the top of this file): count is then the
// would-be step's count, apply its one-byte predicate or null, and block b
// writes its sum of squares to partials[b]. Does not synchronise.
int adamw_step(void* p, const void* g, void* m, void* v, long long n,
               int moment_dtype, int vector, float b1, float b2,
               float one_minus_b1, float one_minus_b2, float eps,
               float weight_decay, float lr, const void* count,
               const void* lr_ptr, const void* pred, const void* apply,
               void* partials, int blocks, int threads, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Hyper h;
  h.b1 = b1;
  h.b2 = b2;
  h.eps = eps;
  h.weight_decay = weight_decay;
  h.lr = lr;
  h.one_minus_b1 = one_minus_b1;
  h.one_minus_b2 = one_minus_b2;
  const int* c = static_cast<const int*>(count);
  const float* l = static_cast<const float*>(lr_ptr);
  const unsigned char* k = static_cast<const unsigned char*>(pred);
  const unsigned char* a = static_cast<const unsigned char*>(apply);
  double* out = static_cast<double*>(partials);
  float* pp = static_cast<float*>(p);
  const float* gp = static_cast<const float*>(g);
  if (moment_dtype == 0) {
    float* mp = static_cast<float*>(m);
    float* vp = static_cast<float*>(v);
    if (out == nullptr)
      adamw_kernel<float, false><<<blocks, threads, 0, s>>>(
          pp, gp, mp, vp, n, vector, h, c, l, k, a, out);
    else
      adamw_kernel<float, true><<<blocks, threads, 0, s>>>(
          pp, gp, mp, vp, n, vector, h, c, l, k, a, out);
  } else if (moment_dtype == 1) {
    __nv_bfloat16* mp = static_cast<__nv_bfloat16*>(m);
    __nv_bfloat16* vp = static_cast<__nv_bfloat16*>(v);
    if (out == nullptr)
      adamw_kernel<__nv_bfloat16, false><<<blocks, threads, 0, s>>>(
          pp, gp, mp, vp, n, vector, h, c, l, k, a, out);
    else
      adamw_kernel<__nv_bfloat16, true><<<blocks, threads, 0, s>>>(
          pp, gp, mp, vp, n, vector, h, c, l, k, a, out);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* adamw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
