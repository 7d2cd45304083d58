// Fused session NLL (GCTR / RCTR / DCTR loss) for Hopper.
//
// Replaces the TPU kernel repro/kernels/session_nll.py
// (_session_nll_kernel / session_nll_pallas): the masked mean of
// softplus(x) - c x over a (B, K) batch of logits x, clicks c and a bool
// mask, in one launch that writes the scalar loss.
//
// What bounds it: bytes. Each element reads a float32 logit, a float32
// click and a mask byte (9 bytes) for ~18 operations, far below the card's
// operations-per-byte balance; at the main-path shape (65,536 x 10) the read
// is 5.9 MB, 1.76 us at 3.35 TB/s. That is about one launch's own cost, so
// the design is about two things: every byte requested at once, and no
// second launch.
//
// Design. The TPU version tiles (256, 128) blocks, one sequential grid step
// each, and sums its per-block partials outside the kernel. Here the batch
// is flattened and every thread takes V 4-element vectors (V = 1 and 512
// threads by default: 2,048 elements a block, 320 blocks at the main shape,
// all resident in one wave). Vector j of thread t of block b starts at
// element b * (V * 4 * T) + (j * T + t) * 4, so each load instruction of a
// warp reads 512 neighbouring bytes of x or c and 128 of the mask. A thread
// issues all its loads (16-byte x and c, 4-byte mask words) before any
// arithmetic, so the whole input is in flight at once; the loads are
// __ldcs (evict first: each byte is read once), measured level with
// __ldg. Where x or c is not
// 16-byte aligned or the mask not 4-byte aligned (a view with a storage
// offset), and for the vector that the ragged end cuts, the same elements
// are read one by one; the sums take the same order on both paths. Then
// softplus(x) - c x with expf and log1pf, the masked (sum, count) of the
// thread, a warp-shuffle block sum and the shared last-block finish
// (last_block.cuh): one launch, no float atomics, the same bits every call.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libsession_nll.so session_nll.cu
// (repro_torch/kernels/build.py). Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>

#include "last_block.cuh"

namespace {

constexpr int kMaxThreads = 1024;

// softplus(x) - c x = max(x, 0) + log1p(exp(-|x|)) - c x; the product is
// rounded on its own, as the plain version computes it.
__device__ __forceinline__ float session_nll(float x, float c) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x))) - __fmul_rn(c, x);
}

template <int kVectors>
__global__ void __launch_bounds__(kMaxThreads)
session_nll_kernel(const float* __restrict__ x_in,
                   const float* __restrict__ c_in,
                   const unsigned char* __restrict__ m_in,
                   float* __restrict__ partials,
                   unsigned int* __restrict__ ticket,
                   float* __restrict__ out, long long n, int vector) {
  const long long block_first =
      static_cast<long long>(blockIdx.x) * kVectors * 4 * blockDim.x;
  float4 x[kVectors];
  float4 c[kVectors];
  unsigned int m[kVectors];
  // Every load first: nothing below waits on one until all are issued.
#pragma unroll
  for (int j = 0; j < kVectors; ++j) {
    const long long first =
        block_first + 4ll * (j * static_cast<long long>(blockDim.x) +
                             threadIdx.x);
    if (vector && first + 4 <= n) {
      x[j] = __ldcs(reinterpret_cast<const float4*>(x_in + first));
      c[j] = __ldcs(reinterpret_cast<const float4*>(c_in + first));
      m[j] = __ldcs(reinterpret_cast<const unsigned int*>(m_in + first));
    } else {
      float xs[4], cs[4];
      unsigned int ms = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool live = first + q < n;
        xs[q] = live ? __ldcs(x_in + first + q) : 0.f;
        cs[q] = live ? __ldcs(c_in + first + q) : 0.f;
        ms |= static_cast<unsigned int>(live ? __ldcs(m_in + first + q) : 0)
              << (8 * q);
      }
      x[j] = make_float4(xs[0], xs[1], xs[2], xs[3]);
      c[j] = make_float4(cs[0], cs[1], cs[2], cs[3]);
      m[j] = ms;
    }
  }
  float sum = 0.f;
  float count = 0.f;
#pragma unroll
  for (int j = 0; j < kVectors; ++j) {
    const float xs[4] = {x[j].x, x[j].y, x[j].z, x[j].w};
    const float cs[4] = {c[j].x, c[j].y, c[j].z, c[j].w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float mq = ((m[j] >> (8 * q)) & 0xffu) ? 1.f : 0.f;
      sum += session_nll(xs[q], cs[q]) * mq;
      count += mq;
    }
  }
  last_block::finish_mean<kMaxThreads / 32>(sum, count, partials, ticket,
                                            out);
}

template <int kVectors>
int launch(const void* x, const void* clicks, const void* mask,
           void* partials, void* ticket, void* out, long long n,
           int threads, int vector, cudaStream_t stream) {
  const long long per_block = 4ll * kVectors * threads;
  const long long blocks = (n + per_block - 1) / per_block;
  session_nll_kernel<kVectors>
      <<<static_cast<unsigned int>(blocks), threads, 0, stream>>>(
          static_cast<const float*>(x), static_cast<const float*>(clicks),
          static_cast<const unsigned char*>(mask),
          static_cast<float*>(partials), static_cast<unsigned int*>(ticket),
          static_cast<float*>(out), n, vector);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` over n > 0 elements (a row-major (B, K)
// batch) with `threads` threads a block (a multiple of 32, at most 1024)
// and `vectors` (1, 2 or 4) 4-element vectors a thread, as launch_plan
// gives them; `vector` != 0 only when x and clicks are 16-byte aligned and
// mask 4-byte aligned.
// partials holds 2 * ceil(n / (4 * vectors * threads)) floats; ticket is
// the call's counter, 0 between launches; out is the float32 scalar loss.
// Returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// an unsupported `vectors`. Does not synchronise.
int session_nll_forward(const void* x, const void* clicks, const void* mask,
                        void* partials, void* ticket, void* out, long long n,
                        int threads, int vectors, int vector, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  switch (vectors) {
    case 1:
      return launch<1>(x, clicks, mask, partials, ticket, out, n, threads,
                       vector, s);
    case 2:
      return launch<2>(x, clicks, mask, partials, ticket, out, n, threads,
                       vector, s);
    case 4:
      return launch<4>(x, clicks, mask, partials, ticket, out, n, threads,
                       vector, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* session_nll_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
