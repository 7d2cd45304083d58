// The fixed-order finish of the port's one-launch loss kernels
// (examination_nll.cu, session_nll.cu).
//
// Each block reduces its threads' (sum, count) parts to one pair and writes
// it to a (2, G) partial array. The last block to finish, found with
// __threadfence() and an atomic ticket on a counter, sums the G pairs in a
// fixed order, writes sum / max(count, 1) and resets the counter to 0. No
// float atomics, so a call gives the same bits every time, also under
// CUDA-graph replay, and nothing has to run before or after the launch.
//
// The counter belongs to the call's stream, or to the captured call
// (repro_torch/kernels/last_block.py): calls that may run at the same time
// never share one, since a block of one call would take tickets of the
// other's and could finish its mean before every partial is written.

#pragma once

#include <cuda_runtime.h>

namespace last_block {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// The block's sums of a and b, valid in thread 0; the same order for the
// same blockDim, whatever the data. s_a and s_b hold a float per warp.
__device__ __forceinline__ float2 block_sum(float a, float b, float* s_a,
                                           float* s_b) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    s_a[warp] = a;
    s_b[warp] = b;
  }
  __syncthreads();
  const int warps = blockDim.x >> 5;
  if (warp == 0) {
    a = lane < warps ? s_a[lane] : 0.f;
    b = lane < warps ? s_b[lane] : 0.f;
    a = warp_sum(a);
    b = warp_sum(b);
  }
  return make_float2(a, b);
}

// Called by every thread of every block (blockDim a multiple of 32, at most
// 32 * kMaxWarps) with its part of the masked sum and of the count.
// partials holds 2 * gridDim.x floats; *ticket is 0 before the launch and
// is 0 again after it; *out receives the mean.
template <int kMaxWarps>
__device__ __forceinline__ void finish_mean(float sum, float count,
                                            float* __restrict__ partials,
                                            unsigned int* __restrict__ ticket,
                                            float* __restrict__ out) {
  __shared__ float s_a[kMaxWarps];
  __shared__ float s_b[kMaxWarps];
  __shared__ bool s_last;

  const float2 block = block_sum(sum, count, s_a, s_b);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = block.x;
    partials[gridDim.x + blockIdx.x] = block.y;
    __threadfence();  // the partials are visible before the ticket moves
    s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;

  // The last block: every other block's partials are visible. Each thread
  // sums a fixed stride of them, then the fixed block tree: the order does
  // not depend on which block came last.
  __threadfence();
  float total_sum = 0.f;
  float total_count = 0.f;
  for (int i = threadIdx.x; i < static_cast<int>(gridDim.x);
       i += blockDim.x) {
    total_sum += __ldcg(partials + i);
    total_count += __ldcg(partials + gridDim.x + i);
  }
  __syncthreads();  // s_a, s_b are reused
  const float2 total = block_sum(total_sum, total_count, s_a, s_b);
  if (threadIdx.x == 0) {
    *out = total.x / fmaxf(total.y, 1.f);
    atomicExch(ticket, 0u);  // ready for the counter's next launch
  }
}

}  // namespace last_block
