// Fused examination-chain NLL (DCM / CCM / DBN / SDBN loss) for Hopper.
//
// Replaces the TPU kernel repro/kernels/examination_nll.py
// (_examination_nll_kernel / examination_nll_pallas): per-position
// probability factors -> capped death-odds recurrence -> two-log
// conditional NLL -> masked (sum, count) per block.
//
// What bounds it: bytes. Each (B, K) position reads six float32 inputs and
// one bool mask (25 bytes) and does ~44 operations, far below the card's
// operations-per-byte balance; at the main-path shape (65,536 x 10) the
// read is 16.4 MB, 4.9 us at 3.35 TB/s, so a single launch is dominated by
// launch and tail latency.
//
// Design. The TPU version runs a Hillis-Steele scan over its 128-lane axis
// because the TPU computes in lanes. Here K is small (10 on the main path),
// so one thread owns one session row and runs the recurrence
// z_k = min(a_k z_{k-1} + b_k, ODDS_CAP) sequentially along K: no scan
// rounds, no shared memory for the scan, no padding. Ragged B is masked by
// the row bound and ragged K by the loop bound. Rows are contiguous, so the
// lanes of a warp together walk one contiguous span of 32*K elements per
// input and L1 serves the rest of each line. Only two floats per block
// leave the kernel: warp shuffles then shared memory reduce the block's
// masked NLL sum and mask count, written to (G,) partial arrays that the
// caller sums (no atomics, so the loss is the same from run to run).
//
// Numerics follow repro/core/recursions.py: ODDS_FLOOR on denominators,
// ODDS_CAP on the odds. A sequential solve never forms composite growth
// products, so GROWTH_CAP has nothing to bound here; on un-saturated rows
// it equals the capped tree combine up to rounding, and saturated rows stay
// at the cap in both.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libexamination_nll.so examination_nll.cu
// (repro_torch/kernels/build.py). Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kOddsCap = 1e9f;
constexpr float kOddsFloor = 1e-9f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
examination_nll_kernel(const float* __restrict__ x_in,
                       const float* __restrict__ c_in,
                       const unsigned char* __restrict__ m_in,
                       const float* __restrict__ pss_in,
                       const float* __restrict__ pd_in,
                       const float* __restrict__ pr_in,
                       const float* __restrict__ prn_in,
                       float* __restrict__ sums,
                       float* __restrict__ counts,
                       int rows, int cols) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  float nll_sum = 0.f;
  float mask_sum = 0.f;
  if (row < rows) {
    const long long base = static_cast<long long>(row) * cols;
    float z = 0.f;  // death odds entering position k (r_0 = 0)
#pragma unroll 4
    for (int k = 0; k < cols; ++k) {
      const long long i = base + k;
      const float x = x_in[i];
      const float c = c_in[i];
      const float m = m_in[i] ? 1.f : 0.f;
      const float clicked = c > 0.f ? 1.f : 0.f;
      const float a = (1.f - clicked) / fmaxf(pss_in[i], kOddsFloor);
      const float reset_odds = prn_in[i] / fmaxf(pr_in[i], kOddsFloor);
      const float b = fminf(a * pd_in[i] + clicked * reset_odds, kOddsCap);
      const float r = z;
      z = fminf(a * z + b, kOddsCap);

      // Two-log NLL (repro/kernels/examination_nll.py:82-87):
      //   log P(C=1) = min(x,0) - log1p(r + e + r e)
      //   log P(C=0) = log(s + r (1 + e)) - log1p(r + e + r e)
      const float e = expf(-fabsf(x));
      const float denom = log1pf(r + e + r * e);
      const float log_p = fminf(x, 0.f) - denom;
      const float s = x >= 0.f ? e : 1.f;
      const float log_1mp = logf(s + r * (1.f + e)) - denom;
      const float nll = -(c * log_p + (1.f - c) * log_1mp);
      nll_sum += nll * m;
      mask_sum += m;
    }
  }

  __shared__ float s_nll[kWarps];
  __shared__ float s_cnt[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  nll_sum = warp_sum(nll_sum);
  mask_sum = warp_sum(mask_sum);
  if (lane == 0) {
    s_nll[warp] = nll_sum;
    s_cnt[warp] = mask_sum;
  }
  __syncthreads();
  if (warp == 0) {
    nll_sum = lane < kWarps ? s_nll[lane] : 0.f;
    mask_sum = lane < kWarps ? s_cnt[lane] : 0.f;
    nll_sum = warp_sum(nll_sum);
    mask_sum = warp_sum(mask_sum);
    if (lane == 0) {
      sums[blockIdx.x] = nll_sum;
      counts[blockIdx.x] = mask_sum;
    }
  }
}

}  // namespace

extern "C" {

// Number of partial (sum, count) pairs a launch over `rows` rows writes.
int examination_nll_num_blocks(int rows) {
  return (rows + kThreads - 1) / kThreads;
}

// Launches the kernel on `stream` over a row-major (rows, cols) batch and
// returns cudaGetLastError() (0 on success). Does not synchronise.
int examination_nll_forward(const void* x, const void* clicks,
                            const void* mask, const void* p_skip_survive,
                            const void* p_death, const void* p_reset,
                            const void* p_reset_not, void* sums, void* counts,
                            int rows, int cols, void* stream) {
  const int blocks = examination_nll_num_blocks(rows);
  examination_nll_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(clicks),
      static_cast<const unsigned char*>(mask),
      static_cast<const float*>(p_skip_survive),
      static_cast<const float*>(p_death), static_cast<const float*>(p_reset),
      static_cast<const float*>(p_reset_not), static_cast<float*>(sums),
      static_cast<float*>(counts), rows, cols);
  return static_cast<int>(cudaGetLastError());
}

const char* examination_nll_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
