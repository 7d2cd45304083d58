// Fused examination-chain NLL (DCM / CCM / DBN / SDBN loss) for Hopper.
//
// Replaces the TPU kernel repro/kernels/examination_nll.py
// (_examination_nll_kernel / examination_nll_pallas): per-position
// probability factors -> capped death-odds recurrence -> two-log
// conditional NLL -> masked mean, all in one launch that writes the scalar
// loss.
//
// What bounds it: bytes. Each (B, K) position reads six float32 inputs and
// one bool mask (25 bytes) and does ~44 operations, far below the card's
// operations-per-byte balance; at the main-path shape (65,536 x 10) the
// read is 16.4 MB, 4.9 us at 3.35 TB/s. So the design is about getting
// those bytes in flight at once and paying one launch, not five.
//
// Design. The TPU version runs a Hillis-Steele scan over its 128-lane axis
// because the TPU computes in lanes. Here K is small (10 on the main path),
// so one thread owns one session row and runs the recurrence
// z_k = min(a_k z_{k-1} + b_k, ODDS_CAP) sequentially along K: no scan
// rounds, no padding. A block owns R consecutive rows (R from the wrapper's
// launch_plan, 128 at K = 10, fewer for long K), whose span of each input
// is one contiguous run of R*K elements; its threads stage the seven spans
// into shared memory with cp.async, 16 bytes at a time where the span is
// 16-byte aligned (every block at K = 10), so a block's whole 32 KB is in
// flight at once and every load is coalesced. Only the recurrence itself
// is sequential, and it is two operations a position: the divisions before
// it and the transcendentals after it are per element, so all of the
// block's threads (up to 512, two or three elements each) compute them in
// shared memory, and one thread per row runs the recurrence between them.
// The block's masked NLL sum and mask count go to
// a (2, G) partial array. The last block to finish, found with
// __threadfence() and an atomic ticket on a per-device counter that it
// resets to 0, sums the partials in a fixed order and writes
// sum / max(count, 1). No float atomics, so the loss has the same bits
// from call to call and under CUDA-graph replay; two calls on one device
// must not run concurrently on two streams (they share the counter).
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

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kFloatInputs = 6;
constexpr float kOddsCap = 1e9f;
constexpr float kOddsFloor = 1e-9f;

__device__ __forceinline__ unsigned shared_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   shared_address(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   shared_address(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// All threads of the block: start copying the nbytes at src to dst (16-byte
// aligned shared memory) in 16-byte pieces while src is 16-byte aligned,
// else in 4-byte pieces while it is 4-byte aligned, and the last bytes one
// by one. The caller waits (cp_async_wait_all, then __syncthreads).
__device__ __forceinline__ void stage(unsigned char* dst,
                                      const unsigned char* src, int nbytes) {
  const auto addr = reinterpret_cast<unsigned long long>(src);
  int done = 0;
  if ((addr & 15) == 0) {
    const int vecs = nbytes >> 4;
    for (int i = threadIdx.x; i < vecs; i += blockDim.x) {
      cp_async16(dst + 16 * i, src + 16 * i);
    }
    done = vecs << 4;
  }
  if (((addr + done) & 3) == 0) {
    const int words = (nbytes - done) >> 2;
    for (int i = threadIdx.x; i < words; i += blockDim.x) {
      cp_async4(dst + done + 4 * i, src + done + 4 * i);
    }
    done += words << 2;
  }
  for (int i = done + threadIdx.x; i < nbytes; i += blockDim.x) {
    dst[i] = __ldg(src + i);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// The block's sums of a and b, valid in thread 0; the same order for the
// same blockDim, whatever the data.
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

__global__ void __launch_bounds__(kMaxThreads)
examination_nll_kernel(const float* __restrict__ x_in,
                       const float* __restrict__ c_in,
                       const unsigned char* __restrict__ m_in,
                       const float* __restrict__ pss_in,
                       const float* __restrict__ pd_in,
                       const float* __restrict__ pr_in,
                       const float* __restrict__ prn_in,
                       float* __restrict__ partials,
                       unsigned int* __restrict__ ticket,
                       float* __restrict__ out, int rows, int cols,
                       int rows_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_a[kMaxWarps];
  __shared__ float s_b[kMaxWarps];
  __shared__ bool s_last;

  const int row0 = blockIdx.x * rows_per_block;
  const int here = min(rows_per_block, rows - row0);
  const int n = here * cols;
  const long long first = static_cast<long long>(row0) * cols;
  // Six float regions of R*K floats, each rounded to 16 bytes, then the
  // mask's R*K bytes: the layout launch_plan sizes.
  const int region = ((rows_per_block * cols * 4 + 15) >> 4) << 4;
  const float* inputs[kFloatInputs] = {x_in, c_in, pss_in,
                                       pd_in, pr_in, prn_in};
#pragma unroll
  for (int j = 0; j < kFloatInputs; ++j) {
    stage(smem + j * region,
          reinterpret_cast<const unsigned char*>(inputs[j] + first), n * 4);
  }
  const unsigned char* s_m = smem + kFloatInputs * region;
  stage(smem + kFloatInputs * region, m_in + first, n);
  cp_async_wait_all();
  __syncthreads();

  const float* s_x = reinterpret_cast<const float*>(smem);
  const float* s_c = reinterpret_cast<const float*>(smem + region);
  // The recurrence's a_k and b_k replace p_skip_survive and p_death, then
  // the odds entering each position replace a_k.
  float* s_pss = reinterpret_cast<float*>(smem + 2 * region);
  float* s_pd = reinterpret_cast<float*>(smem + 3 * region);
  const float* s_pr = reinterpret_cast<const float*>(smem + 4 * region);
  const float* s_prn = reinterpret_cast<const float*>(smem + 5 * region);

  // Every element of the block: the affine step z -> a z + b.
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float clicked = s_c[i] > 0.f ? 1.f : 0.f;
    const float a = (1.f - clicked) / fmaxf(s_pss[i], kOddsFloor);
    const float reset_odds = s_prn[i] / fmaxf(s_pr[i], kOddsFloor);
    s_pss[i] = a;
    s_pd[i] = fminf(a * s_pd[i] + clicked * reset_odds, kOddsCap);
  }
  __syncthreads();
  // One thread per row: z_k = min(a_k z_{k-1} + b_k, ODDS_CAP), sequential
  // along K; r_k = z_{k-1} is kept.
  if (static_cast<int>(threadIdx.x) < here) {
    float z = 0.f;  // death odds entering position k (r_0 = 0)
    for (int i = threadIdx.x * cols; i < (threadIdx.x + 1) * cols; ++i) {
      const float r = z;
      z = fminf(s_pss[i] * z + s_pd[i], kOddsCap);
      s_pss[i] = r;
    }
  }
  __syncthreads();
  // Every element: the two-log NLL (repro/kernels/examination_nll.py:82-87)
  //   log P(C=1) = min(x,0) - log1p(r + e + r e)
  //   log P(C=0) = log(s + r (1 + e)) - log1p(r + e + r e)
  float nll_sum = 0.f;
  float mask_sum = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float x = s_x[i];
    const float c = s_c[i];
    const float m = s_m[i] ? 1.f : 0.f;
    const float r = s_pss[i];
    const float e = expf(-fabsf(x));
    const float denom = log1pf(r + e + r * e);
    const float log_p = fminf(x, 0.f) - denom;
    const float s = x >= 0.f ? e : 1.f;
    const float log_1mp = logf(s + r * (1.f + e)) - denom;
    const float nll = -(c * log_p + (1.f - c) * log_1mp);
    nll_sum += nll * m;
    mask_sum += m;
  }

  const float2 block = block_sum(nll_sum, mask_sum, s_a, s_b);
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
  float sum = 0.f;
  float count = 0.f;
  for (int i = threadIdx.x; i < static_cast<int>(gridDim.x);
       i += blockDim.x) {
    sum += __ldcg(partials + i);
    count += __ldcg(partials + gridDim.x + i);
  }
  __syncthreads();  // s_a, s_b are reused
  const float2 total = block_sum(sum, count, s_a, s_b);
  if (threadIdx.x == 0) {
    *out = total.x / fmaxf(total.y, 1.f);
    atomicExch(ticket, 0u);  // ready for the next launch on this device
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` over a row-major (rows, cols) batch with
// `rows_per_block` rows per block, `threads` threads (a multiple of 32,
// >= rows_per_block, <= 512) and `smem_bytes` of dynamic shared memory,
// as launch_plan gives them. partials holds 2 * ceil(rows /
// rows_per_block) floats; ticket is this device's counter, 0 between
// launches; out is the float32 scalar loss. Returns cudaGetLastError()
// (0 on success). Does not synchronise.
int examination_nll_forward(const void* x, const void* clicks,
                            const void* mask, const void* p_skip_survive,
                            const void* p_death, const void* p_reset,
                            const void* p_reset_not, void* partials,
                            void* ticket, void* out, int rows, int cols,
                            int rows_per_block, int threads, int smem_bytes,
                            void* stream) {
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        examination_nll_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  examination_nll_kernel<<<blocks, threads, smem_bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(clicks),
      static_cast<const unsigned char*>(mask),
      static_cast<const float*>(p_skip_survive),
      static_cast<const float*>(p_death), static_cast<const float*>(p_reset),
      static_cast<const float*>(p_reset_not), static_cast<float*>(partials),
      static_cast<unsigned int*>(ticket), static_cast<float*>(out), rows,
      cols, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

const char* examination_nll_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
