// Fused embedding-bag gather + weighted reduce for Hopper.
//
// Replaces the TPU kernel repro/kernels/embedding_bag.py (_bag_kernel /
// embedding_bag_pallas): out[b, :] = sum_l w[b, l] * table[ids[b, l], :],
// ids < 0 are padding and contribute nothing, the result is float32.
//
// What bounds it: bytes, and of those mostly random row gathers. Each bag
// slot reads one id (int64, 8 bytes), one weight (4 bytes, none when the
// caller passes no weights) and one table row; a row of D floats touches
// ceil(4 D / 32) 32-byte sectors wherever it lies, so at DeepFM's
// first-order shape (B = 65,536 bags of L = 39 slots, D = 1) the table
// side is at most ~2.56M scattered sectors (~82 MB; Zipf-skewed ids touch
// fewer) next to 10 MB of ids at the 4 bytes the function needs (20 MB as
// the int64 read here): at most ~92 MB, ~28 us at 3.35 TB/s. Arithmetic
// is one multiply-add per gathered float.
//
// Design. The TPU kernel DMAs one (1, 128)-lane tile per (bag, slot) grid
// step, D padded to the lane width; at D = 1 that moves 128x the data. Here
// one thread owns one (bag, d) output element, d fastest, and walks the
// bag's L slots: D = 1 wastes no lane (one thread per bag), and for wide
// rows (D = 64, 128, 130) neighbouring threads read neighbouring floats of
// the same row, so each gather is coalesced. The slot loop is unrolled so
// several independent gathers are in flight per thread, which is what a
// latency-bound random gather needs. The bag's ids are the same address for
// all D threads of a bag (one broadcast load) and, at D = 1, neighbouring
// bags' ids share L1 lines across the slot loop. Nothing is padded and
// nothing is written but the (B, D) output, once.
//
// Ids are int64 (what the port's hash_ids and torch indexing produce); an
// id outside [0, rows) reads nothing, like padding. All offsets are 64-bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libembedding_bag.so embedding_bag.cu
// (repro_torch/kernels/build.py). Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const float* __restrict__ table,
                     const long long* __restrict__ ids,
                     const float* __restrict__ weights,
                     float* __restrict__ out, long long rows, int dim,
                     long long bags, int slots) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= bags * dim) return;
  const long long b = i / dim;
  const long long d = i - b * dim;
  const long long* bag_ids = ids + b * slots;
  const float* bag_w = weights == nullptr ? nullptr : weights + b * slots;
  float acc = 0.f;
#pragma unroll 8
  for (int l = 0; l < slots; ++l) {
    const long long id = __ldg(bag_ids + l);
    if (id >= 0 && id < rows) {
      const float w = bag_w == nullptr ? 1.f : __ldg(bag_w + l);
      acc = fmaf(w, __ldg(table + id * dim + d), acc);
    }
  }
  out[i] = acc;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). table (rows, dim), ids (bags, slots) int64, weights (bags,
// slots) float32 or null (all ones), out (bags, dim); all row-major and
// contiguous. Does not synchronise.
int embedding_bag_forward(const void* table, const void* ids,
                          const void* weights, void* out, long long rows,
                          int dim, long long bags, int slots, void* stream) {
  const long long n = bags * dim;
  const long long blocks = (n + kThreads - 1) / kThreads;
  embedding_bag_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const long long*>(ids),
      static_cast<const float*>(weights), static_cast<float*>(out), rows, dim,
      bags, slots);
  return static_cast<int>(cudaGetLastError());
}

const char* embedding_bag_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
