// Fused embedding-bag gather + weighted reduce for Hopper.
//
// Replaces the TPU kernel repro/kernels/embedding_bag.py (_bag_kernel /
// embedding_bag_pallas): out[b, :] = sum_l w[b, l] * table[ids[b, l], :],
// ids < 0 are padding and contribute nothing, an id >= rows reads the last
// row (as bag_lookup's clip does), the result is float32.
//
// What bounds it: bytes, and of those mostly random row gathers. Each bag
// slot reads one id (4 or 8 bytes, the width the caller hands over), one
// weight (4 bytes, none when the caller passes no weights) and one table
// row; a row of D floats touches ceil(4 D / 32) 32-byte sectors wherever it
// lies, so at DeepFM's first-order shape (B = 65,536 bags of L = 39 slots,
// D = 1) the table side is at most ~2.56M scattered sectors (Zipf-skewed
// ids touch ~0.79M, 25 MB) next to 10 MB of int32 ids (20 MB as int64).
// Arithmetic is one multiply-add per gathered float. What a random gather
// needs is many independent loads in flight on every SM.
//
// Design. The TPU kernel DMAs one (1, 128)-lane tile per (bag, slot) grid
// step, D padded to the lane width; at D = 1 that moves 128x the data. Two
// variants here, picked by the wrapper's launch_plan:
//
// * slots (D <= 16). A block owns a tile of T whole bags, so its T*L ids
//   (and weights) are one contiguous span: its threads stage the span into
//   shared memory with cp.async, 16 bytes at a time. Then every (slot, bag,
//   d) of the tile is one unit, d fastest and slot-major, so a warp's lanes
//   read one field of neighbouring bags and a skewed field's repeated ids
//   share sectors; each thread takes the units tid, tid + threads, ... and
//   issues up to kUnroll (16) of its gathers before it uses any of them, so
//   a thread has 8-16 independent loads in flight where one thread per bag
//   had one id load and one gather per round trip. What is left holding it
//   is the rate at which the SMs take scattered 4-byte loads, one sector
//   each: ids that all fall in L2 take 2/3 of the Zipf time (PERF.md).
//   The gathered floats go to shared memory, and one thread
//   per (bag, d) then sums its bag in slot order l = 0 .. L-1 (the order
//   and the fma of the wide variant) and writes the tile's T*D outputs,
//   contiguous. launch_plan picks T for >= 8 gathers per thread within
//   48 KB of shared memory, so several blocks share an SM.
// * wide (D > 16). One thread per (bag, d) output element, d fastest,
//   walks the bag's L slots: neighbouring threads read neighbouring floats
//   of the same row, so each gather is coalesced; the slot loop is
//   unrolled so several gathers are in flight per thread.
//
// Both take int32 or int64 ids (a template on the id type) and clamp an id
// >= rows to rows - 1 in the gather, so bag_lookup needs no pass over the
// ids. Nothing is padded and nothing is written but the (B, D) output,
// once; no atomics, so the result is the same from run to run. Offsets into
// the table, ids and output are 64-bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libembedding_bag.so embedding_bag.cu
// (repro_torch/kernels/build.py). Plain C interface, loaded with ctypes.

#include <cuda_runtime.h>

namespace {

constexpr int kWideThreads = 256;
constexpr int kSlotsThreads = 256;
constexpr int kUnroll = 16;

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

// All threads of the block: start copying the nbytes (a multiple of 4) at
// src to dst (16-byte aligned shared memory), in 16-byte pieces while src is
// 16-byte aligned, then in 4-byte pieces. The caller waits
// (cp_async_wait_all, then __syncthreads).
__device__ __forceinline__ void stage(unsigned char* dst,
                                      const unsigned char* src, int nbytes) {
  int done = 0;
  if ((reinterpret_cast<unsigned long long>(src) & 15) == 0) {
    const int vecs = nbytes >> 4;
    for (int i = threadIdx.x; i < vecs; i += kSlotsThreads) {
      cp_async16(dst + 16 * i, src + 16 * i);
    }
    done = vecs << 4;
  }
  const int words = (nbytes - done) >> 2;
  for (int i = threadIdx.x; i < words; i += kSlotsThreads) {
    cp_async4(dst + done + 4 * i, src + done + 4 * i);
  }
}

__host__ __device__ constexpr int round16(int bytes) {
  return (bytes + 15) & ~15;
}

// kDim > 0 fixes D at compile time (1, DeepFM's first-order table); 0 reads
// it from `dim`.
template <typename Id, int kDim>
__global__ void __launch_bounds__(kSlotsThreads)
embedding_bag_slots_kernel(const float* __restrict__ table,
                           const Id* __restrict__ ids,
                           const float* __restrict__ weights,
                           float* __restrict__ out, long long rows,
                           int dim_arg, long long bags, int slots,
                           int tile_bags) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dim = kDim > 0 ? kDim : dim_arg;
  const long long b0 = static_cast<long long>(blockIdx.x) * tile_bags;
  const int nb = static_cast<int>(min(static_cast<long long>(tile_bags),
                                      bags - b0));
  const int items = nb * slots;
  const long long first = b0 * slots;

  // Layout (launch_plan sizes it): ids, then weights if any, then the
  // gathered floats, each region starting on 16 bytes.
  Id* s_ids = reinterpret_cast<Id*>(smem);
  const int id_region =
      round16(tile_bags * slots * static_cast<int>(sizeof(Id)));
  float* s_w = reinterpret_cast<float*>(smem + id_region);
  const int w_region =
      weights == nullptr ? 0 : round16(tile_bags * slots * 4);
  float* s_g = reinterpret_cast<float*>(smem + id_region + w_region);

  stage(reinterpret_cast<unsigned char*>(s_ids),
        reinterpret_cast<const unsigned char*>(ids + first),
        items * static_cast<int>(sizeof(Id)));
  if (weights != nullptr) {
    stage(reinterpret_cast<unsigned char*>(s_w),
          reinterpret_cast<const unsigned char*>(weights + first),
          items * static_cast<int>(sizeof(float)));
  }
  cp_async_wait_all();
  __syncthreads();

  // Gather: all of a round's loads are issued before any is stored. Units
  // run slot-major, u = (l nb + b) D + d: a warp's lanes read one field of
  // neighbouring bags.
  const int units = items * dim;
  for (int start = threadIdx.x; start < units;
       start += kUnroll * kSlotsThreads) {
    float v[kUnroll];
    int at[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int u = start + j * kSlotsThreads;
      v[j] = 0.f;
      at[j] = -1;
      if (u < units) {
        const int q = kDim == 1 ? u : u / dim;
        const int d = u - q * dim;
        const int l = q / nb;
        const int item = (q - l * nb) * slots + l;
        at[j] = item * dim + d;
        const long long id = static_cast<long long>(s_ids[item]);
        if (id >= 0) {
          const long long row = id < rows ? id : rows - 1;
          v[j] = __ldg(table + row * dim + d);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (at[j] >= 0) s_g[at[j]] = v[j];
    }
  }
  __syncthreads();

  // Reduce: one thread per (bag, d), slots in order.
  for (int o = threadIdx.x; o < nb * dim; o += kSlotsThreads) {
    const int b = kDim == 1 ? o : o / dim;
    const int d = o - b * dim;
    const float* g = s_g + b * slots * dim + d;
    float acc = 0.f;
    if (weights == nullptr) {
      for (int l = 0; l < slots; ++l) acc += g[l * dim];  // padding gave 0
    } else {
      const Id* bag_ids = s_ids + b * slots;
      const float* bag_w = s_w + b * slots;
      for (int l = 0; l < slots; ++l) {
        if (bag_ids[l] >= 0) acc = fmaf(bag_w[l], g[l * dim], acc);
      }
    }
    out[b0 * dim + o] = acc;
  }
}

template <typename Id>
__global__ void __launch_bounds__(kWideThreads)
embedding_bag_wide_kernel(const float* __restrict__ table,
                          const Id* __restrict__ ids,
                          const float* __restrict__ weights,
                          float* __restrict__ out, long long rows, int dim,
                          long long bags, int slots) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kWideThreads + threadIdx.x;
  if (i >= bags * dim) return;
  const long long b = i / dim;
  const long long d = i - b * dim;
  const Id* bag_ids = ids + b * slots;
  const float* bag_w = weights == nullptr ? nullptr : weights + b * slots;
  float acc = 0.f;
#pragma unroll 8
  for (int l = 0; l < slots; ++l) {
    const long long id = static_cast<long long>(__ldg(bag_ids + l));
    if (id >= 0) {
      const long long row = id < rows ? id : rows - 1;
      const float w = bag_w == nullptr ? 1.f : __ldg(bag_w + l);
      acc = fmaf(w, __ldg(table + row * dim + d), acc);
    }
  }
  out[i] = acc;
}

template <typename Id>
cudaError_t launch(const float* table, const Id* ids, const float* weights,
                   float* out, long long rows, int dim, long long bags,
                   int slots, int tile_bags, int smem_bytes,
                   cudaStream_t stream) {
  if (tile_bags == 0) {
    const long long blocks = (bags * dim + kWideThreads - 1) / kWideThreads;
    embedding_bag_wide_kernel<Id>
        <<<static_cast<unsigned>(blocks), kWideThreads, 0, stream>>>(
            table, ids, weights, out, rows, dim, bags, slots);
    return cudaGetLastError();
  }
  auto kernel = dim == 1 ? embedding_bag_slots_kernel<Id, 1>
                         : embedding_bag_slots_kernel<Id, 0>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (bags + tile_bags - 1) / tile_bags;
  kernel<<<static_cast<unsigned>(blocks), kSlotsThreads, smem_bytes,
           stream>>>(table, ids, weights, out, rows, dim, bags, slots,
                     tile_bags);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// table (rows >= 1, dim), ids (bags, slots) of id_bytes (4: int32, 8:
// int64), weights (bags, slots) float32 or null (all ones), out (bags,
// dim); all row-major and contiguous. tile_bags 0 takes the wide variant,
// else the slots variant with tile_bags bags per block and smem_bytes of
// dynamic shared memory, as launch_plan gives them. Does not synchronise.
int embedding_bag_forward(const void* table, const void* ids,
                          const void* weights, void* out, long long rows,
                          int dim, long long bags, int slots, int id_bytes,
                          int tile_bags, int smem_bytes, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto t = static_cast<const float*>(table);
  const auto w = static_cast<const float*>(weights);
  const auto o = static_cast<float*>(out);
  const cudaError_t err =
      id_bytes == 4
          ? launch(t, static_cast<const int*>(ids), w, o, rows, dim, bags,
                   slots, tile_bags, smem_bytes, s)
          : launch(t, static_cast<const long long*>(ids), w, o, rows, dim,
                   bags, slots, tile_bags, smem_bytes, s);
  return static_cast<int>(err);
}

const char* embedding_bag_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
