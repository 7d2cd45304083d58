// DCN-V2 cross layer for Hopper: out = x0 * (x @ W + b) + x.
//
// Replaces the TPU kernel repro/kernels/dcn_cross.py (_cross_kernel /
// dcn_cross_pallas): x0 and x are (B, D), W is (D, D) in the (in, out)
// layout, b is (D,); inputs are float32 or bfloat16, accumulation and the
// (B, D) output are float32.
//
// What bounds it: at the two-tower click model's shape (B = 655,360 items,
// D = 16) bytes. Per row the kernel must read x0 and x and write out, 3 D
// floats (192 bytes), against 2 D^2 = 512 operations: 126 MB, 37.6 us at
// 3.35 TB/s, against 5 us of fp32 FMA at 67 TFLOP/s. Above D = 120, where
// a row's 2 D^2 operations at 67 TFLOP/s take as long as its 12 D bytes at
// 3.35 TB/s, it is operations; at (65,536, 1024) 137 GFLOP, 2.05 ms.
//
// Design. The TPU kernel keeps W resident in VMEM over 256-row batch blocks
// with D padded to 128 lanes and runs the dot on the MXU; at D = 16 that
// pads every row 8x. Here a block owns a BM x BN output tile and walks the
// k dimension in BK-deep tiles: x's k-tile is staged transposed in shared
// memory, W's k-tile as is, and each thread accumulates a TM x TN micro
// tile in registers with FMA. The epilogue (+ b, * x0, + x) is applied to
// the registers before the one write of out, so the (B, D) product never
// reaches device memory. A thread's rows and columns are strided by the
// block's thread grid (row ty + i * BM / TM, column tx + j * BN / TN), so a
// warp's loads of x0 and x and its stores of out cover whole rows of
// consecutive floats. BN is picked from D: a 16-wide tile for D <= 16 (the
// main path; a 64-wide tile would leave three quarters of its threads
// idle), 32 for D <= 32, 64 above. Nothing is padded: every load and store
// is bounds-checked, with zeros for out-of-range k, so B = 1, D = 1 and
// ragged D (130, 190, 469) need no copy. Offsets are 64-bit. x may alias x0
// (the first cross layer): both are only read. No tensor cores and no TF32:
// the products are full float32, as the plain version's.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libdcn_cross.so dcn_cross.cu
// (repro_torch/kernels/build.py). Plain C interface, loaded with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
dcn_cross_kernel(const T* __restrict__ x0, const T* __restrict__ x,
                 const T* __restrict__ w, const T* __restrict__ bias,
                 float* __restrict__ out, long long rows, int dim) {
  constexpr int kRowThreads = BM / TM;
  constexpr int kColThreads = BN / TN;
  constexpr int kThreads = kRowThreads * kColThreads;
  // x's tile transposed (k-major) so the inner loop reads a row of rows;
  // +1 keeps the transposing stores off a single bank.
  __shared__ float xs[BK][BM + 1];
  __shared__ float ws[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % kColThreads;
  const int ty = tid / kColThreads;
  const long long row0 = static_cast<long long>(blockIdx.x) * BM;
  const int col0 = blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < dim; k0 += BK) {
    for (int idx = tid; idx < BM * BK; idx += kThreads) {
      const int r = idx / BK;
      const int k = idx - r * BK;
      const long long row = row0 + r;
      xs[k][r] = (row < rows && k0 + k < dim)
                     ? to_float(x[row * dim + k0 + k])
                     : 0.f;
    }
    for (int idx = tid; idx < BK * BN; idx += kThreads) {
      const int k = idx / BN;
      const int c = idx - k * BN;
      ws[k][c] = (k0 + k < dim && col0 + c < dim)
                     ? to_float(w[static_cast<long long>(k0 + k) * dim +
                                  col0 + c])
                     : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[k][ty + i * kRowThreads];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = ws[k][tx + j * kColThreads];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int col = col0 + tx + j * kColThreads;
    if (col >= dim) continue;
    const float bj = to_float(bias[col]);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const long long row = row0 + ty + i * kRowThreads;
      if (row >= rows) continue;
      const long long at = row * dim + col;
      out[at] = fmaf(to_float(x0[at]), acc[i][j] + bj, to_float(x[at]));
    }
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
int launch(const void* x0, const void* x, const void* w, const void* b,
           void* out, long long rows, int dim, cudaStream_t stream) {
  constexpr int kThreads = (BM / TM) * (BN / TN);
  const dim3 grid(static_cast<unsigned>((rows + BM - 1) / BM),
                  static_cast<unsigned>((dim + BN - 1) / BN));
  dcn_cross_kernel<T, BM, BN, BK, TM, TN><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x0), static_cast<const T*>(x),
      static_cast<const T*>(w), static_cast<const T*>(b),
      static_cast<float*>(out), rows, dim);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_for_dim(const void* x0, const void* x, const void* w,
                   const void* b, void* out, long long rows, int dim,
                   cudaStream_t stream) {
  if (dim <= 16)  // 128 rows x 16 columns, 128 threads of 4 x 4
    return launch<T, 128, 16, 16, 4, 4>(x0, x, w, b, out, rows, dim, stream);
  if (dim <= 32)  // 64 x 32, 128 threads
    return launch<T, 64, 32, 16, 4, 4>(x0, x, w, b, out, rows, dim, stream);
  // 64 x 64, 256 threads
  return launch<T, 64, 64, 16, 4, 4>(x0, x, w, b, out, rows, dim, stream);
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success). x0, x (rows, dim), w (dim, dim), b (dim,) all of one type:
// dtype 0 is float32, 1 bfloat16; out (rows, dim) float32; all row-major
// and contiguous. Does not synchronise.
int dcn_cross_forward(const void* x0, const void* x, const void* w,
                      const void* b, void* out, long long rows, int dim,
                      int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_for_dim<float>(x0, x, w, b, out, rows, dim, s);
  if (dtype == 1)
    return launch_for_dim<__nv_bfloat16>(x0, x, w, b, out, rows, dim, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* dcn_cross_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
