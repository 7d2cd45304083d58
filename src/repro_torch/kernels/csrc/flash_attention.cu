// Online-softmax (FlashAttention-style) attention for Hopper, float32, GQA.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py (_fa_kernel /
// flash_attention_pallas): o = softmax(q k^T * scale) v per (batch, head),
// scale defaulting to 1/sqrt(Dh), K/V head h / (Hq / Hkv) (grouped query
// attention, never a repeated copy), optional causal mask with q aligned
// to the end of KV (q_pos + Skv - Sq >= k_pos), output divided by
// max(l, 1e-30). Running max, sum and accumulator are float32.
//
// What bounds it: bytes at the shapes that call it. AutoInt's attention
// (65,536 x 2 heads x 39 x 16, float32) reads q, k and v once and writes o
// once: 1.31 GB, ~391 us at 3.35 TB/s, against 12.8 GFLOP, ~190 us at the
// 67 TFLOP/s float32 rate outside the tensor cores. Rows of 39 keys are far
// too short for wgmma's 64-row tiles to pay off, and the work per (b, h) is
// a few KB, so the design is about reading each byte once with enough
// blocks in flight, not about the tensor cores.
//
// Design. The TPU kernel walks a sequential (q-block, kv-block) grid and
// carries (m, l, acc) in VMEM from one grid step to the next. Here one block
// owns one (b, h, q-tile); it loops over the KV sequence in tiles staged in
// shared memory (all of AutoInt's 39 keys in one tile), zero-filled past
// Skv and past Dh. Each query row belongs to a group of G lanes of one warp
// (G = 1 for Dh <= 16, up to 8 for Dh = 128), each lane owning <= 16
// dimensions of q and of the accumulator in registers; a score is the
// group's partial dot products summed with xor shuffles. Scores are taken
// 16 keys at a time into registers, then one rescale of (l, acc) per 16
// keys, as FlashAttention-2 does per block. All lanes of a warp read the
// same K/V row of shared memory at once (a broadcast). The block is sized
// to the query rows it has (64 threads for Sq = 39), and causal blocks stop
// at their last row's horizon. Masked keys get p = 0 explicitly (not a
// large negative score), so a row whose first keys are all masked carries
// nothing from them. A causal call with Sq > Skv leaves rows that see no
// key; the wrapper refuses it.
//
// Offsets are 64-bit: AutoInt's q over 1,000,000 candidate rows holds
// 1.25e9 floats (5 GB).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu
// (repro_torch/kernels/build.py). Plain C interface, loaded with ctypes.

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxThreads = 128;
constexpr int kKeyChunk = 16;  // scores held in registers per rescale

// Per padded head width DP (a power of two >= Dh): dims per lane, lanes
// per query row, K/V rows staged per tile (2 x 32 KB at most).
template <int DP>
struct Layout {
  static constexpr int kLaneDims = DP < 16 ? DP : 16;
  static constexpr int kGroup = DP / kLaneDims;
  static constexpr int kKvTile = DP <= 64 ? 64 : 32;
};

template <int DP>
__global__ void __launch_bounds__(kMaxThreads)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int heads_q, int heads_kv, int seq_q, int seq_kv,
                       int dh, int q_tiles, float scale, int causal) {
  constexpr int C = Layout<DP>::kLaneDims;
  constexpr int G = Layout<DP>::kGroup;
  constexpr int T = Layout<DP>::kKvTile;
  __shared__ float ks[T][DP];
  __shared__ float vs[T][DP];

  long long blk = blockIdx.x;
  const int qt = static_cast<int>(blk % q_tiles);
  blk /= q_tiles;
  const int h = static_cast<int>(blk % heads_q);
  const long long b = blk / heads_q;
  const int hk = h / (heads_q / heads_kv);

  const int rows_per_block = blockDim.x / G;
  const int sub = threadIdx.x % G;
  const int d0 = sub * C;
  const int row = qt * rows_per_block + threadIdx.x / G;
  const bool live = row < seq_q;
  const long long q_head = (b * heads_q + h) * static_cast<long long>(seq_q);
  const long long kv_head =
      (b * heads_kv + hk) * static_cast<long long>(seq_kv);

  float qr[C];
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    qr[c] = live && d0 + c < dh ? q[(q_head + row) * dh + d0 + c] : 0.f;
    acc[c] = 0.f;
  }
  float m = -CUDART_INF_F;
  float l = 0.f;

  const int offset = seq_kv - seq_q;
  int kv_end = seq_kv;
  int horizon = INT_MAX;  // the last key position this row may see
  if (causal) {
    const int last_row = min(seq_q, (qt + 1) * rows_per_block) - 1;
    kv_end = min(seq_kv, last_row + offset + 1);
    horizon = row + offset;
  }

  for (int t0 = 0; t0 < kv_end; t0 += T) {
    const int n = min(T, kv_end - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < T * DP; i += blockDim.x) {
      const int r = i / DP;
      const int d = i % DP;
      const bool in = r < n && d < dh;
      const long long src = (kv_head + t0 + r) * dh + d;
      ks[r][d] = in ? k[src] : 0.f;
      vs[r][d] = in ? v[src] : 0.f;
    }
    __syncthreads();

    for (int j0 = 0; j0 < n; j0 += kKeyChunk) {
      float s[kKeyChunk];
      float m_chunk = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < kKeyChunk; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) dot = fmaf(qr[c], ks[j0 + j][d0 + c], dot);
#pragma unroll
        for (int off = G / 2; off > 0; off >>= 1) {
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        }
        const bool valid = j0 + j < n && t0 + j0 + j <= horizon;
        s[j] = valid ? dot * scale : -CUDART_INF_F;
        m_chunk = fmaxf(m_chunk, s[j]);
      }
      const float m_new = fmaxf(m, m_chunk);
      const bool seen = m_new != -CUDART_INF_F;  // some key visible so far
      const float corr = seen ? expf(m - m_new) : 1.f;
      l *= corr;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] *= corr;
#pragma unroll
      for (int j = 0; j < kKeyChunk; ++j) {
        const float p = seen ? expf(s[j] - m_new) : 0.f;  // exp(-inf) = 0
        l += p;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] = fmaf(p, vs[j0 + j][d0 + c], acc[c]);
      }
      m = m_new;
    }
  }

  if (live) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (d0 + c < dh) o[(q_head + row) * dh + d0 + c] = acc[c] * inv;
    }
  }
}

template <int DP>
int launch(const float* q, const float* k, const float* v, float* o,
           long long batch, int heads_q, int heads_kv, int seq_q, int seq_kv,
           int dh, float scale, int causal, cudaStream_t stream) {
  constexpr int G = Layout<DP>::kGroup;
  const int needed = ((seq_q * G + 31) / 32) * 32;
  const int threads = needed < kMaxThreads ? needed : kMaxThreads;
  const int rows_per_block = threads / G;
  const int q_tiles = (seq_q + rows_per_block - 1) / rows_per_block;
  const long long blocks = batch * heads_q * q_tiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  flash_attention_kernel<DP><<<static_cast<unsigned>(blocks), threads, 0,
                               stream>>>(q, k, v, o, heads_q, heads_kv, seq_q,
                                         seq_kv, dh, q_tiles, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns the CUDA error code (0 on
// success). q, o (batch, heads_q, seq_q, dh); k, v (batch, heads_kv,
// seq_kv, dh); float32, contiguous; heads_q % heads_kv == 0, 1 <= dh <=
// 128, and seq_q <= seq_kv when causal (checked by the caller). Does not
// synchronise.
int flash_attention_forward(const void* q, const void* k, const void* v,
                            void* o, long long batch, int heads_q,
                            int heads_kv, int seq_q, int seq_kv, int dh,
                            float scale, int causal, void* stream) {
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  auto st = static_cast<cudaStream_t>(stream);
  if (dh <= 4) return launch<4>(qf, kf, vf, of, batch, heads_q, heads_kv, seq_q, seq_kv, dh, scale, causal, st);
  if (dh <= 8) return launch<8>(qf, kf, vf, of, batch, heads_q, heads_kv, seq_q, seq_kv, dh, scale, causal, st);
  if (dh <= 16) return launch<16>(qf, kf, vf, of, batch, heads_q, heads_kv, seq_q, seq_kv, dh, scale, causal, st);
  if (dh <= 32) return launch<32>(qf, kf, vf, of, batch, heads_q, heads_kv, seq_q, seq_kv, dh, scale, causal, st);
  if (dh <= 64) return launch<64>(qf, kf, vf, of, batch, heads_q, heads_kv, seq_q, seq_kv, dh, scale, causal, st);
  if (dh <= 128) return launch<128>(qf, kf, vf, of, batch, heads_q, heads_kv, seq_q, seq_kv, dh, scale, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
