// Online-softmax (FlashAttention-style) attention for Hopper, GQA, float32
// or bfloat16 inputs.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py (_fa_kernel /
// flash_attention_pallas): o = softmax(q k^T * scale) v per (batch, head),
// scale defaulting to 1/sqrt(Dh), K/V head h / (Hq / Hkv) (grouped query
// attention, never a repeated copy), optional causal mask with q aligned
// to the end of KV (q_pos + Skv - Sq >= k_pos), output divided by
// max(l, 1e-30). Inputs are float32 or bfloat16, as the Pallas kernel
// takes them; every piece of arithmetic (scores, running max and sum,
// accumulator) is float32, and o is written in q's type.
//
// Layouts. Each of q, k and v is either a contiguous (B, H, S, Dh) tensor
// or the transpose(1, 2) view of a contiguous (B, S, H, Dh) tensor, which
// is what AutoInt's (h @ w).reshape(B, F, H, Dh).transpose(1, 2) gives; o
// is written in q's layout. In both layouts one batch row of a tensor is
// one contiguous span of H * S * Dh elements, so no copy is needed.
//
// What bounds it: bytes at the shapes that call it. AutoInt's attention
// (65,536 x 2 heads x 39 x 16) reads q, k and v once and writes o once:
// 1.31 GB in float32, ~391 us at 3.35 TB/s (half that in bfloat16),
// against 12.8 GFLOP, ~190 us at the 67 TFLOP/s float32 rate outside the
// tensor cores. No tensor cores: at Dh = 16 and 39 keys the work is
// bytes-bound, wgmma's 64-row tiles would be mostly padding, and TF32
// products would break the float32 1e-5 contract. The rows variant comes
// near the bytes rate in float32; in bfloat16, with half the bytes, its
// key loop (per row and key, 2 Dh FMAs and the K and V row loads from
// shared memory) is what holds it.
//
// Two variants, picked by the wrapper's launch_plan from the shape:
//
// rows (Dh in {4, 8, 16}, a batch row's q, k and v spans a multiple of 16
//   bytes, a group of them in shared memory): a block owns groups of P
//   whole batch rows with all their heads. A thread owns two query rows of
//   one head, positions s and s + ceil(Sq / 2), holding their q and
//   accumulators in registers, so each K and V row it loads from shared
//   memory serves two rows (AutoInt: 40 threads per batch row; at P = 3,
//   120 of a block's 128 lanes are busy). Threads are numbered in the
//   memory order of their first row, so in either layout a warp's q reads
//   and o stores cover consecutive bytes. The block is persistent (a grid
//   of as many blocks as fit on the card, each walking groups with a
//   stride) and brings each group in by three 1-D bulk copies
//   (cp.async.bulk, the TMA's 1-D form: the group's q, k and v spans) into
//   a ring of shared-memory stages that complete on an mbarrier each, so
//   the next group loads while this one is computed. bfloat16 K/V are
//   widened to float32 once per group into a buffer beside the ring, so
//   the key loop does no conversion. q is pre-scaled by scale * log2(e),
//   so the softmax runs on exp2 (ex2.approx.ftz: 2 ulp, results below
//   2^-126 of the row's largest weight flushed). Keys are walked exactly
//   to Skv in chunks of 8 scores per row held in registers, one rescale of
//   (l, acc) per chunk, the last chunk as long as the keys left; the causal
//   mask is a template parameter, so the unmasked loop has no compare. o is
//   written from registers with 16-byte (8-byte for bfloat16 at Dh = 4)
//   vector stores. Two rows of Dh = 16 take up to 128 registers, without
//   spills on the unmasked path (the causal float32 instance spills ~20
//   bytes for its horizons): at 64 the key loop spilled, and shared
//   memory, not registers, bounds the blocks per SM.
//
// tiles (everything else: Dh up to 128, long sequences): the first design.
//   One block owns one (b, h, q-tile) and loops over the KV sequence in
//   tiles staged in shared memory, zero-filled past Skv and past Dh. Each
//   query row belongs to a group of G lanes of one warp (G = 1 for Dh <=
//   16, up to 8 for Dh = 128), each lane owning <= 16 dimensions of q and
//   of the accumulator; a score is the group's partial dot products summed
//   with xor shuffles, 16 keys per rescale. Causal blocks stop at their
//   last row's horizon.
//
// In both, masked keys get p = 0 explicitly (not a large negative score),
// so a row whose first keys are all masked carries nothing from them. A
// causal call with Sq > Skv leaves rows that see no key; the wrapper
// refuses it. Offsets are 64-bit: AutoInt's q over 1,000,000 candidate
// rows holds 1.25e9 elements.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu
// (repro_torch/kernels/build.py; no -use_fast_math: exp2f and expf are the
// accurate library forms). Plain C interface, loaded with ctypes.

#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// A tensor's strides inside one batch row, in elements: (B, H, S, Dh)
// contiguous, or the (B, S, H, Dh)-backed view.
struct RowStrides {
  int head, row;
};
__host__ __device__ inline RowStrides row_strides(int bshd, int heads,
                                                   int seq, int dh) {
  return bshd ? RowStrides{dh, heads * dh} : RowStrides{seq * dh, dh};
}

// ---------------------------------------------------------------------------
// rows variant
// ---------------------------------------------------------------------------

constexpr int kRowsMaxThreads = 512;
constexpr int kRowsMinBlocks = 1;  // 65,536 / 512: up to 128 registers
constexpr int kRowsPerThread = 2;  // query rows sharing each K/V row load
constexpr int kChunk = 8;  // scores held in registers per row and rescale
constexpr int kMaxStages = 4;
constexpr int kBarrierBytes = 64;  // the stages' mbarriers, 16-byte padded
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One contiguous span global -> shared, completing on `bar` (16-byte
// aligned addresses, a multiple of 16 bytes).
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __bfloat162float(__ushort_as_bfloat16(
      static_cast<unsigned short>(w & 0xffffu)));
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __bfloat162float(
      __ushort_as_bfloat16(static_cast<unsigned short>(w >> 16)));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(hi)))
          << 16);
}

// 16 or 8 bytes of shared memory at a 32-bit shared-window address.
__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 w;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(w.x), "=r"(w.y), "=r"(w.z), "=r"(w.w)
               : "r"(addr));
  return w;
}
__device__ __forceinline__ uint2 lds64(uint32_t addr) {
  uint2 w;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];"
               : "=r"(w.x), "=r"(w.y)
               : "r"(addr));
  return w;
}

// A D-element row from shared memory into float registers, in 16-byte
// (8-byte for 4 bfloat16) vector loads. Addresses are 32-bit offsets in
// the shared window, which keeps the key loop's address arithmetic to one
// register per stream.
template <int D, typename T>
__device__ __forceinline__ void load_row(uint32_t addr, float (&x)[D]) {
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int c = 0; c < D; c += 4) {
      const uint4 w = lds128(addr + c * 4);
      x[c] = __uint_as_float(w.x);
      x[c + 1] = __uint_as_float(w.y);
      x[c + 2] = __uint_as_float(w.z);
      x[c + 3] = __uint_as_float(w.w);
    }
  } else if constexpr (D % 8 == 0) {
#pragma unroll
    for (int c = 0; c < D; c += 8) {
      const uint4 w = lds128(addr + c * 2);
      x[c] = bf16_lo(w.x);
      x[c + 1] = bf16_hi(w.x);
      x[c + 2] = bf16_lo(w.y);
      x[c + 3] = bf16_hi(w.y);
      x[c + 4] = bf16_lo(w.z);
      x[c + 5] = bf16_hi(w.z);
      x[c + 6] = bf16_lo(w.w);
      x[c + 7] = bf16_hi(w.w);
    }
  } else {
    const uint2 w = lds64(addr);
    x[0] = bf16_lo(w.x);
    x[1] = bf16_hi(w.x);
    x[2] = bf16_lo(w.y);
    x[3] = bf16_hi(w.y);
  }
}

// A D-element row of float registers to device memory in q's type.
template <int D>
__device__ __forceinline__ void store_row(float* dst, const float (&x)[D]) {
#pragma unroll
  for (int c = 0; c < D; c += 4) {
    *reinterpret_cast<float4*>(dst + c) =
        make_float4(x[c], x[c + 1], x[c + 2], x[c + 3]);
  }
}
template <int D>
__device__ __forceinline__ void store_row(bf16* dst, const float (&x)[D]) {
  if constexpr (D % 8 == 0) {
#pragma unroll
    for (int c = 0; c < D; c += 8) {
      *reinterpret_cast<uint4*>(dst + c) =
          make_uint4(pack_bf16(x[c], x[c + 1]), pack_bf16(x[c + 2], x[c + 3]),
                     pack_bf16(x[c + 4], x[c + 5]),
                     pack_bf16(x[c + 6], x[c + 7]));
    }
  } else {
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]));
  }
}

// 2^x for x <= 0 (a score minus the running max): one MUFU.EX2, at most
// 2 ulp from the exact value; a result below 2^-126 of the row's largest
// weight flushes to 0, which changes no float32 sum that also holds 1.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes to shared memory at a 32-bit shared-window address.
__device__ __forceinline__ void sts128(uint32_t addr, float a, float b,
                                       float c, float d) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

// Running softmax state of R query rows of one thread: q (pre-scaled by
// scale * log2(e)), the accumulator, running max (base 2) and sum, and
// (causal) the last key each row may see.
template <int R, int D>
struct RowState {
  float q[R][D];
  float acc[R][D];
  float m[R];
  float l[R];
  int horizon[R];
};

// N keys from j0 for the R rows: N R base-2 scores into registers, one
// rescale of (l, acc) per row, then the N weighted rows of v. Each K and V
// row (of type KT) is loaded once for the R rows. Key j's rows are at
// k_addr + j k_step and v_addr + j v_step (bytes). Causal: keys past a
// row's horizon get p = 0.
template <int N, bool kCausal, int R, int D, typename KT>
__device__ __forceinline__ void attend_chunk(RowState<R, D>& st,
                                             uint32_t k_addr, uint32_t v_addr,
                                             int k_step, int v_step, int j0) {
  float s[R][N];
  float m_new[R];
#pragma unroll
  for (int i = 0; i < R; ++i) m_new[i] = st.m[i];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float kx[D];
    load_row<D, KT>(k_addr + (j0 + j) * k_step, kx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) dot = fmaf(st.q[i][c], kx[c], dot);
      s[i][j] = !kCausal || j0 + j <= st.horizon[i] ? dot : -CUDART_INF_F;
      m_new[i] = fmaxf(m_new[i], s[i][j]);
    }
  }
  // Non-causal, every key is seen, so m_new is finite from the first chunk
  // on and exp2(-inf - m_new) = 0 clears the empty (l, acc). Causal, a row
  // that has seen no key yet keeps (l, acc) = 0 and takes p = 0.
  bool seen[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    seen[i] = !kCausal || m_new[i] != -CUDART_INF_F;
    const float corr = seen[i] ? exp2_approx(st.m[i] - m_new[i]) : 1.f;
    st.l[i] *= corr;
#pragma unroll
    for (int c = 0; c < D; ++c) st.acc[i][c] *= corr;
    st.m[i] = m_new[i];
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float vx[D];
    load_row<D, KT>(v_addr + (j0 + j) * v_step, vx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      // exp2(-inf) = 0 for a masked key once some key was seen.
      const float p = seen[i] ? exp2_approx(s[i][j] - st.m[i]) : 0.f;
      st.l[i] += p;
#pragma unroll
      for (int c = 0; c < D; ++c) st.acc[i][c] = fmaf(p, vx[c], st.acc[i][c]);
    }
  }
}

struct RowsArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long batch;
  int groups;  // ceil(batch / per_group)
  int heads_q, heads_kv, seq_q, seq_kv;
  int q_bshd, k_bshd, v_bshd;  // o has q's layout
  int per_group;               // P batch rows per group
  int stages;
  float qscale;  // scale * log2(e)
};

template <int D, typename T, bool kCausal>
__global__ void __launch_bounds__(kRowsMaxThreads, kRowsMinBlocks)
attention_rows_kernel(const RowsArgs a) {
  constexpr int R = kRowsPerThread;
  // K/V as the key loop reads them: bfloat16 K/V are widened once per
  // group into a float32 copy beside the ring.
  constexpr bool kWiden = std::is_same<T, bf16>::value;
  using KT = typename std::conditional<kWiden, float, T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  constexpr int kRowBytes = D * sizeof(T);
  // One batch row's span of q (and of o), and of k (and of v), in bytes;
  // a stage holds P of each, q's first.
  const int q_bytes = a.heads_q * a.seq_q * kRowBytes;
  const int kv_bytes = a.heads_kv * a.seq_kv * kRowBytes;
  const int stage_bytes = a.per_group * (q_bytes + 2 * kv_bytes);
  const uint32_t ring = smem_addr(smem) + kBarrierBytes;
  const uint32_t widened = ring + a.stages * stage_bytes;  // kWiden only
  const int kv_read_bytes = kv_bytes / int(sizeof(T)) * int(sizeof(KT));

  // Thread 0 brings group g's q, k and v spans into stage s.
  auto issue = [&](int g, int s) {
    const long long b0 = static_cast<long long>(g) * a.per_group;
    const int nb = static_cast<int>(
        min(static_cast<long long>(a.per_group), a.batch - b0));
    const uint32_t st = ring + s * stage_bytes;
    mbar_expect_tx(&full[s], nb * (q_bytes + 2 * kv_bytes));
    bulk_load(st, static_cast<const char*>(a.q) + b0 * q_bytes, nb * q_bytes,
              &full[s]);
    bulk_load(st + a.per_group * q_bytes,
              static_cast<const char*>(a.k) + b0 * kv_bytes, nb * kv_bytes,
              &full[s]);
    bulk_load(st + a.per_group * (q_bytes + kv_bytes),
              static_cast<const char*>(a.v) + b0 * kv_bytes, nb * kv_bytes,
              &full[s]);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 0; s < a.stages; ++s) {
      const long long g = blockIdx.x + static_cast<long long>(s) * gridDim.x;
      if (g < a.groups) issue(static_cast<int>(g), s);
    }
  }
  __syncthreads();

  // This thread's R query rows: batch row p of the group, head h,
  // positions sq + i * span (i < R) of that head. Threads are numbered in
  // the q span's memory order of their first row, so a warp's q reads and
  // o stores are dense in either layout. A row past Sq repeats the first
  // row's work and is not stored.
  const int span = (a.seq_q + R - 1) / R;
  const int threads_per_b = a.heads_q * span;
  const int p = threadIdx.x / threads_per_b;
  const int u = threadIdx.x - p * threads_per_b;
  int h, sq;
  if (a.q_bshd) {
    sq = u / a.heads_q;
    h = u - sq * a.heads_q;
  } else {
    h = u / span;
    sq = u - h * span;
  }
  const RowStrides qs = row_strides(a.q_bshd, a.heads_q, a.seq_q, D);
  const RowStrides ks = row_strides(a.k_bshd, a.heads_kv, a.seq_kv, D);
  const RowStrides vs = row_strides(a.v_bshd, a.heads_kv, a.seq_kv, D);
  const int hk = h / (a.heads_q / a.heads_kv);
  int row_off[R];  // bytes from the batch row's q (and o) span
  bool stored[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int pos = sq + i * span;
    stored[i] = pos < a.seq_q;
    row_off[i] =
        (h * qs.head + (stored[i] ? pos : sq) * qs.row) * int(sizeof(T));
  }
  // Offsets of this thread's K/V head's first key from the start of the
  // group's K span (V follows K), as the key loop reads them.
  const int k_off = p * kv_read_bytes + hk * ks.head * int(sizeof(KT));
  const int v_off = (a.per_group + p) * kv_read_bytes +
                    hk * vs.head * int(sizeof(KT));
  const int k_step = ks.row * int(sizeof(KT));
  const int v_step = vs.row * int(sizeof(KT));
  constexpr int N = kChunk;
  const int full_chunks_end = a.seq_kv - a.seq_kv % N;

  int s = 0;
  uint32_t phase = 0;
  for (int g = blockIdx.x; g < a.groups; g += gridDim.x) {
    mbar_wait(&full[s], phase);
    const uint32_t st = ring + s * stage_bytes;
    uint32_t kv = st + a.per_group * q_bytes;
    if constexpr (kWiden) {
      const int units = a.per_group * 2 * kv_bytes / 16;  // 8 values each
      for (int x = threadIdx.x; x < units; x += blockDim.x) {
        const uint4 w = lds128(kv + x * 16);
        const uint32_t dst = widened + x * 32;
        sts128(dst, bf16_lo(w.x), bf16_hi(w.x), bf16_lo(w.y), bf16_hi(w.y));
        sts128(dst + 16, bf16_lo(w.z), bf16_hi(w.z), bf16_lo(w.w),
               bf16_hi(w.w));
      }
      __syncthreads();
      kv = widened;
    }
    const long long b = static_cast<long long>(g) * a.per_group + p;
    if (p < a.per_group && b < a.batch) {
      const uint32_t kr = kv + k_off;
      const uint32_t vr = kv + v_off;
      RowState<R, D> rs;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        load_row<D, T>(st + p * q_bytes + row_off[i], rs.q[i]);
#pragma unroll
        for (int c = 0; c < D; ++c) {
          rs.q[i][c] *= a.qscale;
          rs.acc[i][c] = 0.f;
        }
        rs.m[i] = -CUDART_INF_F;
        rs.l[i] = 0.f;
        rs.horizon[i] =
            (stored[i] ? sq + i * span : sq) + a.seq_kv - a.seq_q;
      }
      int j0 = 0;
      for (; j0 < full_chunks_end; j0 += N) {
        attend_chunk<N, kCausal, R, D, KT>(rs, kr, vr, k_step, v_step, j0);
      }
      switch (a.seq_kv - j0) {  // the last keys, exactly as many as are left
#define FA_TAIL(n)                                                   \
  case n:                                                            \
    attend_chunk<n, kCausal, R, D, KT>(rs, kr, vr, k_step, v_step, j0); \
    break;
        FA_TAIL(1) FA_TAIL(2) FA_TAIL(3) FA_TAIL(4) FA_TAIL(5) FA_TAIL(6)
        FA_TAIL(7)
#undef FA_TAIL
        default:
          break;
      }
      static_assert(N <= 8, "the tail cases cover N - 1 keys");
      char* ob = static_cast<char*>(a.o) + b * q_bytes;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float inv = 1.f / fmaxf(rs.l[i], 1e-30f);
#pragma unroll
        for (int c = 0; c < D; ++c) rs.acc[i][c] *= inv;
        if (stored[i]) {
          store_row<D>(reinterpret_cast<T*>(ob + row_off[i]), rs.acc[i]);
        }
      }
    }
    __syncthreads();  // every thread is done reading stage s (and widened)
    if (threadIdx.x == 0) {
      // Order the reads above before the bulk copy's writes into stage s.
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      const long long next = g + static_cast<long long>(a.stages) * gridDim.x;
      if (next < a.groups) issue(static_cast<int>(next), s);
    }
    if (++s == a.stages) {
      s = 0;
      phase ^= 1u;
    }
  }
}

template <int D, typename T>
int launch_rows(const RowsArgs& a, int causal, int threads, int grid,
                int smem_bytes, cudaStream_t stream) {
  const long long q_bytes =
      static_cast<long long>(a.heads_q) * a.seq_q * D * sizeof(T);
  const long long kv_bytes =
      static_cast<long long>(a.heads_kv) * a.seq_kv * D * sizeof(T);
  const long long widened = std::is_same<T, bf16>::value ? 4 * kv_bytes : 0;
  const long long need =
      kBarrierBytes + a.stages * a.per_group * (q_bytes + 2 * kv_bytes) +
      a.per_group * widened;
  if (threads > kRowsMaxThreads || threads % 32 ||
      threads < a.per_group * a.heads_q *
                    ((a.seq_q + kRowsPerThread - 1) / kRowsPerThread) ||
      a.stages < 1 || a.stages > kMaxStages || smem_bytes < need ||
      grid < 1 || grid > a.groups || q_bytes % 16 || kv_bytes % 16) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  auto* kernel = causal ? attention_rows_kernel<D, T, true>
                        : attention_rows_kernel<D, T, false>;
  // The opt-in above 48 KB, on the current device.
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem_bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// tiles variant (the first design, strided and typed)
// ---------------------------------------------------------------------------

constexpr int kTilesMaxThreads = 128;
constexpr int kKeyChunk = 16;  // scores held in registers per rescale

// Per padded head width DP (a power of two >= Dh): dims per lane, lanes
// per query row, K/V rows staged per tile (2 x 32 KB at most).
template <int DP>
struct Layout {
  static constexpr int kLaneDims = DP < 16 ? DP : 16;
  static constexpr int kGroup = DP / kLaneDims;
  static constexpr int kKvTile = DP <= 64 ? 64 : 32;
};

struct TilesArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int heads_q, heads_kv, seq_q, seq_kv, dh, q_tiles;
  int q_bshd, k_bshd, v_bshd;
  float scale;
  int causal;
};

template <int DP, typename T>
__global__ void __launch_bounds__(kTilesMaxThreads)
attention_tiles_kernel(const TilesArgs a) {
  constexpr int C = Layout<DP>::kLaneDims;
  constexpr int G = Layout<DP>::kGroup;
  constexpr int TK = Layout<DP>::kKvTile;
  __shared__ float ks[TK][DP];
  __shared__ float vs[TK][DP];
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* o = static_cast<T*>(a.o);
  const int dh = a.dh;

  long long blk = blockIdx.x;
  const int qt = static_cast<int>(blk % a.q_tiles);
  blk /= a.q_tiles;
  const int h = static_cast<int>(blk % a.heads_q);
  const long long b = blk / a.heads_q;
  const int hk = h / (a.heads_q / a.heads_kv);

  const RowStrides qst = row_strides(a.q_bshd, a.heads_q, a.seq_q, dh);
  const RowStrides kst = row_strides(a.k_bshd, a.heads_kv, a.seq_kv, dh);
  const RowStrides vst = row_strides(a.v_bshd, a.heads_kv, a.seq_kv, dh);
  const long long q_head = b * a.heads_q * a.seq_q * static_cast<long long>(dh) +
                           static_cast<long long>(h) * qst.head;
  const long long k_head =
      b * a.heads_kv * a.seq_kv * static_cast<long long>(dh) +
      static_cast<long long>(hk) * kst.head;
  const long long v_head =
      b * a.heads_kv * a.seq_kv * static_cast<long long>(dh) +
      static_cast<long long>(hk) * vst.head;

  const int rows_per_block = blockDim.x / G;
  const int sub = threadIdx.x % G;
  const int d0 = sub * C;
  const int row = qt * rows_per_block + threadIdx.x / G;
  const bool live = row < a.seq_q;
  const long long q_row = q_head + static_cast<long long>(row) * qst.row;

  float qr[C];
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    qr[c] = live && d0 + c < dh ? to_float(q[q_row + d0 + c]) : 0.f;
    acc[c] = 0.f;
  }
  float m = -CUDART_INF_F;
  float l = 0.f;

  const int offset = a.seq_kv - a.seq_q;
  int kv_end = a.seq_kv;
  int horizon = INT_MAX;  // the last key position this row may see
  if (a.causal) {
    const int last_row = min(a.seq_q, (qt + 1) * rows_per_block) - 1;
    kv_end = min(a.seq_kv, last_row + offset + 1);
    horizon = row + offset;
  }

  for (int t0 = 0; t0 < kv_end; t0 += TK) {
    const int n = min(TK, kv_end - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < TK * DP; i += blockDim.x) {
      const int r = i / DP;
      const int d = i % DP;
      const bool in = r < n && d < dh;
      const long long key = t0 + r;
      ks[r][d] = in ? to_float(k[k_head + key * kst.row + d]) : 0.f;
      vs[r][d] = in ? to_float(v[v_head + key * vst.row + d]) : 0.f;
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
        s[j] = valid ? dot * a.scale : -CUDART_INF_F;
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
      if (d0 + c < dh) o[q_row + d0 + c] = from_float<T>(acc[c] * inv);
    }
  }
}

template <int DP, typename T>
int launch_tiles(const TilesArgs& a, long long batch, int threads,
                 long long grid, cudaStream_t stream) {
  constexpr int G = Layout<DP>::kGroup;
  if (threads > kTilesMaxThreads || threads % 32 || threads < G ||
      a.q_tiles != (a.seq_q + threads / G - 1) / (threads / G) ||
      grid != batch * a.heads_q * a.q_tiles || grid > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  attention_tiles_kernel<DP, T>
      <<<static_cast<unsigned>(grid), threads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tiles_dh(const TilesArgs& a, long long batch, int threads,
                    long long grid, cudaStream_t st) {
  const int dh = a.dh;
  if (dh <= 4) return launch_tiles<4, T>(a, batch, threads, grid, st);
  if (dh <= 8) return launch_tiles<8, T>(a, batch, threads, grid, st);
  if (dh <= 16) return launch_tiles<16, T>(a, batch, threads, grid, st);
  if (dh <= 32) return launch_tiles<32, T>(a, batch, threads, grid, st);
  if (dh <= 64) return launch_tiles<64, T>(a, batch, threads, grid, st);
  if (dh <= 128) return launch_tiles<128, T>(a, batch, threads, grid, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_rows_dh(const RowsArgs& a, int dh, int causal, int threads,
                   int grid, int smem_bytes, cudaStream_t st) {
  if (dh == 4) return launch_rows<4, T>(a, causal, threads, grid, smem_bytes, st);
  if (dh == 8) return launch_rows<8, T>(a, causal, threads, grid, smem_bytes, st);
  if (dh == 16) return launch_rows<16, T>(a, causal, threads, grid, smem_bytes, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Launches one variant on `stream` and returns the CUDA error code (0 on
// success; cudaErrorInvalidConfiguration when the geometry does not fit
// the shape). q, o (batch, heads_q, seq_q, dh); k, v (batch, heads_kv,
// seq_kv, dh); each (B, H, S, Dh) contiguous (layout flag 0) or the
// transpose(1, 2) view of a contiguous (B, S, H, Dh) tensor (flag 1); o in
// q's layout; all float32 (bf16 = 0) or all bfloat16 (bf16 = 1).
// heads_q % heads_kv == 0, seq_q <= seq_kv when causal, 1 <= dh <= 128.
// variant 0 (tiles): `threads` per block, grid = batch x heads_q x
// ceil(seq_q / rows per block). variant 1 (rows): dh in {4, 8, 16},
// `per_group` batch rows per group, `stages` ring stages, `smem_bytes` of
// dynamic shared memory, a persistent grid of `grid` blocks; 16-byte
// aligned pointers and batch-row spans. The wrapper's launch_plan computes
// all of these. Does not synchronise.
int flash_attention_forward(const void* q, const void* k, const void* v,
                            void* o, long long batch, int heads_q,
                            int heads_kv, int seq_q, int seq_kv, int dh,
                            int q_bshd, int k_bshd, int v_bshd, int bf16_io,
                            float scale, int causal, int variant,
                            int per_group, int stages, int threads,
                            long long grid, int smem_bytes, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    if (per_group < 1 || grid > INT_MAX ||
        (batch + per_group - 1) / per_group > INT_MAX) {
      return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    RowsArgs a{q, k, v, o, batch,
               static_cast<int>((batch + per_group - 1) / per_group),
               heads_q, heads_kv, seq_q, seq_kv, q_bshd, k_bshd, v_bshd,
               per_group, stages, scale * kLog2e};
    const int g = static_cast<int>(grid);
    return bf16_io
               ? launch_rows_dh<bf16>(a, dh, causal, threads, g, smem_bytes, st)
               : launch_rows_dh<float>(a, dh, causal, threads, g, smem_bytes,
                                       st);
  }
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int dp_group = dh <= 16 ? 1 : (dh <= 32 ? 2 : (dh <= 64 ? 4 : 8));
  if (threads < dp_group) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const int rows_per_block = threads / dp_group;
  TilesArgs a{q, k, v, o, heads_q, heads_kv, seq_q, seq_kv, dh,
              (seq_q + rows_per_block - 1) / rows_per_block, q_bshd, k_bshd,
              v_bshd, scale, causal};
  return bf16_io ? launch_tiles_dh<bf16>(a, batch, threads, grid, st)
                 : launch_tiles_dh<float>(a, batch, threads, grid, st);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
