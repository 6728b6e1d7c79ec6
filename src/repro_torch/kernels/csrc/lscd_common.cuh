// Load-as-Sparse / Compute-as-Dense SpMM for Hopper (sm_90a): shared body.
//
// C[G, M, N] = epilogue(decode(A_g)[M, K] @ B[K, N] + bias_g), A_g in padded
// Tiled-CSL: per (m_tb x k_tb) tile a list of 32-bit words, each a bf16 value
// (bits 31..16) and a 16-bit intra-tile location row * k_tb + col (bits
// 15..0), padded with zero words to max_nnz; nnz[g][mt][kt] holds the count.
//
// Two bodies, chosen by shape (the same rule for the single-pass and the
// split-K kernels, so split_k == 1 bit-matches the single-pass kernel at
// every n_tb; analysis/contracts.py states it):
//
// * bf16 B with n_tb >= 64 (prefill): the pipelined wgmma mainloop of
//   hopper_pipe.cuh, one (weight or binary pair, m tile, n tile[, K
//   slice]) per block, n tiles fastest in the grid so that the blocks
//   sharing a weight tile's words run together and find them in L2.
// * n_tb <= 32 (decode) and every f32 launch: the first body, below. One
//   block of THREADS threads owns one (m tile, n tile[, K slice]) for all
//   G weights. For each K tile whose words are not all empty it
//     1. stages the B tile in shared memory, once for all G weights;
//     2. per weight g: zeroes a dense A tile in shared memory and stores
//        the tile's first nnz words into it. Only the first nnz words are
//        read, so a padding word, (+0.0 | loc 0), never overwrites (0, 0);
//     3. runs the dense product of the two tiles into per-thread f32
//        register accumulators acc[G][...]:
//          bf16 B: tensor cores, mma.sync m16n8k16 -> f32 (MmaTile);
//          f32 B:  CUDA-core f32 FMAs, so f32 inputs keep full f32.
// The single-pass kernels flush bias + epilogue + one cast; the split-K
// kernels write f32 partials [S, G, M, N] and a reduce kernel sums the S
// slices in slice order (no atomics), then applies the same flush_value().
//
// What bounds it on an H100: at decode (N <= 64) the weight words are
// nearly all the bytes moved (4 bytes per kept weight), so the bound is the
// words' bytes over 3.35 TB/s; at prefill N the useful bf16 operations,
// 2 * nnz * N, over 989 TFLOP/s. The first body has no cp.async
// pipelining: it keeps loads in flight by running several blocks on each
// SM and by letting the schedule split K (kernels/schedule.py). What it does
// not hide is each block's walk over its K tiles: every tile costs a few
// dependent global reads, a full-tile zeroing and three barriers in
// sequence. The decode kernels' redesign is the next step (ROADMAP.md).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_pipe.cuh"

namespace lscd {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_ACC = 64;  // f32 accumulators per thread (registers)

constexpr int cmin(int x, int y) { return x < y ? x : y; }

enum Epilogue {
  EPI_NONE = 0,
  EPI_SILU = 1,
  EPI_GELU = 2,  // tanh form, as jax.nn.gelu's default
  EPI_RELU = 3,
  EPI_SILU_MUL = 4,
  EPI_GELU_MUL = 5,
};

// Explicit-rounding intrinsics keep nvcc from contracting these into FMAs
// differently in different kernels, which the S=1 bit-match relies on.
__device__ __forceinline__ float silu(float x) {
  return __fdiv_rn(x, __fadd_rn(1.0f, expf(-x)));
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  const float x3 = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(k0, __fadd_rn(x, __fmul_rn(0.044715f, x3)));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, tanhf(inner)));
}

__device__ __forceinline__ float unary(int epi, float x) {
  switch (epi) {
    case EPI_SILU: return silu(x);
    case EPI_GELU: return gelu_tanh(x);
    case EPI_RELU: return fmaxf(x, 0.0f);
    default: return x;
  }
}

__device__ __forceinline__ float binary(int epi, float a, float b) {
  return __fmul_rn(epi == EPI_SILU_MUL ? silu(a) : gelu_tanh(a), b);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void zero_smem(void* p, int bytes) {
  uint4* q = static_cast<uint4*>(p);
  for (int i = threadIdx.x; i < bytes / 16; i += THREADS)
    q[i] = make_uint4(0u, 0u, 0u, 0u);
}

// f32 B and C: CUDA-core FMAs. Thread (ty, tx) owns rows ty + i * THREADS_M
// and columns tx + j * THREADS_N of the block's M_TB x N_TB tile, so
// neighbouring threads hit neighbouring columns of B and C. A rows are
// padded by one word against bank conflicts.
template <int M_TB, int N_TB>
struct FmaTile {
  using Elem = float;
  static constexpr int P = M_TB * N_TB / THREADS;
  static constexpr int TN = cmin(cmin(N_TB, P), 8);
  static constexpr int TM = P / TN;
  static constexpr int THREADS_N = N_TB / TN;
  static constexpr int THREADS_M = THREADS / THREADS_N;
  static constexpr int ACC = TM * TN;
  static_assert(P >= 1, "tile smaller than the block");
  static_assert(THREADS_N * TN == N_TB, "N layout");
  static_assert(THREADS_M * TM == M_TB, "M layout");

  __host__ __device__ static int lda(int k_tb) { return k_tb + 1; }
  __host__ __device__ static int a_bytes(int k_tb) {
    return (int)sizeof(float) * M_TB * lda(k_tb);
  }
  __host__ static size_t smem(int k_tb) {
    return (size_t)a_bytes(k_tb) + sizeof(float) * k_tb * N_TB;
  }
  __device__ static void put_a(float* a_s, int idx, uint32_t w) {
    a_s[idx] = __uint_as_float(w & 0xFFFF0000u);
  }
  __device__ static void stage_b(float* b_s, const float* bt, int n, int k_tb) {
    for (int i = threadIdx.x; i < k_tb * N_TB; i += THREADS)
      b_s[i] = bt[(size_t)(i / N_TB) * n + (i % N_TB)];
  }
  __device__ static void compute(float (&acc)[ACC], const float* a_s,
                                 const float* b_s, int k_tb) {
    const int tx = threadIdx.x % THREADS_N, ty = threadIdx.x / THREADS_N;
    const int ld = lda(k_tb);
#pragma unroll 4
    for (int kk = 0; kk < k_tb; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = a_s[(ty + i * THREADS_M) * ld + kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = b_s[kk * N_TB + tx + j * THREADS_N];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i * TN + j] = __fmaf_rn(av[i], bv[j], acc[i * TN + j]);
    }
  }
  // Tile-local (row, col) of accumulator e; false if it holds no output.
  __device__ static bool coord(int e, int& row, int& col) {
    const int tx = threadIdx.x % THREADS_N, ty = threadIdx.x / THREADS_N;
    row = ty + (e / TN) * THREADS_M;
    col = tx + (e % TN) * THREADS_N;
    return true;
  }
};

// bf16 B and C: tensor cores, mma.sync.m16n8k16 (bf16 x bf16 -> f32; a
// bf16 product is exact in f32). Warp w owns the 16-row strip w % STRIPS
// and the 8-column n tiles ng, ng + WN, ... with ng = w / STRIPS. A is kept
// row-major and B transposed ([n][k]) as bf16, rows padded by 8 elements so
// each fragment load of a warp hits 32 distinct banks.
template <int M_TB, int N_TB>
struct MmaTile {
  using Elem = uint16_t;  // bf16 bits
  static constexpr int STRIPS = M_TB / 16;
  static constexpr int WN = WARPS / STRIPS;
  static constexpr int NT = N_TB / 8;
  static constexpr int TPW = (NT + WN - 1) / WN;
  static constexpr int ACC = 4 * TPW;
  static_assert(STRIPS * WN == WARPS, "warp layout");
  static_assert(NT * 8 == N_TB, "N tile is a multiple of 8");

  __host__ __device__ static int lda(int k_tb) { return k_tb + 8; }
  __host__ __device__ static int a_bytes(int k_tb) {
    return 2 * M_TB * lda(k_tb);
  }
  __host__ static size_t smem(int k_tb) {
    return (size_t)a_bytes(k_tb) + 2 * (size_t)N_TB * lda(k_tb);
  }
  __device__ static void put_a(uint16_t* a_s, int idx, uint32_t w) {
    a_s[idx] = (uint16_t)(w >> 16);
  }
  __device__ static void stage_b(uint16_t* b_s, const __nv_bfloat16* bt,
                                 int n, int k_tb) {
    const int ld = lda(k_tb);
    const uint16_t* src = reinterpret_cast<const uint16_t*>(bt);
    for (int i = threadIdx.x; i < k_tb * N_TB; i += THREADS) {
      const int kk = i / N_TB, nn = i % N_TB;
      b_s[nn * ld + kk] = src[(size_t)kk * n + nn];
    }
  }
  __device__ static uint32_t ld32(const uint16_t* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  __device__ static void compute(float (&acc)[ACC], const uint16_t* a_s,
                                 const uint16_t* b_s, int k_tb) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int gid = lane >> 2, tig = lane & 3;
    const int ng = warp / STRIPS, ld = lda(k_tb);
    const uint16_t* a = a_s + ((warp % STRIPS) * 16 + gid) * ld + tig * 2;
    for (int kk = 0; kk < k_tb; kk += 16) {
      const uint32_t a0 = ld32(a + kk), a1 = ld32(a + 8 * ld + kk);
      const uint32_t a2 = ld32(a + kk + 8), a3 = ld32(a + 8 * ld + kk + 8);
#pragma unroll
      for (int q = 0; q < TPW; ++q) {
        const int j = ng + q * WN;
        if (j >= NT) break;
        const uint16_t* b = b_s + (j * 8 + gid) * ld + tig * 2 + kk;
        const uint32_t b0 = ld32(b), b1 = ld32(b + 8);
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+f"(acc[4 * q]), "+f"(acc[4 * q + 1]), "+f"(acc[4 * q + 2]),
              "+f"(acc[4 * q + 3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      }
    }
  }
  // Accumulator 4q + c is fragment element c of n tile ng + q * WN: rows
  // gid (c < 2) and gid + 8, columns 2 * tig + (c & 1).
  __device__ static bool coord(int e, int& row, int& col) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int j = warp / STRIPS + (e >> 2) * WN;
    row = (warp % STRIPS) * 16 + (lane >> 2) + ((e & 3) >> 1) * 8;
    col = j * 8 + (lane & 3) * 2 + (e & 1);
    return j < NT;
  }
};

template <typename T, int M_TB, int N_TB> struct TileOf;
template <int M_TB, int N_TB> struct TileOf<float, M_TB, N_TB> {
  using type = FmaTile<M_TB, N_TB>;
};
template <int M_TB, int N_TB> struct TileOf<__nv_bfloat16, M_TB, N_TB> {
  using type = MmaTile<M_TB, N_TB>;
};

struct Args {
  const uint32_t* words;  // [G, Mt, Kt, max_nnz]
  const int32_t* nnz;     // [G, Mt, Kt]
  const void* b;          // [K, N] bf16 or f32, row-major
  const float* bias;      // [G, M] or nullptr
  float* partials;        // [S, G, M, N] (split-K only)
  void* out;              // [G, M, N], or [M, N] for binary epilogues
  int groups, m, k, n, m_tb, k_tb, n_tb, max_nnz, split_k, dtype, epilogue;
  cudaStream_t stream;
};

// The K tiles [kt_begin, kt_end) of one (m tile, n tile) for all G weights.
template <int G, int M_TB, int N_TB, typename Tile, typename T>
__device__ __forceinline__ void accumulate(
    float (&acc)[G][Tile::ACC], const Args& a, const T* __restrict__ b,
    int mi, int ni, int kt_begin, int kt_end, typename Tile::Elem* a_s,
    typename Tile::Elem* b_s) {
  const int k_tb = a.k_tb, ld = Tile::lda(k_tb);
  const int mt_count = a.m / M_TB, kt_count = a.k / k_tb;
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < Tile::ACC; ++e) acc[g][e] = 0.0f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    int live = 0;
#pragma unroll
    for (int g = 0; g < G; ++g)
      live |= a.nnz[(g * mt_count + mi) * kt_count + kt];
    if (live == 0) continue;  // uniform across the block
    __syncthreads();          // readers of the previous tiles are done
    Tile::stage_b(b_s, b + (size_t)kt * k_tb * a.n + (size_t)ni * N_TB, a.n,
                  k_tb);
    bool first = true;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      int cnt = a.nnz[(g * mt_count + mi) * kt_count + kt];
      cnt = cnt < a.max_nnz ? cnt : a.max_nnz;
      if (cnt <= 0) continue;
      if (!first) __syncthreads();  // readers of the last weight are done
      first = false;
      zero_smem(a_s, Tile::a_bytes(k_tb));
      __syncthreads();
      const uint32_t* wt =
          a.words + ((size_t)(g * mt_count + mi) * kt_count + kt) * a.max_nnz;
      for (int i = threadIdx.x; i < cnt; i += THREADS) {
        const uint32_t w = wt[i];
        const int loc = (int)(w & 0xFFFFu);
        const int r = loc / k_tb;
        Tile::put_a(a_s, r * ld + (loc - r * k_tb), w);
      }
      __syncthreads();  // the A tile (and, the first time, B) is complete
      Tile::compute(acc[g], a_s, b_s, k_tb);
    }
  }
}

// Bias + epilogue + one cast for output (row, col). `acc_of(g)` is group g's
// f32 sum; unary epilogues write each group, binary ones combine the pair.
template <int G, typename T, typename AccOf>
__device__ __forceinline__ void flush_value(const Args& a, int row, int col,
                                            AccOf acc_of) {
  T* out = static_cast<T*>(a.out);
  if (a.epilogue >= EPI_SILU_MUL) {
    float x0 = acc_of(0), x1 = acc_of(G > 1 ? 1 : 0);
    if (a.bias != nullptr) {
      x0 = __fadd_rn(x0, a.bias[row]);
      x1 = __fadd_rn(x1, a.bias[a.m + row]);
    }
    store(out + (size_t)row * a.n + col, binary(a.epilogue, x0, x1));
    return;
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float v = acc_of(g);
    if (a.bias != nullptr) v = __fadd_rn(v, a.bias[(size_t)g * a.m + row]);
    store(out + ((size_t)g * a.m + row) * a.n + col, unary(a.epilogue, v));
  }
}

template <bool SPLIT, int G, int M_TB, int N_TB, typename T>
__global__ void __launch_bounds__(THREADS)
    lscd_kernel(const Args a) {
  using Tile = typename TileOf<T, M_TB, N_TB>::type;
  using Elem = typename Tile::Elem;
  extern __shared__ __align__(16) unsigned char smem[];
  Elem* a_s = reinterpret_cast<Elem*>(smem);
  Elem* b_s = reinterpret_cast<Elem*>(smem + Tile::a_bytes(a.k_tb));
  const int mi = blockIdx.x, ni = blockIdx.y, s = blockIdx.z;
  const int kt_count = a.k / a.k_tb;
  int kt_begin = 0, kt_end = kt_count;
  if (SPLIT) {
    const int chunk = (kt_count + a.split_k - 1) / a.split_k;
    kt_begin = min(s * chunk, kt_count);  // the ragged last slice is short
    kt_end = min(kt_begin + chunk, kt_count);
  }
  float acc[G][Tile::ACC];
  accumulate<G, M_TB, N_TB, Tile, T>(acc, a, static_cast<const T*>(a.b), mi,
                                     ni, kt_begin, kt_end, a_s, b_s);
#pragma unroll
  for (int e = 0; e < Tile::ACC; ++e) {
    int r, c;
    if (!Tile::coord(e, r, c)) continue;
    const int row = mi * M_TB + r, col = ni * N_TB + c;
    if constexpr (SPLIT) {
#pragma unroll
      for (int g = 0; g < G; ++g)
        a.partials[(((size_t)s * G + g) * a.m + row) * a.n + col] = acc[g][e];
    } else {
      flush_value<G, T>(a, row, col, [&](int g) { return acc[g][e]; });
    }
  }
}

// Split-K reduce: one thread per (row, col); slices summed in order.
template <int G, typename T>
__global__ void __launch_bounds__(THREADS) splitk_reduce_kernel(const Args a) {
  const size_t idx = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (size_t)a.m * a.n) return;
  const int row = (int)(idx / a.n), col = (int)(idx % a.n);
  const size_t slice = (size_t)G * a.m * a.n;
  flush_value<G, T>(a, row, col, [&](int g) {
    const float* p = a.partials + ((size_t)g * a.m + row) * a.n + col;
    float v = p[0];
    for (int s = 1; s < a.split_k; ++s) v = __fadd_rn(v, p[s * slice]);
    return v;
  });
}

template <bool SPLIT, int G, int M_TB, int N_TB, typename T>
int launch_tile(const Args& a) {
  if constexpr (G * M_TB * N_TB / THREADS > MAX_ACC) {
    return (int)cudaErrorInvalidValue;  // refused by analysis/contracts.py
  } else {
    using Tile = typename TileOf<T, M_TB, N_TB>::type;
    const size_t smem = Tile::smem(a.k_tb);
    auto kern = lscd_kernel<SPLIT, G, M_TB, N_TB, T>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid(a.m / M_TB, a.n / N_TB, SPLIT ? a.split_k : 1);
    kern<<<grid, THREADS, smem, a.stream>>>(a);
    e = cudaGetLastError();
    if constexpr (SPLIT) {
      if (e != cudaSuccess) return (int)e;
      const size_t total = (size_t)a.m * a.n;
      const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
      splitk_reduce_kernel<G, T><<<blocks, THREADS, 0, a.stream>>>(a);
      e = cudaGetLastError();
    }
    return (int)e;
  }
}

// The pipelined body (hopper_pipe.cuh). GB weights per block: 2 for a
// binary epilogue, which combines the pair at the flush; else 1, with the
// weight in the grid (z = slice * G / GB + weight).
template <bool SPLIT, int G, int GB, int M_TB, int K_TB, int N_TB>
__global__ void __launch_bounds__(hpipe::THREADS, 1)
    lscd_pipe_kernel(const Args a) {
  using Gm = hpipe::Geom<M_TB, K_TB, N_TB>;
  extern __shared__ __align__(128) unsigned char pipe_smem[];
  unsigned char* base = hpipe::aligned_smem(pipe_smem);
  uint16_t* ring = reinterpret_cast<uint16_t*>(base);
  uint32_t* list = reinterpret_cast<uint32_t*>(base + Gm::RING_BYTES);
  constexpr int GZ = G / GB;
  const int ni = blockIdx.x, mi = blockIdx.y;
  const int s = blockIdx.z / GZ, g0 = (blockIdx.z % GZ) * GB;
  hpipe::Operands op;
  op.words = a.words;
  op.a = nullptr;
  op.b = static_cast<const uint16_t*>(a.b);
  op.k = a.k; op.n = a.n; op.max_nnz = a.max_nnz;
  op.mt_count = a.m / M_TB; op.kt_count = a.k / K_TB; op.g0 = g0;
  int kt_begin = 0, kt_end = op.kt_count;
  if (SPLIT) {
    const int chunk = (op.kt_count + a.split_k - 1) / a.split_k;
    kt_begin = min(s * chunk, op.kt_count);  // the ragged last slice is short
    kt_end = min(kt_begin + chunk, op.kt_count);
  }
  const int steps =
      hpipe::live_steps<GB>(list, a.nnz, op, mi, kt_begin, kt_end);
  float acc[GB][Gm::ACC];
  hpipe::mainloop<GB, M_TB, K_TB, N_TB, false>(acc, op, mi, ni, kt_begin,
                                              steps, list, ring);
  if (!Gm::multiplies()) return;  // a 64 x 64 tile keeps one warpgroup
  Args f = a;  // this block's weights: the outputs and biases of g0 on
  if (GB == 1) {
    f.out = static_cast<__nv_bfloat16*>(a.out) + (size_t)g0 * a.m * a.n;
    if (a.bias != nullptr) f.bias = a.bias + (size_t)g0 * a.m;
  }
#pragma unroll
  for (int e = 0; e < Gm::ACC; ++e) {
    int r, c;
    Gm::coord(e, r, c);
    const int row = mi * M_TB + r, col = ni * N_TB + c;
    if constexpr (SPLIT) {
#pragma unroll
      for (int g = 0; g < GB; ++g)
        a.partials[(((size_t)s * G + g0 + g) * a.m + row) * a.n + col] =
            acc[g][e];
    } else {
      flush_value<GB, __nv_bfloat16>(f, row, col,
                                     [&](int g) { return acc[g][e]; });
    }
  }
}

template <bool SPLIT, int G, int GB, int M_TB, int K_TB, int N_TB>
int launch_pipe(const Args& a) {
  using Gm = hpipe::Geom<M_TB, K_TB, N_TB>;
  if constexpr (GB * Gm::ACC > hpipe::MAX_ACC) {
    return (int)cudaErrorInvalidValue;  // refused by analysis/contracts.py
  } else {
    const int kt_count = a.k / K_TB;
    const int slices = SPLIT ? a.split_k : 1;
    if ((kt_count + slices - 1) / slices * GB > hpipe::MAX_STEPS)
      return (int)cudaErrorInvalidValue;
    const size_t smem = Gm::SMEM_BYTES;
    auto kern = lscd_pipe_kernel<SPLIT, G, GB, M_TB, K_TB, N_TB>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid(a.n / N_TB, a.m / M_TB, slices * (G / GB));
    kern<<<grid, hpipe::THREADS, smem, a.stream>>>(a);
    e = cudaGetLastError();
    if constexpr (SPLIT) {
      if (e != cudaSuccess) return (int)e;
      const size_t total = (size_t)a.m * a.n;
      const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
      splitk_reduce_kernel<G, __nv_bfloat16>
          <<<blocks, THREADS, 0, a.stream>>>(a);
      e = cudaGetLastError();
    }
    return (int)e;
  }
}

template <bool SPLIT, int G, int M_TB, int N_TB>
int launch_pipe_k(const Args& a) {
  constexpr int PAIR = G == 2 ? 2 : 1;  // a binary epilogue's block weights
  const bool pair = G == 2 && a.epilogue >= EPI_SILU_MUL;
  if (a.k_tb == 64)
    return pair ? launch_pipe<SPLIT, G, PAIR, M_TB, 64, N_TB>(a)
                : launch_pipe<SPLIT, G, 1, M_TB, 64, N_TB>(a);
  return pair ? launch_pipe<SPLIT, G, PAIR, M_TB, 128, N_TB>(a)
              : launch_pipe<SPLIT, G, 1, M_TB, 128, N_TB>(a);
}

template <bool SPLIT, int G, int M_TB, typename T>
int launch_n(const Args& a) {
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  switch (a.n_tb) {
    case 8: return launch_tile<SPLIT, G, M_TB, 8, T>(a);
    case 16: return launch_tile<SPLIT, G, M_TB, 16, T>(a);
    case 32: return launch_tile<SPLIT, G, M_TB, 32, T>(a);
    case 64:
      if constexpr (BF16) return launch_pipe_k<SPLIT, G, M_TB, 64>(a);
      else return launch_tile<SPLIT, G, M_TB, 64, T>(a);
    case 128:
      if constexpr (BF16) return launch_pipe_k<SPLIT, G, M_TB, 128>(a);
      else return launch_tile<SPLIT, G, M_TB, 128, T>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool SPLIT, int G, typename T>
int launch_m(const Args& a) {
  if (a.k_tb != 64 && a.k_tb != 128) return (int)cudaErrorInvalidValue;
  switch (a.m_tb) {
    case 64: return launch_n<SPLIT, G, 64, T>(a);
    case 128: return launch_n<SPLIT, G, 128, T>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <bool SPLIT, int G>
int launch_t(const Args& a) {
  // dtype: 0 = float32, 1 = bfloat16 (B and C share it).
  if (a.dtype == 0) return launch_m<SPLIT, G, float>(a);
  if (a.dtype == 1) return launch_m<SPLIT, G, __nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}

template <bool SPLIT, bool GROUPED>
int launch(const Args& a) {
  if (a.m <= 0 || a.n <= 0 || a.n % a.n_tb || a.m % a.m_tb || a.k % a.k_tb)
    return (int)cudaErrorInvalidValue;
  if (SPLIT && a.split_k < 1) return (int)cudaErrorInvalidValue;
  if constexpr (GROUPED) {
    if (a.groups == 2) return launch_t<SPLIT, 2>(a);
    if (a.groups == 3) return launch_t<SPLIT, 3>(a);
    return (int)cudaErrorInvalidValue;
  } else {
    if (a.groups != 1 || a.epilogue >= EPI_SILU_MUL)
      return (int)cudaErrorInvalidValue;
    return launch_t<SPLIT, 1>(a);
  }
}

}  // namespace lscd

// Plain C entry shared by the four sources (one exported name each).
#define LSCD_DEFINE_ENTRY(NAME, SPLIT, GROUPED)                              \
  extern "C" int NAME(const void* words, const void* nnz, const void* b,     \
                      const void* bias, void* partials, void* out,           \
                      int groups, int m, int k, int n, int m_tb, int k_tb,   \
                      int n_tb, int max_nnz, int split_k, int dtype,         \
                      int epilogue, void* stream) {                          \
    lscd::Args a;                                                            \
    a.words = static_cast<const uint32_t*>(words);                           \
    a.nnz = static_cast<const int32_t*>(nnz);                                \
    a.b = b;                                                                 \
    a.bias = static_cast<const float*>(bias);                                \
    a.partials = static_cast<float*>(partials);                              \
    a.out = out;                                                             \
    a.groups = groups; a.m = m; a.k = k; a.n = n;                            \
    a.m_tb = m_tb; a.k_tb = k_tb; a.n_tb = n_tb; a.max_nnz = max_nnz;        \
    a.split_k = split_k; a.dtype = dtype; a.epilogue = epilogue;             \
    a.stream = static_cast<cudaStream_t>(stream);                            \
    return lscd::launch<SPLIT, GROUPED>(a);                                  \
  }
