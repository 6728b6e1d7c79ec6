// Load-as-Sparse / Compute-as-Dense SpMM for Hopper (sm_90a): shared body.
//
// C[G, M, N] = epilogue(decode(A_g)[M, K] @ B[K, N] + bias_g), A_g in padded
// Tiled-CSL: per (m_tb x k_tb) tile a list of 32-bit words, each a bf16 value
// (bits 31..16) and a 16-bit intra-tile location row * k_tb + col (bits
// 15..0), padded with zero words to max_nnz; nnz[g][mt][kt] holds the count.
//
// Three bodies, chosen by dtype and N tile (the same rule for the
// single-pass and the split-K kernels, so split_k == 1 bit-matches the
// single-pass kernel at every n_tb; analysis/contracts.py states it):
//
// * bf16 B with n_tb <= 32 (decode): the decode body of lscd_decode.cuh,
//   bounded by the words' bytes: words and B copied by cp.async.bulk into
//   shared-memory slots ahead of their use, a live-step list, one dense A
//   tile rebuilt per step, mma.sync m16n8k16, four blocks per SM.
// * bf16 B with n_tb >= 64 (prefill): the pipelined wgmma mainloop of
//   hopper_pipe.cuh, bounded by the tensor cores.
//   Both bf16 bodies run one (weight or binary pair, m tile, n tile[, K
//   slice]) per block, n tiles fastest in the grid so that the blocks
//   sharing a weight tile's words run together and find them in L2.
// * f32 B (the tests' and the plain-version checks' full-f32 path): the
//   first body, below. One block of THREADS threads owns one (m tile,
//   n tile[, K slice]) for all G weights; for each K tile with words it
//   stages the B tile, then per weight zeroes a dense f32 A tile, stores
//   the tile's first nnz words into it (a padding word, (+0.0 | loc 0),
//   never overwrites (0, 0)) and runs CUDA-core f32 FMAs into per-thread
//   accumulators acc[G][...].
// The single-pass kernels flush bias + epilogue + one cast; the split-K
// kernels write f32 partials [S, G, M, N] and a reduce kernel sums the S
// slices in slice order (no atomics), then applies the same flush_value().
//
// Expert-batched launches (lscd_spmm_batched.cu, lscd_spmm_splitk_batched.cu;
// the counterpart of jax.vmap over the TPU kernels in repro/models/moe.py,
// which Pallas batches into one pallas_call with the expert axis in the
// grid): C[e] = decode(A[e]) @ B[e] for the E experts of a stacked
// Tiled-CSL weight, words [E, Mt, Kt, max_nnz], B [E, K, N], C [E, M, N],
// in one launch (one partials launch and one reduce over [S, E, M, N] for
// split-K). The expert is one more grid index: weight w = e * G + g, z =
// slice * E * G / GB + w / GB in the bf16 bodies (Args::experts E, G = 1),
// z = slice * E + e in the first body; words, counts, B rows and outputs
// are offset by it. No bias, no epilogue.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_pipe.cuh"
#include "lscd_decode.cuh"

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

struct Args {
  const uint32_t* words;  // [E, G, Mt, Kt, max_nnz]
  const int32_t* nnz;     // [E, G, Mt, Kt]
  const void* b;          // [E, K, N] bf16 or f32, row-major
  const float* bias;      // [G, M] or nullptr
  float* partials;        // [S, E, G, M, N] (split-K only)
  void* out;              // [E, G, M, N], or [M, N] for binary epilogues
  int groups, m, k, n, m_tb, k_tb, n_tb, max_nnz, split_k, dtype, epilogue;
  int ring;               // word slots of the decode body's ring
  int experts;            // E of an expert-batched launch, else 1
  cudaStream_t stream;
};

// Expert ex's operands in the first body: its words, counts, B and output.
template <int G>
__device__ __forceinline__ Args for_expert(const Args& a, int ex) {
  Args x = a;
  const size_t tiles = (size_t)ex * G * (a.m / a.m_tb) * (a.k / a.k_tb);
  x.words = a.words + tiles * a.max_nnz;
  x.nnz = a.nnz + tiles;
  x.b = static_cast<const float*>(a.b) + (size_t)ex * a.k * a.n;
  x.out = static_cast<float*>(a.out) + (size_t)ex * G * a.m * a.n;
  return x;
}

// The first body: the K tiles [kt_begin, kt_end) of one (m tile, n tile)
// for all G weights, f32.
template <int G, int M_TB, int N_TB>
__device__ __forceinline__ void accumulate(
    float (&acc)[G][FmaTile<M_TB, N_TB>::ACC], const Args& a,
    const float* __restrict__ b, int mi, int ni, int kt_begin, int kt_end,
    float* a_s, float* b_s) {
  using Tile = FmaTile<M_TB, N_TB>;
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

template <bool SPLIT, int G, int M_TB, int N_TB>
__global__ void __launch_bounds__(THREADS)
    lscd_kernel(const Args a) {
  using Tile = FmaTile<M_TB, N_TB>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* a_s = reinterpret_cast<float*>(smem);
  float* b_s = reinterpret_cast<float*>(smem + Tile::a_bytes(a.k_tb));
  const int mi = blockIdx.x, ni = blockIdx.y;
  const int s = blockIdx.z / a.experts, ex = blockIdx.z % a.experts;
  const Args x = for_expert<G>(a, ex);
  const int kt_count = a.k / a.k_tb;
  int kt_begin = 0, kt_end = kt_count;
  if (SPLIT) {
    const int chunk = (kt_count + a.split_k - 1) / a.split_k;
    kt_begin = min(s * chunk, kt_count);  // the ragged last slice is short
    kt_end = min(kt_begin + chunk, kt_count);
  }
  float acc[G][Tile::ACC];
  accumulate<G, M_TB, N_TB>(acc, x, static_cast<const float*>(x.b), mi, ni,
                            kt_begin, kt_end, a_s, b_s);
#pragma unroll
  for (int e = 0; e < Tile::ACC; ++e) {
    int r, c;
    Tile::coord(e, r, c);
    const int row = mi * M_TB + r, col = ni * N_TB + c;
    if constexpr (SPLIT) {
#pragma unroll
      for (int g = 0; g < G; ++g)
        a.partials[(((size_t)s * a.experts * G + ex * G + g) * a.m + row) *
                       a.n + col] = acc[g][e];
    } else {
      flush_value<G, float>(x, row, col, [&](int g) { return acc[g][e]; });
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

// After a split-K partials launch that returned e: the reduce. A batched
// launch (G == 1, no bias) reduces its E experts' outputs as E * M rows.
template <bool SPLIT, int G, typename T>
int then_reduce(const Args& a, cudaError_t e) {
  if constexpr (SPLIT) {
    if (e != cudaSuccess) return (int)e;
    Args r = a;
    r.m = a.m * a.experts;
    const size_t total = (size_t)r.m * r.n;
    const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
    splitk_reduce_kernel<G, T><<<blocks, THREADS, 0, a.stream>>>(r);
    e = cudaGetLastError();
  }
  return (int)e;
}

template <bool SPLIT, int G, int M_TB, int N_TB>
int launch_tile(const Args& a) {
  if constexpr (G * M_TB * N_TB / THREADS > MAX_ACC) {
    return (int)cudaErrorInvalidValue;  // refused by analysis/contracts.py
  } else {
    const size_t smem = FmaTile<M_TB, N_TB>::smem(a.k_tb);
    auto kern = lscd_kernel<SPLIT, G, M_TB, N_TB>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid(a.m / M_TB, a.n / N_TB, (SPLIT ? a.split_k : 1) * a.experts);
    kern<<<grid, THREADS, smem, a.stream>>>(a);
    return then_reduce<SPLIT, G, float>(a, cudaGetLastError());
  }
}

// A bf16 body's block: its K tiles, and the weights g0 .. g0 + GB - 1 it
// accumulates (of the E * G of a batched launch). GB is 2 for a binary
// epilogue, which combines the pair at the flush; else 1, with the weight
// in the grid (z = slice * E * G / GB + weight / GB) and n tiles fastest.
template <bool SPLIT, int G, int GB>
struct BlockWork {
  int ni, mi, s, g0, kt_begin, kt_end;
  __device__ BlockWork(const Args& a, int kt_count) {
    const int gz = G / GB * a.experts;
    ni = blockIdx.x;
    mi = blockIdx.y;
    s = blockIdx.z / gz;
    g0 = (blockIdx.z % gz) * GB;
    kt_begin = 0;
    kt_end = kt_count;
    if (SPLIT) {
      const int chunk = (kt_count + a.split_k - 1) / a.split_k;
      kt_begin = min(s * chunk, kt_count);  // the ragged last slice is short
      kt_end = min(kt_begin + chunk, kt_count);
    }
  }
};

// Writes a bf16 body's accumulators (tile-local coordinates from Gm):
// f32 partials of weights g0 .. g0 + GB - 1, or bias + epilogue + one cast.
template <bool SPLIT, int G, int GB, class Gm, int M_TB, int N_TB, int ACC>
__device__ __forceinline__ void flush_bf16(const Args& a,
                                           const BlockWork<SPLIT, G, GB>& w,
                                           float (&acc)[GB][ACC]) {
  Args f = a;  // this block's weights: the outputs and biases of g0 on
  if (GB == 1) {
    f.out = static_cast<__nv_bfloat16*>(a.out) + (size_t)w.g0 * a.m * a.n;
    if (a.bias != nullptr) f.bias = a.bias + (size_t)w.g0 * a.m;
  }
#pragma unroll
  for (int e = 0; e < ACC; ++e) {
    int r, c;
    Gm::coord(e, r, c);
    const int row = w.mi * M_TB + r, col = w.ni * N_TB + c;
    if constexpr (SPLIT) {
#pragma unroll
      for (int g = 0; g < GB; ++g)
        a.partials[(((size_t)w.s * G * a.experts + w.g0 + g) * a.m + row) *
                       a.n + col] = acc[g][e];
    } else {
      flush_value<GB, __nv_bfloat16>(f, row, col,
                                     [&](int g) { return acc[g][e]; });
    }
  }
}

// Weight g0's operands in a bf16 body: B's rows of expert g0 / G.
template <int G>
__device__ __forceinline__ hpipe::Operands operands(const Args& a, int m_tb,
                                                   int k_tb, int g0) {
  hpipe::Operands op;
  op.words = a.words;
  op.b = static_cast<const uint16_t*>(a.b);
  op.k = a.k; op.n = a.n; op.max_nnz = a.max_nnz;
  op.mt_count = a.m / m_tb; op.kt_count = a.k / k_tb; op.g0 = g0;
  op.b_row0 = g0 / G * a.k;
  return op;
}

// The decode body (lscd_decode.cuh). Shared memory: the A tile, the B and
// word slots, their mbarriers, then the live-step list.
template <bool SPLIT, int G, int GB, int M_TB, int K_TB, int N_TB>
__global__ void __launch_bounds__(ldec::THREADS,
                                  ldec::Geom<M_TB, K_TB, N_TB>::MIN_BLOCKS)
    lscd_decode_kernel(const Args a) {
  using Gm = ldec::Geom<M_TB, K_TB, N_TB>;
  extern __shared__ __align__(128) unsigned char dec_smem[];
  const BlockWork<SPLIT, G, GB> w(a, a.k / K_TB);
  const ldec::Layout<M_TB, K_TB, N_TB> lay(a.max_nnz, a.ring, 0);
  ldec::init_ring(reinterpret_cast<uint64_t*>(dec_smem + lay.bars), a.ring);
  uint32_t* list = reinterpret_cast<uint32_t*>(dec_smem + lay.list);
  const hpipe::Operands op = operands<G>(a, M_TB, K_TB, w.g0);
  // live_steps' barriers also publish the ring's mbarriers
  const int steps = hpipe::live_steps<GB, ldec::THREADS>(
      list, a.nnz, op, w.mi, w.kt_begin, w.kt_end);
  float acc[GB][Gm::ACC];
  ldec::mainloop<GB, M_TB, K_TB, N_TB>(acc, op, w.mi, w.ni, w.kt_begin, steps,
                                       a.ring, list, dec_smem);
  if (!Gm::multiplies()) return;  // m_tb = 64: warps 4..7 hold no outputs
  flush_bf16<SPLIT, G, GB, Gm, M_TB, N_TB>(a, w, acc);
}

template <bool SPLIT, int G, int GB, int M_TB, int K_TB, int N_TB>
int launch_decode(const Args& a) {
  const int kt_count = a.k / K_TB;
  const int slices = SPLIT ? a.split_k : 1;
  const int steps = (kt_count + slices - 1) / slices * GB;
  if (steps > hpipe::MAX_STEPS || a.ring < 1 || a.max_nnz % 4 ||
      a.n % 8)
    return (int)cudaErrorInvalidValue;  // refused by analysis/contracts.py
  const size_t smem =
      ldec::Layout<M_TB, K_TB, N_TB>(a.max_nnz, a.ring, steps).total;
  auto kern = lscd_decode_kernel<SPLIT, G, GB, M_TB, K_TB, N_TB>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.n / N_TB, a.m / M_TB, slices * (G / GB) * a.experts);
  kern<<<grid, ldec::THREADS, smem, a.stream>>>(a);
  return then_reduce<SPLIT, G, __nv_bfloat16>(a, cudaGetLastError());
}

// The pipelined body (hopper_pipe.cuh), sparse A source. Shared memory:
// the ring, its mbarriers, then the live-step list.
template <bool SPLIT, int G, int GB, int M_TB, int K_TB, int N_TB>
__global__ void __launch_bounds__(hpipe::Source<false>::THREADS, 1)
    lscd_pipe_kernel(const Args a, const __grid_constant__ CUtensorMap map_b) {
  using Gm = hpipe::Geom<M_TB, K_TB, N_TB>;
  using L = hpipe::SparseLayout<M_TB, K_TB, N_TB>;
  extern __shared__ __align__(128) unsigned char pipe_smem[];
  unsigned char* base = hpipe::aligned_smem(pipe_smem);
  uint16_t* ring = reinterpret_cast<uint16_t*>(base);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::RING_BYTES);
  uint64_t* empty = full + hpipe::STAGES;
  uint32_t* list =
      reinterpret_cast<uint32_t*>(base + L::RING_BYTES + L::BAR_BYTES);
  hpipe::init_ring<Gm>(full, empty, hpipe::STAGES, 1 + hpipe::PRODUCERS);
  const BlockWork<SPLIT, G, GB> w(a, a.k / K_TB);
  const hpipe::Operands op = operands<G>(a, M_TB, K_TB, w.g0);
  // live_steps' barriers also publish the ring's mbarriers
  const int steps = hpipe::live_steps<GB, hpipe::Source<false>::THREADS>(
      list, a.nnz, op, w.mi, w.kt_begin, w.kt_end);
  if (threadIdx.x >= hpipe::CONSUMERS) {
    hpipe::sparse_producer<GB, M_TB, K_TB, N_TB>(
        op, &map_b, w.mi, w.ni, w.kt_begin, steps, list, ring, full, empty);
  } else if (Gm::multiplies()) {  // a 64 x 64 tile keeps one warpgroup
    float acc[GB][Gm::ACC];
    hpipe::sparse_consumer<GB, M_TB, K_TB, N_TB>(acc, steps, list, ring,
                                                 full, empty);
    flush_bf16<SPLIT, G, GB, Gm, M_TB, N_TB>(a, w, acc);
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
    CUtensorMap map_b;
    const int rc = hpipe::make_map(&map_b, a.b, a.experts * a.k, a.n, K_TB);
    if (rc != 0) return rc;
    const size_t smem = hpipe::SparseLayout<M_TB, K_TB, N_TB>::SMEM_BYTES;
    auto kern = lscd_pipe_kernel<SPLIT, G, GB, M_TB, K_TB, N_TB>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid(a.n / N_TB, a.m / M_TB, slices * (G / GB) * a.experts);
    kern<<<grid, hpipe::Source<false>::THREADS, smem, a.stream>>>(a, map_b);
    return then_reduce<SPLIT, G, __nv_bfloat16>(a, cudaGetLastError());
  }
}

// A bf16 body at one (m_tb, n_tb): k_tb and the block's weights picked.
template <bool SPLIT, int G, int GB, int M_TB, int K_TB, int N_TB>
int launch_bf16(const Args& a) {
  if constexpr (N_TB <= 32)
    return launch_decode<SPLIT, G, GB, M_TB, K_TB, N_TB>(a);
  else
    return launch_pipe<SPLIT, G, GB, M_TB, K_TB, N_TB>(a);
}

template <bool SPLIT, int G, int M_TB, int N_TB>
int launch_bf16_k(const Args& a) {
  constexpr int PAIR = G == 2 ? 2 : 1;  // a binary epilogue's block weights
  const bool pair = G == 2 && a.epilogue >= EPI_SILU_MUL;
  if (a.k_tb == 64)
    return pair ? launch_bf16<SPLIT, G, PAIR, M_TB, 64, N_TB>(a)
                : launch_bf16<SPLIT, G, 1, M_TB, 64, N_TB>(a);
  return pair ? launch_bf16<SPLIT, G, PAIR, M_TB, 128, N_TB>(a)
              : launch_bf16<SPLIT, G, 1, M_TB, 128, N_TB>(a);
}

template <bool SPLIT, int G, int M_TB, int N_TB, typename T>
int launch_body(const Args& a) {
  if constexpr (std::is_same<T, float>::value)
    return launch_tile<SPLIT, G, M_TB, N_TB>(a);
  else
    return launch_bf16_k<SPLIT, G, M_TB, N_TB>(a);
}

template <bool SPLIT, int G, int M_TB, typename T>
int launch_n(const Args& a) {
  switch (a.n_tb) {
    case 8: return launch_body<SPLIT, G, M_TB, 8, T>(a);
    case 16: return launch_body<SPLIT, G, M_TB, 16, T>(a);
    case 32: return launch_body<SPLIT, G, M_TB, 32, T>(a);
    case 64: return launch_body<SPLIT, G, M_TB, 64, T>(a);
    case 128: return launch_body<SPLIT, G, M_TB, 128, T>(a);
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

// The grid's z extent (analysis/contracts.py: MAX_GRID_Z).
constexpr int MAX_GRID_Z = 65535;

template <bool SPLIT, bool GROUPED>
int launch(const Args& a) {
  if (a.m <= 0 || a.n <= 0 || a.n % a.n_tb || a.m % a.m_tb || a.k % a.k_tb)
    return (int)cudaErrorInvalidValue;
  if (a.experts < 1 ||
      (long long)(SPLIT ? a.split_k : 1) * a.groups * a.experts > MAX_GRID_Z)
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

// Plain C entry shared by the four single-weight-stack sources (one
// exported name each).
#define LSCD_DEFINE_ENTRY(NAME, SPLIT, GROUPED)                              \
  extern "C" int NAME(const void* words, const void* nnz, const void* b,     \
                      const void* bias, void* partials, void* out,           \
                      int groups, int m, int k, int n, int m_tb, int k_tb,   \
                      int n_tb, int max_nnz, int split_k, int dtype,         \
                      int epilogue, int ring, void* stream) {                \
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
    a.ring = ring;                                                           \
    a.experts = 1;                                                           \
    a.stream = static_cast<cudaStream_t>(stream);                            \
    return lscd::launch<SPLIT, GROUPED>(a);                                  \
  }

// Plain C entry of the two expert-batched sources: E experts' stacked
// words, B [E, K, N] and C [E, M, N]; no bias, no epilogue.
#define LSCD_DEFINE_BATCHED_ENTRY(NAME, SPLIT)                               \
  extern "C" int NAME(const void* words, const void* nnz, const void* b,     \
                      void* partials, void* out, int experts, int m, int k,  \
                      int n, int m_tb, int k_tb, int n_tb, int max_nnz,      \
                      int split_k, int dtype, int ring, void* stream) {      \
    lscd::Args a;                                                            \
    a.words = static_cast<const uint32_t*>(words);                           \
    a.nnz = static_cast<const int32_t*>(nnz);                                \
    a.b = b;                                                                 \
    a.bias = nullptr;                                                        \
    a.partials = static_cast<float*>(partials);                              \
    a.out = out;                                                             \
    a.groups = 1; a.m = m; a.k = k; a.n = n;                                 \
    a.m_tb = m_tb; a.k_tb = k_tb; a.n_tb = n_tb; a.max_nnz = max_nnz;        \
    a.split_k = split_k; a.dtype = dtype; a.epilogue = lscd::EPI_NONE;       \
    a.ring = ring;                                                           \
    a.experts = experts;                                                     \
    a.stream = static_cast<cudaStream_t>(stream);                            \
    return lscd::launch<SPLIT, false>(a);                                    \
  }
