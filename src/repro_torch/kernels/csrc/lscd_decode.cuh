// The decode body of the LSCD kernels for Hopper (sm_90a): bf16 B with
// n_tb <= 32, the skinny N of a decode step.
//
// Replaces the K loop of the TPU kernels repro/kernels/spmm.py:
// _lscd_spmm_splitk_kernel / _lscd_spmm_splitk_grouped_kernel (and of
// _lscd_spmm_kernel / _lscd_spmm_grouped_kernel at those N tiles), where
// Pallas's grid pipeline streams each tile's words into VMEM and the MXU
// multiplies the rebuilt tile.
//
// What bounds it on an H100: bytes. At N = 8 the useful operations,
// 2 * nnz * N, need about 1% of the time the weight words (4 bytes per kept
// weight) need at 3.35 TB/s, so every choice here is on the memory side.
// A block's rebuild of a dense tile (zero it, store each word, read it back
// as mma fragments: some 1,000 shared-memory wavefronts for 13 KB of words
// at 0.8 sparsity) takes about as long as its share of the memory stream,
// so the design keeps many blocks on each SM, and each block's copies ahead
// of its rebuild:
//
// * Words by asynchronous copy. A tile's words are one contiguous run that
//   starts 16-byte aligned (max_nnz is a multiple of 4; the encoder pads it
//   to a multiple of 128). One thread copies the first ceil(nnz / 4) * 4
//   words of each live step, never the padding beyond, with cp.async.bulk
//   (the 1-D TMA copy) into a word slot in shared memory, and the step's B
//   tile (k_tb x n_tb bf16, as it lies) into a B slot; both complete on the
//   word slot's mbarrier. (16-byte cp.async from every thread, each then
//   storing the words it copied, was slower.) The number of word slots
//   comes with the launch (analysis/contracts.py: decode_ring_depth): as
//   many as keep the most blocks resident on an SM, one at 0.8 sparsity
//   and n_tb <= 16, which gives four blocks per SM; a deeper ring that
//   costs a resident block is slower.
// * A live-step list. The block first compacts its (K tile, weight) steps
//   with nnz > 0 into shared memory (hpipe::live_steps), so an empty tile
//   costs no round trip and a K slice with no live step writes zeros.
// * One dense A tile, two barriers a step. After step i's first barrier,
//   warp w multiplies its 16-row strip of the tile with mma.sync m16n8k16
//   (bf16 -> f32, fragments by ldmatrix from a 128-byte-swizzled tile) and
//   zeroes that same strip, which no other warp reads; after the second
//   barrier every thread stores step i+1's words from its slot into the
//   tile. Only the first nnz words are stored, so a padding word
//   (+0.0 | loc 0) never overwrites (0, 0); a warp's lanes store
//   consecutive words, which the encoding's interleave order spreads over
//   the eight row classes (row % 8) and so over distinct banks of the
//   swizzled tile. A second A tile would save the second barrier but cost
//   32 KB, two of four resident blocks (PERF.md, PR 13).
//
// Each weight's steps run in K-tile order into its own accumulators, in the
// single-pass and the split-K kernels alike, so split_k == 1 bit-matches the
// single-pass kernel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_pipe.cuh"

namespace ldec {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// The mbarrier helpers of hopper_pipe.cuh (a wait that never completes
// traps after about two seconds instead of hanging the card).
using hpipe::mbar_expect_tx;
using hpipe::mbar_init;
using hpipe::mbar_wait;
using hpipe::smem_u32;

// cp.async.bulk: `bytes` (a multiple of 16) from global to shared memory,
// both 16-byte aligned, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Tiles of one launch geometry. Warp w < STRIPS owns rows 16w .. 16w + 15
// of the block's tile and all N_TB columns (NT n8 tiles): four f32
// accumulators per n8 tile and weight. At m_tb = 64 warps 4..7 only copy
// and rebuild.
template <int M_TB, int K_TB, int N_TB>
struct Geom {
  static constexpr int STRIPS = M_TB / 16;
  static constexpr int NT = N_TB / 8;
  static constexpr int ACC = 4 * NT;
  static constexpr int A_ELEMS = M_TB * K_TB, B_ELEMS = K_TB * N_TB;
  // Blocks an SM is to hold (the launch bounds; analysis/contracts.py:
  // DECODE_REG_BLOCKS): an n_tb = 32 block needs more registers than four
  // blocks leave it.
  static constexpr int MIN_BLOCKS = N_TB <= 16 ? 4 : 2;
  static_assert(STRIPS <= WARPS, "a strip per warp");
  static_assert(NT * 8 == N_TB && N_TB <= 32, "decode N tile");
  static_assert(K_TB == 64 || K_TB == 128, "k_tb is 64 or 128");

  __device__ static bool multiplies() { return threadIdx.x / 32 < STRIPS; }
  // Tile-local (row, col) of accumulator e of a warp that multiplies.
  __device__ static void coord(int e, int& row, int& col) {
    const int lane = threadIdx.x % 32;
    row = (threadIdx.x / 32) * 16 + (lane >> 2) + ((e & 3) >> 1) * 8;
    col = (e >> 2) * 8 + (lane & 3) * 2 + (e & 1);
  }
};

// Byte offsets of one block's shared memory (analysis/contracts.py:
// decode_smem_bytes): the A tile, depth + 1 B slots and depth word slots of
// max_nnz words from 0, then depth mbarriers, then the live-step list of
// `steps` entries.
template <int M_TB, int K_TB, int N_TB>
struct Layout {
  size_t b_ring, w_ring, bars, list, total;
  __host__ __device__ Layout(int max_nnz, int depth, int steps) {
    using Gm = Geom<M_TB, K_TB, N_TB>;
    b_ring = (size_t)2 * Gm::A_ELEMS;
    w_ring = b_ring + (size_t)2 * (depth + 1) * Gm::B_ELEMS;
    bars = w_ring + (size_t)depth * 4 * max_nnz;
    list = bars + (size_t)8 * depth;
    total = list + (size_t)4 * steps;
  }
};

// Zeroes warp w's strip of a swizzled A tile: 16 rows of each 64-column
// panel, 2 KB contiguous.
template <int M_TB, int K_TB>
__device__ __forceinline__ void zero_strip(uint16_t* a_s) {
  const int lane = threadIdx.x % 32, strip = threadIdx.x / 32;
#pragma unroll
  for (int p = 0; p < K_TB / 64; ++p) {
    uint4* q = reinterpret_cast<uint4*>(a_s + (p * M_TB + strip * 16) * 64);
#pragma unroll
    for (int i = lane; i < 16 * 64 / 8; i += 32) q[i] = make_uint4(0, 0, 0, 0);
  }
}

// acc += warp w's strip of A_tile @ B_tile, K_TB / 16 mma.sync steps; then
// the warp zeroes the strip for the next step.
template <int M_TB, int K_TB, int N_TB>
__device__ __forceinline__ void mma_strip(float* acc, uint16_t* a_s,
                                          const uint16_t* b_s) {
  using Gm = Geom<M_TB, K_TB, N_TB>;
  const int lane = threadIdx.x % 32;
  // x4: lanes 0-15 address rows 0-15 at column kk, lanes 16-31 at kk + 8.
  const int row = (threadIdx.x / 32) * 16 + (lane & 15);
  const int col = (lane >> 4) * 8;
  // x2.trans: lanes 0-15 address k rows kk .. kk + 15 of an n8 tile.
  const uint16_t* b_row = b_s + (lane & 15) * N_TB;
#pragma unroll
  for (int kk = 0; kk < K_TB; kk += 16) {
    uint32_t a[4];
    ldsm_x4(a, a_s + hpipe::sw128<M_TB>(row, kk + col));
#pragma unroll
    for (int q = 0; q < Gm::NT; ++q) {
      uint32_t b[2];
      ldsm_x2_trans(b, b_row + kk * N_TB + q * 8);
      mma_bf16(acc + 4 * q, a, b);
    }
  }
  __syncwarp();  // the warp's fragment reads precede its zeroing
  zero_strip<M_TB, K_TB>(a_s);
}

// Stores a step's first cnt words from its slot into the zeroed A tile;
// word idx goes to thread idx % THREADS, four loads in flight.
template <int M_TB, int K_TB>
__device__ __forceinline__ void scatter(uint16_t* a_s, const uint32_t* w,
                                        int cnt) {
  constexpr int U = 4;
  for (int base = threadIdx.x; base < cnt; base += U * THREADS) {
    uint32_t v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + u * THREADS;
      v[u] = idx < cnt ? w[idx] : 0u;
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (base + u * THREADS < cnt) hpipe::put_word<M_TB, K_TB>(a_s, v[u]);
  }
}

// acc[g] += the live steps list[0 .. steps) of one (m tile, n tile[, K
// slice]), each one weight's K tile, in K-tile order. `op` carries the
// words, B and the geometry; GB weights from op.g0 share the block.
//
// Step i: after its first barrier the A tile holds step i, and step i's
// word slot and step i-1's B slot are free: warp 0 issues the copies of
// step i + depth into them, and the strips' owners multiply and zero. After
// the second barrier every thread waits for step i+1's copies and stores
// its share of the words.
template <int GB, int M_TB, int K_TB, int N_TB>
__device__ __forceinline__ void mainloop(
    float (&acc)[GB][Geom<M_TB, K_TB, N_TB>::ACC], const hpipe::Operands& op,
    int mi, int ni, int kt_begin, int steps, int depth, const uint32_t* list,
    unsigned char* smem) {
  using Gm = Geom<M_TB, K_TB, N_TB>;
  constexpr uint32_t B_BYTES = 2 * Gm::B_ELEMS;
  constexpr uint32_t MASK = (1u << hpipe::ENTRY_BITS) - 1u;
  const Layout<M_TB, K_TB, N_TB> lay(op.max_nnz, depth, 0);
  uint16_t* a_s = reinterpret_cast<uint16_t*>(smem);
  uint16_t* b_ring = reinterpret_cast<uint16_t*>(smem + lay.b_ring);
  uint32_t* w_ring = reinterpret_cast<uint32_t*>(smem + lay.w_ring);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int e = 0; e < Gm::ACC; ++e) acc[g][e] = 0.0f;
  if (steps == 0) return;

  // Warp 0 copies step j's words into word slot j % depth and its B tile
  // into B slot j % (depth + 1).
  auto issue = [&](int j) {
    const uint32_t entry = list[j];
    const int e = (int)(entry & MASK), cnt = (int)(entry >> hpipe::ENTRY_BITS);
    const int g = op.g0 + e % GB, kt = kt_begin + e / GB;
    uint64_t* bar = full + j % depth;
    const uint32_t w_bytes = (uint32_t)((cnt + 3) & ~3) * 4u;
    const uint16_t* b_src =
        op.b + (size_t)kt * K_TB * op.n + (size_t)ni * N_TB;
    uint16_t* b_dst = b_ring + (j % (depth + 1)) * Gm::B_ELEMS;
    if (lane == 0) mbar_expect_tx(bar, w_bytes + B_BYTES);
    __syncwarp();
    if (lane == 0) {
      bulk_copy(w_ring + (size_t)(j % depth) * op.max_nnz,
                op.words + (((size_t)g * op.mt_count + mi) * op.kt_count +
                            kt) * op.max_nnz,
                w_bytes, bar);
      if (op.n == N_TB) bulk_copy(b_dst, b_src, B_BYTES, bar);
    }
    if (op.n != N_TB)  // B rows lie op.n apart: one copy per row
      for (int r = lane; r < K_TB; r += 32)
        bulk_copy(b_dst + r * N_TB, b_src + (size_t)r * op.n, 2 * N_TB, bar);
  };
  // Every thread waits for step j's copies (its B tile is read by the
  // strips' owners in step j), then stores its share of the words.
  auto stage = [&](int j) {
    mbar_wait(full + j % depth, (uint32_t)((j / depth) & 1));
    scatter<M_TB, K_TB>(a_s, w_ring + (size_t)(j % depth) * op.max_nnz,
                        (int)(list[j] >> hpipe::ENTRY_BITS));
  };

  if (warp == 0)
    for (int j = 0; j < depth && j < steps; ++j) issue(j);
  for (int i = threadIdx.x; i < Gm::A_ELEMS / 8; i += THREADS)
    reinterpret_cast<uint4*>(a_s)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();  // the A tile is zero
  stage(0);

  for (int i = 0; i < steps; ++i) {
    __syncthreads();  // the A tile holds step i
    if (warp == 0 && i + depth < steps) issue(i + depth);
    if (Gm::multiplies()) {
      const uint16_t* b_s = b_ring + (i % (depth + 1)) * Gm::B_ELEMS;
      if constexpr (GB == 1) {
        mma_strip<M_TB, K_TB, N_TB>(acc[0], a_s, b_s);
      } else {
        const int g = (int)(list[i] & MASK) % GB;
#pragma unroll
        for (int gg = 0; gg < GB; ++gg)
          if (g == gg) mma_strip<M_TB, K_TB, N_TB>(acc[gg], a_s, b_s);
      }
    }
    if (i + 1 < steps) {
      __syncthreads();  // the A tile is zero
      stage(i + 1);
    }
  }
}

// The ring's mbarriers, initialised by one thread; the caller's next
// __syncthreads publishes them.
__device__ __forceinline__ void init_ring(uint64_t* full, int depth) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < depth; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

}  // namespace ldec
