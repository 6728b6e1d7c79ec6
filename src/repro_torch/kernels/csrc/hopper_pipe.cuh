// Pipelined bf16 tensor-core mainloop for Hopper (sm_90a), shared by the
// large-N LSCD kernels (n_tb >= 64) and the dense GEMM baseline.
//
// Replaces the K loop of the TPU kernels repro/kernels/spmm.py:
// _lscd_spmm_kernel / _lscd_spmm_grouped_kernel / _lscd_spmm_splitk_kernel
// and repro/kernels/gemm.py:_gemm_kernel, where Pallas's grid pipeline
// double-buffers each (A, B) block into VMEM and the MXU consumes it.
//
// What bounds it on an H100: at prefill N the work is compute-bound (2·nnz·N
// useful operations over 989 TFLOP/s; Compute-as-Dense does 2·M·K·N). The
// Load-as-Sparse side adds, per K tile, the word stream (4 bytes per kept
// weight, re-read from L2 once per N tile), the zeroing of a dense A tile
// and one 2-byte shared-memory store per word; those stores cost a block
// the most beyond the product itself (PERF.md). The design overlaps all of
// it with the tensor cores:
//
// * Tensor cores through wgmma (m64nNk16, bf16 -> f32), which reads both
//   operands from shared memory by descriptor. Warpgroups 0 and 1 (the
//   consumers) only multiply, each a 64-row or 64-column part of the tile,
//   accumulators in registers. Warpgroups 2 and 3 (the producers) load and
//   rebuild the tiles of later steps meanwhile. Keeping the producers'
//   branchy code out of the consumers' way lets ptxas keep wgmma
//   asynchronous.
// * A ring of STAGES = 3 slots in shared memory, each a B tile and a dense
//   A tile. B (and, for the dense GEMM, A) arrive by cp.async 16-byte
//   chunks two steps ahead of the product (one cp.async group per step).
// * Sparse A: the producers load the words of step i+2 into registers (one
//   coalesced word per lane) while step i is multiplied, and store them into
//   their slot while step i+1 is; slot i+2 is zeroed the same way. One
//   barrier per step separates producers from consumers. Only the first nnz
//   words of a tile are stored: a padding word (+0.0 | loc 0) never
//   overwrites (0, 0).
// * Both tiles are in wgmma's 128-byte-swizzled layout: panels of 64 bf16
//   columns, 16-byte chunk c of row r at chunk c ^ (r & 7). A is K-major
//   ([m][k] panels), B lies as in device memory ([k][n] panels, read
//   MN-major, "transposed"), so B is copied as it lies, 16 bytes a thread.
//   K_TB and N_TB are template constants: the scatter computes the
//   swizzled address of (row, col) with shifts and masks.
// * Empty steps never enter the ring: a block first compacts the list of
//   (K tile, weight) steps with nnz > 0 into shared memory (with their
//   counts), so the loop walks live steps only, in K-tile order.
//
// Not yet done here: TMA, wider N tiles (each weight tile is rebuilt once
// per 128 columns of B) and a persistent grid.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hpipe {

constexpr int THREADS = 512;  // four warpgroups
constexpr int STAGES = 3;
constexpr int MAX_STEPS = 2048;   // live-step list (analysis/contracts.py)
constexpr int WORD_REGS = 16;    // words a producer prefetches per tile
constexpr int SMEM_ALIGN = 1024;  // the 128-byte swizzle's period

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Generic-proxy writes (st.shared, cp.async) made visible to wgmma.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads of an accumulator across a wait.
__device__ __forceinline__ void fence_operand(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// wgmma.m64nNk16 bf16 x bf16 -> f32: A K-major, B MN-major (transposed).
__device__ __forceinline__ void wgmma_m64n64(float* d, uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128(float* d, uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Element offset of (row, col) in a 128-byte-swizzled tile of ROWS rows:
// panels of 64 columns, each ROWS x 128 bytes.
template <int ROWS>
__device__ __forceinline__ int sw128(int row, int col) {
  return ((col >> 6) * ROWS + row) * 64 +
         ((((col >> 3) & 7) ^ (row & 7)) << 3) + (col & 7);
}

// Warpgroups 0 and 1 multiply (the consumers); warpgroups 2 and 3 load and
// rebuild tiles (the producers). A consumer's code between a product's
// issue and its wait has no divergent branch, so ptxas keeps wgmma
// asynchronous; two producer warpgroups give the scatter two warps on each
// scheduler.
constexpr int CONSUMERS = 256, PRODUCERS = THREADS - CONSUMERS;
constexpr int MAX_ACC = 64;  // accumulators a thread (analysis/contracts.py)

template <int M_TB, int K_TB, int N_TB>
struct Geom {
  // The consumers split the tile into 64-row, then 64-column parts; a
  // 64 x 64 tile keeps one of them.
  static constexpr int WG_M = M_TB / 64;
  static constexpr int WG_N = (2 / WG_M < N_TB / 64) ? 2 / WG_M : N_TB / 64;
  static constexpr int WGS = WG_M * WG_N;  // warpgroups that multiply
  static constexpr int WN = N_TB / WG_N;   // wgmma N
  static constexpr int ACC = WN / 2;       // f32 accumulators per thread
  static constexpr int A_ELEMS = M_TB * K_TB, B_ELEMS = K_TB * N_TB;
  static_assert(WN == 64 || WN == 128, "wgmma N of 64 or 128");
  static_assert(K_TB == 64 || K_TB == 128, "k_tb is 64 or 128");
  // Ring of A and B tiles (1 KB aligned), then the live-step list.
  static constexpr size_t RING_BYTES =
      (size_t)STAGES * 2 * (A_ELEMS + B_ELEMS);
  static constexpr size_t SMEM_BYTES =
      SMEM_ALIGN + RING_BYTES + 4 * MAX_STEPS;

  __device__ static int wg() { return threadIdx.x >> 7; }
  __device__ static bool multiplies() { return wg() < WGS; }
  // Tile-local (row, col) of a consumer's accumulator e.
  __device__ static void coord(int e, int& row, int& col) {
    const int w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    row = (wg() / WG_N) * 64 + w * 16 + (lane >> 2) + ((e >> 1) & 1) * 8;
    col = (wg() % WG_N) * WN + (e >> 2) * 8 + (lane & 3) * 2 + (e & 1);
  }
};

// The block's dynamic shared memory, aligned to the swizzle's period.
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((SMEM_ALIGN - (a & (SMEM_ALIGN - 1))) & (SMEM_ALIGN - 1));
}

// A consumer's acc += its part of A_tile @ B_tile, one wgmma per k16
// step. Waits for it before returning.
template <class Gm, int M_TB, int K_TB>
__device__ __forceinline__ void mma_tile(float (&acc)[Gm::ACC],
                                         const uint16_t* a_s,
                                         const uint16_t* b_s) {
  const int wm = Gm::wg() / Gm::WG_N, wn = Gm::wg() % Gm::WG_N;
  const uint32_t a0 = smem_u32(a_s) + wm * 64 * 128;
  const uint32_t b0 = smem_u32(b_s) + ((wn * Gm::WN) >> 6) * K_TB * 128;
#pragma unroll
  for (int e = 0; e < Gm::ACC; ++e) fence_operand(acc[e]);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < K_TB; k += 16) {
    // A: 8-row groups 1 KB apart; a k16 step is 32 bytes into its panel.
    const uint64_t da =
        sw128_desc(a0 + (k >> 6) * M_TB * 128 + (k & 63) * 2, 16, 1024);
    // B: 8-row (k) groups 1 KB apart, 64-column panels K_TB rows apart.
    const uint64_t db = sw128_desc(b0 + k * 128, K_TB * 128, 1024);
    if constexpr (Gm::WN == 128) {
      wgmma_m64n128(acc, da, db);
    } else {
      wgmma_m64n64(acc, da, db);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int e = 0; e < Gm::ACC; ++e) fence_operand(acc[e]);
}

// The producer's copies of one step's tiles into a ring slot, 16 bytes a
// thread at a time.
template <int ROWS, int COLS>
__device__ __forceinline__ void copy_tile(uint16_t* dst, const uint16_t* src,
                                          size_t ld) {
  constexpr int CHUNKS = ROWS * COLS / 8, PER_ROW = COLS / 8;
  for (int i = threadIdx.x - CONSUMERS; i < CHUNKS; i += PRODUCERS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * 8;
    cp_async16(dst + sw128<ROWS>(r, c), src + (size_t)r * ld + c);
  }
}

template <int ELEMS>
__device__ __forceinline__ void zero_tile(uint16_t* p) {
  uint4* q = reinterpret_cast<uint4*>(p);
  for (int i = threadIdx.x - CONSUMERS; i < ELEMS / 8; i += PRODUCERS)
    q[i] = make_uint4(0u, 0u, 0u, 0u);
}

// What the mainloop reads. Sparse: the padded Tiled-CSL words of weights
// g0 .. g0 + GB - 1 and the live-step list; dense: A[M, K] row-major.
struct Operands {
  const uint32_t* words;  // [G, Mt, Kt, max_nnz] (sparse)
  const uint16_t* a;      // [M, K] bf16 bits (dense)
  const uint16_t* b;      // [K, N] bf16 bits
  int k, n, max_nnz, mt_count, kt_count, g0;
};

// Step list entry: (K tile - kt_begin) * GB + g in bits 10..0, count above.
constexpr int ENTRY_BITS = 11;
static_assert(MAX_STEPS <= (1 << ENTRY_BITS), "entry field");

// Compacts the live (K tile, weight) steps of [kt_begin, kt_end), in order,
// into list; returns their number (the same in every thread). NTHREADS is
// the block's size.
template <int GB, int NTHREADS = THREADS>
__device__ int live_steps(uint32_t* list, const int32_t* __restrict__ nnz,
                          const Operands& op, int mi, int kt_begin,
                          int kt_end) {
  __shared__ int warp_live[NTHREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int entries = (kt_end - kt_begin) * GB;
  int total = 0;
  for (int base = 0; base < entries; base += NTHREADS) {
    const int e = base + threadIdx.x;
    int cnt = 0;
    if (e < entries) {
      const int g = op.g0 + e % GB, kt = kt_begin + e / GB;
      cnt = nnz[((size_t)g * op.mt_count + mi) * op.kt_count + kt];
      cnt = cnt < op.max_nnz ? cnt : op.max_nnz;
    }
    const unsigned live = __ballot_sync(0xFFFFFFFFu, cnt > 0);
    if (lane == 0) warp_live[warp] = __popc(live);
    __syncthreads();
    int off = total, round = 0;
#pragma unroll
    for (int w = 0; w < NTHREADS / 32; ++w) {
      off += w < warp ? warp_live[w] : 0;
      round += warp_live[w];
    }
    if (cnt > 0)
      list[off + __popc(live & ((1u << lane) - 1u))] =
          (uint32_t)e | ((uint32_t)cnt << ENTRY_BITS);
    __syncthreads();  // warp_live is rewritten next round; list is complete
    total += round;
  }
  return total;
}

// One tile's words, held in registers between their load and their scatter.
// Producer p holds words p, p + PRODUCERS, ...: the lanes of a warp hold
// consecutive words, which the encoding's interleave order spreads over the
// eight row classes (row % 8), so one store instruction's 32 addresses fall
// in distinct bank groups of the swizzled tile.
struct Words {
  uint32_t v[WORD_REGS];
  const uint32_t* src;
  int cnt;
};

template <int GB>
__device__ __forceinline__ void fetch_words(Words& w, const Operands& op,
                                            uint32_t entry, int mi,
                                            int kt_begin) {
  const int e = (int)(entry & ((1u << ENTRY_BITS) - 1u));
  const int g = op.g0 + e % GB, kt = kt_begin + e / GB;
  w.cnt = (int)(entry >> ENTRY_BITS);
  w.src = op.words +
          (((size_t)g * op.mt_count + mi) * op.kt_count + kt) * op.max_nnz;
#pragma unroll
  for (int j = 0; j < WORD_REGS; ++j) {
    const int idx = threadIdx.x - CONSUMERS + j * PRODUCERS;
    if (idx < w.cnt) w.v[j] = __ldg(w.src + idx);
  }
}

template <int M_TB, int K_TB>
__device__ __forceinline__ void put_word(uint16_t* a_s, uint32_t w) {
  constexpr int LOG_K = K_TB == 64 ? 6 : 7;
  const int loc = (int)(w & 0xFFFFu);
  a_s[sw128<M_TB>(loc >> LOG_K, loc & (K_TB - 1))] = (uint16_t)(w >> 16);
}

// Stores a tile's first cnt words into a zeroed A slot: the prefetched
// ones, then those of a tile denser than the prefetch covers, loaded in
// place.
template <int M_TB, int K_TB>
__device__ __forceinline__ void scatter_words(uint16_t* a_s, const Words& w) {
  const int p = threadIdx.x - CONSUMERS;
#pragma unroll
  for (int j = 0; j < WORD_REGS; ++j)
    if (p + j * PRODUCERS < w.cnt) put_word<M_TB, K_TB>(a_s, w.v[j]);
  for (int idx = p + WORD_REGS * PRODUCERS; idx < w.cnt; idx += PRODUCERS)
    put_word<M_TB, K_TB>(a_s, w.src[idx]);
}

// acc[g] += the steps of one (m tile, n tile) in K-tile order (in the
// consumer's registers). DENSE reads the K tiles [kt_begin, kt_begin +
// steps) of A; otherwise the steps are list[0 .. steps), each one weight's
// K tile, rebuilt from its words.
//
// Step i, after its one barrier (slot i is full, step i-1's product done):
// the consumers multiply slot i and wait for it; meanwhile the producers
// issue the cp.async of step i+2, load step i+2's words into registers,
// zero slot i+2, store step i+1's words (loaded a step earlier) into
// slot i+1, and wait for step i+1's copies.
template <int GB, int M_TB, int K_TB, int N_TB, bool DENSE>
__device__ __forceinline__ void mainloop(
    float (&acc)[GB][Geom<M_TB, K_TB, N_TB>::ACC], const Operands& op,
    int mi, int ni, int kt_begin, int steps, const uint32_t* list,
    uint16_t* ring) {
  using Gm = Geom<M_TB, K_TB, N_TB>;
  uint16_t* a_ring = ring;
  uint16_t* b_ring = ring + STAGES * Gm::A_ELEMS;
  const bool consumer = Gm::multiplies();
  const bool producer = (int)threadIdx.x >= CONSUMERS;
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int e = 0; e < Gm::ACC; ++e) acc[g][e] = 0.0f;
  if (steps == 0) return;

  auto entry_of = [&](int i) {
    return (int)(list[i] & ((1u << ENTRY_BITS) - 1u));
  };
  auto issue = [&](int i) {  // cp.async of step i into slot i % STAGES
    const int slot = i % STAGES;
    const int kt = DENSE ? kt_begin + i : kt_begin + entry_of(i) / GB;
    copy_tile<K_TB, N_TB>(b_ring + slot * Gm::B_ELEMS,
                          op.b + (size_t)kt * K_TB * op.n + (size_t)ni * N_TB,
                          op.n);
    if constexpr (DENSE)
      copy_tile<M_TB, K_TB>(a_ring + slot * Gm::A_ELEMS,
                            op.a + (size_t)mi * M_TB * op.k +
                                (size_t)kt * K_TB,
                            op.k);
  };
  // Step i: cur holds step i+1's words (loaded a step ago), nxt receives
  // step i+2's. The loop runs two steps per turn with the roles swapped, so
  // each set stays in its own registers while its loads are in flight.
  auto step = [&](int i, Words& cur, Words& nxt) {
    __syncthreads();
    if (consumer) {
      const uint16_t* a_s = a_ring + (i % STAGES) * Gm::A_ELEMS;
      const uint16_t* b_s = b_ring + (i % STAGES) * Gm::B_ELEMS;
      if constexpr (GB == 1) {
        mma_tile<Gm, M_TB, K_TB>(acc[0], a_s, b_s);
      } else {
        const int g = entry_of(i) % GB;
#pragma unroll
        for (int gg = 0; gg < GB; ++gg)
          if (g == gg) mma_tile<Gm, M_TB, K_TB>(acc[gg], a_s, b_s);
      }
    } else if (producer) {
      if (i + 2 < steps) issue(i + 2);
      cp_async_commit();
      if constexpr (!DENSE) {
        if (i + 2 < steps) {
          fetch_words<GB>(nxt, op, list[i + 2], mi, kt_begin);
          zero_tile<Gm::A_ELEMS>(a_ring + ((i + 2) % STAGES) * Gm::A_ELEMS);
        }
        if (i + 1 < steps)
          scatter_words<M_TB, K_TB>(
              a_ring + ((i + 1) % STAGES) * Gm::A_ELEMS, cur);
      }
      cp_async_wait<1>();  // step i+1's copies have landed
      fence_async_smem();  // the stores and copies, seen by wgmma
    }
  };

  Words w0, w1;
  if (producer) {
    if constexpr (!DENSE) {
      zero_tile<Gm::A_ELEMS>(a_ring);
      zero_tile<Gm::A_ELEMS>(a_ring + Gm::A_ELEMS);
      fetch_words<GB>(w1, op, list[0], mi, kt_begin);
      if (steps > 1) fetch_words<GB>(w0, op, list[1], mi, kt_begin);
    }
    issue(0);
    cp_async_commit();
    if (steps > 1) issue(1);
    cp_async_commit();
    if constexpr (!DENSE) {
      // slots 0 and 1 are zero in every producer thread
      asm volatile("bar.sync 1, %0;\n" ::"n"(PRODUCERS) : "memory");
      scatter_words<M_TB, K_TB>(a_ring, w1);
    }
    cp_async_wait<1>();  // step 0's copies have landed
    fence_async_smem();
  }
  for (int i = 0; i < steps; i += 2) {
    step(i, w0, w1);
    if (i + 1 < steps) step(i + 1, w1, w0);
  }
}

}  // namespace hpipe
