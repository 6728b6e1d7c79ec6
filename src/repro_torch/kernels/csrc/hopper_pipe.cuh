// Pipelined bf16 tensor-core mainloop for Hopper (sm_90a), shared by the
// large-N LSCD kernels (n_tb >= 64) and the dense GEMM baseline.
//
// Replaces the K loop of the TPU kernels repro/kernels/spmm.py:
// _lscd_spmm_kernel / _lscd_spmm_grouped_kernel / _lscd_spmm_splitk_kernel
// and repro/kernels/gemm.py:_gemm_kernel, where Pallas's grid pipeline
// double-buffers each (A, B) block into VMEM and the MXU consumes it.
//
// What bounds it on an H100: at prefill N the work is compute-bound (2·nnz·N
// useful operations over 989 TFLOP/s; Compute-as-Dense does 2·M·K·N). So the
// tensor cores must never wait: for loads, for the other warps, or for the
// shared-memory reads of their own operands. The Load-as-Sparse side adds,
// per K tile, the word stream (4 bytes per kept weight, re-read from L2 once
// per N tile), the zeroing of a dense A tile and one 2-byte shared-memory
// store per word; those stores cost a block the most beyond the product
// itself (PERF.md). The design:
//
// * Tensor cores through wgmma (m64nNk16, N up to 256, bf16 -> f32), which
//   reads both operands from shared memory by descriptor. Warpgroups 0 and
//   1 (the consumers) only multiply, each a 64-row or 64-column part of the
//   tile, accumulators in registers. The other warpgroups (the producers)
//   fill the stages of later steps meanwhile.
// * A ring of stages in shared memory, each an A tile and a B tile, and two
//   mbarriers a stage: "full" completes when the stage's TMA bytes have
//   landed (and, for a rebuilt A tile, when every producer thread has
//   arrived after its stores and a proxy fence); "empty" completes when
//   every consumer warp is done reading it. There is no block-wide barrier
//   in the loop. A consumer keeps one step's wgmma group in flight: it
//   issues step i, waits for step i-1's group and only then releases step
//   i-1's stage. A wait that never completes traps after about two seconds
//   instead of hanging the card.
// * B, and the dense A, arrive by TMA (cp.async.bulk.tensor, one elected
//   producer thread, 2-D tensor maps made on the host per launch) in
//   wgmma's 128-byte-swizzled layout: panels of 64 bf16 columns, 16-byte
//   chunk c of row r at chunk c ^ (r & 7), every stage 1 KB aligned. A is
//   K-major ([m][k] panels), B lies as in device memory ([k][n] panels,
//   read MN-major, "transposed"); one TMA box is one panel.
// * The A source is a template parameter (Source<DENSE>):
//   - dense (dense_gemm): A by TMA; one producer warpgroup (384 threads),
//     which gives its registers to the consumers (setmaxnreg), so a
//     128 x 256 tile (two m64n256 parts, 128 accumulators a thread) fits;
//     the stage is 64 deep in K and the ring as deep as 227 KB allow
//     (DenseRing); a persistent grid, one block per SM, walks the output
//     tiles with n tiles fastest, so the blocks that share an A row panel
//     run together and A streams from DRAM about once; a consumer's
//     epilogue overlaps the producer's loads of its next tile: it casts
//     its accumulators into a swizzled shared-memory chunk of 128-byte
//     rows and one thread stores the chunk by TMA while the warpgroup
//     writes the next (stores straight from registers, 8 rows of 16 or
//     32 bytes a warp instruction, made the epilogue several times
//     slower; PERF.md §6).
//   - sparse (LSCD): A rebuilt from Tiled-CSL words by two producer
//     warpgroups (512 threads), the work of the cp.async design before it:
//     the producers load a step's words into registers (one coalesced word
//     per lane) a step ahead, zero the A slot, and store the first nnz
//     words into it (a padding word, +0.0 | loc 0, never overwrites
//     (0, 0)); a live-step list (the (K tile, weight) steps with nnz > 0,
//     compacted first) means empty steps never enter the ring. The stage
//     is one K tile (k_tb deep), three stages.
//
// Not yet done here: TMA multicast across a cluster (each block loads its
// own B, and for the LSCD kernels its words, from L2), a persistent grid for
// the LSCD kernels, and a fill of the card for skinny N (at N = 8 the dense
// GEMM has one tile per 128 rows).
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hpipe {

constexpr int CONSUMERS = 256;    // warpgroups 0 and 1 multiply
constexpr int STAGES = 3;         // the sparse ring
constexpr int MAX_STEPS = 2048;   // live-step list (analysis/contracts.py)
constexpr int WORD_REGS = 16;     // words a producer prefetches per tile
constexpr int SMEM_ALIGN = 1024;  // the 128-byte swizzle's period
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory of one block
constexpr int MAX_ACC = 64;       // sparse: accumulators a thread (contracts)
constexpr int DENSE_MAX_STAGES = 8;
// A copy or a stage that never lands (a fault) traps after about two
// seconds of waiting instead of hanging the card.
constexpr long long WAIT_LIMIT_CYCLES = 1ll << 32;

// Threads of a block by A source: consumers, then producers.
template <bool DENSE>
struct Source {
  static constexpr int THREADS = DENSE ? 384 : 512;
  static constexpr int PRODUCERS = THREADS - CONSUMERS;
};
constexpr int PRODUCERS = Source<false>::PRODUCERS;  // the sparse rebuild
// Registers a thread under setmaxnreg (dense): 2 x 128 x 232 + 128 x 40
// fit the SM's 65,536.
constexpr int DENSE_CONSUMER_REGS = 232, DENSE_PRODUCER_REGS = 40;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Generic-proxy writes (st.shared) made visible to wgmma.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > WAIT_LIMIT_CYCLES) __trap();
  }
}

// TMA: the box at (c0 = column, c1 = row) of a 2-D tensor map into shared
// memory, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// TMA store: the box at (c0 = column, c1 = row) of a 2-D tensor map from
// shared memory, in the thread's bulk group.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until at most N of the thread's TMA stores still read shared memory.
template <int N>
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Named barrier `id` over `count` threads (id 0 is __syncthreads').
__device__ __forceinline__ void named_bar(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
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

__device__ __forceinline__ void wgmma_m64n256(float* d, uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, "
      "%128, %129, p, 1, 1, 0, 1;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// Element offset of (row, col) in a 128-byte-swizzled tile of ROWS rows:
// panels of 64 columns, each ROWS x 128 bytes.
template <int ROWS>
__device__ __forceinline__ int sw128(int row, int col) {
  return ((col >> 6) * ROWS + row) * 64 +
         ((((col >> 3) & 7) ^ (row & 7)) << 3) + (col & 7);
}

// One stage's tiles: M_TB x K_TB of A, K_TB x N_TB of B (K_TB: the stage's
// depth in K).
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
  static constexpr int STAGE_BYTES = 2 * (A_ELEMS + B_ELEMS);
  static_assert(WN == 64 || WN == 128 || WN == 256, "wgmma N of 64..256");
  static_assert(K_TB == 64 || K_TB == 128, "k_tb is 64 or 128");

  __device__ static int wg() { return threadIdx.x >> 7; }
  __device__ static bool multiplies() { return wg() < WGS; }
  // Tile-local (row, col) of a consumer's accumulator e (e and e + 1 are
  // neighbouring columns).
  __device__ static void coord(int e, int& row, int& col) {
    const int w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    row = (wg() / WG_N) * 64 + w * 16 + (lane >> 2) + ((e >> 1) & 1) * 8;
    col = (wg() % WG_N) * WN + (e >> 2) * 8 + (lane & 3) * 2 + (e & 1);
  }
  // A stage: the A tile, then the B tile (each 1 KB aligned).
  __device__ static uint16_t* a_tile(uint16_t* ring, int slot) {
    return ring + slot * (A_ELEMS + B_ELEMS);
  }
  __device__ static uint16_t* b_tile(uint16_t* ring, int slot) {
    return a_tile(ring, slot) + A_ELEMS;
  }
};

// The block's dynamic shared memory, aligned to the swizzle's period.
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((SMEM_ALIGN - (a & (SMEM_ALIGN - 1))) & (SMEM_ALIGN - 1));
}

// A consumer's acc += its part of A_tile @ B_tile: one wgmma per k16 step,
// committed as one group. Does not wait for it.
template <class Gm>
__device__ __forceinline__ void mma_issue(float (&acc)[Gm::ACC],
                                          const uint16_t* a_s,
                                          const uint16_t* b_s) {
  const int wm = Gm::wg() / Gm::WG_N, wn = Gm::wg() % Gm::WG_N;
  constexpr int M_TB = Gm::WG_M * 64, K_TB = Gm::A_ELEMS / M_TB;
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
    if constexpr (Gm::WN == 256) {
      wgmma_m64n256(acc, da, db);
    } else if constexpr (Gm::WN == 128) {
      wgmma_m64n128(acc, da, db);
    } else {
      wgmma_m64n64(acc, da, db);
    }
  }
  wgmma_commit();
}

template <int N, int ACC>
__device__ __forceinline__ void mma_wait(float (&acc)[ACC]) {
  wgmma_wait<N>();
#pragma unroll
  for (int e = 0; e < ACC; ++e) fence_operand(acc[e]);
}

// A consumer warp is done reading a stage (after the wait for its group).
__device__ __forceinline__ void release(uint64_t* empty) {
  if ((threadIdx.x & 31) == 0) mbar_arrive(empty);
}

// B's panels of one stage by TMA: N_TB / 64 boxes of 64 columns x K_TB rows
// at K row k0 and N column n0.
template <int K_TB, int N_TB>
__device__ __forceinline__ void load_b(uint16_t* b_s, const CUtensorMap* map,
                                       int k0, int n0, uint64_t* full) {
#pragma unroll
  for (int p = 0; p < N_TB / 64; ++p)
    tma_load_2d(b_s + p * K_TB * 64, map, n0 + p * 64, k0, full);
}

// ---- the sparse source (LSCD) ---------------------------------------------

template <int ELEMS>
__device__ __forceinline__ void zero_tile(uint16_t* p) {
  uint4* q = reinterpret_cast<uint4*>(p);
  for (int i = threadIdx.x - CONSUMERS; i < ELEMS / 8; i += PRODUCERS)
    q[i] = make_uint4(0u, 0u, 0u, 0u);
}

// What the LSCD bodies read: the padded Tiled-CSL words of weights
// g0 .. g0 + GB - 1, the live-step counts' shape and B. B may be a stack
// of experts' blocks [E, K, N]; this block's weights multiply the K rows
// from b_row0 on.
struct Operands {
  const uint32_t* words;  // [E * G, Mt, Kt, max_nnz]
  const uint16_t* b;      // [E * K, N] bf16 bits
  int k, n, max_nnz, mt_count, kt_count, g0, b_row0;
};

// Step list entry: (K tile - kt_begin) * GB + g in bits 10..0, count above.
constexpr int ENTRY_BITS = 11;
static_assert(MAX_STEPS <= (1 << ENTRY_BITS), "entry field");

// Compacts the live (K tile, weight) steps of [kt_begin, kt_end), in order,
// into list; returns their number (the same in every thread). NTHREADS is
// the block's size.
template <int GB, int NTHREADS>
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

// Shared memory of a sparse block: the ring, its full and empty mbarriers,
// then the live-step list.
template <int M_TB, int K_TB, int N_TB>
struct SparseLayout {
  using Gm = Geom<M_TB, K_TB, N_TB>;
  static constexpr size_t RING_BYTES = (size_t)STAGES * Gm::STAGE_BYTES;
  static constexpr size_t BAR_BYTES = 2 * 8 * STAGES;
  static constexpr size_t SMEM_BYTES =
      SMEM_ALIGN + RING_BYTES + BAR_BYTES + 4 * MAX_STEPS;
};

// Full: the B bytes and one arrival of every producer thread, besides the
// TMA thread's own expect_tx. Empty: one arrival of every consumer warp.
template <class Gm>
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty,
                                          int stages, int full_count) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, full_count);
      mbar_init(empty + s, Gm::WGS * 4);
    }
    fence_mbar_init();
  }
}

// The LSCD consumers: acc[g] += the steps list[0 .. steps) in K-tile order,
// each one weight's K tile. A single weight (GB = 1) keeps one step's wgmma
// group in flight; the binary pair waits for each step, since the weight
// of a step is picked by a branch, and no branch may sit between a
// product's issue and its wait.
template <int GB, int M_TB, int K_TB, int N_TB>
__device__ __forceinline__ void sparse_consumer(
    float (&acc)[GB][Geom<M_TB, K_TB, N_TB>::ACC], int steps,
    const uint32_t* list, uint16_t* ring, uint64_t* full, uint64_t* empty) {
  using Gm = Geom<M_TB, K_TB, N_TB>;
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int e = 0; e < Gm::ACC; ++e) acc[g][e] = 0.0f;
  int slot = 0, prev = 0;
  uint32_t phase = 0;
  for (int i = 0; i < steps; ++i) {
    mbar_wait(full + slot, phase);
    const uint16_t* a_s = Gm::a_tile(ring, slot);
    const uint16_t* b_s = Gm::b_tile(ring, slot);
    if constexpr (GB == 1) {
      mma_issue<Gm>(acc[0], a_s, b_s);
      mma_wait<1>(acc[0]);
      if (i > 0) release(empty + prev);
      prev = slot;
    } else {
      const int g = (int)(list[i] & ((1u << ENTRY_BITS) - 1u)) % GB;
#pragma unroll
      for (int gg = 0; gg < GB; ++gg)
        if (g == gg) {
          mma_issue<Gm>(acc[gg], a_s, b_s);
          mma_wait<0>(acc[gg]);
        }
      release(empty + slot);
    }
    if (++slot == STAGES) {
      slot = 0;
      phase ^= 1;
    }
  }
  if constexpr (GB == 1) {
    mma_wait<0>(acc[0]);  // not under a branch: ptxas would serialize wgmma
    if (steps > 0) release(empty + prev);
  }
}

// The LSCD producers (warpgroups 2 and 3). Step j: wait until slot j is
// empty; the TMA thread starts B's copy; every producer issues the loads of
// step j+1's words into registers, zeroes the A slot, meets the others at a
// named barrier, stores step j's words (loaded a step ago), fences and
// arrives on the slot's full barrier. Two steps a turn with the word
// registers' roles swapped, so each set stays in its own registers while
// its loads are in flight.
template <int GB, int M_TB, int K_TB, int N_TB>
__device__ __forceinline__ void sparse_producer(
    const Operands& op, const CUtensorMap* map_b, int mi, int ni,
    int kt_begin, int steps, const uint32_t* list, uint16_t* ring,
    uint64_t* full, uint64_t* empty) {
  using Gm = Geom<M_TB, K_TB, N_TB>;
  if (steps == 0) return;
  int slot = 0;
  uint32_t phase = 0;
  auto step = [&](int j, Words& cur, Words& nxt) {
    mbar_wait(empty + slot, phase ^ 1);
    uint16_t* a_s = Gm::a_tile(ring, slot);
    if (threadIdx.x == CONSUMERS) {
      const int kt = kt_begin +
                     (int)(list[j] & ((1u << ENTRY_BITS) - 1u)) / GB;
      mbar_expect_tx(full + slot, 2 * Gm::B_ELEMS);
      load_b<K_TB, N_TB>(Gm::b_tile(ring, slot), map_b,
                         op.b_row0 + kt * K_TB, ni * N_TB, full + slot);
    }
    if (j + 1 < steps) fetch_words<GB>(nxt, op, list[j + 1], mi, kt_begin);
    zero_tile<Gm::A_ELEMS>(a_s);
    asm volatile("bar.sync 1, %0;\n" ::"n"(PRODUCERS) : "memory");
    scatter_words<M_TB, K_TB>(a_s, cur);
    fence_async_smem();  // the zeros and words, seen by wgmma
    mbar_arrive(full + slot);
    if (++slot == STAGES) {
      slot = 0;
      phase ^= 1;
    }
  };
  Words w0, w1;
  fetch_words<GB>(w0, op, list[0], mi, kt_begin);
  for (int j = 0; j < steps; j += 2) {
    step(j, w0, w1);
    if (j + 1 < steps) step(j + 1, w1, w0);
  }
}

// ---- the dense source (dense_gemm) ----------------------------------------

// The epilogue's staging: two buffers a consumer warpgroup, each 64 rows
// of 128 bytes (64 bf16 or 32 f32 output columns), 128-byte swizzled as
// the output's TMA box.
constexpr int EPI_BUF_BYTES = 64 * 128;
constexpr int EPI_BYTES = 2 * 2 * EPI_BUF_BYTES;

// Shared memory of a dense block: the ring of stages 64 deep in K, as many
// as fit beside the epilogue's staging (at most DENSE_MAX_STAGES), the
// staging, then 2 mbarriers a stage.
template <int M_TB, int N_TB>
struct DenseRing {
  using Gm = Geom<M_TB, 64, N_TB>;
  static constexpr int FIT =
      (SMEM_LIMIT - SMEM_ALIGN - EPI_BYTES) / (Gm::STAGE_BYTES + 16);
  static constexpr int STAGES =
      FIT < DENSE_MAX_STAGES ? FIT : DENSE_MAX_STAGES;
  static constexpr size_t RING_BYTES = (size_t)STAGES * Gm::STAGE_BYTES;
  static constexpr size_t SMEM_BYTES =
      SMEM_ALIGN + RING_BYTES + EPI_BYTES + 16 * STAGES;
  static_assert(STAGES >= 2, "two stages fit");
};

// Output tile t of the persistent walk: n tiles fastest.
__device__ __forceinline__ void tile_of(int t, int nt, int& mi, int& ni) {
  mi = t / nt;
  ni = t - mi * nt;
}

// The elected producer thread: every stage of every tile of this block, in
// order, one expect_tx and 1 + N_TB / 64 TMA boxes each.
template <int M_TB, int N_TB>
__device__ __forceinline__ void dense_producer(
    const CUtensorMap* map_a, const CUtensorMap* map_b, uint16_t* ring,
    uint64_t* full, uint64_t* empty, int mt, int nt, int ksteps) {
  using R = DenseRing<M_TB, N_TB>;
  using Gm = typename R::Gm;
  int slot = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < mt * nt; t += gridDim.x) {
    int mi, ni;
    tile_of(t, nt, mi, ni);
    for (int ks = 0; ks < ksteps; ++ks) {
      mbar_wait(empty + slot, phase ^ 1);
      mbar_expect_tx(full + slot, Gm::STAGE_BYTES);
      tma_load_2d(Gm::a_tile(ring, slot), map_a, ks * 64, mi * M_TB,
                  full + slot);
      load_b<64, N_TB>(Gm::b_tile(ring, slot), map_b, ks * 64, ni * N_TB,
                       full + slot);
      if (++slot == R::STAGES) {
        slot = 0;
        phase ^= 1;
      }
    }
  }
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// A consumer warpgroup: its part of every tile of this block, one wgmma
// group in flight; then the tile's one cast into shared memory, 128 bytes
// of columns at a time, each chunk stored by one TMA (map_c) while the
// warpgroup writes the next, and the producer already fills the next
// tile's stages.
template <int M_TB, int N_TB, typename TO>
__device__ __forceinline__ void dense_consumer(const CUtensorMap* map_c,
                                               uint16_t* ring,
                                               unsigned char* epi,
                                               uint64_t* full,
                                               uint64_t* empty, int mt,
                                               int nt, int ksteps) {
  using R = DenseRing<M_TB, N_TB>;
  using Gm = typename R::Gm;
  // CW output columns a chunk, PER accumulators a thread in each
  constexpr int CW = 128 / (int)sizeof(TO), PER = CW / 2;
  constexpr int CHUNKS = Gm::WN / CW;
  const int wg = Gm::wg(), wm = wg / Gm::WG_N, wn = wg % Gm::WG_N;
  const int w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const bool leader = (threadIdx.x & 127) == 0;
  unsigned char* bufs = epi + wg * 2 * EPI_BUF_BYTES;
  float acc[Gm::ACC];
  int slot = 0, prev = 0, buf = 0;
  uint32_t phase = 0;
  for (int t = blockIdx.x; t < mt * nt; t += gridDim.x) {
    int mi, ni;
    tile_of(t, nt, mi, ni);
#pragma unroll
    for (int e = 0; e < Gm::ACC; ++e) acc[e] = 0.0f;
    for (int ks = 0; ks < ksteps; ++ks) {
      mbar_wait(full + slot, phase);
      mma_issue<Gm>(acc, Gm::a_tile(ring, slot), Gm::b_tile(ring, slot));
      mma_wait<1>(acc);
      if (ks > 0) release(empty + prev);
      prev = slot;
      if (++slot == R::STAGES) {
        slot = 0;
        phase ^= 1;
      }
    }
    mma_wait<0>(acc);
    release(empty + prev);
#pragma unroll
    for (int j = 0; j < CHUNKS; ++j) {
      unsigned char* b = bufs + buf * EPI_BUF_BYTES;
      if (leader) tma_store_wait_read<1>();  // b's last store has read it
      named_bar(2 + wg, 128);
#pragma unroll
      for (int q = 0; q < PER; q += 2) {
        const int e = j * PER + q;
        const int row = w * 16 + (lane >> 2) + ((e >> 1) & 1) * 8;
        const int cb =
            ((((e >> 2) * 8) % CW) + (lane & 3) * 2) * (int)sizeof(TO);
        store2(reinterpret_cast<TO*>(
                   b + row * 128 + ((((cb >> 4) ^ (row & 7))) << 4) +
                   (cb & 15)),
               acc[e], acc[e + 1]);
      }
      fence_async_smem();  // the chunk, seen by the TMA store
      named_bar(2 + wg, 128);
      if (leader)
        tma_store_2d(map_c, b, ni * N_TB + wn * Gm::WN + j * CW,
                     mi * M_TB + wm * 64);
      buf ^= 1;
    }
  }
  if (leader) tma_store_wait_read<0>();  // before the block's memory goes
}

// ---- host -----------------------------------------------------------------

// A 2-D tensor map of a row-major bf16 (elem_bytes 2) or f32 (4) matrix
// [rows, cols], in boxes of box_rows x 128 bytes of columns (the swizzle's
// span), 128-byte swizzled. Returns 0 or the error of cuTensorMapEncodeTiled
// (or of looking it up).
inline int make_map(CUtensorMap* map, const void* base, int rows, int cols,
                    int box_rows, int elem_bytes = 2) {
  static PFN_cuTensorMapEncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                            cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess) return (int)e;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {128u / elem_bytes, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1u, 1u};
  return (int)encode(map,
                     elem_bytes == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                     2,
                     const_cast<void*>(base), dims, strides, box, elem,
                     CU_TENSOR_MAP_INTERLEAVE_NONE,
                     CU_TENSOR_MAP_SWIZZLE_128B,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace hpipe
