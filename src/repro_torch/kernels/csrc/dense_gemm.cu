// Dense GEMM baseline: C[M, N] = A[M, K] @ B[K, N], f32 accumulator, one
// cast at the end.
//
// Replaces the TPU kernel repro/kernels/gemm.py:dense_gemm (body
// _gemm_kernel, pallas_call at :66): the paper's dense comparison point.
// It runs the mainloop of the prefill LSCD kernels (hopper_pipe.cuh) with
// the dense A source, so LSCD time minus this kernel's time at the same
// tiles is the Load-as-Sparse cost: the word stream, the zeroing and the
// scatter, and what differs between the two sources' mainloops and
// epilogues: here A comes by TMA and the stage is 64 deep in K, there the
// stage is one K tile and the ring three deep; here one producer
// warpgroup, there two; here a persistent grid and a TMA-store epilogue,
// there one block a tile and stores from registers (with bias and
// activation).
//
// Bound on an H100: 2·M·K·N operations over 989 TFLOP/s (bf16) at the
// shapes it is compared at. Design:
// * bf16 inputs: A and B by TMA into a ring of 64-deep stages (four at a
//   128 x 256 tile, six at 128 x 128), full and empty mbarriers a stage
//   and no block-wide barrier, one elected producer thread, two consumer
//   warpgroups that keep one wgmma group in flight (m64n256k16 at a
//   128 x 256 tile: 128 accumulators a thread, registers taken from the
//   producer warpgroup with setmaxnreg), and a persistent grid of one
//   block per SM over the output tiles, n tiles fastest, so the blocks
//   sharing an A row panel run together and A streams from DRAM about
//   once; the epilogue casts into shared memory and stores each 64-row
//   chunk by TMA. k_tb only has to divide K: the kernel walks K in 64-deep
//   stages.
//   What still bounds it: each block loads its own B from L2 (no cluster
//   multicast yet), and at a skinny N the grid has one tile per m_tb rows
//   (56 blocks for 7168 rows on 132 SMs).
// * f32 inputs: CUDA-core FMAs on the f32 tile of lscd_common.cuh
//   (FmaTile), so f32 stays full f32; not pipelined, it exists for the
//   f32 comparisons of the tests.
#include "lscd_common.cuh"

namespace {

using hpipe::CONSUMERS;

template <int M_TB, int N_TB, typename TO>
__global__ void __launch_bounds__(hpipe::Source<true>::THREADS, 1)
    dense_gemm_bf16_kernel(const __grid_constant__ CUtensorMap map_a,
                           const __grid_constant__ CUtensorMap map_b,
                           const __grid_constant__ CUtensorMap map_c, int m,
                           int k, int n) {
  using R = hpipe::DenseRing<M_TB, N_TB>;
  extern __shared__ __align__(128) unsigned char ring_smem[];
  unsigned char* base = hpipe::aligned_smem(ring_smem);
  uint16_t* ring = reinterpret_cast<uint16_t*>(base);
  unsigned char* epi = base + R::RING_BYTES;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(epi + hpipe::EPI_BYTES);
  uint64_t* empty = full + R::STAGES;
  hpipe::init_ring<typename R::Gm>(full, empty, R::STAGES, 1);
  __syncthreads();
  const int mt = m / M_TB, nt = n / N_TB, ksteps = k / 64;
  // One if/else by warpgroup, never rejoined, so ptxas honours setmaxnreg.
  if (threadIdx.x >= CONSUMERS) {
    hpipe::setmaxnreg_dec<hpipe::DENSE_PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS)
      hpipe::dense_producer<M_TB, N_TB>(&map_a, &map_b, ring, full, empty,
                                        mt, nt, ksteps);
  } else {
    hpipe::setmaxnreg_inc<hpipe::DENSE_CONSUMER_REGS>();
    if (R::Gm::multiplies())  // a 64 x 64 tile keeps one warpgroup
      hpipe::dense_consumer<M_TB, N_TB, TO>(&map_c, ring, epi, full, empty,
                                            mt, nt, ksteps);
  }
}

template <int M_TB, int N_TB, typename TO>
__global__ void __launch_bounds__(lscd::THREADS)
    dense_gemm_f32_kernel(const float* a, const float* b, TO* out, int m,
                          int k, int n, int k_tb) {
  using Tile = lscd::FmaTile<M_TB, N_TB>;
  extern __shared__ __align__(16) unsigned char gemm_smem[];
  float* a_s = reinterpret_cast<float*>(gemm_smem);
  float* b_s = reinterpret_cast<float*>(gemm_smem + Tile::a_bytes(k_tb));
  const int ni = blockIdx.x, mi = blockIdx.y, ld = Tile::lda(k_tb);
  float acc[Tile::ACC];
#pragma unroll
  for (int e = 0; e < Tile::ACC; ++e) acc[e] = 0.0f;
  for (int kt = 0; kt < k / k_tb; ++kt) {
    __syncthreads();  // readers of the previous tiles are done
    const float* at = a + (size_t)mi * M_TB * k + (size_t)kt * k_tb;
    for (int i = threadIdx.x; i < M_TB * k_tb; i += lscd::THREADS)
      a_s[(i / k_tb) * ld + i % k_tb] = at[(size_t)(i / k_tb) * k + i % k_tb];
    Tile::stage_b(b_s, b + (size_t)kt * k_tb * n + (size_t)ni * N_TB, n,
                  k_tb);
    __syncthreads();
    Tile::compute(acc, a_s, b_s, k_tb);
  }
#pragma unroll
  for (int e = 0; e < Tile::ACC; ++e) {
    int r, c;
    Tile::coord(e, r, c);
    lscd::store(out + (size_t)(mi * M_TB + r) * n + ni * N_TB + c, acc[e]);
  }
}

template <int M_TB, int N_TB, typename TO>
int launch_bf16(const void* a, const void* b, void* out, int m, int k, int n,
                cudaStream_t stream) {
  using R = hpipe::DenseRing<M_TB, N_TB>;
  CUtensorMap map_a, map_b, map_c;
  int rc = hpipe::make_map(&map_a, a, m, k, M_TB);
  if (rc == 0) rc = hpipe::make_map(&map_b, b, k, n, 64);
  if (rc == 0) rc = hpipe::make_map(&map_c, out, m, n, 64, sizeof(TO));
  if (rc != 0) return rc;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  auto kern = dense_gemm_bf16_kernel<M_TB, N_TB, TO>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)R::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (m / M_TB) * (n / N_TB);
  kern<<<tiles < sms ? tiles : sms, hpipe::Source<true>::THREADS,
         R::SMEM_BYTES, stream>>>(map_a, map_b, map_c, m, k, n);
  return (int)cudaGetLastError();
}

template <int M_TB, int N_TB, typename TO>
int launch_f32(const void* a, const void* b, void* out, int m, int k, int n,
               int k_tb, cudaStream_t stream) {
  using Tile = lscd::FmaTile<M_TB, N_TB>;
  auto kern = dense_gemm_f32_kernel<M_TB, N_TB, TO>;
  const size_t smem = Tile::smem(k_tb);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(n / N_TB, m / M_TB), lscd::THREADS, smem, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<TO*>(out), m, k, n, k_tb);
  return (int)cudaGetLastError();
}

template <int M_TB, int N_TB, typename TO>
int launch_in(const void* a, const void* b, void* out, int m, int k, int n,
              int k_tb, bool bf16_in, cudaStream_t stream) {
  if (bf16_in) return launch_bf16<M_TB, N_TB, TO>(a, b, out, m, k, n, stream);
  // f32: the CUDA-core tile holds at most lscd::MAX_ACC a thread.
  if constexpr (M_TB * N_TB / lscd::THREADS > lscd::MAX_ACC)
    return (int)cudaErrorInvalidValue;  // refused by analysis/contracts.py
  else
    return launch_f32<M_TB, N_TB, TO>(a, b, out, m, k, n, k_tb, stream);
}

template <int M_TB, typename TO>
int launch_n(const void* a, const void* b, void* out, int m, int k, int n,
             int k_tb, int n_tb, bool bf16_in, cudaStream_t stream) {
  switch (n_tb) {
    case 64:
      return launch_in<M_TB, 64, TO>(a, b, out, m, k, n, k_tb, bf16_in,
                                     stream);
    case 128:
      return launch_in<M_TB, 128, TO>(a, b, out, m, k, n, k_tb, bf16_in,
                                      stream);
    default:
      return launch_in<M_TB, 256, TO>(a, b, out, m, k, n, k_tb, bf16_in,
                                      stream);
  }
}

template <typename TO>
int launch_m(const void* a, const void* b, void* out, int m, int k, int n,
             int m_tb, int k_tb, int n_tb, bool bf16_in,
             cudaStream_t stream) {
  if (m_tb == 64)
    return launch_n<64, TO>(a, b, out, m, k, n, k_tb, n_tb, bf16_in, stream);
  return launch_n<128, TO>(a, b, out, m, k, n, k_tb, n_tb, bf16_in, stream);
}

}  // namespace

// dtype: bit 0 = A and B are bf16 (else f32), bit 1 = C is bf16 (else f32).
extern "C" int dense_gemm_launch(const void* a, const void* b, void* out,
                                 int m, int k, int n, int m_tb, int k_tb,
                                 int n_tb, int dtype, void* stream) {
  if ((m_tb != 64 && m_tb != 128) || (k_tb != 64 && k_tb != 128) ||
      (n_tb != 64 && n_tb != 128 && n_tb != 256) || dtype < 0 || dtype > 3)
    return (int)cudaErrorInvalidValue;
  if (m <= 0 || n <= 0 || k <= 0 || m % m_tb || k % k_tb || n % n_tb)
    return (int)cudaErrorInvalidValue;
  const bool bf16_in = dtype & 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype & 2)
    return launch_m<__nv_bfloat16>(a, b, out, m, k, n, m_tb, k_tb, n_tb,
                                   bf16_in, s);
  return launch_m<float>(a, b, out, m, k, n, m_tb, k_tb, n_tb, bf16_in, s);
}
