// Dense GEMM baseline: C[M, N] = A[M, K] @ B[K, N], f32 accumulator, one
// cast at the end.
//
// Replaces the TPU kernel repro/kernels/gemm.py:dense_gemm (body
// _gemm_kernel, pallas_call at :66): the paper's dense comparison point,
// built on the same tiles and the same K walk as the LSCD kernels with A
// read dense, so LSCD time minus this kernel's time at the same tiles is
// the Load-as-Sparse cost.
//
// Bound on an H100: 2·M·K·N operations over 989 TFLOP/s (bf16) at the
// shapes it is compared at. Design:
// * bf16 inputs: the pipelined wgmma mainloop of hopper_pipe.cuh,
//   with A's K tile copied by cp.async into its swizzled ring slot beside
//   B's (in place of the extraction from Tiled-CSL words).
// * f32 inputs: CUDA-core FMAs on the f32 tile of lscd_common.cuh
//   (FmaTile), so f32 stays full f32; not pipelined, it exists for the
//   f32 comparisons of the tests.
// Grid: n tiles fastest, so blocks sharing an A row panel run together.
#include "lscd_common.cuh"

namespace {

template <int M_TB, int K_TB, int N_TB, typename TO>
__global__ void __launch_bounds__(hpipe::THREADS, 1)
    dense_gemm_bf16_kernel(const uint16_t* a, const uint16_t* b, TO* out,
                           int m, int k, int n) {
  using Gm = hpipe::Geom<M_TB, K_TB, N_TB>;
  extern __shared__ __align__(128) unsigned char ring_smem[];
  uint16_t* ring = reinterpret_cast<uint16_t*>(hpipe::aligned_smem(ring_smem));
  const int ni = blockIdx.x, mi = blockIdx.y;
  hpipe::Operands op;
  op.words = nullptr;
  op.a = a;
  op.b = b;
  op.k = k; op.n = n; op.max_nnz = 0;
  op.mt_count = m / M_TB; op.kt_count = k / K_TB; op.g0 = 0;
  float acc[1][Gm::ACC];
  hpipe::mainloop<1, M_TB, K_TB, N_TB, true>(
      acc, op, mi, ni, 0, op.kt_count, nullptr, ring);
  if (!Gm::multiplies()) return;  // a 64 x 64 tile keeps one warpgroup
#pragma unroll
  for (int e = 0; e < Gm::ACC; ++e) {
    int r, c;
    Gm::coord(e, r, c);
    lscd::store(out + (size_t)(mi * M_TB + r) * n + ni * N_TB + c, acc[0][e]);
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

template <int M_TB, int K_TB, int N_TB, typename TO>
int launch_bf16(const void* a, const void* b, void* out, int m, int k, int n,
                cudaStream_t stream) {
  using Gm = hpipe::Geom<M_TB, K_TB, N_TB>;
  auto kern = dense_gemm_bf16_kernel<M_TB, K_TB, N_TB, TO>;
  const size_t smem = hpipe::SMEM_ALIGN + Gm::RING_BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3(n / N_TB, m / M_TB), hpipe::THREADS, smem, stream>>>(
      static_cast<const uint16_t*>(a), static_cast<const uint16_t*>(b),
      static_cast<TO*>(out), m, k, n);
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
  if (!bf16_in) return launch_f32<M_TB, N_TB, TO>(a, b, out, m, k, n, k_tb,
                                                  stream);
  if (k_tb == 64)
    return launch_bf16<M_TB, 64, N_TB, TO>(a, b, out, m, k, n, stream);
  return launch_bf16<M_TB, 128, N_TB, TO>(a, b, out, m, k, n, stream);
}

template <int M_TB, typename TO>
int launch_n(const void* a, const void* b, void* out, int m, int k, int n,
             int k_tb, int n_tb, bool bf16_in, cudaStream_t stream) {
  if (n_tb == 64)
    return launch_in<M_TB, 64, TO>(a, b, out, m, k, n, k_tb, bf16_in, stream);
  return launch_in<M_TB, 128, TO>(a, b, out, m, k, n, k_tb, bf16_in, stream);
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
      (n_tb != 64 && n_tb != 128) || dtype < 0 || dtype > 3)
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
