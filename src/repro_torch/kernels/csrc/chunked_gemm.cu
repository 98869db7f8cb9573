// K1: tiled GEMM with an fp32 accumulator, batched over logical ranks,
// and K2: the same GEMM folded into an accumulator in place.
//
// K1 replaces the TPU kernel repro/kernels/chunked_gemm.py::chunked_matmul
// (body _matmul_kernel): out = x @ w with the sum kept in fp32 across the
// K blocks and cast to x's dtype at the end.  On the FiCCO path it is the
// step GEMM of ficco_uniform_fused_1d_dma: every logical rank multiplies
// its gathered (g*m_c, K) step buffer by its own (K, n_local) weight
// shard, and grid dimension z runs over the ranks, so one launch does all
// ranks' step GEMMs.
//
// K2 replaces repro/kernels/chunked_gemm.py::accumulate_matmul: C += x @ w,
// the fp32 accumulator seeded from C and the sum stored back into C, cast
// to C's dtype (the TPU kernel aliases C's input and output).  It is the
// per-step GEMM of the uniform-fused-2D schedule, where C is the fp32
// (g*m_s, n_local) accumulator and x, w are bf16 K-slice panels.  The same
// two kernels serve both: K2 is K1 with a prologue that loads the C tile
// into the accumulator where K1 zeroes it.
//
// What bounds them on an H100: at the path shape (4 ranks x 512 x 2048 x
// 1408, bf16) a K1 launch does 11.8 GFLOP against 37 MB of compulsory
// traffic, about 320 operations per byte, above the card's bf16 ridge
// point (its tensor-core peak over its memory rate): the bound is the
// tensor cores' bf16 rate.  A K2 launch of the 2D schedule (4 ranks x
// 2048 x 512 x 1408, C fp32) does the same 11.8 GFLOP but reads and
// writes the 92 MB fp32 accumulator, about 110 operations per byte:
// bound by bytes.
//
// What the design does about it, in two kernels of one shape each, both
// one output tile of gemm_tile.cuh per block with grid dimension z over
// the ranks: K is looped inside the block (it takes the place of the TPU
// grid's sequential K dimension, so nothing is carried between blocks),
// the running sum stays in fp32 registers, and the result is cast once.
//  * tc (bf16 operands, 128-multiple N, 32-multiple K, 16-byte aligned
//    rows): 128 x 128 tiles of WMMA tensor-core products, the next K
//    slab's 16-byte loads in flight under the current products.
//  * simt (f32, and any shape the tc tile does not take): 64 x 64 tiles
//    on the CUDA cores in fp32, edges masked.  f32 stays off the tensor
//    cores, whose fp32 input mode (TF32) keeps only 10 bits.
// The Python wrappers keep the reference's contracts (K1's divisibility
// ValueError; K2 launches for every shape, where the TPU kernel fell back
// to plain jnp for shapes that do not tile).  wgmma with TMA-fed
// shared-memory rings is the later, faster version.
//
// Strides are in elements; the last dim of x, w and out is contiguous.

#include "gemm_tile.cuh"

namespace {

using namespace gemm_tile;

// Rank blockIdx.z's rows of a strided (g, M, K) x and (g, M, N) out.
template <typename TA, typename TO>
struct RankRows {
  int n;
  const TA* x;
  TO* out;
  long long x_row, o_row;
  __device__ __forceinline__ const TA* a(int q) const { return x + q * x_row; }
  __device__ __forceinline__ TO* c(int q) const { return out + q * o_row; }
};

// ACC: seed the accumulator from out (K2's C += x @ w) instead of zero.
template <typename TA, typename TO, bool ACC>
__global__ void __launch_bounds__(simt::THREADS) chunked_gemm_simt_kernel(
    const TA* __restrict__ x, const TA* __restrict__ w, TO* __restrict__ out,
    int M, int N, int K,
    long long x_rank, long long x_row,
    long long w_rank, long long w_row,
    long long o_rank, long long o_row) {
  const long long r = blockIdx.z;
  const RankRows<TA, TO> rows{M, x + r * x_rank, out + r * o_rank, x_row,
                              o_row};
  simt_tile<TA, TO, ACC>(rows, blockIdx.y * simt::BM, blockIdx.x * simt::BN,
                         w + r * w_rank, w_row, N, K);
}

template <typename TO, bool ACC, bool MASK>
__global__ void __launch_bounds__(tc::THREADS) chunked_gemm_tc_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    TO* __restrict__ out,
    int M, int K,
    long long x_rank, long long x_row,
    long long w_rank, long long w_row,
    long long o_rank, long long o_row) {
  const long long r = blockIdx.z;
  const RankRows<__nv_bfloat16, TO> rows{M, x + r * x_rank, out + r * o_rank,
                                         x_row, o_row};
  tc_tile<TO, ACC, MASK>(rows, blockIdx.y * tc::BM, blockIdx.x * tc::BN,
                         w + r * w_rank, w_row, K);
}

// One launch of either kernel over g ranks.  TA: operand type; TO: output
// (and, for ACC, accumulator) type.
template <typename TA, typename TO, bool ACC>
int launch(const void* x, const void* w, void* out, int g, int M, int N,
           int K, long long x_rank, long long x_row, long long w_rank,
           long long w_row, long long o_rank, long long o_row,
           cudaStream_t s) {
  if (g < 1 || M < 1 || N < 1 || K < 1) return cudaErrorInvalidValue;
  if (g > 65535) return cudaErrorInvalidConfiguration;
  constexpr bool bf16_operands = sizeof(TA) == 2;
  const bool tc_ok = bf16_operands &&
                     tc_weight_ok(w, N, K, w_rank, w_row) && aligned16(x) &&
                     x_rank % 8 == 0 && x_row % 8 == 0;
  if (tc_ok) {
    const int grid_y = (M + tc::BM - 1) / tc::BM;
    if (grid_y > 65535) return cudaErrorInvalidConfiguration;
    const dim3 grid(N / tc::BN, grid_y, g);
    auto kernel = M % tc::BM ? chunked_gemm_tc_kernel<TO, ACC, true>
                             : chunked_gemm_tc_kernel<TO, ACC, false>;
    kernel<<<grid, tc::THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), static_cast<TO*>(out), M, K,
        x_rank, x_row, w_rank, w_row, o_rank, o_row);
    return cudaGetLastError();
  }
  const int grid_y = (M + simt::BM - 1) / simt::BM;
  if (grid_y > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((N + simt::BN - 1) / simt::BN, grid_y, g);
  chunked_gemm_simt_kernel<TA, TO, ACC><<<grid, simt::THREADS, 0, s>>>(
      static_cast<const TA*>(x), static_cast<const TA*>(w),
      static_cast<TO*>(out), M, N, K, x_rank, x_row, w_rank, w_row, o_rank,
      o_row);
  return cudaGetLastError();
}

}  // namespace

// K1: out = x @ w.  dtype: 0 = float32, 1 = bfloat16 (operands and out).
// Returns a cudaError_t.
extern "C" int chunked_gemm(
    const void* x, const void* w, void* out, int dtype,
    int g, int M, int N, int K,
    long long x_rank, long long x_row,
    long long w_rank, long long w_row,
    long long o_rank, long long o_row,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, float, false>(x, w, out, g, M, N, K, x_rank, x_row,
                                       w_rank, w_row, o_rank, o_row, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(
        x, w, out, g, M, N, K, x_rank, x_row, w_rank, w_row, o_rank, o_row,
        s);
  return cudaErrorInvalidValue;
}

// K2: c += x @ w in place.  c_dtype and ab_dtype: 0 = float32,
// 1 = bfloat16; the pairs taken are (f32, f32), (bf16, bf16) and
// (f32, bf16).  Returns a cudaError_t.
extern "C" int accumulate_gemm(
    void* c, const void* x, const void* w, int c_dtype, int ab_dtype,
    int g, int M, int N, int K,
    long long x_rank, long long x_row,
    long long w_rank, long long w_row,
    long long c_rank, long long c_row,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c_dtype == 0 && ab_dtype == 0)
    return launch<float, float, true>(x, w, c, g, M, N, K, x_rank, x_row,
                                      w_rank, w_row, c_rank, c_row, s);
  if (c_dtype == 1 && ab_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, true>(
        x, w, c, g, M, N, K, x_rank, x_row, w_rank, w_row, c_rank, c_row, s);
  if (c_dtype == 0 && ab_dtype == 1)
    return launch<__nv_bfloat16, float, true>(
        x, w, c, g, M, N, K, x_rank, x_row, w_rank, w_row, c_rank, c_row, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* chunked_gemm_strerror(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
