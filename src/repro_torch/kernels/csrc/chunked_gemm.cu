// K1: tiled GEMM with an fp32 accumulator, batched over logical ranks,
// and K2: the same GEMM folded into an accumulator in place.
//
// K1 replaces the TPU kernel repro/kernels/chunked_gemm.py::chunked_matmul
// (body _matmul_kernel): out = x @ w with the sum kept in fp32 across the
// K blocks and cast to x's dtype at the end.  On the FiCCO path it is the
// step GEMM of ficco_uniform_fused_1d_dma: every logical rank multiplies
// its gathered (g*m_c, K) step buffer by its own (K, n_local) weight
// shard, so one launch does all ranks' step GEMMs.
//
// K2 replaces repro/kernels/chunked_gemm.py::accumulate_matmul: C += x @ w
// in place, the sum in fp32, cast to C's dtype (the TPU kernel aliases C's
// input and output and seeds its sum from C).  It is the per-step GEMM of
// the uniform-fused-2D schedule, where C is the fp32 (g*m_s, n_local)
// accumulator and x, w are bf16 K-slice panels.
//
// What bounds them on an H100: at the path shape (4 ranks x 512 x 2048 x
// 1408, bf16) a K1 launch does 11.8 GFLOP against 37 MB of compulsory
// traffic, about 320 operations per byte, above the card's bf16 ridge
// point (its tensor-core peak over its memory rate): the bound is the
// tensor cores' bf16 rate, then the 185 MB its 176 tiles of 128 x 128
// bring from L2 into the SMs (A 11 x 8.4 MB, W 4 x 23 MB).  A K2 launch of
// the 2D schedule (4 ranks x 2048 x 512 x 1408, C fp32) does the same
// 11.8 GFLOP but reads and writes the 92 MB fp32 accumulator, about 110
// operations per byte: bound by bytes.
//
// What the design does about it.  K is looped inside the block (it takes
// the place of the TPU grid's sequential K dimension, so nothing is
// carried between blocks), the running sum stays in fp32 registers, and
// the result is cast once.  Each kernel takes the route its Python wrapper
// names, and refuses (cudaErrorInvalidValue) operands the route cannot
// take:
//  * wgmma (bf16 operands, every base 16-byte aligned, every stride a
//    multiple of 16 bytes; for K2 an fp32 C): gemm_wgmma.cuh's persistent
//    main loop, TMA-fed through an mbarrier ring, over 3D tensor maps of x
//    (K, M, g), w (N, K, g) and out or C (N, M, g).  Tiles past M, N or K
//    are zero-filled on load and clipped on store.  Tiles are 128 rows by
//    128 or 192 columns, the width that leaves the least work on the
//    busiest SM (gemm_wgmma::pick_bn): K1's path shape is 176 tiles of 128
//    x 128 in 2 rounds of 132 SMs or 128 tiles of 128 x 192 in one.  K2's
//    epilogue adds its fp32 tile into C with TMA's reduce-add, so C is
//    read and written once, by L2, and no SM reads it.
//  * simt (f32, a bf16 C, and any shape the wgmma route does not take): 64
//    x 64 tiles on the CUDA cores in fp32, edges masked, K2's accumulator
//    seeded from C.  f32 stays off the tensor cores, whose fp32 input mode
//    (TF32) keeps only 10 bits.
// The Python wrappers keep the reference's contracts (K1's divisibility
// ValueError; K2 launches for every shape, where the TPU kernel fell back
// to plain jnp for shapes that do not tile).
//
// Strides are in elements; the last dim of x, w and out is contiguous.

#include "gemm_tile.cuh"
#include "gemm_wgmma.cuh"

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

// The wgmma route's tiles: rank-major, then column block, then row block,
// so tiles 2P and 2P + 1 (a cluster's pair) share a weight column block.
// The row blocks are counted up to an even number; a last, empty one loads
// zeros and stores nothing.  ACC: the tile is added into an fp32 C (K2)
// instead of stored as bf16 (K1).
template <int BN, bool ACC>
struct ChunkedProblem {
  static constexpr bool ACCUMULATE = ACC;
  CUtensorMap x_map;  // (K, M, g)
  CUtensorMap w_map;  // (N, K, g)
  CUtensorMap o_map;  // (N, M, g): out (bf16) or C (fp32)
  int k, mt, nt, tiles;  // mt even
  __device__ __forceinline__ gemm_wgmma::Tile tile(int t) const {
    const int r = t / (mt * nt), rem = t % (mt * nt);
    const int m0 = (rem % mt) * gemm_wgmma::BM, n0 = (rem / mt) * BN;
    return gemm_wgmma::Tile{&x_map, m0, r, r, n0, m0, r, -1};
  }
};

template <int BN, bool ACC>
__global__ void __launch_bounds__(gemm_wgmma::THREADS, 1)
    chunked_gemm_wgmma_kernel(
        const __grid_constant__ ChunkedProblem<BN, ACC> p) {
  gemm_wgmma::run<BN>(p);
}

template <int BN, bool ACC>
int launch_wgmma_bn(const void* x, const void* w, void* out, int g, int M,
                    int N, int K, long long x_rank, long long x_row,
                    long long w_rank, long long w_row, long long o_rank,
                    long long o_row, cudaStream_t s) {
  using namespace gemm_wgmma;
  ChunkedProblem<BN, ACC> p;
  const long long x_dims[3] = {K, M, g}, x_strides[2] = {x_row, x_rank};
  const long long o_dims[3] = {N, M, g}, o_strides[2] = {o_row, o_rank};
  // A box row is 128 bytes: 64 bf16 or 32 fp32 columns.
  const int x_box[3] = {BK, BM, 1}, o_box[3] = {ACC ? 32 : BOX_N, 64, 1};
  cudaError_t err = encode(&p.x_map, x, 3, x_dims, x_strides, x_box);
  if (err == cudaSuccess)
    err = encode_weight(&p.w_map, w, g, N, K, w_rank, w_row);
  if (err == cudaSuccess)
    err = encode(&p.o_map, out, 3, o_dims, o_strides, o_box,
                 ACC ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
  if (err != cudaSuccess) return err;
  p.k = K;
  p.mt = (M + 2 * BM - 1) / (2 * BM) * 2;
  p.nt = (N + BN - 1) / BN;
  const long long tiles = static_cast<long long>(g) * p.mt * p.nt;
  if (tiles > (1LL << 30)) return cudaErrorInvalidConfiguration;
  p.tiles = static_cast<int>(tiles);
  return launch<BN>(chunked_gemm_wgmma_kernel<BN, ACC>, p, s);
}

// The wgmma route, at gemm_wgmma::pick_bn's tile width.  ACC: out is an
// fp32 C to add into (K2), else a bf16 output (K1).
template <bool ACC>
int launch_wgmma(const void* x, const void* w, void* out, int g, int M,
                 int N, int K, long long x_rank, long long x_row,
                 long long w_rank, long long w_row, long long o_rank,
                 long long o_row, cudaStream_t s) {
  const int o_align = ACC ? 4 : 8;  // elements in 16 bytes
  const bool ok = aligned16(x) && aligned16(w) && aligned16(out) &&
                  x_rank % 8 == 0 && x_row % 8 == 0 && w_rank % 8 == 0 &&
                  w_row % 8 == 0 && o_rank % o_align == 0 &&
                  o_row % o_align == 0;
  if (!ok) return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = gemm_wgmma::sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long mt = (M + 2 * gemm_wgmma::BM - 1) / (2 * gemm_wgmma::BM) * 2;
  if (gemm_wgmma::pick_bn(g * mt, N, sms) == 192)
    return launch_wgmma_bn<192, ACC>(x, w, out, g, M, N, K, x_rank, x_row,
                                     w_rank, w_row, o_rank, o_row, s);
  return launch_wgmma_bn<128, ACC>(x, w, out, g, M, N, K, x_rank, x_row,
                                   w_rank, w_row, o_rank, o_row, s);
}

// The simt tile over g ranks.  TA: operand type.
template <typename TA, typename TO, bool ACC>
int launch_simt(const void* x, const void* w, void* out, int g, int M,
                int N, int K, long long x_rank, long long x_row,
                long long w_rank, long long w_row, long long o_rank,
                long long o_row, cudaStream_t s) {
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
// route: 0 = simt, 2 = wgmma (code 1, the WMMA tile, is K4's alone); f32
// takes only simt.  Returns a cudaError_t; cudaErrorInvalidValue when the
// route cannot take the operands.
extern "C" int chunked_gemm(
    const void* x, const void* w, void* out, int dtype, int route,
    int g, int M, int N, int K,
    long long x_rank, long long x_row,
    long long w_rank, long long w_row,
    long long o_rank, long long o_row,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g < 1 || M < 1 || N < 1 || K < 1) return cudaErrorInvalidValue;
  if (g > 65535) return cudaErrorInvalidConfiguration;
  using bf16 = __nv_bfloat16;
  if (dtype == 0 && route == 0)
    return launch_simt<float, float, false>(x, w, out, g, M, N, K, x_rank,
                                            x_row, w_rank, w_row, o_rank,
                                            o_row, s);
  if (dtype != 1) return cudaErrorInvalidValue;
  if (route == 0)
    return launch_simt<bf16, bf16, false>(x, w, out, g, M, N, K, x_rank,
                                          x_row, w_rank, w_row, o_rank,
                                          o_row, s);
  if (route == 2)
    return launch_wgmma<false>(x, w, out, g, M, N, K, x_rank, x_row, w_rank,
                               w_row, o_rank, o_row, s);
  return cudaErrorInvalidValue;
}

// K2: c += x @ w in place.  c_dtype and ab_dtype: 0 = float32,
// 1 = bfloat16.  route: 0 = simt, which takes (f32, f32), (bf16, bf16) and
// (f32, bf16); 2 = wgmma, which takes (f32, bf16) alone.  Returns a
// cudaError_t; cudaErrorInvalidValue when the route cannot take the
// operands.
extern "C" int accumulate_gemm(
    void* c, const void* x, const void* w, int c_dtype, int ab_dtype,
    int route, int g, int M, int N, int K,
    long long x_rank, long long x_row,
    long long w_rank, long long w_row,
    long long c_rank, long long c_row,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g < 1 || M < 1 || N < 1 || K < 1) return cudaErrorInvalidValue;
  if (g > 65535) return cudaErrorInvalidConfiguration;
  using bf16 = __nv_bfloat16;
  if (route == 2) {
    if (c_dtype != 0 || ab_dtype != 1) return cudaErrorInvalidValue;
    return launch_wgmma<true>(x, w, c, g, M, N, K, x_rank, x_row, w_rank,
                              w_row, c_rank, c_row, s);
  }
  if (route != 0) return cudaErrorInvalidValue;
  if (c_dtype == 0 && ab_dtype == 0)
    return launch_simt<float, float, true>(x, w, c, g, M, N, K, x_rank,
                                           x_row, w_rank, w_row, c_rank,
                                           c_row, s);
  if (c_dtype == 1 && ab_dtype == 1)
    return launch_simt<bf16, bf16, true>(x, w, c, g, M, N, K, x_rank, x_row,
                                         w_rank, w_row, c_rank, c_row, s);
  if (c_dtype == 0 && ab_dtype == 1)
    return launch_simt<bf16, float, true>(x, w, c, g, M, N, K, x_rank, x_row,
                                          w_rank, w_row, c_rank, c_row, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* chunked_gemm_strerror(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
