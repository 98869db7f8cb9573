// K1: tiled GEMM with an fp32 accumulator, batched over logical ranks.
//
// Replaces the TPU kernel repro/kernels/chunked_gemm.py::chunked_matmul
// (body _matmul_kernel): out = x @ w with the sum kept in fp32 across the
// K blocks and cast to x's dtype at the end.  On the FiCCO path it is the
// step GEMM of ficco_uniform_fused_1d_dma: every logical rank multiplies
// its gathered (g*m_c, K) step buffer by its own (K, n_local) weight
// shard, and grid dimension z runs over the ranks, so one launch does all
// ranks' step GEMMs.
//
// What bounds it on an H100: at the path shape (4 ranks x 512 x 2048 x
// 1408, bf16) a launch does 11.8 GFLOP against 37 MB of compulsory
// traffic, about 320 operations per byte, above the card's bf16 ridge
// point (its tensor-core peak over its memory rate): the bound is the
// tensor cores' bf16 rate.
//
// What the design does about it, in two kernels of one shape each: K is
// looped inside the block (it takes the place of the TPU grid's
// sequential K dimension, so nothing is carried between blocks), the
// running sum stays in fp32 registers, and the result is cast once.
//  * tc (bf16, 128-multiple M and N, 32-multiple K, 16-byte aligned
//    rows): a 128 x 128 output tile per block of 8 warps, each warp a
//    64 x 32 tile of 16 x 16 x 16 tensor-core products (WMMA, mma.sync);
//    32-deep K slabs of A and B are staged in padded shared memory, and
//    the next slab is loaded into registers with 16-byte loads while the
//    tensor cores work on the current one.
//  * simt (f32, and any shape the tc tile does not divide): a 64 x 64 tile
//    on the CUDA cores in fp32, a 16-deep K slab in shared memory and a
//    4 x 4 register tile per thread; edges are masked.  f32 stays off the
//    tensor cores, whose fp32 input mode (TF32) keeps only 10 bits.
// The Python wrapper keeps the reference's divisibility ValueError.
// wgmma with TMA-fed shared-memory rings is the later, faster version.
//
// Strides are in elements; the last dim of x, w and out is contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch does
}

// ---------------------------------------------------------------------------
// simt: CUDA cores, any shape
// ---------------------------------------------------------------------------

namespace simt {
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
}  // namespace simt

template <typename T>
__global__ void __launch_bounds__(simt::THREADS) chunked_gemm_simt_kernel(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
    int M, int N, int K,
    long long x_rank, long long x_row,
    long long w_rank, long long w_row,
    long long o_rank, long long o_row) {
  using namespace simt;
  // A slab stored transposed (k-major) so the inner loop reads a column of
  // the 64-row tile; +1 padding keeps the transposing store conflict-free.
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];

  const long long rank = blockIdx.z;
  x += rank * x_rank;
  w += rank * w_rank;
  out += rank * o_rank;

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // Neighbouring threads load neighbouring addresses of one row.
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? to_f32(x[gm * x_row + gk]) : 0.f;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < K && gn < N) ? to_f32(w[gk * w_row + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn < N) out[gm * o_row + gn] = from_f32<T>(acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// tc: bf16 tensor cores, tile-divisible shapes
// ---------------------------------------------------------------------------

namespace tc {
constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int WARPS_M = 2;
constexpr int WARPS_N = 4;
constexpr int WM = BM / WARPS_M;  // 64 rows per warp
constexpr int WN = BN / WARPS_N;  // 32 columns per warp
constexpr int FM = WM / 16;       // 4 fragments down
constexpr int FN = WN / 16;       // 2 fragments across
constexpr int THREADS = 32 * WARPS_M * WARPS_N;  // 256
// Row pitches padded by 8 bf16 (16 bytes) against bank conflicts; both
// stay multiples of 8 elements, as WMMA's loads need.
constexpr int LDA = BK + 8;
constexpr int LDB = BN + 8;
// 16-byte vectors per thread for one A slab (BM x BK) and one B slab.
constexpr int VA = BM * BK / 8 / THREADS;  // 2
constexpr int VB = BK * BN / 8 / THREADS;  // 2
}  // namespace tc

__global__ void __launch_bounds__(tc::THREADS) chunked_gemm_tc_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    __nv_bfloat16* __restrict__ out,
    int K,
    long long x_rank, long long x_row,
    long long w_rank, long long w_row,
    long long o_rank, long long o_row) {
  using namespace tc;
  using namespace nvcuda;
  __shared__ __align__(128) __nv_bfloat16 As[BM * LDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK * LDB];
  __shared__ __align__(128) float stage[THREADS / 32][16 * 16];

  const long long rank = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  x += rank * x_rank + m0 * x_row;
  w += rank * w_rank + n0;
  out += rank * o_rank + m0 * o_row + n0;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;

  uint4 ra[VA], rb[VB];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < VA; ++i) {
      const int v = tid + i * THREADS;
      const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
      ra[i] = *reinterpret_cast<const uint4*>(x + r * x_row + k0 + c);
    }
#pragma unroll
    for (int i = 0; i < VB; ++i) {
      const int v = tid + i * THREADS;
      const int r = v / (BN / 8), c = (v % (BN / 8)) * 8;
      rb[i] = *reinterpret_cast<const uint4*>(w + (k0 + r) * w_row + c);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < VA; ++i) {
      const int v = tid + i * THREADS;
      const int r = v / (BK / 8), c = (v % (BK / 8)) * 8;
      *reinterpret_cast<uint4*>(&As[r * LDA + c]) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < VB; ++i) {
      const int v = tid + i * THREADS;
      const int r = v / (BN / 8), c = (v % (BN / 8)) * 8;
      *reinterpret_cast<uint4*>(&Bs[r * LDB + c]) = rb[i];
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();  // every warp is done reading the previous slab
    store();
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);  // in flight under the products below
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * WM + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * LDB + wn * WN + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }

  // Each warp casts its fragments through a 16 x 16 fp32 staging tile.
  float* st = stage[warp];
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 16 * 16; e += 32) {
        const int r = wm * WM + i * 16 + e / 16;
        const int c = wn * WN + j * 16 + e % 16;
        out[r * o_row + c] = __float2bfloat16(st[e]);
      }
      __syncwarp();
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t.
extern "C" int chunked_gemm(
    const void* x, const void* w, void* out, int dtype,
    int g, int M, int N, int K,
    long long x_rank, long long x_row,
    long long w_rank, long long w_row,
    long long o_rank, long long o_row,
    void* stream) {
  if (g < 1 || M < 1 || N < 1 || K < 1) return cudaErrorInvalidValue;
  if (g > 65535) return cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tc_tile = dtype == 1 && M % tc::BM == 0 && N % tc::BN == 0 &&
                       K % tc::BK == 0 && aligned16(x) && aligned16(w) &&
                       x_rank % 8 == 0 && x_row % 8 == 0 &&
                       w_rank % 8 == 0 && w_row % 8 == 0;
  if (tc_tile) {
    if (M / tc::BM > 65535) return cudaErrorInvalidConfiguration;
    const dim3 grid(N / tc::BN, M / tc::BM, g);
    chunked_gemm_tc_kernel<<<grid, tc::THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), K,
        x_rank, x_row, w_rank, w_row, o_rank, o_row);
    return cudaGetLastError();
  }
  const int grid_y = (M + simt::BM - 1) / simt::BM;
  if (grid_y > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((N + simt::BN - 1) / simt::BN, grid_y, g);
  if (dtype == 0) {
    chunked_gemm_simt_kernel<float><<<grid, simt::THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), M, N, K,
        x_rank, x_row, w_rank, w_row, o_rank, o_row);
  } else if (dtype == 1) {
    chunked_gemm_simt_kernel<__nv_bfloat16><<<grid, simt::THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), M, N, K,
        x_rank, x_row, w_rank, w_row, o_rank, o_row);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

extern "C" const char* chunked_gemm_strerror(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
