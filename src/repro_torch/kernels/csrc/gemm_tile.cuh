// One output tile of a GEMM with an fp32 accumulator, for the shapes and
// dtypes that gemm_wgmma.cuh's main loop does not take: K1, K2
// (chunked_gemm.cu) and K4 (ficco_ag_matmul.cu) on the CUDA cores, and K4
// groups of more than 16 ranks on the tensor cores.
//
// A block computes a tile of out = A @ W (or, simt only, C += A @ W) where
// A's rows are reached through a Rows policy, so one loop serves a strided
// rank batch (K1, K2) and rows gathered from several ranks' shards (K4):
//
//   struct Rows {
//     int n;                           // rows in the row space
//     const TA* a(int q) const;        // row q of A (K contiguous values)
//     TO* c(int q) const;              // row q of out / C
//   };
//
// Two tiles (see chunked_gemm.cu for what bounds them):
//  * simt_tile (any dtype, any shape): 64 x 64 on the CUDA cores in fp32, a
//    16-deep K slab in shared memory, a 4 x 4 register tile per thread,
//    rows and columns masked.
//  * tc_tile (bf16 A and W, 128-multiple N, 32-multiple K, 16-byte aligned
//    rows): 128 x 128 per block of 8 warps, each warp a 64 x 32 tile of
//    16 x 16 x 16 tensor-core products (WMMA, mma.sync); 32-deep K slabs in
//    padded shared memory, the next slab's 16-byte loads in flight under
//    the current products.  With MASK, rows past Rows::n are loaded as
//    zeros and not stored; without it every tile must be full.  The
//    unmasked tile is the one to launch when Rows::n allows: the row
//    checks keep the compiler from overlapping the slab loads with the
//    products (on an H100 the masked tile takes 1.6 x as long for K1's
//    path shape).  Both do the same arithmetic on the rows they store.
// Either way K is looped inside the block in one fixed slab order, so an
// output element's value does not depend on which tile or block holds it.
// simt_tile's ACC seeds the accumulator from C instead of zero (K2).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace gemm_tile {

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

inline bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
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

// Rows [q0, q0 + 64) x columns [n0, n0 + 64); w is this rank's (K, N).
template <typename TA, typename TO, bool ACC, typename Rows>
__device__ __forceinline__ void simt_tile(const Rows& rows, int q0, int n0,
                                          const TA* __restrict__ w,
                                          long long w_row, int N, int K) {
  using namespace simt;
  // A slab stored transposed (k-major) so the inner loop reads a column of
  // the 64-row tile; +1 padding keeps the transposing store conflict-free.
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int q = q0 + ty * TM + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      acc[i][j] = (ACC && q < rows.n && gn < N) ? to_f32(rows.c(q)[gn])
                                                : 0.f;
    }
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
    // Neighbouring threads load neighbouring addresses of one row.
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const int q = q0 + r, gk = k0 + c;
      As[c][r] = (q < rows.n && gk < K) ? to_f32(rows.a(q)[gk]) : 0.f;
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
    const int q = q0 + ty * TM + i;
    if (q >= rows.n) continue;
    TO* crow = rows.c(q);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn < N) crow[gn] = from_f32<TO>(acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// tc: bf16 tensor cores, 128-multiple N, 32-multiple K
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

// Whether tc_tile takes a (K, N) weight of this rank with these strides.
inline bool tc_weight_ok(const void* w, int N, int K, long long w_rank,
                         long long w_row) {
  return N % tc::BN == 0 && K % tc::BK == 0 && aligned16(w) &&
         w_rank % 8 == 0 && w_row % 8 == 0;
}

// Rows [q0, q0 + 128) x columns [n0, n0 + 128) of a bf16 out; w is this
// rank's (K, N).  Every row Rows::a gives must be 16-byte aligned.
// Without MASK, rows [q0, q0 + 128) must all exist.
template <bool MASK, typename Rows>
__device__ __forceinline__ void tc_tile(const Rows& rows, int q0, int n0,
                                        const __nv_bfloat16* __restrict__ w,
                                        long long w_row, int K) {
  using namespace tc;
  using namespace nvcuda;
  __shared__ __align__(128) __nv_bfloat16 As[BM * LDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK * LDB];
  __shared__ __align__(128) float stage[THREADS / 32][16 * 16];

  w += n0;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;

  // The A rows this thread loads; with MASK, nullptr past the last row
  // (loaded as zeros).
  const __nv_bfloat16* arow[VA];
#pragma unroll
  for (int i = 0; i < VA; ++i) {
    const int q = q0 + (tid + i * THREADS) / (BK / 8);
    arow[i] = (!MASK || q < rows.n) ? rows.a(q) : nullptr;
  }

  uint4 ra[VA], rb[VB];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < VA; ++i) {
      const int c = ((tid + i * THREADS) % (BK / 8)) * 8;
      ra[i] = (!MASK || arow[i])
                  ? *reinterpret_cast<const uint4*>(arow[i] + k0 + c)
                  : make_uint4(0, 0, 0, 0);
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

  // Each warp moves its fragments to device memory through a 16 x 16 fp32
  // staging tile, which converts them to bf16.
  float* st = stage[warp];
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 16 * 16; e += 32) {
        const int q = q0 + wm * WM + i * 16 + e / 16;
        const int c = n0 + wn * WN + j * 16 + e % 16;
        if (!MASK || q < rows.n)
          rows.c(q)[c] = from_f32<__nv_bfloat16>(st[e]);
      }
      __syncwarp();
    }
  }
}

}  // namespace gemm_tile
