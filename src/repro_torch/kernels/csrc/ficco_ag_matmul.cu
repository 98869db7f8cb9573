// K4: the FiCCO all-gather and the step GEMM in one kernel.
//
// Replaces the TPU kernel
// repro/kernels/ficco_ag_matmul.py::ficco_ag_matmul_fused (body
// _fused_kernel): for every rank r of the group, out[r] = all_gather(x) @
// w[r], with the sum in fp32 and cast to x's dtype.  The TPU kernel pushes
// chunk s+1 to every peer's VMEM slot while its MXU multiplies chunk s,
// with no gather kernel (chunks land in place in the step buffer) and no
// scatter kernel (output rows are written straight to their final rows).
//
// What the port keeps.  There is no gather and no scatter here either: a
// block's A tile is loaded straight from the owning rank's chunk through a
// per-rank pointer table (on one card the logical ranks' shards; across
// cards the same table would hold peer-mapped pointers), and every output
// row is stored straight into its final row d*m_s + s*m_c + i.  The
// variant's chunk count and dispatch order map pipeline positions onto
// blocks: grid row y covers position y / tiles_per_step, which carries
// chunk s = pos (or steps-1-pos in reverse), so blocks of earlier positions
// are dispatched first.  The K loop uses one fixed slab depth whatever the
// variant and every output element is one full-K dot, so all variants are
// bit-identical, as the reference requires of its variants.  On one card
// there are no slot buffers to rotate: buffer_depth is checked and moves
// nothing; the push / slot / release-flag protocol of the TPU kernel comes
// with groups over several cards.
//
// What bounds it on an H100: at the path shape (4 ranks, m_s 512, K 2048,
// n_local 1408, bf16) a launch does 47.2 GFLOP over 54 MB read once and
// written once, about 870 operations per byte: the tensor cores' bf16 rate.
// The design is K1's: one output tile of gemm_tile.cuh per block, with the
// A rows addressed through the table.  For bf16 with 128-multiple N and
// 32-multiple K, 128 x 128 tiles of WMMA tensor-core products; otherwise
// (f32, other shapes) 64 x 64 tiles on the CUDA cores in fp32.  Rows past
// the step buffer's end are masked, so the path taken never depends on the
// variant.  A persistent, TMA-fed design is the later, faster version.
//
// Strides are in elements; the last dim of x, w and out is contiguous.

#include "gemm_tile.cuh"

namespace {

using namespace gemm_tile;

constexpr int MAX_RANKS = 64;

// Rank d's (m_s, K) row shard, by value in the kernel's parameters
// (__grid_constant__, so the rows read it in place, not from a copy).
struct RankTable {
  const void* x[MAX_RANKS];
};

// The rows of one pipeline step's buffer: row q is row i = q % m_c of
// chunk s of rank d = q / m_c, and lands in output row d*m_s + s*m_c + i.
template <typename T>
struct StepRows {
  int n;  // g * m_c
  const RankTable* table;
  T* out;  // this block's rank's (g*m_s, n_local) output
  int m_s, m_c, s;
  long long x_row, o_row;
  __device__ __forceinline__ const T* a(int q) const {
    return static_cast<const T*>(table->x[q / m_c]) +
           (static_cast<long long>(s) * m_c + q % m_c) * x_row;
  }
  __device__ __forceinline__ T* c(int q) const {
    return out + (static_cast<long long>(q / m_c) * m_s + s * m_c +
                  q % m_c) * o_row;
  }
};

// Block (x, y, z) -> rank z's rows of the chunk that pipeline position
// y / tiles_per_step carries, and the first row of its tile.
template <typename T>
__device__ __forceinline__ StepRows<T> step_rows(
    const RankTable* table, T* out, int g, int m_s, int m_c, int steps,
    int reverse, int tiles_per_step, int bm, long long x_row,
    long long o_rank, long long o_row, int* q0) {
  const int pos = blockIdx.y / tiles_per_step;
  *q0 = (blockIdx.y % tiles_per_step) * bm;
  return StepRows<T>{g * m_c, table, out + blockIdx.z * o_rank, m_s, m_c,
                     reverse ? steps - 1 - pos : pos, x_row, o_row};
}

template <typename T>
__global__ void __launch_bounds__(simt::THREADS) ag_matmul_simt_kernel(
    const __grid_constant__ RankTable table, const T* __restrict__ w,
    T* __restrict__ out,
    int g, int m_s, int m_c, int steps, int reverse, int tiles_per_step,
    int N, int K, long long x_row, long long w_rank, long long w_row,
    long long o_rank, long long o_row) {
  int q0;
  const StepRows<T> rows =
      step_rows(&table, out, g, m_s, m_c, steps, reverse, tiles_per_step,
                simt::BM, x_row, o_rank, o_row, &q0);
  simt_tile<T, T, false>(rows, q0, blockIdx.x * simt::BN,
                         w + blockIdx.z * w_rank, w_row, N, K);
}

template <bool MASK>
__global__ void __launch_bounds__(tc::THREADS) ag_matmul_tc_kernel(
    const __grid_constant__ RankTable table,
    const __nv_bfloat16* __restrict__ w, __nv_bfloat16* __restrict__ out,
    int g, int m_s, int m_c, int steps, int reverse, int tiles_per_step,
    int K, long long x_row, long long w_rank, long long w_row,
    long long o_rank, long long o_row) {
  int q0;
  const StepRows<__nv_bfloat16> rows =
      step_rows(&table, out, g, m_s, m_c, steps, reverse, tiles_per_step,
                tc::BM, x_row, o_rank, o_row, &q0);
  tc_tile<__nv_bfloat16, false, MASK>(rows, q0, blockIdx.x * tc::BN,
                                      w + blockIdx.z * w_rank, w_row, K);
}

}  // namespace

// x: g pointers, rank d's (m_s, K) shard at x[d] with row stride x_row.
// w: (g, K, n) with rank stride w_rank and row stride w_row; out: (g,
// g*m_s, n) with rank stride o_rank and row stride o_row.  The shard is cut
// into `steps` chunks of m_s / steps rows, dispatched in reverse order when
// `reverse`.  depth: the TPU kernel's step-buffer slots (2..steps, or 2 for
// a single step); checked, and unused on one card.  dtype: 0 = float32,
// 1 = bfloat16.  Returns a cudaError_t.
extern "C" int ficco_ag_matmul(
    const void* const* x, int g, const void* w, void* out, int dtype,
    int m_s, int n, int k, int steps, int depth, int reverse,
    long long x_row, long long w_rank, long long w_row,
    long long o_rank, long long o_row, void* stream) {
  if (g < 1 || g > MAX_RANKS || m_s < 1 || n < 1 || k < 1 || steps < 1 ||
      m_s % steps || depth < 2 || (steps > 1 && depth > steps))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RankTable table = {};
  bool x_aligned = x_row % 8 == 0;
  for (int d = 0; d < g; ++d) {
    table.x[d] = x[d];
    x_aligned = x_aligned && aligned16(x[d]);
  }
  const int m_c = m_s / steps;
  const int rows = g * m_c;
  if (dtype == 1 && x_aligned && tc_weight_ok(w, n, k, w_rank, w_row)) {
    const int tiles = (rows + tc::BM - 1) / tc::BM;
    if (static_cast<long long>(tiles) * steps > 65535)
      return cudaErrorInvalidConfiguration;
    const dim3 grid(n / tc::BN, tiles * steps, g);
    // Full tiles skip the row checks; the arithmetic is the same either
    // way, so variants that differ in chunk count stay bit-identical.
    auto kernel = rows % tc::BM ? ag_matmul_tc_kernel<true>
                                : ag_matmul_tc_kernel<false>;
    kernel<<<grid, tc::THREADS, 0, s>>>(
        table, static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), g, m_s, m_c, steps, reverse, tiles,
        k, x_row, w_rank, w_row, o_rank, o_row);
    return cudaGetLastError();
  }
  const int tiles = (rows + simt::BM - 1) / simt::BM;
  if (static_cast<long long>(tiles) * steps > 65535)
    return cudaErrorInvalidConfiguration;
  const dim3 grid((n + simt::BN - 1) / simt::BN, tiles * steps, g);
  if (dtype == 0) {
    ag_matmul_simt_kernel<float><<<grid, simt::THREADS, 0, s>>>(
        table, static_cast<const float*>(w), static_cast<float*>(out), g,
        m_s, m_c, steps, reverse, tiles, n, k, x_row, w_rank, w_row, o_rank,
        o_row);
  } else if (dtype == 1) {
    ag_matmul_simt_kernel<__nv_bfloat16><<<grid, simt::THREADS, 0, s>>>(
        table, static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), g, m_s, m_c, steps, reverse, tiles,
        n, k, x_row, w_rank, w_row, o_rank, o_row);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

extern "C" const char* ficco_ag_matmul_strerror(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
