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
// tile's A rows are loaded straight from the owning rank's shard, through
// one tensor map per rank (wgmma route) or a per-rank pointer table (wmma
// and simt routes); on one card these hold the logical ranks' shards,
// across processes the peers' shards mapped by CUDA IPC (another card's
// memory over NVLink when each rank has its own card).  Every output
// row is stored straight into its final row d*m_s + s*m_c + i.  The
// variant's chunk count and dispatch order set only the order in which
// tiles are taken up, earlier pipeline positions first.  A launch computes
// the blocks of `outs` destination ranks: all g of a logical group on one
// card, or one, its own, for a rank of a group of processes.  With peer
// reads there are no slot buffers to rotate: buffer_depth is checked and
// moves nothing.  Across processes the TPU kernel's push / slot /
// release-flag protocol becomes counters around the launch (the Python
// wrapper's): ready counters order it after every peer's shard is written,
// release counters keep a rank from overwriting its shard while a peer's
// launch still reads it.
//
// What bounds it on an H100: at the path shape (4 ranks, m_s 512, K 2048,
// n_local 1408, bf16) a launch does 47.2 GFLOP over 54 MB read once and
// written once, about 870 operations per byte: the tensor cores' bf16 rate
// first, then the 738 MB that its 704 tiles of 128 x 128 bring from L2
// into the SMs (the gathered A 44 x 8.4 MB, W 16 x 23 MB).
//
// What the design does about it.  The wrapper names the route, and a route
// that cannot take the operands refuses them (cudaErrorInvalidValue):
//  * wgmma (bf16, bases 16-byte aligned, strides multiples of 8 elements,
//    a group of at most MAX_WGMMA_RANKS): gemm_wgmma.cuh's persistent
//    main loop, TMA-fed through an mbarrier ring.  The rank table becomes
//    one 2D tensor map per rank over its (m_s, K) shard (across cards the
//    maps point at the peers' shards on their cards, and TMA loads them
//    over NVLink: on four H100s every call gave the logical launch's bits,
//    so the route needs no local copy of a peer's shard and no slot
//    ring), plus a 3D map of the
//    weight and a 4D map of the output; g + 2 maps of 128 bytes in the
//    kernel's parameters.  A tile is (rank r, source rank d, row block j
//    of d's shard, column block), 128 rows by 128 or 192 columns
//    (gemm_wgmma::pick_bn; at the path shape 128, 704 tiles): output row
//    d*m_s + j*128 + i is x[d, j*128 + i] @ w[r] whatever the chunking,
//    and rows past the shard are zero-filled on load and clipped on store
//    (the output map is (N, m_s, d, r)).  The variant sets only the order
//    in which the persistent blocks walk the tiles: by pipeline position,
//    the chunk of the tile's first row, which grows with j (a shard's
//    chunks are consecutive row ranges), so the walk is by row block, last
//    first for `reverse`.
//  * wmma (bf16, 128-multiple N, 32-multiple K, 16-byte aligned rows; any
//    group up to MAX_RANKS): one 128 x 128 WMMA tile of gemm_tile.cuh per
//    block, A rows read through the pointer table, grid rows mapped onto
//    pipeline positions.
//  * simt (f32, and other shapes): 64 x 64 tiles on the CUDA cores.
// Every route loops K in one fixed order whatever the variant, and every
// output element is one full-K dot, so all variants of a route are
// bit-identical; the route never depends on the variant.
//
// Strides are in elements; the last dim of x, w and out is contiguous.

#include "gemm_tile.cuh"
#include "gemm_wgmma.cuh"

namespace {

using namespace gemm_tile;

constexpr int MAX_RANKS = 64;
// The wgmma route's cap: its g + 1 tensor maps stay within the 4 KB of
// kernel parameters.
constexpr int MAX_WGMMA_RANKS = 16;

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
  tc_tile<MASK>(rows, q0, blockIdx.x * tc::BN, w + blockIdx.z * w_rank,
                w_row, K);
}

// The wgmma route's tiles, walked by pairs of row blocks first (last first
// for `reverse`), then source rank d, destination rank r, column block;
// tiles 2P and 2P + 1 (a cluster's pair) are the two row blocks of one
// pair, with the same weight columns.  The row blocks are counted up to an
// even number; a last, empty one loads zeros and stores nothing.
template <int BN>
struct AgProblem {
  static constexpr bool ACCUMULATE = false;
  CUtensorMap w_map;                   // (N, K, outs)
  CUtensorMap o_map;                   // (N, m_s, d, r): row d*m_s + i
  CUtensorMap x_map[MAX_WGMMA_RANKS];  // rank d's (K, m_s)
  int g, outs, k, mt, nt, tiles, reverse;  // mt even
  __device__ __forceinline__ gemm_wgmma::Tile tile(int t) const {
    const int per_pair = g * outs * nt, pair = t / 2;
    const int jq = pair / per_pair, rem = pair % per_pair;
    const int d = rem / (outs * nt), r = (rem / nt) % outs;
    const int n0 = (rem % nt) * BN;
    const int j = 2 * (reverse ? mt / 2 - 1 - jq : jq) + t % 2;
    const int m0 = j * gemm_wgmma::BM;
    return gemm_wgmma::Tile{&x_map[d], m0, -1, r, n0, m0, d, r};
  }
};

template <int BN>
__global__ void __launch_bounds__(gemm_wgmma::THREADS, 1)
    ag_matmul_wgmma_kernel(const __grid_constant__ AgProblem<BN> p) {
  gemm_wgmma::run<BN>(p);
}

template <int BN>
int launch_wgmma_bn(const void* const* x, int g, int outs, const void* w,
                    void* out, int m_s, int n, int k, int reverse,
                    long long x_row,
                    long long w_rank, long long w_row, long long o_rank,
                    long long o_row, cudaStream_t s) {
  using namespace gemm_wgmma;
  AgProblem<BN> p;
  const long long x_dims[2] = {k, m_s}, x_strides[1] = {x_row};
  const int x_box[2] = {BK, BM};
  for (int d = 0; d < g; ++d) {
    const cudaError_t err =
        encode(&p.x_map[d], x[d], 2, x_dims, x_strides, x_box);
    if (err != cudaSuccess) return err;
  }
  // The output viewed as (N, m_s, d, r), so a tile's store is clipped at
  // the end of source rank d's rows.
  const long long o_dims[4] = {n, m_s, g, outs};
  const long long o_strides[3] = {o_row, m_s * o_row, o_rank};
  const int o_box[4] = {BOX_N, 64, 1, 1};
  cudaError_t err = encode_weight(&p.w_map, w, outs, n, k, w_rank, w_row);
  if (err == cudaSuccess)
    err = encode(&p.o_map, out, 4, o_dims, o_strides, o_box);
  if (err != cudaSuccess) return err;
  p.g = g;
  p.outs = outs;
  p.k = k;
  p.mt = (m_s + 2 * BM - 1) / (2 * BM) * 2;
  p.nt = (n + BN - 1) / BN;
  const long long tiles = static_cast<long long>(p.mt) * g * outs * p.nt;
  if (tiles > (1LL << 30)) return cudaErrorInvalidConfiguration;
  p.tiles = static_cast<int>(tiles);
  p.reverse = reverse;
  return launch<BN>(ag_matmul_wgmma_kernel<BN>, p, s);
}

// The wgmma route, at gemm_wgmma::pick_bn's tile width.
int launch_wgmma(const void* const* x, int g, int outs, const void* w,
                 void* out, int m_s, int n, int k, int reverse,
                 long long x_row,
                 long long w_rank, long long w_row, long long o_rank,
                 long long o_row, cudaStream_t s) {
  bool ok = g <= MAX_WGMMA_RANKS && aligned16(w) && aligned16(out) &&
            x_row % 8 == 0 && w_rank % 8 == 0 && w_row % 8 == 0 &&
            o_rank % 8 == 0 && o_row % 8 == 0;
  for (int d = 0; ok && d < g; ++d) ok = aligned16(x[d]);
  if (!ok) return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t err = gemm_wgmma::sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long rows =
      static_cast<long long>(g) * outs *
      ((m_s + 2 * gemm_wgmma::BM - 1) / (2 * gemm_wgmma::BM) * 2);
  if (gemm_wgmma::pick_bn(rows, n, sms) == 192)
    return launch_wgmma_bn<192>(x, g, outs, w, out, m_s, n, k, reverse,
                                x_row, w_rank, w_row, o_rank, o_row, s);
  return launch_wgmma_bn<128>(x, g, outs, w, out, m_s, n, k, reverse,
                              x_row, w_rank, w_row, o_rank, o_row, s);
}

}  // namespace

// x: g pointers, rank d's (m_s, K) shard at x[d] with row stride x_row.
// outs: the destination ranks computed, g (a logical group's every
// block) or 1 (one rank's own, across processes).  w: (outs, K, n) with
// rank stride w_rank and row stride w_row; out: (outs, g*m_s, n) with rank
// stride o_rank and row stride o_row.  The shard is cut into `steps`
// chunks of m_s / steps rows, dispatched in reverse order when `reverse`.
// depth: the TPU kernel's step-buffer slots (2..steps, or 2 for a single
// step); checked, and unused (peer reads need no ring).  dtype: 0 =
// float32, 1 = bfloat16.  route: 0 = simt, 1 = wmma (the tc tile), 2 =
// wgmma; f32 takes only simt.  Returns a cudaError_t; cudaErrorInvalidValue when the
// route cannot take the operands.
extern "C" int ficco_ag_matmul(
    const void* const* x, int g, int outs, const void* w, void* out,
    int dtype, int route, int m_s, int n, int k, int steps, int depth,
    int reverse,
    long long x_row, long long w_rank, long long w_row,
    long long o_rank, long long o_row, void* stream) {
  if (g < 1 || g > MAX_RANKS || outs < 1 || outs > g || m_s < 1 || n < 1 ||
      k < 1 || steps < 1 ||
      m_s % steps || depth < 2 || (steps > 1 && depth > steps) ||
      route < 0 || route > 2 || (dtype == 0 && route != 0) ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 2)
    return launch_wgmma(x, g, outs, w, out, m_s, n, k, reverse, x_row,
                        w_rank, w_row, o_rank, o_row, s);
  RankTable table = {};
  bool x_aligned = x_row % 8 == 0;
  for (int d = 0; d < g; ++d) {
    table.x[d] = x[d];
    x_aligned = x_aligned && aligned16(x[d]);
  }
  const int m_c = m_s / steps;
  const int rows = g * m_c;
  if (route == 1) {
    if (!x_aligned || !tc_weight_ok(w, n, k, w_rank, w_row))
      return cudaErrorInvalidValue;
    const int tiles = (rows + tc::BM - 1) / tc::BM;
    if (static_cast<long long>(tiles) * steps > 65535)
      return cudaErrorInvalidConfiguration;
    const dim3 grid(n / tc::BN, tiles * steps, outs);
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
  const dim3 grid((n + simt::BN - 1) / simt::BN, tiles * steps, outs);
  if (dtype == 0) {
    ag_matmul_simt_kernel<float><<<grid, simt::THREADS, 0, s>>>(
        table, static_cast<const float*>(w), static_cast<float*>(out), g,
        m_s, m_c, steps, reverse, tiles, n, k, x_row, w_rank, w_row, o_rank,
        o_row);
  } else {
    ag_matmul_simt_kernel<__nv_bfloat16><<<grid, simt::THREADS, 0, s>>>(
        table, static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), g, m_s, m_c, steps, reverse, tiles,
        n, k, x_row, w_rank, w_row, o_rank, o_row);
  }
  return cudaGetLastError();
}

extern "C" const char* ficco_ag_matmul_strerror(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
