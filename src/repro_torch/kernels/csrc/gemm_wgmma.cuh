// The Hopper GEMM main loop that K1, K2 (chunked_gemm.cu) and K4
// (ficco_ag_matmul.cu) launch for bf16 operands: persistent,
// warp-specialised, fed by TMA through an mbarrier ring in shared memory
// and computed with wgmma (sm_90a).
//
// What it replaces.  K1 is the port of the TPU kernel
// repro/kernels/chunked_gemm.py::chunked_matmul, K2 of
// chunked_gemm.py::accumulate_matmul and K4 of
// repro/kernels/ficco_ag_matmul.py::ficco_ag_matmul_fused; all three used
// to run gemm_tile.cuh::tc_tile (WMMA, one 128 x 128 tile per block,
// 32-deep K slabs staged through registers, one slab in flight, and for K2
// the fp32 C read and written one element at a time).  tc_tile stays for
// the bf16 shapes this loop does not take (a group of more than 16 ranks
// in K4, whose tensor maps would not fit the kernel's parameters).
//
// What bounds it on an H100.  At the path shapes both GEMMs sit above the
// card's bf16 ridge point (K1: 11.8 GFLOP over 37 MB, K4: 47.2 GFLOP over
// 54 MB), so the floor is the tensor cores' rate.  Next come the bytes
// that reach each SM from L2: every 128 x 128 tile over K = 2048 brings
// 1 MiB of A and W into its SM, 185 MB per K1 launch (176 tiles) and
// 738 MB per K4 launch (704 tiles).  Both working sets (31-37 MB) fit in
// the 50 MB L2, so once load latency is hidden the L2->SM rate and the
// last round of tiles, not HBM, set the pace.  scripts/gemm_wgmma_ablation.py
// measures it on the card by taking parts out of this loop: on an H100 the
// loads alone take as long as the whole kernel, the products alone about
// 85-90 % of it (K4 at the path shape).
//
// What the design does about it.
//  * wgmma, the only instruction that reaches the full tensor-core rate:
//    two consumer warpgroups, each a 64 x BN slab of the 128 x BN tile as
//    m64nBNk16 products into fp32 registers.
//  * TMA fills a ring of 3-6 stages (up to 227 KB with the epilogue's
//    tile), 128 x 64 of A (one 128-byte row of K per tile row: TMA's 128B
//    swizzle, which wgmma reads without bank conflicts) and 64 x BN of W,
//    in 64-column boxes.  The weight is (K, N) with N contiguous, so W is
//    wgmma's B operand in MN-major layout (its transpose bit): no weight
//    is transposed.  One producer thread keeps the ring full; a full
//    barrier per stage counts the bytes, an empty barrier per stage takes
//    one arrival from each consumer warpgroup once its products have read
//    it.  setmaxnreg moves the producer's registers to the consumers.
//  * Clusters of 2 blocks take two tiles of the same columns, one above
//    the other, so the hardware runs the pair side by side and both read
//    the same W boxes at once.  Measured, that makes K4 about a fifth
//    faster than the same tiles in the same order without clusters.
//    Multicasting each W box into both blocks (a quarter fewer L2->SM
//    bytes, K4 738 -> 554 MB) was built and measured to save nothing, so
//    each block loads its own boxes.
//  * Persistent: as many clusters as fit on the card walk the tile pairs
//    in the order the Problem defines, so one tile's epilogue runs while
//    the producer already loads the next.  The tile width, 128 or 192
//    (pick_bn), leaves the least work on the busiest SM: K1's path shape
//    is one round of 128 x 192 tiles where 128 x 128 takes two.
//  * Tiles that pass M, N or K are zero-filled by TMA on load and clipped
//    on store, so any shape whose bases and strides are 16-byte aligned
//    runs here, not only full tiles.
//  * Epilogue: fp32 to bf16 by __float2bfloat16 (round to nearest even),
//    written into a swizzled bf16 tile in shared memory and stored by TMA,
//    which runs under the next tile's products.
//  * A Problem that accumulates (K2: C += A @ W with an fp32 C) stages
//    the fp32 sum instead and stores it with TMA's reduce-add, so L2 adds
//    it into C and no SM ever reads C.  A reduce whose lines miss in L2
//    waits on HBM, so the producer, when it starts a tile's loads, asks
//    TMA to prefetch the tile's box of C into L2, more than a tile ahead
//    of the epilogue's reduce.  (Loading C into shared memory during the
//    products and storing the sum, the other way to keep C off the
//    critical path, was built and measured slower: its second fp32
//    staging tile left the ring 3 stages.)  The sum is C + (A @ W), the
//    order of the plain version; the TPU kernel seeds its sum from C,
//    which differs in rounding only.
// K is walked in one fixed 64-deep order for every tile, so an output
// element's value does not depend on which tile, block or order holds it:
// K4's variants stay bit-identical.
//
// A Problem gives: `tiles` (even), `k`, a 3D weight map `w_map` over (N,
// K, rank), an output map `o_map` (bf16, 64 x 64 boxes; or, when
// `ACCUMULATE`, a 3D fp32 map with 32 x 64 boxes that the tile is added
// into), and `Tile tile(int t) const` (which A map and coordinates, which
// weight rank and columns, where in the output map the tile goes), where
// tiles 2P and 2P + 1 share the weight rank and columns.
//
// Tensor maps are encoded on the host with cuTensorMapEncodeTiled, reached
// through the runtime's driver entry point (no -lcuda), and passed to the
// kernel as __grid_constant__ parameters.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; nothing is linked from it
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace gemm_wgmma {

constexpr int BM = 128;
constexpr int BK = 64;  // 64 bf16: one 128-byte swizzle row
constexpr int CONSUMERS = 2;
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int A_BYTES = BM * BK * 2;
constexpr int BOX_N = 64;                  // W box: 64 columns x BK rows
constexpr int BOX_BYTES = BOX_N * BK * 2;  // 8 KB
constexpr int SMEM_MAX = 232448;           // what a block may use (227 KB)

// The tile widths: 128 or 192 columns, 64-column boxes of W each.  ACC:
// the Problem adds an fp32 tile into C (twice the epilogue's bytes, so
// fewer stages).
template <int BN, bool ACC = false>
struct Cfg {
  static_assert(BN == 128 || BN == 192, "BN: 128 or 192");
  static constexpr int STAGE_BYTES = A_BYTES + BN * BK * 2;
  // The epilogue's tile: bf16 in BN / 64 boxes of 64 columns per
  // warpgroup, or fp32 in BN / 32 boxes of 32 columns; each box is 64 rows
  // of 128 bytes (BOX_BYTES).
  static constexpr int OUT_BYTES = BM * BN * (ACC ? 4 : 2);
  // 1024 bytes of slack align the ring (the 128B swizzle repeats every 8
  // rows of 128 bytes); then the ring's barriers.
  static constexpr int FIXED = 1024 + OUT_BYTES + 2 * 6 * 8;
  static constexpr int STAGES = (SMEM_MAX - FIXED) / STAGE_BYTES < 6
                                    ? (SMEM_MAX - FIXED) / STAGE_BYTES
                                    : 6;
  static constexpr int SMEM = STAGES * STAGE_BYTES + FIXED;
  static_assert(STAGES >= 3 && SMEM <= SMEM_MAX, "shared memory");
};

// The tile width for a GEMM of `rows` row blocks times N columns on `sms`
// SMs: the one that leaves the least work on the busiest SM (rounds of
// the SMs times the tile width); 128 on a tie (more stages in the ring,
// fewer registers).
inline int pick_bn(long long rows, long long n, int sms) {
  const long long t128 = rows * ((n + 127) / 128);
  const long long t192 = rows * ((n + 191) / 192);
  return (t192 + sms - 1) / sms * 192 < (t128 + sms - 1) / sms * 128 ? 192
                                                                    : 128;
}

// One output tile, as the Problem places it.  The output map `o_map` is
// 3D (N, rows, rank) or 4D (N, rows, d, rank); TMA clips a tile's store to
// it, rows past `rows` and columns past N included.
struct Tile {
  const CUtensorMap* a_map;  // 2D (K, rows) or 3D (K, rows, rank)
  int a_row;                 // first A row
  int a_rank;                // A's rank coordinate; < 0: a_map is 2D
  int b_rank;                // the weight's rank coordinate
  int n0;                    // first column
  int o_row;                 // the output map's first row
  int o_c2, o_c3;            // its outer coordinates; o_c3 < 0: it is 3D
};

// ---------------------------------------------------------------------------
// device: shared-memory barriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits for the phase of parity `parity` to complete.  A ring that stops
// turning (a fault in the kernel) traps after about 10 s of SM clock
// instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (!start)
      start = clock64();
    else if (clock64() - start > 20000000000LL)
      __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// Asks for a box of a 3D tensor map to be brought into L2; nothing waits
// for it.
__device__ __forceinline__ void tma_prefetch_3d(const CUtensorMap* map,
                                                int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.prefetch.tensor.3d.L2.global [%0, {%1, %2, %3}];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Shared memory added into device memory (fp32 reduce-add in L2) through
// a 3D tensor map, in a bulk group.
__device__ __forceinline__ void tma_reduce_add(const CUtensorMap* map,
                                               uint32_t src, int c0, int c1,
                                               int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Shared memory to device memory through a tensor map, in a bulk group.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  if (c3 < 0)
    asm volatile(
        "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
        " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
        "r"(src), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
        " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
            reinterpret_cast<uint64_t>(map)),
        "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Until the committed stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Until the committed stores are done.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// The 128 threads of warpgroup `wg` (barrier 0 is __syncthreads').
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// A shared-memory matrix descriptor with the 128B swizzle: start address,
// leading and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
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

// Keeps the compiler from moving reads of the accumulators across a
// wgmma wait (the products write them asynchronously).
template <int R>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, fp32) += A (64 x 16, K-major) @ B (16 x N, MN-major); scale_d
// 0 ignores D's old value.
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 1;\n"
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
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n192k16(float* d, uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95},"
      " %96, %97, p, 1, 1, 0, 1;\n"
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
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b,
                                    int scale_d) {
  if constexpr (BN == 128)
    wgmma_m64n128k16(d, a, b, scale_d);
  else
    wgmma_m64n192k16(d, a, b, scale_d);
}

// ---------------------------------------------------------------------------
// the main loop
// ---------------------------------------------------------------------------

// Stores the warpgroup's 64 x BN slab of the tile: thread (warp w, lane l)
// holds rows 16w + l/4 and 16w + l/4 + 8 of columns 8i + 2(l%4) + {0, 1}.
// The slab goes into `out` as boxes of 64 rows x 128 bytes, laid out in
// TMA's 128B swizzle, so the 16-byte chunks of the 8 rows a warp writes at
// once fall in different banks: as bf16 (BN / 64 boxes of 64 columns),
// or, when the Problem accumulates, as fp32 (BN / 32 boxes of 32 columns).
// Then one thread stores the boxes through the output map (or adds them
// into it) and the warpgroup moves on: the store runs under the next
// tile's products.  Before `out` is written again the previous stores
// must have read it.
template <int BN, typename Problem>
__device__ __forceinline__ void store_tile(const float* acc, const Tile& t,
                                           const Problem& p, uint32_t out,
                                           int wg) {
  const int tid = threadIdx.x % 128;
  if (tid == 0) bulk_wait_read();
  wg_sync(wg);
  const int r0 = (tid / 32) * 16 + (tid % 32) / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      if constexpr (Problem::ACCUMULATE) {
        // Columns 8i + 2(l%4): box i/4, byte 32(i%4) + 8(l%4) of its row.
        const int chunk = (2 * (i % 4) + (tid % 4) / 2) ^ (r % 8);
        const uint32_t addr = out + (i / 4) * BOX_BYTES + r * 128 +
                              chunk * 16 + (tid % 2) * 8;
        asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr),
                     "f"(acc[4 * i + 2 * h]), "f"(acc[4 * i + 2 * h + 1])
                     : "memory");
      } else {
        const __nv_bfloat162 v = __halves2bfloat162(
            __float2bfloat16(acc[4 * i + 2 * h]),
            __float2bfloat16(acc[4 * i + 2 * h + 1]));
        const int chunk = (i % 8) ^ (r % 8);  // 16-byte chunk of the row
        const uint32_t addr = out + (i / 8) * BOX_BYTES + r * 128 +
                              chunk * 16 + (tid % 4) * 4;
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr),
                     "r"(*reinterpret_cast<const uint32_t*>(&v))
                     : "memory");
      }
    }
  }
  // The writes, made visible to the bulk copies (the async proxy).
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  wg_sync(wg);
  if (tid == 0) {
    if constexpr (Problem::ACCUMULATE) {
#pragma unroll
      for (int h = 0; h < BN / 32; ++h)
        tma_reduce_add(&p.o_map, out + h * BOX_BYTES, t.n0 + h * 32,
                       t.o_row + wg * 64, t.o_c2);
    } else {
#pragma unroll
      for (int h = 0; h < BN / BOX_N; ++h)
        tma_store(&p.o_map, out + h * BOX_BYTES, t.n0 + h * BOX_N,
                  t.o_row + wg * 64, t.o_c2, t.o_c3);
    }
    bulk_commit();
  }
}

// The tile's BM x BN box of C (BN / 32 fp32 boxes of 32 columns per
// 64 rows), into L2.
template <int BN, typename Problem>
__device__ __forceinline__ void prefetch_c(const Problem& p, const Tile& t) {
#pragma unroll
  for (int r = 0; r < BM; r += 64)
#pragma unroll
    for (int h = 0; h < BN / 32; ++h)
      tma_prefetch_3d(&p.o_map, t.n0 + h * 32, t.o_row + r, t.o_c2);
}

// The body of a kernel launched in clusters of 2 blocks of THREADS
// threads, Cfg<BN, Problem::ACCUMULATE>::SMEM bytes of dynamic shared
// memory and at most one block per SM.  The two blocks of a cluster take
// tiles 2P and 2P + 1, which the Problem gives the same weight columns, so
// the pair reads the same W boxes at the same time.
template <int BN, typename Problem>
__device__ __forceinline__ void run(const Problem& p) {
  using C = Cfg<BN, Problem::ACCUMULATE>;
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t ring = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t out = ring + C::STAGES * C::STAGE_BYTES;
  const uint32_t bars = out + C::OUT_BYTES;
  // full[s]: the producer's arrival plus the stage's TMA bytes; empty[s]:
  // one arrival from each consumer warpgroup.
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (C::STAGES + s); };
  auto a_stage = [&](int s) { return ring + s * C::STAGE_BYTES; };
  auto b_stage = [&](int s) { return ring + s * C::STAGE_BYTES + A_BYTES; };
  const int pairs = p.tiles / 2, half = blockIdx.x % 2;
  const int cluster = blockIdx.x / 2, clusters = gridDim.x / 2;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int nk = (p.k + BK - 1) / BK;
  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // Producer warpgroup: one thread issues every load.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != CONSUMERS * 128) return;
    int s = 0;
    uint32_t phase = 0;
    for (int q = cluster; q < pairs; q += clusters) {
      const Tile tile = p.tile(2 * q + half);
      if constexpr (Problem::ACCUMULATE) prefetch_c<BN>(p, tile);
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(empty(s), phase ^ 1);  // a fresh ring passes at once
        mbar_expect_tx(full(s), C::STAGE_BYTES);
        const int k0 = kb * BK;
        if (tile.a_rank < 0)
          tma_load_2d(a_stage(s), tile.a_map, full(s), k0, tile.a_row);
        else
          tma_load_3d(a_stage(s), tile.a_map, full(s), k0, tile.a_row,
                      tile.a_rank);
#pragma unroll
        for (int h = 0; h < BN / BOX_N; ++h)
          tma_load_3d(b_stage(s) + h * BOX_BYTES, &p.w_map, full(s),
                      tile.n0 + h * BOX_N, k0, tile.b_rank);
        if (++s == C::STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // Consumer warpgroups: rows [64 wg, 64 wg + 64) of each tile.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const bool signals = threadIdx.x % 128 == 0;
  int s = 0;
  uint32_t phase = 0;
  for (int q = cluster; q < pairs; q += clusters) {
    const Tile tile = p.tile(2 * q + half);
    int prev = 0;
    for (int kb = 0; kb < nk; ++kb) {
      mbar_wait(full(s), phase);
      // A: K-major, 8-row groups 1024 bytes apart; a 16-deep step is 32
      // bytes along the swizzled row.  B: MN-major, 8-row (K) groups 1024
      // bytes apart, 64-column boxes BOX_BYTES apart; a 16-deep step is 16
      // rows of 128 bytes.
      const uint32_t a = a_stage(s) + wg * 64 * BK * 2;
      const uint32_t b = b_stage(s);
      fence_acc<BN / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        mma<BN>(acc, smem_desc(a + kk * 32, 16, 1024),
                smem_desc(b + kk * 16 * 128, BOX_BYTES, 1024),
                (kb | kk) != 0);
      wgmma_commit();
      fence_acc<BN / 2>(acc);
      // The previous stage's products are done: hand it back.
      wgmma_wait<1>();
      if (kb > 0 && signals) mbar_arrive(empty(prev));
      prev = s;
      if (++s == C::STAGES) {
        s = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc<BN / 2>(acc);
    if (signals) mbar_arrive(empty(prev));
    store_tile<BN>(acc, tile, p, out + wg * (C::OUT_BYTES / 2), wg);
  }
  if (signals) bulk_wait();
}

// ---------------------------------------------------------------------------
// host: tensor maps and the launch
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A bf16 (or `type`) map over `rank` dims (innermost first), `strides`
// the rank - 1 outer strides in elements, boxes of `box`, 128B swizzle,
// zero fill.
inline cudaError_t encode(
    CUtensorMap* map, const void* base, int rank, const long long* dims,
    const long long* strides, const int* box,
    CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const EncodeTiled fn = encoder();
  if (!fn) return cudaErrorNotSupported;
  if (rank < 2 || rank > 4) return cudaErrorInvalidValue;
  cuuint64_t gdim[4], gstride[3];
  cuuint32_t bdim[4], estride[4] = {1, 1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    gdim[i] = static_cast<cuuint64_t>(dims[i]);
    bdim[i] = static_cast<cuuint32_t>(box[i]);
  }
  for (int i = 0; i + 1 < rank; ++i)
    gstride[i] = static_cast<cuuint64_t>(strides[i]) *
                 (type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2);
  const CUresult r = fn(map, type, rank,
                        const_cast<void*>(base), gdim, gstride, bdim,
                        estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The 3D weight map over (N, K, g), boxes of 64 columns x BK rows.
inline cudaError_t encode_weight(CUtensorMap* map, const void* w, int g,
                                 int N, int K, long long w_rank,
                                 long long w_row) {
  const long long dims[3] = {N, K, g};
  const long long strides[2] = {w_row, w_rank};
  const int box[3] = {BOX_N, BK, 1};
  return encode(map, w, 3, dims, strides, box);
}

// The current device's SM count, read once per device.
inline cudaError_t sm_count(int* n) {
  static int cache[64] = {};
  int dev;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!cache[dev]) {
    const cudaError_t e = cudaDeviceGetAttribute(
        &cache[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  *n = cache[dev];
  return cudaSuccess;
}

// Launches `kernel` (whose body is run<BN>) in clusters of 2 blocks, as
// many clusters as fit on the card at once (at most one per pair of
// tiles); p.tiles must be even.
template <int BN, typename Problem>
cudaError_t launch(void (*kernel)(Problem), const Problem& p,
                   cudaStream_t s) {
  static int fit[64] = {};  // per device: clusters that fit at once
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || p.tiles % 2) return cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Cfg<BN, Problem::ACCUMULATE>::SMEM;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (!fit[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Cfg<BN, Problem::ACCUMULATE>::SMEM);
    if (err != cudaSuccess) return err;
    int sms = 0;
    err = sm_count(&sms);
    if (err != cudaSuccess) return err;
    cfg.gridDim = dim3(sms);
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (n < 1) return cudaErrorInvalidConfiguration;
    fit[dev] = n;
  }
  const int clusters = p.tiles / 2 < fit[dev] ? p.tiles / 2 : fit[dev];
  cfg.gridDim = dim3(2 * clusters);
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace gemm_wgmma
