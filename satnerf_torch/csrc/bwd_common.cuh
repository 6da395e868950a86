// Building blocks of the hand-written backward passes K2 (heads, field_bwd.cu)
// and K4 (trunk, trunk_bwd.cu).
//
// The TPU kernels they replace (satnerf_tpu/ops/pallas/field_fused.py:
// _heads_bwd_kernel, satnerf_tpu/ops/pallas/trunk.py: _bwd_kernel,
// _bwd_kernel_stored, _bwd_sweep) walk the point tiles on a SEQUENTIAL grid:
// each grid step recomputes the tile's activations in VMEM, runs the reverse
// sweep, and adds the tile's weight gradients into output blocks that stay
// resident across the grid. A CUDA grid runs in parallel and a block has
// 227 KB of shared memory, far below one tile's (L, tile, F) stash. So the
// backward is split into two kinds of launch, both deterministic and free of
// float atomics:
//
//  - the row GEMM: one layer (or one head layer) for every point,
//    v = sum_j A_j W_j [+ add] [+ bias], then one epilogue: a forward layer
//    (linear, sine, ReLU: the recompute) or a backward one
//    (ga = g * cos(scale * a) * scale, or ga = [a > 0] g). Its results go to
//    global workspaces in f32 and/or the compute dtype; that is where the TPU
//    kernel's VMEM stash lives on this card.
//  - the reduction: every weight gradient dW = A^T B (f32 sums of
//    compute-dtype products) and every bias gradient db = sum_n B[n] of one
//    backward, over fixed chunks of kSplitRows rows, then a second small
//    launch that adds the chunks' partial sums in chunk order. The result
//    depends on the rows alone, never on the launch, and two runs agree bit
//    for bit.
//
// What bounds them on an H100: operations. Per point the flagship backward
// does ~2.8 M (heads) + 3.8-5.7 M (trunk) multiply-adds against a few kB of
// workspace traffic, so both blocks run on the tensor cores (wgmma,
// wgmma.cuh). The f32 compute dtype (the flagship's) runs 3xTF32: each
// operand x = hi + lo with hi, lo tf32, and a tile sums lo*hi + hi*lo + hi*hi
// in f32, about 22 significant bits; bf16 operands go as they are. A pass
// costs 3 x its FLOP in f32 (495 TFLOP/s tf32) and 1 x in bf16 (989). Next
// come the bytes that reach each SM: an f32 128 x 128 tile's 32-column chunk
// needs 16 KB of A and 32 KB of B (hi + lo) for 0.84 us of tensor time,
// ~7.5 TB/s over 132 SMs, above what L2 delivers; and every byte staged
// twice through shared memory costs tensor time there too.
//
// Both blocks are warp-specialised and persistent: one block of 384 threads
// per SM walks its share of the output tiles (the row GEMM's 128 x BN tiles,
// the reduction's (dW tile, row chunk) items) in a fixed order. A producer
// warpgroup (setmaxnreg.dec) keeps the next chunks in flight into a ring of
// stages, each with a "full" and an "empty" mbarrier; two consumer
// warpgroups (setmaxnreg.inc) own 64 rows of the tile each and run the
// wgmmas. No block-wide barrier runs after the start.
//
// The row GEMM (row_ws_kernel). What held the earlier design (a row kernel
// of two warpgroups that staged its own operands) back, and what this one
// does:
//  1. The consumers staged A through registers beside their MMAs, one block
//     per SM. Now the producer copies A raw with cp.async into a 128-byte
//     swizzled tile, and B arrives by one bulk copy per chunk from tiles
//     prepared once per backward by prep_kernel (ops/_bwd.py:row_weight:
//     W^T cut into BN x 128-byte tiles, swizzled, contiguous, hi then lo in
//     f32). In f32 the consumers load their A fragments from the swizzled
//     tile (a fragment's eight rows on eight 16-byte columns: no bank
//     conflict) and split them into tf32 hi + lo in registers for
//     register-A wgmma (tc::mma_rs): the A tile's hi/lo stores and their
//     second reads are gone.
//  2. f32 waited for each k-step's three MMAs before adding them into the
//     f32 total. Now a k-step runs as two units, its column halves
//     (m64n(BN/2) wgmmas), into two accumulators that alternate: a unit is
//     issued before the previous one's sum joins the total (wg_wait<1>).
//     Halves, not two full-width accumulators, because the total, two
//     accumulators and two fragment sets then take 144 of the consumers'
//     232 registers: at full width ptxas spilled. The numerics are the earlier design's:
//     each output's k-step sum starts afresh, its three passes the cross
//     terms first, then one round-to-nearest add into the total per
//     k-step, in k-step order, so the sums are the earlier design's bit for
//     bit. ptxas still serialises some of these wgmmas (its note C7514;
//     chip_smoke.py build_bwd_sass prints it).
//  3. Every column block of a row tile loaded and split the same A tile.
//     Tiles now go row-major (a row tile's column blocks back to back) and
//     the blocks walk them together, so the width / BN blocks that read one
//     row tile's A run at the same time and all but the first find it in
//     L2: A crosses from device memory once per layer (128 MB per 65,536 x
//     512 f32 layer, ~40 us at 3.35 TB/s), and the weight tiles (1 MB hi +
//     lo at 512 x 512) stay in L2. Splitting a tile between the consumers by
//     columns instead would halve A's traffic and double B's, the larger.
//  4. A two-stage ring with block barriers per chunk and an epilogue after
//     the loop: now kRowStages stages on mbarriers, and the next tile's
//     chunks land while the consumers run the epilogue. The epilogue goes
//     through a 16 x 64 slab of shared memory per warp, so that a warp
//     reads and writes 64 neighbouring columns of a row; its code is one
//     copy for every 64-column pass (unrolled over a tile's columns, the
//     sine engines' code overflowed the instruction cache).
// bf16 keeps one accumulator over the whole of K, SS wgmma on both tiles,
// BN 256 where the width allows.
//
// The reduction (reduce_ws_kernel):
//  5. Both operands contract over rows, their strided dimension. bf16 wgmma
//     takes MN-major operands from shared memory, so the producer's cp.async
//     puts each 64-row x 64-column box of A and B straight into 128-byte
//     swizzled MN-major tiles (desc_mn, the transpose flags set): no
//     transpose at all. tf32 wgmma takes K-major operands only, so f32
//     transposes once, on the chip: the producer only copies the chunk's 32
//     raw rows of A's and B's 128 columns into a raw ring (kRawStages, no
//     registers held in flight), and each consumer warpgroup transposes and
//     splits its own half (64 columns of A and of B) into the K-major hi/lo
//     tiles while its previous chunk's MMAs run. The other route, the row
//     GEMM's epilogue writing ga and h transposed and split for the
//     reduction, costs 4 x 134 MB per 65,536 x 512 f32 layer (hi + lo of
//     both operands), ~160 us written and read again per layer, ~1.3 ms for
//     the flagship trunk; the in-block transform moves 64 KB through shared
//     memory per 32-row chunk and nothing through device memory. (A
//     producer warpgroup transforming alone held the 512 x 65,536 x 512
//     block at 0.79 ms; split between the consumers, 0.48.)
//  6. Each chunk waited for its MMAs before adding them into the total,
//     behind two block barriers. Now two accumulators alternate as in the
//     row GEMM. The earlier design's numerics are kept: each 32-row (bf16 64-row) chunk's
//     sum starts afresh, f32 cross terms first, and a bias sum folded into
//     an f32 GEMM's pass is two compensated (Kahan) chains per column (the
//     even and the odd 4-row groups, run by two consumer threads), added at
//     the end, as before: the f32 sums are the earlier design's bit for bit.
//  7. The partial sums (kSplitRows rows each) stay: 8 MB per 512 x 512 job
//     at 65,536 rows, written once and read once by finish_kernel, ~5 us of
//     device memory per job. The bias sums that no GEMM stages (every bias
//     sum in bf16) are items of the same walk, one per 128 columns and
//     chunk of rows, run by the consumers (float4 loads, eight rows in
//     flight per thread), their chunks added in order by finish_kernel:
//     walking all rows in one block per 64 columns, they took 2.5 ms of
//     the bf16 trunk's reduction.
//
// Accuracy in f32. The tensor cores add into their accumulator with
// truncation toward zero (1 + 0.75 ulp reads 1, -1 - 0.75 ulp reads -1), so
// an add's error leans the way the sum it lands on points. Summed over rows
// whose values cancel, as a head's bias gradient does at trained weights,
// errors that follow a partial sum's sign stay where the values go. So every
// tensor-core sum is short and its truncating add lands on that sum itself
// (the k-step and chunk sums above), and the bias sums are compensated,
// where a plain chain of 4,096 f32 adds drifts. Measured at trained weights
// (k2_audit.py): K2's head gradients, step-level, within the plain f32
// version's distance from f64.
//
// Thin products stay on the f32 FMA row kernel by a fixed rule on shape: an
// output 16 wide. That is K2's g_aux launch at aux blocks up to 16 columns
// (t-embeddings up to 6 wide): under 1% of K2's multiply-adds. Every other
// product, K 16 included, runs on the tensor cores; a wider g_aux launch
// (32 to 128 aux columns) comes padded by its wrapper to this rule's
// 64-column tiles.
//
// Times above: chip_smoke.py and variants of this file timed on an NVIDIA
// H100 80GB HBM3 at 700.00 W (PERF.md section 6).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sine.cuh"
#include "tile_gemm.cuh"
#include "wgmma.cuh"

namespace satnerf {
namespace tc {

// m64n32k8, A from registers: the f32 row GEMM's half-width units at 64-wide
// tiles (the other widths are wgmma.cuh's)
template <> __device__ __forceinline__ void mma_rs<float, 32>(
    float (&d)[16], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

}  // namespace tc

namespace bwd {

using namespace satnerf::tile;

constexpr int kMaxProds = 4;
// K of a product: the tensor-core row GEMM stages K chunk by chunk, so its
// K is bounded only by the widest layer (1,024, ops/trunk.py FEAT_WIDTHS);
// the thin FMA row kernel stages all of K in shared memory (its K, the
// heads' width, stays at most 512)
constexpr int kMaxK = 1024;
constexpr int kThinMaxK = 512;
constexpr int kMaxJobs = 24;
constexpr int kThinWidth = 16;   // the one width the FMA row kernel keeps
constexpr int kSplitRows = 8192; // rows per partial sum of the reduction

// epilogues of the row GEMM (satnerf_torch.ops._bwd mirrors the numbering)
enum RowMode : int {
  kFwdLinear = 0,  // main = v
  kFwdSine = 1,    // main = v (the pre-activation), second = sin(scale * v)
  kFwdRelu = 2,    // main = v, second = max(v, 0)
  kBwdSine = 3,    // main = v * cos(scale * pre) * scale, second = sin(scale * pre)
  kBwdRelu = 4,    // main = pre > 0 ? v : 0
  kPlain = 5,      // main = v
};

// Mirror of satnerf_torch.ops._bwd._RowArgs (ctypes); keep in sync.
// v = sum_j A_j @ W_j [+ add] [+ bias] for each row < rows and column < width;
// main goes to out_f32 and/or out_dt, second to out2_dt (each optional).
struct RowArgs {
  const void* a[kMaxProds];  // (rows, k[j]) compute dtype, row stride lda[j]
  const void* w[kMaxProds];  // width 16: W (k[j], width); else W^T's prepared
                             // tiles (ops/_bwd.py:row_weight)
  const void* add;           // (rows, width), row stride ld_add, f32 if add_f32
  const float* bias;         // (width,)
  const void* pre;           // (rows, width), row stride ld_pre, f32 if pre_f32
  float* out_f32;
  void* out_dt;
  void* out2_dt;
  int lda[kMaxProds];
  int k[kMaxProds];
  int n_prod, ld_add, add_f32, ld_pre, pre_f32, ld_out_f32, ld_out_dt, ld_out2;
  int rows, width, mode, sin_mode, bf16;
  float scale;
};

// dW (k, m) = A^T B over all rows; A (rows, k), B (rows, m) in the compute
// dtype with row strides lda, ldb. Chunk s of split_rows rows writes
// part + s * k * m; with bias_part, the tiles at k offset 0 also write the
// chunk's column sums of B (f32 only) to bias_part + s * m.
struct GemmJob {
  const void* a;
  const void* b;
  float* part;
  float* out;
  float* bias_part;
  float* bias_out;
  int lda, ldb, k, m;
};

// out (m,) f32 = sum over rows of B (rows, m), f32 if b_f32 else compute
// dtype; chunk s of split_rows rows writes its partial sums to part + s * m
struct SumJob {
  const void* b;
  float* out;
  float* part;
  int ldb, m, b_f32;
};

// Mirror of satnerf_torch.ops._bwd._ReduceArgs (ctypes); keep in sync.
struct ReduceArgs {
  GemmJob gemms[kMaxJobs];
  SumJob sums[kMaxJobs];
  int n_gemm, n_sum, rows, bf16, split_rows, n_split;
};

// ---- the epilogue shared by both row kernels ----------------------------------

template <typename T>
__device__ __forceinline__ float2 load2(const void* p, bool f32, size_t idx) {
  if (f32) return *reinterpret_cast<const float2*>(static_cast<const float*>(p) + idx);
  return ldg2(static_cast<const T*>(p) + idx);
}

// what the epilogue of columns c, c + 1 of one row reads: the addend and
// the pre-activation (zeros where the launch has none)
struct EpiIn {
  float2 add, pre;
};

template <typename T>
__device__ __forceinline__ EpiIn epi_in(const RowArgs& a, int row, int c) {
  EpiIn in{make_float2(0.0f, 0.0f), make_float2(0.0f, 0.0f)};
  if (a.add != nullptr)
    in.add = load2<T>(a.add, a.add_f32, static_cast<size_t>(row) * a.ld_add + c);
  if (a.mode == kBwdSine || a.mode == kBwdRelu)
    in.pre = load2<T>(a.pre, a.pre_f32, static_cast<size_t>(row) * a.ld_pre + c);
  return in;
}

// columns c, c + 1 of one row: v0, v1 are the products' sums
template <typename T>
__device__ __forceinline__ void epi_out(const RowArgs& a, int row, int c, float v0, float v1,
                                        const EpiIn& in) {
  if (a.add != nullptr) {
    v0 += in.add.x;
    v1 += in.add.y;
  }
  if (a.bias != nullptr) {
    v0 += __ldg(a.bias + c);
    v1 += __ldg(a.bias + c + 1);
  }
  float m0 = v0, m1 = v1, s0 = 0.0f, s1 = 0.0f;
  if (a.mode == kFwdSine) {
    s0 = sin_mode(a.scale * v0, a.sin_mode);
    s1 = sin_mode(a.scale * v1, a.sin_mode);
  } else if (a.mode == kFwdRelu) {
    s0 = fmaxf(v0, 0.0f);
    s1 = fmaxf(v1, 0.0f);
  } else if (a.mode == kBwdSine) {
    m0 = v0 * cos_mode(a.scale * in.pre.x, a.sin_mode) * a.scale;
    m1 = v1 * cos_mode(a.scale * in.pre.y, a.sin_mode) * a.scale;
    s0 = sin_mode(a.scale * in.pre.x, a.sin_mode);
    s1 = sin_mode(a.scale * in.pre.y, a.sin_mode);
  } else if (a.mode == kBwdRelu) {
    m0 = in.pre.x > 0.0f ? v0 : 0.0f;
    m1 = in.pre.y > 0.0f ? v1 : 0.0f;
  }
  if (a.out_f32 != nullptr)
    st2(a.out_f32 + static_cast<size_t>(row) * a.ld_out_f32 + c, m0, m1);
  if (a.out_dt != nullptr)
    st2(static_cast<T*>(a.out_dt) + static_cast<size_t>(row) * a.ld_out_dt + c, m0, m1);
  if (a.out2_dt != nullptr)
    st2(static_cast<T*>(a.out2_dt) + static_cast<size_t>(row) * a.ld_out2 + c, s0, s1);
}

template <typename T>
__device__ __forceinline__ void row_epilogue(const RowArgs& a, int row, int c, float v0,
                                             float v1) {
  epi_out<T>(a, row, c, v0, v1, epi_in<T>(a, row, c));
}

// ---- the thin row kernel: f32 FMAs, 32-row tiles (width 16) -----------------------

template <typename T, int N>
__global__ void __launch_bounds__(kThreads) row_kernel(const RowArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);
  using M = Map<N>;
  const int row0 = blockIdx.x * kRows;

  float acc[M::kRpt][2];
#pragma unroll
  for (int r = 0; r < M::kRpt; ++r) acc[r][0] = acc[r][1] = 0.0f;
  for (int j = 0; j < a.n_prod; ++j) {
    const int K = a.k[j], lds = K + kPad, ldg = a.lda[j];
    const T* ag = static_cast<const T*>(a.a[j]);
    for (int i = threadIdx.x; i < kRows * K; i += kThreads) {
      const int r = i / K, c = i - r * K;
      As[r * lds + c] = (row0 + r < a.rows)
                            ? ag[static_cast<size_t>(row0 + r) * ldg + c]
                            : zero<T>();
    }
    __syncthreads();
    gemm_acc<N>(acc, As, lds, K, static_cast<const T*>(a.w[j]));
    __syncthreads();
  }

  const int c = 2 * (threadIdx.x % M::kPairs);
  const int rbase = row0 + (threadIdx.x / M::kPairs) * M::kRpt;
#pragma unroll
  for (int r = 0; r < M::kRpt; ++r) {
    const int row = rbase + r;
    if (row >= a.rows) break;
    row_epilogue<T>(a, row, c, acc[r][0], acc[r][1]);
  }
}

template <typename T, int N>
int launch_row(const RowArgs& a, cudaStream_t stream) {
  int kmax = 0;
  for (int j = 0; j < a.n_prod; ++j) kmax = a.k[j] > kmax ? a.k[j] : kmax;
  const size_t smem = sizeof(T) * kRows * static_cast<size_t>(kmax + kPad);
  auto kern = row_kernel<T, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<(a.rows + kRows - 1) / kRows, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---- the warp-specialised blocks: roles, barriers, copies --------------------------

constexpr int kConsumers = 256;                  // threads 0 .. 255: two warpgroups
constexpr int kWsThreads = kConsumers + 128;     // and the producer warpgroup
constexpr int kLaunchRegs = 168;                 // 65,536 / 384, in multiples of 8
// registers after setmaxnreg: the block's 384 x 168 shared out as 128 x
// the producer's and 256 x the consumers'
template <int P>
struct Regs {
  static constexpr int kProducer = P;
  static constexpr int kConsumer = (kLaunchRegs * kWsThreads - 128 * P) / kConsumers;
  static_assert(kConsumer % 8 == 0 && kConsumer <= 255, "setmaxnreg takes multiples of 8");
};
using RowRegs = Regs<40>;  // consumers 232: the f32 total, two accumulators, fragments
// the reduction's consumers: the total and two accumulators, in f32 beside
// the transform of their halves of the stage (its producer only copies)
template <typename T>
using RedRegs = Regs<sizeof(T) == 4 ? 40 : 56>;

constexpr int kTcRows = 128;           // output rows per tile: 64 per consumer warpgroup
constexpr int kTileA = kTcRows * 128;  // bytes of one 128 x 128-byte tile

// K per 128-byte chunk; f32 keeps hi and lo
template <typename T> struct Tc;
template <> struct Tc<float> {
  static constexpr int kKc = 32, kParts = 2;
};
template <> struct Tc<__nv_bfloat16> {
  static constexpr int kKc = 64, kParts = 1;
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uintptr_t v = reinterpret_cast<uintptr_t>(p);
  return reinterpret_cast<unsigned char*>((v + 1023) & ~static_cast<uintptr_t>(1023));
}

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
// named barrier `id` over one warpgroup's 128 threads
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// one arrival on `bar` once every earlier cp.async of this thread has landed
// (the barrier's count includes it)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
// 16 bytes to shared dst, of which the first `bytes` (0 .. 16) come from src
// and the rest are zeros
__device__ __forceinline__ void cp_async16n(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}
// 4 bytes to shared dst, from src if valid, else zeros
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ float lds(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ float2 lds2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ void sts2(uint32_t addr, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(x), "f"(y) : "memory");
}

// this warp's release of a ring stage: its wgmmas on the stage have retired
__device__ __forceinline__ void release(uint32_t empty, int slot) {
  if ((threadIdx.x & 31) == 0) mbar_arrive(empty + 8 * slot);
}

// the SMs of the current device, once (the persistent grids' size)
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
      n = 132;
  }
  return n;
}

template <int R>
__device__ __forceinline__ void fold(float (&total)[R], float (&acc)[R]) {
  tc::fence_regs(acc);
#pragma unroll
  for (int i = 0; i < R; ++i) total[i] += acc[i];
}

// ---- the row GEMM ---------------------------------------------------------------

constexpr int kRowStages = 4;  // the row GEMM's ring
constexpr int kSlabLd = 66;    // the epilogue's slab: 16 rows x 64 columns (+ 2), f32
constexpr int kSlabBytes = 16 * kSlabLd * 4;  // per consumer warp

// A stage: the A tile (128 rows x 128 bytes, swizzled), then B's prepared
// chunk (parts x BN rows x 128 bytes: hi, then lo in f32)
template <typename T, int BN>
struct RowWs {
  static constexpr int kStages = kRowStages;
  static constexpr int kB = Tc<T>::kParts * BN * 128;
  static constexpr int kStage = kTileA + kB;
  static constexpr int kSlabs = kStages * kStage;  // the consumer warps' epilogue slabs
  static constexpr int kBars = kSlabs + 8 * kSlabBytes;
  static constexpr int kBytes = kBars + 2 * 8 * kStages + 1024;  // + alignment
  static_assert(kBytes <= 232448, "shared memory");
};

// the fixed rule on shape (ops/_bwd.py:row_bn mirrors it): width 16 -> the
// FMA kernel; else the widest of 256 (bf16 only: the f32 total beside the
// two accumulators must fit the registers), 128 and 64 that divides it
template <typename T>
__host__ __device__ constexpr int row_bn(int width) {
  return (Tc<T>::kParts == 1 && width % 256 == 0) ? 256 : width % 128 == 0 ? 128 : 64;
}

// The row GEMM's weight preparation (ops/_bwd.py:row_weight, whose torch
// construction swizzle_tiles is its plain version): W^T (width, K; row
// stride ld) in the compute dtype -> tiles (width / bn, chunks, parts, bn,
// 128 bytes), each 128-byte row's 16-byte piece p at position p ^ (row % 8),
// zeros past K; f32 parts the tf32 hi and lo (tc::split_tf32). One thread
// per 16-byte position of the first part.
template <typename T>
__global__ void __launch_bounds__(256)
    prep_kernel(const T* __restrict__ w, int ld, int width, int K, int bn, T* __restrict__ tiles) {
  constexpr int kKc = Tc<T>::kKc, kPer = 16 / static_cast<int>(sizeof(T));
  const int nkc = (K + kKc - 1) / kKc;
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long>(width) * nkc * 8) return;
  const int p = static_cast<int>(i & 7);
  const long rest = i >> 3;
  const int r = static_cast<int>(rest % bn);
  const int kc = static_cast<int>((rest / bn) % nkc), cb = static_cast<int>(rest / bn / nkc);
  const int col = kc * kKc + (p ^ (r & 7)) * kPer;
  const T* src = w + static_cast<size_t>(cb * bn + r) * ld;
  T* dst = tiles + ((static_cast<size_t>(cb) * nkc + kc) * Tc<T>::kParts * bn + r) * kKc + p * kPer;
  if constexpr (Tc<T>::kParts == 2) {
    float h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) tc::split_tf32(col + e < K ? src[col + e] : 0.0f, h[e], l[e]);
    *reinterpret_cast<float4*>(dst) = make_float4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<float4*>(dst + bn * kKc) = make_float4(l[0], l[1], l[2], l[3]);
  } else {
    __align__(16) T v[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) v[e] = col + e < K ? src[col + e] : zero<T>();
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
  }
}

inline int prep_entry(const void* w, int ld, int width, int K, int bn, int bf16, void* tiles,
                      cudaStream_t stream) {
  if (w == nullptr || tiles == nullptr || K <= 0 || K > kMaxK || ld < K || width <= 0 ||
      (bn != 64 && bn != 128 && bn != 256) || width % bn || (!bf16 && bn == 256))
    return static_cast<int>(cudaErrorInvalidValue);
  const int kc = bf16 ? Tc<__nv_bfloat16>::kKc : Tc<float>::kKc;
  const long threads = static_cast<long>(width) * ((K + kc - 1) / kc) * 8;
  const int blocks = static_cast<int>((threads + 255) / 256);
  if (bf16)
    prep_kernel<__nv_bfloat16><<<blocks, 256, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(w), ld, width, K, bn, static_cast<__nv_bfloat16*>(tiles));
  else
    prep_kernel<float><<<blocks, 256, 0, stream>>>(static_cast<const float*>(w), ld, width, K, bn,
                                                   static_cast<float*>(tiles));
  return static_cast<int>(cudaGetLastError());
}

// The producer warpgroup: for every tile of this block (row-major: a row
// tile's column blocks back to back) and every chunk of every product, the
// A chunk by cp.async (rows past `rows` and columns past K zero) and B's
// prepared chunk by one bulk copy, into the next stage once its eight
// consumer warps have released it.
template <typename T, int BN>
__device__ __forceinline__ void row_produce(const RowArgs& a, uint32_t ring, uint32_t full,
                                            uint32_t empty) {
  using S = RowWs<T, BN>;
  constexpr int kKc = Tc<T>::kKc, kPer = 16 / static_cast<int>(sizeof(T));
  const int tid = threadIdx.x - kConsumers;
  const int ncb = a.width / BN, tiles = (a.rows + kTcRows - 1) / kTcRows * ncb;
  int q = 0;
#pragma unroll 1
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int row0 = t / ncb * kTcRows, cb = t % ncb;
#pragma unroll 1
    for (int j = 0; j < a.n_prod; ++j) {
      const int K = a.k[j], nkc = (K + kKc - 1) / kKc;
      const char* A = static_cast<const char*>(a.a[j]);
      const size_t lda = static_cast<size_t>(a.lda[j]) * sizeof(T);
      const char* B = static_cast<const char*>(a.w[j]) + static_cast<size_t>(cb) * nkc * S::kB;
      // this thread's pieces: rows r0 + 16 i of the tile, 16-byte piece c
      const int r0 = tid >> 3, c = tid & 7;
      const size_t step = 16 * lda;
#pragma unroll 1
      for (int kc = 0; kc < nkc; ++kc, ++q) {
        const int slot = q % S::kStages;
        const uint32_t st = ring + slot * S::kStage, fb = full + 8 * slot;
        tc::mbar_wait(empty + 8 * slot, ((q / S::kStages) & 1) ^ 1);
        if (tid == 0) {
          tc::mbar_expect_tx(fb, S::kB);
          tc::bulk_g2s(st + kTileA, B + static_cast<size_t>(kc) * S::kB, S::kB, fb);
        }
        const int col = kc * kKc + c * kPer;
        const int bytes = col < K ? 16 : 0;
        const char* src = A + static_cast<size_t>(row0 + r0) * lda + col * sizeof(T);
        const uint32_t dst = st + tc::sw128(r0, c);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const bool ok = bytes > 0 && row0 + r0 + 16 * i < a.rows;
          cp_async16n(dst + 2048 * i, ok ? src + i * step : A, ok ? 16 : 0);
        }
        cp_async_arrive(fb);
      }
    }
  }
  cp_async_wait<0>();
}

// The consumers' epilogue: warp w of the warpgroup holds rows 16w + lane/4
// (+8) of the accumulator fragment, value 4i + 2h + e at column
// 8i + 2(lane % 4) + e, row + 8h. Each 64-column pass goes through the
// warp's 16 x kSlabLd floats of shared memory, then lane l takes the column
// pair 2l of the pass along the 16 rows, so that a warp reads and writes
// 64 neighbouring columns of one row, four rows' loads issued before their
// stores. Only the fragment's stores are unrolled (a switch on the pass);
// one copy of the epilogue's code serves every pass, which keeps the
// sine and cosine engines' code small enough for the instruction cache
// (unrolled over a 128-column fragment it took 6x the tile's MMA time).
template <int BN, int P>
__device__ __forceinline__ void slab_put(const float (&v)[BN / 2], uint32_t buf, int g, int t) {
#pragma unroll
  for (int ii = 0; ii < 8; ++ii)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      sts2(buf + 4 * ((g + 8 * h) * kSlabLd + 8 * ii + 2 * t), v[4 * (8 * P + ii) + 2 * h],
           v[4 * (8 * P + ii) + 2 * h + 1]);
}

template <typename T, int BN>
__device__ __forceinline__ void row_store(const RowArgs& a, const float (&v)[BN / 2], int row0,
                                          int n0, int wg, uint32_t buf) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int rbase = row0 + wg * 64 + warp * 16;
  const int rows = min(16, a.rows - rbase);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int pass = 0; pass < BN / 64; ++pass) {
    __syncwarp();
    switch (pass) {
      case 0: slab_put<BN, 0>(v, buf, g, t); break;
      case 1: if constexpr (BN >= 128) slab_put<BN, 1>(v, buf, g, t); break;
      case 2: if constexpr (BN >= 256) slab_put<BN, 2>(v, buf, g, t); break;
      default: if constexpr (BN >= 256) slab_put<BN, 3>(v, buf, g, t); break;
    }
    __syncwarp();
    const int c = n0 + 64 * pass + 2 * lane;
#pragma unroll 1
    for (int r0 = 0; r0 < rows; r0 += 4) {
      EpiIn in[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (r0 + k < rows) in[k] = epi_in<T>(a, rbase + r0 + k, c);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (r0 + k < rows) {
          const float2 x = lds2(buf + 4 * ((r0 + k) * kSlabLd + 2 * lane));
          epi_out<T>(a, rbase + r0 + k, c, x.x, x.y, in[k]);
        }
      }
    }
  }
}

// f32: this thread's fragment of k-step s (rows r, r + 8; columns 8s + t,
// 8s + t + 4) from the swizzled A tile at shared address sa, split into
// tf32 hi and lo. `frag`: the offset of row r's 16-byte piece 0 as swizzled
// (r * 128 + (r % 8) * 16) plus column t's 4 t; the stage is 1,024-byte
// aligned, so piece p of the row sits at (sa + frag) ^ (16 p), and row
// r + 8 (the same swizzle) 1,024 bytes on.
__device__ __forceinline__ void row_frag(uint32_t (&hi)[4], uint32_t (&lo)[4], uint32_t sa,
                                         uint32_t frag, int s) {
  const uint32_t c0 = (sa + frag) ^ (32 * s), c1 = (sa + frag) ^ (32 * s + 16);
  const float v[4] = {lds(c0), lds(c0 + 1024), lds(c1), lds(c1 + 1024)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float h, l;
    tc::split_tf32(v[i], h, l);
    hi[i] = __float_as_uint(h);
    lo[i] = __float_as_uint(l);
  }
}

// f32: half H (columns H BN/2 .. + BN/2) of k-step s into acc, afresh:
// lo*hi, hi*lo, hi*hi on the stage's B rows of that half (8 KB apart at
// BN 128, whole 1,024-byte atoms)
template <int BN, int H>
__device__ __forceinline__ void row_half(float (&acc)[BN / 4], const uint32_t (&hi)[4],
                                         const uint32_t (&lo)[4], uint32_t sa, int s) {
  const uint32_t bh = sa + kTileA + H * (BN / 2) * 128 + 32 * s, bl = bh + BN * 128;
  tc::fence_regs(acc);
  tc::wg_fence();
  tc::mma_rs<float, BN / 2>(acc, lo, tc::desc_sw128(bh), 0);
  tc::mma_rs<float, BN / 2>(acc, hi, tc::desc_sw128(bl), 1);
  tc::mma_rs<float, BN / 2>(acc, hi, tc::desc_sw128(bh), 1);
  tc::wg_commit();
}

// the sum of the unit that used acc joins the total's half H
template <int BN, int H>
__device__ __forceinline__ void row_fold(float (&total)[BN / 2], float (&acc)[BN / 4]) {
  tc::fence_regs(acc);
#pragma unroll
  for (int i = 0; i < BN / 4; ++i) total[H * (BN / 4) + i] += acc[i];
}

// The seven units after a chunk's first: k-step s's halves 0 and 1 in turn
// (accumulators acc0 and acc1), each issued before the previous unit's sum
// joins the total (wg_wait<1>); a k-step's fragments are loaded with its
// half 0, into (h0, l0) for even s and (h1, l1) for odd s, whose previous
// k-step has retired by then. On entry k-step 0's half 0 is in flight; on
// return k-step 3's half 1.
template <int BN>
__device__ __forceinline__ void row_chunk_units(float (&total)[BN / 2], float (&acc0)[BN / 4],
                                                float (&acc1)[BN / 4], uint32_t (&h0)[4],
                                                uint32_t (&l0)[4], uint32_t (&h1)[4],
                                                uint32_t (&l1)[4], uint32_t sa, uint32_t frag) {
  row_half<BN, 1>(acc1, h0, l0, sa, 0);
  tc::wg_wait<1>();
  row_fold<BN, 0>(total, acc0);
#pragma unroll
  for (int s = 1; s < 4; ++s) {
    uint32_t(&h)[4] = (s & 1) ? h1 : h0;
    uint32_t(&l)[4] = (s & 1) ? l1 : l0;
    row_frag(h, l, sa, frag, s);
    row_half<BN, 0>(acc0, h, l, sa, s);
    tc::wg_wait<1>();
    row_fold<BN, 1>(total, acc1);
    row_half<BN, 1>(acc1, h, l, sa, s);
    tc::wg_wait<1>();
    row_fold<BN, 0>(total, acc0);
  }
}

// the shared address of this consumer warp's epilogue slab
template <typename S>
__device__ __forceinline__ uint32_t slab_of(uint32_t ring) {
  return ring + S::kSlabs + (threadIdx.x / 32) * kSlabBytes;
}

// A consumer warpgroup wg of the f32 row GEMM: its 64 rows of each tile.
// Each k-step runs as two units, its column halves, with m64n(BN/2)
// wgmmas: the two accumulators of BN/4 registers alternate by unit, so a
// unit is issued before the previous one's sum joins the total, and the
// total, two accumulators and two fragments fit the registers (at BN 128
// two full-width accumulators left no room: ptxas spilled). Per output the
// adds are the earlier design's: each k-step's three passes afresh, the
// cross terms first, one round-to-nearest add into the total per k-step.
// A chunk's stage is released once its last unit has retired; the first
// chunk is peeled off the loop so that every wait is unconditional.
template <int BN>
__device__ __forceinline__ void row_consume_f32(const RowArgs& a, int wg, uint32_t ring) {
  using S = RowWs<float, BN>;
  constexpr int kKc = Tc<float>::kKc;
  const uint32_t full = ring + S::kBars, empty = full + 8 * S::kStages;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3, g = lane >> 2;
  // the fragment's row r = 16 warp + g (and r + 8; r % 8 = g) and column t
  const uint32_t frag = (wg * 64 + warp * 16 + g) * 128 + 16 * g + 4 * (lane & 3);
  const int ncb = a.width / BN, tiles = (a.rows + kTcRows - 1) / kTcRows * ncb;
  int nc = 0;
  for (int j = 0; j < a.n_prod; ++j) nc += (a.k[j] + kKc - 1) / kKc;
  int q = 0;
#pragma unroll 1
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    float total[BN / 2], acc0[BN / 4], acc1[BN / 4];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) total[i] = 0.0f;
    if (nc > 0) {
      uint32_t h0[4], l0[4], h1[4], l1[4];
      uint32_t sa = ring + (q % S::kStages) * S::kStage;
      tc::mbar_wait(full + 8 * (q % S::kStages), (q / S::kStages) & 1);
      row_frag(h0, l0, sa, frag, 0);
      row_half<BN, 0>(acc0, h0, l0, sa, 0);
      row_chunk_units<BN>(total, acc0, acc1, h0, l0, h1, l1, sa, frag);
#pragma unroll 1
      for (int c = 1; c < nc; ++c) {
        ++q;
        sa = ring + (q % S::kStages) * S::kStage;
        tc::mbar_wait(full + 8 * (q % S::kStages), (q / S::kStages) & 1);
        row_frag(h0, l0, sa, frag, 0);
        row_half<BN, 0>(acc0, h0, l0, sa, 0);
        tc::wg_wait<1>();  // the previous chunk's last unit
        row_fold<BN, 1>(total, acc1);
        release(empty, (q - 1) % S::kStages);
        row_chunk_units<BN>(total, acc0, acc1, h0, l0, h1, l1, sa, frag);
      }
      tc::wg_wait<0>();
      row_fold<BN, 1>(total, acc1);
      release(empty, q % S::kStages);
      ++q;
    }
    row_store<float, BN>(a, total, tile / ncb * kTcRows, tile % ncb * BN, wg, slab_of<S>(ring));
  }
}

// A consumer warpgroup of the bf16 row GEMM: one accumulator over all of K
// (as the earlier design summed it), each chunk's four k-steps on the two
// swizzled tiles; chunk c's stage is released once chunk c + 1 is issued and
// c has retired.
template <int BN>
__device__ __forceinline__ void row_consume_bf16(const RowArgs& a, int wg, uint32_t ring) {
  using S = RowWs<__nv_bfloat16, BN>;
  const uint32_t full = ring + S::kBars, empty = full + 8 * S::kStages;
  constexpr int kKc = Tc<__nv_bfloat16>::kKc;
  const int ncb = a.width / BN, tiles = (a.rows + kTcRows - 1) / kTcRows * ncb;
  int nc = 0;
  for (int j = 0; j < a.n_prod; ++j) nc += (a.k[j] + kKc - 1) / kKc;
  int q = 0;
#pragma unroll 1
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
#pragma unroll 1
    for (int c = 0; c < nc; ++c, ++q) {
      const int slot = q % S::kStages;
      tc::mbar_wait(full + 8 * slot, (q / S::kStages) & 1);
      tc::fence_async_smem();  // the cp.async bytes, to the tensor cores' proxy
      const uint32_t st = ring + slot * S::kStage, sa = st + wg * 64 * 128, sb = st + kTileA;
      tc::fence_regs(acc);
      tc::wg_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s)
        tc::mma<__nv_bfloat16, BN>(acc, tc::desc_sw128(sa + 32 * s), tc::desc_sw128(sb + 32 * s),
                                   1);
      tc::wg_commit();
      if (c > 0) {
        tc::wg_wait<1>();
        release(empty, (q - 1) % S::kStages);
      }
    }
    if (nc > 0) {
      tc::wg_wait<0>();
      tc::fence_regs(acc);
      release(empty, (q - 1) % S::kStages);
    }
    row_store<__nv_bfloat16, BN>(a, acc, tile / ncb * kTcRows, tile % ncb * BN, wg,
                                 slab_of<S>(ring));
  }
}

template <typename T, int BN>
__global__ void __launch_bounds__(kWsThreads, 1)
    row_ws_kernel(const __grid_constant__ RowArgs a) {
  extern __shared__ unsigned char ws_smem_raw[];
  using S = RowWs<T, BN>;
  unsigned char* smem = align1024(ws_smem_raw);
  const uint32_t ring = tc::smem_u32(smem);
  const uint32_t full = ring + S::kBars, empty = full + 8 * S::kStages;
  if (threadIdx.x == 0) {
    for (int j = 0; j < S::kStages; ++j) {
      tc::mbar_init(full + 8 * j, 128 + 1);  // the producers' copies, the bulk copy's bytes
      tc::mbar_init(empty + 8 * j, 8);       // the eight consumer warps
    }
    tc::fence_mbar_init();
  }
  __syncthreads();  // the block's one barrier
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 2) {
    regs_dec<RowRegs::kProducer>();
    row_produce<T, BN>(a, ring, full, empty);
    return;
  }
  regs_inc<RowRegs::kConsumer>();
  if constexpr (Tc<T>::kParts == 2)
    row_consume_f32<BN>(a, wg, ring);
  else
    row_consume_bf16<BN>(a, wg, ring);
}

template <typename T, int BN>
int launch_row_ws(const RowArgs& a, cudaStream_t stream) {
  constexpr int smem = RowWs<T, BN>::kBytes;
  auto kern = row_ws_kernel<T, BN>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long tiles = static_cast<long>((a.rows + kTcRows - 1) / kTcRows) * (a.width / BN);
  const int grid = static_cast<int>(tiles < sm_count() ? tiles : sm_count());
  kern<<<grid, kWsThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// argument checks; 0 when the launch may go ahead
inline int check_row(const RowArgs& a) {
  if (a.n_prod < 0 || a.n_prod > kMaxProds || a.rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool thin = a.width == kThinWidth;
  if (!thin && (a.width <= 0 || a.width % 64))
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte copies: K a whole number of 16-byte pieces (4 f32, 8 bf16)
  const int per = a.bf16 ? 8 : 4;
  for (int j = 0; j < a.n_prod; ++j) {
    if (a.k[j] <= 0 || a.k[j] > (thin ? kThinMaxK : kMaxK) || a.a[j] == nullptr ||
        a.w[j] == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    if (thin ? a.k[j] % 4
             : (a.k[j] % per || a.lda[j] % per || reinterpret_cast<uintptr_t>(a.a[j]) % 16 ||
                reinterpret_cast<uintptr_t>(a.w[j]) % 16))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((a.mode == kBwdSine || a.mode == kBwdRelu) && a.pre == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <typename T>
int dispatch_row(const RowArgs& a, cudaStream_t stream) {
  if (a.width == kThinWidth) return launch_row<T, kThinWidth>(a, stream);
  switch (row_bn<T>(a.width)) {
    case 256:
      if constexpr (Tc<T>::kParts == 1) return launch_row_ws<T, 256>(a, stream);
      break;
    case 128:
      return launch_row_ws<T, 128>(a, stream);
    default:
      return launch_row_ws<T, 64>(a, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

inline int row_entry(const RowArgs* a, cudaStream_t stream) {
  if (const int err = check_row(*a)) return err;
  if (a->rows == 0) return 0;
  return a->bf16 ? dispatch_row<__nv_bfloat16>(*a, stream) : dispatch_row<float>(*a, stream);
}

// ---- the weight-gradient reduction ----------------------------------------------

// s + x, compensated (Kahan): c keeps what the f32 add of s dropped, so a
// chain of thousands of adds ends within a few roundings of the exact sum,
// where a plain chain drifts by its length times the rounding of its
// partial sums (a bias gradient that cancels at trained weights reads that
// drift against its small result)
struct Kahan {
  float s = 0.0f, c = 0.0f;
  __device__ __forceinline__ void add(float x) {
    const float y = x - c;
    const float t = s + y;
    c = (t - s) - y;
    s = t;
  }
};

constexpr int kRedTile = 128;  // dW tile: 128 x 128, 64 rows of it per warpgroup
constexpr int kSumCols = 128;  // a sum item: 128 columns over one chunk of rows

__host__ __device__ __forceinline__ int red_tiles(const GemmJob& g) {
  return ((g.k + kRedTile - 1) / kRedTile) * ((g.m + kRedTile - 1) / kRedTile);
}

// f32: an MMA stage holds A^T hi, A^T lo, B^T hi, B^T lo (128 x 128-byte
// K-major tiles, kKc = 32 rows); the producer's raw stage the 32 rows of A's
// and B's 128 columns as copied. bf16: a stage holds A's and B's 64 rows as
// two 64-column MN-major panels each (8 KB per panel).
template <typename T> struct RedWs;
template <> struct RedWs<float> {
  static constexpr int kStages = 2;
  static constexpr int kStage = 4 * kTileA;
  static constexpr int kRawStages = 3;
  static constexpr int kRawStage = 2 * 32 * 128 * 4;
  static constexpr int kRaw = kStages * kStage;
  static constexpr int kEnd = kRaw + kRawStages * kRawStage;
};
template <> struct RedWs<__nv_bfloat16> {
  static constexpr int kStages = 6;
  static constexpr int kStage = 2 * 2 * 8192;
  static constexpr int kRawStages = 0;
  static constexpr int kRawStage = 0;
  static constexpr int kRaw = kStages * kStage;
  static constexpr int kEnd = kRaw;
};
template <typename T>
struct RedSmem {
  static constexpr int kBars = RedWs<T>::kEnd + 128 * 4;  // + the odd chains (f32)
  static constexpr int kBytes = kBars + 2 * 8 * (RedWs<T>::kStages + RedWs<T>::kRawStages) + 1024;
  static_assert(kBytes <= 232448, "shared memory");
};

// One item of the reduction's walk: a sum's 64-column tile, or one 128 x 128
// tile of a dW over one chunk of split_rows rows. Items: the sums first
// (they walk every row), then for each GEMM its tiles, chunk-major so that
// blocks in flight share rows in L2.
struct Item {
  int gemm;    // 1: a GEMM tile, 0: a sum tile
  int j, tile, split;
};

__device__ __forceinline__ Item item_at(const ReduceArgs& a, int b) {
  for (int j = 0; j < a.n_sum; ++j) {
    const int tiles = (a.sums[j].m + kSumCols - 1) / kSumCols;
    const int t = tiles * a.n_split;
    if (b < t) return {0, j, b % tiles, b / tiles};
    b -= t;
  }
  for (int j = 0; j < a.n_gemm; ++j) {
    const int tiles = red_tiles(a.gemms[j]);
    const int t = tiles * a.n_split;
    if (b < t) return {1, j, b % tiles, b / tiles};
    b -= t;
  }
  return {-1, 0, 0, 0};
}

__host__ __device__ __forceinline__ long red_items(const ReduceArgs& a) {
  long n = 0;
  for (int j = 0; j < a.n_sum; ++j)
    n += static_cast<long>((a.sums[j].m + kSumCols - 1) / kSumCols) * a.n_split;
  for (int j = 0; j < a.n_gemm; ++j) n += static_cast<long>(red_tiles(a.gemms[j])) * a.n_split;
  return n;
}

// the rows, column offsets and chunks of a GEMM item
struct Span {
  int n_begin, n_end, k0, m0, nc;
};

template <typename T>
__device__ __forceinline__ Span span_of(const ReduceArgs& a, const Item& it) {
  const GemmJob& g = a.gemms[it.j];
  const int tiles_m = (g.m + kRedTile - 1) / kRedTile;
  Span s;
  s.n_begin = it.split * a.split_rows;
  s.n_end = min(a.rows, s.n_begin + a.split_rows);
  s.k0 = (it.tile / tiles_m) * kRedTile;
  s.m0 = (it.tile % tiles_m) * kRedTile;
  s.nc = (s.n_end - s.n_begin + Tc<T>::kKc - 1) / Tc<T>::kKc;
  return s;
}

// The producer's walk over this block's GEMM chunks: item `it` of the
// launch, chunk `c` of `span`; `valid` false past the last one
template <typename T>
struct Cursor {
  int item, c;
  bool valid;
  Item it;
  Span span;
  __device__ __forceinline__ void seek(const ReduceArgs& a, long items) {
    for (; item < items; item += gridDim.x) {
      it = item_at(a, item);
      if (it.gemm == 1) {
        span = span_of<T>(a, it);
        if (span.nc > 0) {
          valid = true;
          return;
        }
      }
    }
    valid = false;
  }
  __device__ __forceinline__ void first(const ReduceArgs& a, long items) {
    item = blockIdx.x;
    c = 0;
    seek(a, items);
  }
  __device__ __forceinline__ void next(const ReduceArgs& a, long items) {
    if (++c < span.nc) return;
    c = 0;
    item += gridDim.x;
    seek(a, items);
  }
};

// Columns c0 .. c0 + 127 of rows n0 .. n0 + nr - 1 of X (rows past n_end and
// columns past ncols zero) into `dst`: f32 raw rows of 512 bytes; bf16 two
// 64-column MN-major panels of 64 rows x 128 bytes, swizzled. 16-byte copies
// where X's rows are whole 16-byte pieces on 16-byte addresses, else 4-byte
// ones (f32 one value, bf16 a column pair).
template <typename T>
__device__ __forceinline__ void copy_box(const void* x, int ld, int ncols, int c0, int n0,
                                         int n_end, uint32_t dst, int tid) {
  constexpr int kEl = static_cast<int>(sizeof(T));
  constexpr int kRowsBox = Tc<T>::kKc;  // 32 f32, 64 bf16 rows
  const char* base = static_cast<const char*>(x);
  const bool wide = reinterpret_cast<uintptr_t>(x) % 16 == 0 && (ld * kEl) % 16 == 0;
  auto at = [&](int r, int byte) -> uint32_t {  // the shared address of byte `byte` of row r
    if constexpr (kEl == 4) {
      return dst + r * 512 + byte;
    } else {
      const int panel = byte >> 7, b = byte & 127;
      return dst + panel * 8192 + tc::sw128(r, b >> 4) + (b & 15);
    }
  };
  constexpr int kRowBytes = 128 * kEl;  // 512 f32, 256 bf16
  if (wide) {
    constexpr int kPer = kRowBytes / 16;  // 16-byte pieces per row
#pragma unroll 4
    for (int idx = tid; idx < kRowsBox * kPer; idx += 128) {
      const int r = idx / kPer, p = idx % kPer;
      const int n = n0 + r, col = c0 + p * (16 / kEl);
      const int bytes = (n < n_end && col < ncols) ? min(16, (ncols - col) * kEl) : 0;
      const char* src = bytes > 0 ? base + (static_cast<size_t>(n) * ld + col) * kEl : base;
      cp_async16n(at(r, p * 16), src, bytes);
    }
  } else {
    constexpr int kPer = kRowBytes / 4;  // 4-byte words per row
#pragma unroll 4
    for (int idx = tid; idx < kRowsBox * kPer; idx += 128) {
      const int r = idx / kPer, w = idx % kPer;
      const int n = n0 + r, col = c0 + w * (4 / kEl);
      const bool ok = n < n_end && col < ncols;
      const char* src = ok ? base + (static_cast<size_t>(n) * ld + col) * kEl : base;
      cp_async4(at(r, w * 4), src, ok);
    }
  }
}

// f32: the split of one raw stage's 4-row group q of column `col` (raw row
// stride 128 floats) into the 16-byte chunk q of row `row` of a K-major hi
// and lo tile (the layout tc::mma reads)
__device__ __forceinline__ void split_chunk(const float* x, int col, unsigned char* hi, int row,
                                            int q, float (&v)[4]) {
  float h[4], l[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    v[e] = x[(4 * q + e) * 128 + col];
    tc::split_tf32(v[e], h[e], l[e]);
  }
  const uint32_t off = tc::sw128(row, q);
  *reinterpret_cast<float4*>(hi + off) = make_float4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<float4*>(hi + kTileA + off) = make_float4(l[0], l[1], l[2], l[3]);
}

// f32, consumer warpgroup wg, while its previous chunk's MMAs run: its own
// 64 rows of A^T (A's columns 64 wg .. 64 wg + 63 of the raw stage) and its
// half of B^T's (B's same columns) into the MMA stage. Thread t takes
// column t % 64 of each and the 4-row groups t / 64 + 2i, in row order;
// with `fold_bias`, B's values join the thread's compensated chain, the even
// groups' chain of its column for t < 64 and the odd groups' for t >= 64
// (the chains the earlier design ran, added at the item's end).
__device__ __forceinline__ void transform_f32(const unsigned char* raw, unsigned char* st,
                                              int wg, bool fold_bias, Kahan& cs) {
  const int t = threadIdx.x & 127, col = 64 * wg + (t & 63);
  const float* a = reinterpret_cast<const float*>(raw);
  const float* b = reinterpret_cast<const float*>(raw + 32 * 512);
#pragma unroll 1
  for (int i = 0; i < 4; ++i) {
    const int q = (t >> 6) + 2 * i;
    float v[4];
    split_chunk(a, col, st, col, q, v);
    split_chunk(b, col, st + 2 * kTileA, col, q, v);
    if (fold_bias) {
#pragma unroll
      for (int e = 0; e < 4; ++e) cs.add(v[e]);
    }
  }
}

// The f32 producer: each chunk's 32 rows of A's and B's 128 columns by
// cp.async into the raw ring, once its two consumer warpgroups have read
// the stage's previous chunk (raw_empty); raw_full counts the copies.
__device__ __forceinline__ void red_produce_f32(const ReduceArgs& a, uint32_t raw,
                                                uint32_t raw_full, uint32_t raw_empty) {
  using W = RedWs<float>;
  constexpr int R = W::kRawStages;
  const int tid = threadIdx.x - kConsumers;
  const long items = red_items(a);
  Cursor<float> cur;
  cur.first(a, items);
#pragma unroll 1
  for (int c = 0; cur.valid; ++c) {
    const int r = c % R;
    tc::mbar_wait(raw_empty + 8 * r, ((c / R) & 1) ^ 1);
    const GemmJob& g = a.gemms[cur.it.j];
    const int n0 = cur.span.n_begin + cur.c * 32;
    const uint32_t dst = raw + r * W::kRawStage;
    copy_box<float>(g.a, g.lda, g.k, cur.span.k0, n0, cur.span.n_end, dst, tid);
    copy_box<float>(g.b, g.ldb, g.m, cur.span.m0, n0, cur.span.n_end, dst + 32 * 512, tid);
    cp_async_arrive(raw_full + 8 * r);
    cur.next(a, items);
  }
  cp_async_wait<0>();
}

// The bf16 producer: each chunk's 64-row boxes of A and B by cp.async
// straight into the MMA stage, once released.
__device__ __forceinline__ void red_produce_bf16(const ReduceArgs& a, uint32_t ring,
                                                 uint32_t full, uint32_t empty) {
  using W = RedWs<__nv_bfloat16>;
  const int tid = threadIdx.x - kConsumers;
  const long items = red_items(a);
  Cursor<__nv_bfloat16> cur;
  cur.first(a, items);
#pragma unroll 1
  for (int c = 0; cur.valid; ++c) {
    const int slot = c % W::kStages;
    tc::mbar_wait(empty + 8 * slot, ((c / W::kStages) & 1) ^ 1);
    const GemmJob& g = a.gemms[cur.it.j];
    const int n0 = cur.span.n_begin + cur.c * 64;
    const uint32_t st = ring + slot * W::kStage;
    copy_box<__nv_bfloat16>(g.a, g.lda, g.k, cur.span.k0, n0, cur.span.n_end, st, tid);
    copy_box<__nv_bfloat16>(g.b, g.ldb, g.m, cur.span.m0, n0, cur.span.n_end, st + 16384, tid);
    cp_async_arrive(full + 8 * slot);
    cur.next(a, items);
  }
  cp_async_wait<0>();
}

// descriptor of an MN-major, 128-byte swizzled operand (bf16): lines of 64
// values along M (or N) at one k, eight lines to a 1,024-byte atom, atoms
// along K 1,024 bytes apart (stride byte offset) and along M / N `lbo`
// bytes apart (leading byte offset)
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x 128, f32) (+)= A (64 x 16) B (16 x 128), bf16, both MN-major in
// shared memory (the transpose flags set)
__device__ __forceinline__ void mma_mn(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16,"
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46,"
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      "%62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
      "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// One chunk of an item into acc, afresh, waiting for its stage first. f32:
// the cross terms lo*hi and hi*lo of the four k-steps, then hi*hi of each,
// on the K-major tiles (this warpgroup's 64 rows of A^T, all of B^T). bf16:
// four k-steps of 16 rows on the MN-major panels (this warpgroup's panel of
// A, both of B, 8 KB apart).
template <typename T>
__device__ __forceinline__ void red_issue(float (&acc)[kRedTile / 2], unsigned char* smem,
                                          uint32_t ring, uint32_t full, uint32_t empty,
                                          uint32_t raw_full, uint32_t raw_empty, int q, int wg,
                                          bool fold_bias, Kahan& cs) {
  using W = RedWs<T>;
  const int slot = q % W::kStages;
  if constexpr (Tc<T>::kParts == 2) {
    // this warpgroup's halves of the stage, once the copies have landed and
    // both warpgroups have retired the stage's previous chunk; `full` then
    // counts the eight consumer warps' halves
    const int r = q % W::kRawStages;
    tc::mbar_wait(raw_full + 8 * r, (q / W::kRawStages) & 1);
    tc::mbar_wait(empty + 8 * slot, ((q / W::kStages) & 1) ^ 1);
    transform_f32(smem + W::kRaw + r * W::kRawStage, smem + slot * W::kStage, wg, fold_bias,
                  cs);
    tc::fence_async_smem();
    __syncwarp();
    release(raw_empty, r);
    release(full, slot);
  }
  tc::mbar_wait(full + 8 * slot, (q / W::kStages) & 1);
  tc::fence_async_smem();  // the cp.async bytes, to the tensor cores' proxy
  const uint32_t st = ring + slot * W::kStage;
  tc::fence_regs(acc);
  tc::wg_fence();
  if constexpr (Tc<T>::kParts == 2) {
    const uint32_t a_hi = st + wg * 64 * 128, a_lo = a_hi + kTileA;
    const uint32_t b_hi = st + 2 * kTileA, b_lo = b_hi + kTileA;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint32_t k = 32 * s;
      tc::mma<float, kRedTile>(acc, tc::desc_sw128(a_lo + k), tc::desc_sw128(b_hi + k),
                               s == 0 ? 0 : 1);
      tc::mma<float, kRedTile>(acc, tc::desc_sw128(a_hi + k), tc::desc_sw128(b_lo + k), 1);
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint32_t k = 32 * s;
      tc::mma<float, kRedTile>(acc, tc::desc_sw128(a_hi + k), tc::desc_sw128(b_hi + k), 1);
    }
  } else {
    const uint32_t pa = st + wg * 8192, pb = st + 16384;
#pragma unroll
    for (int s = 0; s < 4; ++s)
      mma_mn(acc, desc_mn(pa + 2048 * s, 8192), desc_mn(pb + 2048 * s, 8192), s == 0 ? 0 : 1);
  }
  tc::wg_commit();
}

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 128 columns of one bias sum that no GEMM stages (bf16: the f32
// gradient), over one chunk of rows, by the two consumer warpgroups: lane l
// of warp w takes the four columns 4 (4w + l / 8) .. + 3 at the rows l % 8,
// l % 8 + 8, ... of the chunk, a compensated chain per column; the eight
// chains of a column are then added in row-lane order into the chunk's
// partial sum, and finish_kernel adds the chunks in order.
template <typename T>
__device__ __forceinline__ void load4(const SumJob& s, size_t idx, bool vec, int cols,
                                      float (&x)[4]) {
  if (s.b_f32) {
    const float* b = static_cast<const float*>(s.b) + idx;
    if (vec) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(b));
      x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
      return;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = e < cols ? __ldg(b + e) : 0.0f;
  } else {
    const T* b = static_cast<const T*>(s.b) + idx;
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = e < cols ? to_f32<T>(b[e]) : 0.0f;
  }
}

template <typename T>
__device__ void sum_tile(const SumJob& s, int tile, int split, int split_rows, int rows) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int c0 = tile * kSumCols + 4 * (4 * w + (lane >> 3)), r8 = lane & 7;
  const int n_begin = split * split_rows, n_end = min(rows, n_begin + split_rows);
  const int cols = min(4, s.m - c0);
  // f32 rows as float4 where they are whole 16-byte pieces
  const bool vec = s.b_f32 && cols == 4 && s.ldb % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(s.b) % 16 == 0;
  Kahan acc[4];
  if (cols > 0) {
#pragma unroll 8
    for (int n = n_begin + r8; n < n_end; n += 8) {
      float x[4];
      load4<T>(s, static_cast<size_t>(n) * s.ldb + c0, vec, cols, x);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e].add(x[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int first = lane & ~7;
    float total = __shfl_sync(0xffffffffu, acc[e].s, first);
#pragma unroll
    for (int q = 1; q < 8; ++q) total += __shfl_sync(0xffffffffu, acc[e].s, first + q);
    if (r8 == 0 && e < cols) s.part[static_cast<size_t>(split) * s.m + c0 + e] = total;
  }
}

// A consumer warpgroup over this block's items: a sum tile with the other
// consumer warpgroup; a GEMM item's chunks (at least one) into two
// alternating accumulators, chunk c + 1 issued before chunk c's sum joins
// the total, then the total, this warpgroup's 64 rows of the 128 x 128 dW
// tile, to the item's partial sums.
template <typename T>
__device__ __forceinline__ void red_consume(const ReduceArgs& a, int wg, unsigned char* smem,
                                            uint32_t ring, uint32_t full, uint32_t empty,
                                            uint32_t raw_full, uint32_t raw_empty) {
  float* bias = reinterpret_cast<float*>(smem + RedWs<T>::kEnd);  // the odd chains, f32
  using W = RedWs<T>;
  constexpr int R = kRedTile / 2;
  const long items = red_items(a);
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  int q = 0;
#pragma unroll 1
  for (long b = blockIdx.x; b < items; b += gridDim.x) {
    const Item it = item_at(a, static_cast<int>(b));
    if (it.gemm == 0) {
      sum_tile<T>(a.sums[it.j], it.tile, it.split, a.split_rows, a.rows);
      continue;
    }
    const Span sp = span_of<T>(a, it);
    const GemmJob& g = a.gemms[it.j];
    const bool fold_bias = g.bias_part != nullptr && sp.k0 == 0;  // f32 only
    Kahan cs;
    float total[R], acc0[R], acc1[R];
#pragma unroll
    for (int i = 0; i < R; ++i) total[i] = 0.0f;
    // chunk 0 in acc0, then pairs (acc1, acc0), each issued before the one
    // in flight joins the total; every wait unconditional inside a path, so
    // that ptxas sees which accumulator each wait retires
    red_issue<T>(acc0, smem, ring, full, empty, raw_full, raw_empty, q, wg, fold_bias, cs);
    ++q;
    int c = 1;
#pragma unroll 1
    for (; c + 1 < sp.nc; c += 2) {
      red_issue<T>(acc1, smem, ring, full, empty, raw_full, raw_empty, q, wg, fold_bias, cs);
      tc::wg_wait<1>();
      fold(total, acc0);
      release(empty, (q - 1) % W::kStages);
      ++q;
      red_issue<T>(acc0, smem, ring, full, empty, raw_full, raw_empty, q, wg, fold_bias, cs);
      tc::wg_wait<1>();
      fold(total, acc1);
      release(empty, (q - 1) % W::kStages);
      ++q;
    }
    if (c < sp.nc) {
      red_issue<T>(acc1, smem, ring, full, empty, raw_full, raw_empty, q, wg, fold_bias, cs);
      tc::wg_wait<1>();
      fold(total, acc0);
      release(empty, (q - 1) % W::kStages);
      ++q;
      tc::wg_wait<0>();
      fold(total, acc1);
    } else {
      tc::wg_wait<0>();
      fold(total, acc0);
    }
    release(empty, (q - 1) % W::kStages);
    if (fold_bias) {  // the column's even chain + its odd chain (in thread t + 64)
      const int t = threadIdx.x & 127, col = sp.m0 + 64 * wg + (t & 63);
      bar_sync(1 + wg);
      if (t >= 64) bias[64 * wg + (t & 63)] = cs.s;
      bar_sync(1 + wg);
      if (t < 64 && col < g.m)
        g.bias_part[static_cast<size_t>(it.split) * g.m + col] = cs.s + bias[64 * wg + t];
    }
    float* part = g.part + static_cast<size_t>(it.split) * g.k * g.m;
    const int kbase = sp.k0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int i = 0; i < kRedTile / 8; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int kk = kbase + 8 * h;
        const int mm = sp.m0 + 8 * i + 2 * (lane % 4);
        if (kk < g.k) {
          if (mm < g.m) part[static_cast<size_t>(kk) * g.m + mm] = total[4 * i + 2 * h];
          if (mm + 1 < g.m) part[static_cast<size_t>(kk) * g.m + mm + 1] = total[4 * i + 2 * h + 1];
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kWsThreads, 1)
    reduce_ws_kernel(const __grid_constant__ ReduceArgs a) {
  extern __shared__ unsigned char ws_smem_raw[];
  using W = RedWs<T>;
  using S = RedSmem<T>;
  using G = RedRegs<T>;
  unsigned char* smem = align1024(ws_smem_raw);
  const uint32_t ring = tc::smem_u32(smem);
  const uint32_t full = ring + S::kBars, empty = full + 8 * W::kStages;
  const uint32_t raw_full = empty + 8 * W::kStages, raw_empty = raw_full + 8 * W::kRawStages;
  if (threadIdx.x == 0) {
    for (int j = 0; j < W::kStages; ++j) {
      // bf16: the producer warpgroup's copies; f32: the consumer warps' halves
      tc::mbar_init(full + 8 * j, Tc<T>::kParts == 2 ? 8 : 128);
      tc::mbar_init(empty + 8 * j, 8);  // the eight consumer warps
    }
    for (int j = 0; j < W::kRawStages; ++j) {
      tc::mbar_init(raw_full + 8 * j, 128);  // the producer threads' copies
      tc::mbar_init(raw_empty + 8 * j, 8);   // the consumer warps' reads
    }
    tc::fence_mbar_init();
  }
  __syncthreads();  // the block's one barrier
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 2) {
    regs_dec<G::kProducer>();
    if constexpr (Tc<T>::kParts == 2)
      red_produce_f32(a, ring + W::kRaw, raw_full, raw_empty);
    else
      red_produce_bf16(a, ring, full, empty);
    return;
  }
  regs_inc<G::kConsumer>();
  red_consume<T>(a, wg, smem, ring, full, empty, raw_full, raw_empty);
}

// out = the chunks' partial sums added in chunk order, for every dW and
// folded bias
__global__ void __launch_bounds__(256) finish_kernel(const __grid_constant__ ReduceArgs a) {
  long idx = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int j = 0; j < a.n_gemm; ++j) {
    const GemmJob& g = a.gemms[j];
    const long size = static_cast<long>(g.k) * g.m;
    if (idx < size) {
      float s = g.part[idx];
      for (int q = 1; q < a.n_split; ++q) s += g.part[q * size + idx];
      g.out[idx] = s;
      return;
    }
    idx -= size;
  }
  for (int j = 0; j < a.n_gemm; ++j) {
    const GemmJob& g = a.gemms[j];
    if (g.bias_part == nullptr) continue;
    if (idx < g.m) {
      float s = g.bias_part[idx];
      for (int q = 1; q < a.n_split; ++q) s += g.bias_part[q * g.m + idx];
      g.bias_out[idx] = s;
      return;
    }
    idx -= g.m;
  }
  for (int j = 0; j < a.n_sum; ++j) {
    const SumJob& u = a.sums[j];
    if (idx < u.m) {
      float s = u.part[idx];
      for (int q = 1; q < a.n_split; ++q) s += u.part[q * u.m + idx];
      u.out[idx] = s;
      return;
    }
    idx -= u.m;
  }
}

template <typename T>
int launch_reduce_t(const ReduceArgs& a, long items, cudaStream_t stream) {
  constexpr int smem = RedSmem<T>::kBytes;
  auto kern = reduce_ws_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = static_cast<int>(items < sm_count() ? items : sm_count());
  kern<<<grid, kWsThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

inline int launch_reduce(const ReduceArgs& a, cudaStream_t stream) {
  if (a.n_gemm < 0 || a.n_gemm > kMaxJobs || a.n_sum < 0 || a.n_sum > kMaxJobs ||
      a.rows < 0 || a.split_rows != kSplitRows)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (a.rows + a.split_rows - 1) / a.split_rows;
  if (a.n_split != (chunks > 1 ? chunks : 1)) return static_cast<int>(cudaErrorInvalidValue);
  long finish = 0;
  for (int j = 0; j < a.n_gemm; ++j) {
    const GemmJob& g = a.gemms[j];
    if (g.part == nullptr || g.out == nullptr || (a.bf16 && g.bias_part != nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    // bf16 copies column pairs (4 bytes) at the least
    if (a.bf16 && (g.k % 2 || g.m % 2 || g.lda % 2 || g.ldb % 2 ||
                   reinterpret_cast<uintptr_t>(g.a) % 4 || reinterpret_cast<uintptr_t>(g.b) % 4))
      return static_cast<int>(cudaErrorInvalidValue);
    finish += static_cast<long>(g.k) * g.m + (g.bias_part != nullptr ? g.m : 0);
  }
  for (int j = 0; j < a.n_sum; ++j) {
    if (a.sums[j].part == nullptr || a.sums[j].out == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    finish += a.sums[j].m;
  }
  if (a.rows == 0) {  // empty sums: zeros, as the plain version gives
    for (int j = 0; j < a.n_gemm; ++j) {
      const GemmJob& g = a.gemms[j];
      cudaMemsetAsync(g.out, 0, sizeof(float) * g.k * g.m, stream);
      if (g.bias_out != nullptr) cudaMemsetAsync(g.bias_out, 0, sizeof(float) * g.m, stream);
    }
    for (int j = 0; j < a.n_sum; ++j)
      cudaMemsetAsync(a.sums[j].out, 0, sizeof(float) * a.sums[j].m, stream);
    return static_cast<int>(cudaGetLastError());
  }
  const long items = red_items(a);
  if (items == 0) return 0;
  const int err = a.bf16 ? launch_reduce_t<__nv_bfloat16>(a, items, stream)
                         : launch_reduce_t<float>(a, items, stream);
  if (err != 0 || finish == 0) return err;
  finish_kernel<<<static_cast<int>((finish + 255) / 256), 256, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bwd
}  // namespace satnerf
