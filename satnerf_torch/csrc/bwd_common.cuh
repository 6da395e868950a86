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
//    backward, over fixed chunks of rows, then a second small launch that
//    adds the chunks' partial sums in chunk order. The result depends on the
//    rows alone, never on the launch, and two runs agree bit for bit.
//
// What bounds it on an H100: operations. Per point the flagship backward
// does ~2.8 M (heads) + 3.8-5.7 M (trunk) multiply-adds against a few kB of
// workspace traffic. The f32 FMA units cap that at 67 TFLOP/s, so both blocks
// run on the tensor cores (wgmma, wgmma.cuh): a block of two warpgroups owns
// a 128 x BN tile of the output, its f32 accumulators stay in registers, and
// K arrives in 128-byte chunks through a two-stage ring of swizzled
// shared-memory tiles. The f32 compute dtype (the flagship's) runs 3xTF32:
// each operand x = hi + lo with hi, lo tf32, and the tile sums
// lo*hi + hi*lo + hi*hi in f32, about 22 significant bits, where one TF32
// pass would keep 11. Activations are split in registers on their way into
// shared memory; the wrapper splits the weights once (ops/_bwd.py). bf16
// operands go to the tensor cores as they are. Each tensor-core pass costs
// 3 x its FLOP in f32 (495 TFLOP/s tf32) and 1 x in bf16 (989 TFLOP/s).
//
// Staging: the row GEMM's A (rows, K) is K-major already and goes through
// registers (the split); its B is the weight stored (width, K), K-major as
// tf32 wgmma requires, and arrives by cp.async; in f32 the next chunk goes
// in four pieces, one beside each k-step's MMAs. The reduction contracts over
// rows, the strided dimension of both operands, so it transposes them in
// registers: a warp reads 32 neighbouring columns of four rows (f32) or 32
// column pairs of eight rows (bf16, one 32-bit load per row) and stores each
// column's values as one 16-byte chunk.
//
// What holds the blocks above that bound (f32 at 65,536 points on an H100 SXM
// at 700 W: K4 4.1x, its reduction 3.2x; the f32 row GEMM's per-step sums
// below cost it a wait per k-step and 128-wide tiles): one block per SM, so
// the register staging, the split and the epilogue run beside no MMAs; every
// 128-row tile reads its weight columns (hi and lo) again from L2; and the
// reduction waits for each chunk's MMAs before adding them to its f32 total.
//
// Accuracy in f32. The tensor cores add into their accumulator with
// truncation toward zero (1 + 0.75 ulp reads 1, -1 - 0.75 ulp reads -1), so
// an add's error leans the way the sum it lands on points. Summed over rows
// whose values cancel, as a head's bias gradient does at trained weights,
// errors that follow a partial sum's sign stay where the values go. So every
// tensor-core sum is short and its truncating add lands on that sum itself:
// the row GEMM sums each k-step afresh (its cross terms first, then hi*hi)
// into an f32 total in registers, rounded to nearest, which is why its f32
// tiles are 128 wide (the total beside the accumulator); the reduction sums
// each 32-row chunk afresh, its cross terms first; and the bias sums are
// compensated (Kahan) chains, where a plain chain of 4,096 f32 adds drifts.
// Measured at trained weights (k2_audit.py): K2's head gradients, step-level,
// within the plain f32 version's distance from f64.
//
// Thin products stay on the f32 FMA row kernel by a fixed rule on shape: an
// output 16 wide. That is K2's g_aux launch at aux blocks up to 16 columns
// (t-embeddings up to 6 wide): under 1% of K2's multiply-adds, 0.24 ms of
// K2's 8.85 ms (f32, 65,536 points, an H100 SXM at 700 W). Every other
// product, K 16 included, runs on the tensor cores; a wider g_aux launch
// (32 to 128 aux columns) comes padded by its wrapper to this rule's
// 64-column tiles.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sine.cuh"
#include "tile_gemm.cuh"
#include "wgmma.cuh"

namespace satnerf {
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
constexpr int kThinWidth = 16;  // the one width the FMA row kernel keeps

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
  const void* a[kMaxProds];     // (rows, k[j]) compute dtype, row stride lda[j]
  const void* w[kMaxProds];     // width 16: (k[j], width); else W^T (width, k[j]),
                                // in f32 its tf32 hi part
  const void* w_lo[kMaxProds];  // f32, width > 16: the tf32 lo part of W^T
  const void* add;              // (rows, width), row stride ld_add, f32 if add_f32
  const float* bias;            // (width,)
  const void* pre;              // (rows, width), row stride ld_pre, f32 if pre_f32
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

// out (m,) f32 = sum over rows of B (rows, m), f32 if b_f32 else compute dtype
struct SumJob {
  const void* b;
  float* out;
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

// columns c, c + 1 of one row: v0, v1 are the products' sums
template <typename T>
__device__ __forceinline__ void row_epilogue(const RowArgs& a, int row, int c, float v0,
                                             float v1) {
  if (a.add != nullptr) {
    const float2 g = load2<T>(a.add, a.add_f32, static_cast<size_t>(row) * a.ld_add + c);
    v0 += g.x;
    v1 += g.y;
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
  } else if (a.mode == kBwdSine || a.mode == kBwdRelu) {
    const float2 p = load2<T>(a.pre, a.pre_f32, static_cast<size_t>(row) * a.ld_pre + c);
    if (a.mode == kBwdSine) {
      m0 = v0 * cos_mode(a.scale * p.x, a.sin_mode) * a.scale;
      m1 = v1 * cos_mode(a.scale * p.y, a.sin_mode) * a.scale;
      s0 = sin_mode(a.scale * p.x, a.sin_mode);
      s1 = sin_mode(a.scale * p.y, a.sin_mode);
    } else {
      m0 = p.x > 0.0f ? v0 : 0.0f;
      m1 = p.y > 0.0f ? v1 : 0.0f;
    }
  }
  if (a.out_f32 != nullptr)
    st2(a.out_f32 + static_cast<size_t>(row) * a.ld_out_f32 + c, m0, m1);
  if (a.out_dt != nullptr)
    st2(static_cast<T*>(a.out_dt) + static_cast<size_t>(row) * a.ld_out_dt + c, m0, m1);
  if (a.out2_dt != nullptr)
    st2(static_cast<T*>(a.out2_dt) + static_cast<size_t>(row) * a.ld_out2 + c, s0, s1);
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

// ---- tensor-core tiles ------------------------------------------------------------

constexpr int kTcThreads = 256;  // two warpgroups
constexpr int kTcRows = 128;     // output rows per block: 64 per warpgroup
constexpr int kTileA = kTcRows * 128;  // bytes of one 128 x 128-byte tile

// K per 128-byte chunk (kKc) and per wgmma k-step (kKs); f32 keeps hi and lo
template <typename T> struct Tc;
template <> struct Tc<float> {
  static constexpr int kKc = 32, kKs = 8, kParts = 2;
};
template <> struct Tc<__nv_bfloat16> {
  static constexpr int kKc = 64, kKs = 16, kParts = 1;
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uintptr_t v = reinterpret_cast<uintptr_t>(p);
  return reinterpret_cast<unsigned char*>((v + 1023) & ~static_cast<uintptr_t>(1023));
}

// store one 16-byte chunk of compute-dtype values to the hi (and lo) tile
__device__ __forceinline__ void put16(unsigned char* hi, unsigned char* lo, uint32_t off,
                                      uint4 v, bool f32) {
  if (f32) {
    float4 x = *reinterpret_cast<float4*>(&v), h, l;
    tc::split_tf32(x.x, h.x, l.x);
    tc::split_tf32(x.y, h.y, l.y);
    tc::split_tf32(x.z, h.z, l.z);
    tc::split_tf32(x.w, h.w, l.w);
    *reinterpret_cast<float4*>(hi + off) = h;
    *reinterpret_cast<float4*>(lo + off) = l;
  } else {
    *reinterpret_cast<uint4*>(hi + off) = v;
  }
}

// d (+)= A B^T over one staged 128-byte chunk of four k-steps; `fresh`
// overwrites d with the chunk's sum instead of adding to it. bf16: one pass
// a k-step. f32: the cross terms lo*hi and hi*lo of every k-step first, then
// hi*hi of every k-step. Each tensor-core add truncates the sum to f32
// toward zero, so an add costs up to an ulp of what d holds: the eight
// cross-term adds land on a sum ~2^-11 of the chunk's, and only the four
// hi*hi adds cost ulps of the chunk's own size. a_hi/a_lo: this
// warpgroup's 64 rows; b_hi/b_lo: the N rows of B.
template <typename T, int N>
__device__ __forceinline__ void mma_chunk(float (&d)[N / 2], uint32_t a_hi, uint32_t a_lo,
                                          uint32_t b_hi, uint32_t b_lo, bool fresh) {
  if constexpr (Tc<T>::kParts == 2) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint32_t step = 32 * s;
      tc::mma<T, N>(d, tc::desc_sw128(a_lo + step), tc::desc_sw128(b_hi + step),
                    (s == 0 && fresh) ? 0 : 1);
      tc::mma<T, N>(d, tc::desc_sw128(a_hi + step), tc::desc_sw128(b_lo + step), 1);
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint32_t step = 32 * s;
      tc::mma<T, N>(d, tc::desc_sw128(a_hi + step), tc::desc_sw128(b_hi + step), 1);
    }
  } else {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint32_t step = 32 * s;
      tc::mma<T, N>(d, tc::desc_sw128(a_hi + step), tc::desc_sw128(b_hi + step),
                    (s == 0 && fresh) ? 0 : 1);
    }
  }
}

// ---- the row GEMM on the tensor cores ---------------------------------------------

// the chunk after (j, k0) in the products' K order
__device__ __forceinline__ void next_chunk(const RowArgs& a, int kc, int& j, int& k0) {
  k0 += kc;
  if (k0 >= a.k[j]) {
    ++j;
    k0 = 0;
  }
}

// this thread's four 16-byte pieces of the A chunk (j, k0): rows row0 .. +127
template <typename T>
__device__ __forceinline__ void load_a(const RowArgs& a, int j, int k0, int row0,
                                       uint4 (&r)[4]) {
  constexpr int kPer = 16 / sizeof(T);
  const char* base = static_cast<const char*>(a.a[j]);
  const size_t ld = static_cast<size_t>(a.lda[j]) * sizeof(T);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = threadIdx.x + kTcThreads * i;
    const int row = row0 + (idx >> 3), col = k0 + (idx & 7) * kPer;
    r[i] = (row < a.rows && col < a.k[j])
               ? __ldg(reinterpret_cast<const uint4*>(base + row * ld + col * sizeof(T)))
               : make_uint4(0, 0, 0, 0);
  }
}

// piece i of this thread's A chunk (rows 32 i .. 32 i + 31 of the tile)
template <typename T>
__device__ __forceinline__ void store_a_piece(unsigned char* hi, unsigned char* lo,
                                              const uint4 (&r)[4], int i) {
  const int idx = threadIdx.x + kTcThreads * i;
  put16(hi, lo, tc::sw128(idx >> 3, idx & 7), r[i], Tc<T>::kParts == 2);
}

template <typename T>
__device__ __forceinline__ void store_a(unsigned char* hi, unsigned char* lo,
                                        const uint4 (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) store_a_piece<T>(hi, lo, r, i);
}

// cp.async of rows n0 .. n0 + BN - 1 of W^T (width, K), chunk k0; zeros past K.
// Piece p of 4 (or all of them, p < 0): a quarter of the rows
template <typename T, int BN>
__device__ __forceinline__ void issue_b(const void* w, int K, int n0, int k0,
                                        unsigned char* dst, int p = -1) {
  constexpr int kPer = 16 / sizeof(T);
  constexpr int kIters = BN * 8 / kTcThreads;
  const char* base = static_cast<const char*>(w);
  const uint32_t d0 = tc::smem_u32(dst);
#pragma unroll
  for (int i = 0; i < kIters; ++i) {
    if (p >= 0 && i * 4 / kIters != p) continue;
    const int idx = threadIdx.x + kTcThreads * i;
    const int rr = idx >> 3, col = k0 + (idx & 7) * kPer;
    const bool ok = col < K;
    const char* src =
        ok ? base + (static_cast<size_t>(n0 + rr) * K + col) * sizeof(T) : base;
    tc::cp_async16(d0 + tc::sw128(rr, idx & 7), src, ok);
  }
}

template <typename T, int BN>
struct RowSmem {
  static constexpr int kB = BN * 128;
  static constexpr int kStage = Tc<T>::kParts * (kTileA + kB);
  static constexpr int kEpi = kTcRows * (BN + 8) * 4;  // the f32 output tile
  static constexpr int kBytes = (2 * kStage > kEpi ? 2 * kStage : kEpi) + 1024;
};

template <typename T, int BN>
__device__ __forceinline__ void stage_row_chunk(const RowArgs& a, unsigned char* st, int j,
                                                int k0, int n0, const uint4 (&r)[4]) {
  using S = RowSmem<T, BN>;
  unsigned char* a_hi = st;
  unsigned char* a_lo = st + kTileA;  // f32 only
  unsigned char* b_hi = st + Tc<T>::kParts * kTileA;
  issue_b<T, BN>(a.w[j], a.k[j], n0, k0, b_hi);
  if (Tc<T>::kParts == 2) issue_b<T, BN>(a.w_lo[j], a.k[j], n0, k0, b_hi + S::kB);
  tc::cp_async_commit();
  store_a<T>(a_hi, a_lo, r);
  tc::cp_async_wait_all();
  tc::fence_async_smem();
}

// piece p of 4 of stage_row_chunk (f32): a quarter of the B copies and of the
// A stores; the caller waits for the copies and fences after the last piece
template <int BN>
__device__ __forceinline__ void stage_row_piece(const RowArgs& a, unsigned char* st, int j,
                                                int k0, int n0, const uint4 (&r)[4], int p) {
  using S = RowSmem<float, BN>;
  unsigned char* b_hi = st + 2 * kTileA;
  issue_b<float, BN>(a.w[j], a.k[j], n0, k0, b_hi, p);
  issue_b<float, BN>(a.w_lo[j], a.k[j], n0, k0, b_hi + S::kB, p);
  tc::cp_async_commit();
  store_a_piece<float>(st, st + kTileA, r, p);
}

template <typename T, int BN>
__global__ void __launch_bounds__(kTcThreads, 1)
    tc_row_kernel(const __grid_constant__ RowArgs a) {
  extern __shared__ unsigned char tc_smem_raw[];
  using S = RowSmem<T, BN>;
  constexpr int kKc = Tc<T>::kKc;
  // f32: the tensor cores add into `acc` with truncation toward zero, so an
  // add's error leans the way the sum it lands on points. Each k-step's three
  // passes start afresh, the cross terms first, so that the one add that
  // truncates at the step's own size lands on the step's sum itself, and join
  // `total` in an f32 add, rounded to nearest. Over many rows whose values
  // cancel (a bias gradient at trained weights) those errors then cancel with
  // the values; truncating a longer running sum left them standing.
  constexpr bool kFold = Tc<T>::kParts == 2;
  unsigned char* smem = align1024(tc_smem_raw);
  const int wg = threadIdx.x / 128;
  const int row0 = blockIdx.x * kTcRows, n0 = blockIdx.y * BN;

  int nc = 0;
  for (int j = 0; j < a.n_prod; ++j) nc += (a.k[j] + kKc - 1) / kKc;

  float acc[BN / 2], total[BN / 2];  // total: f32 only
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = total[i] = 0.0f;
  uint4 ra[4];
  int j = 0, k0 = 0;  // the next chunk to stage
  if (nc > 0) {
    load_a<T>(a, j, k0, row0, ra);
    stage_row_chunk<T, BN>(a, smem, j, k0, n0, ra);
    next_chunk(a, kKc, j, k0);
  }
  __syncthreads();
  for (int c = 0; c < nc; ++c) {
    unsigned char* cur = smem + (c & 1) * S::kStage;
    unsigned char* nxt = smem + ((c + 1) & 1) * S::kStage;
    const bool more = c + 1 < nc;
    if (more) load_a<T>(a, j, k0, row0, ra);  // in flight during the MMAs
    const uint32_t a_hi = tc::smem_u32(cur) + wg * 64 * 128;
    const uint32_t b_hi = tc::smem_u32(cur) + Tc<T>::kParts * kTileA;
    if constexpr (kFold) {
      // the next chunk is staged in four pieces, one beside each k-step's MMAs
      // (every MMA on its stage, chunk c - 1's, retired before the barrier
      // that ended the last iteration). One accumulator: a second, to run a
      // step's MMAs under the previous step's sum, spilled (255 registers)
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const uint32_t k = 32 * s;
        tc::fence_regs(acc);
        tc::wg_fence();
        tc::mma<T, BN>(acc, tc::desc_sw128(a_hi + kTileA + k), tc::desc_sw128(b_hi + k), 0);
        tc::mma<T, BN>(acc, tc::desc_sw128(a_hi + k), tc::desc_sw128(b_hi + S::kB + k), 1);
        tc::mma<T, BN>(acc, tc::desc_sw128(a_hi + k), tc::desc_sw128(b_hi + k), 1);
        tc::wg_commit();
        if (more) stage_row_piece<BN>(a, nxt, j, k0, n0, ra, s);
        tc::wg_wait<0>();
        tc::fence_regs(acc);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) total[i] += acc[i];
      }
      if (more) {
        tc::cp_async_wait_all();
        tc::fence_async_smem();
        next_chunk(a, kKc, j, k0);
      }
      __syncthreads();
    } else {
      tc::fence_regs(acc);
      tc::wg_fence();
      mma_chunk<T, BN>(acc, a_hi, a_hi + kTileA, b_hi, b_hi + S::kB, false);
      tc::wg_commit();
      tc::wg_wait<1>();  // chunk c - 1 done: its stage may be refilled
      tc::fence_regs(acc);
      __syncthreads();
      if (more) {
        stage_row_chunk<T, BN>(a, nxt, j, k0, n0, ra);
        next_chunk(a, kKc, j, k0);
      }
      __syncthreads();
    }
  }
  if constexpr (!kFold) {
    tc::wg_wait<0>();
    tc::fence_regs(acc);
  }
  __syncthreads();  // both warpgroups are done with the stages

  // the sums' fragment to shared memory: warp w of the warpgroup holds
  // rows 16w + lane/4 (+8); value 4i + 2h + e sits at column
  // 8i + 2(lane % 4) + e, row + 8h
  constexpr int ldc = BN + 8;
  float* ct = reinterpret_cast<float*>(smem);
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int r0 = wg * 64 + warp * 16 + lane / 4;
  auto put = [&](const float (&v)[BN / 2]) {
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(ct + (r0 + 8 * h) * ldc + 8 * i + 2 * (lane % 4)) =
            make_float2(v[4 * i + 2 * h], v[4 * i + 2 * h + 1]);
  };
  if constexpr (kFold) put(total); else put(acc);
  __syncthreads();
  // the epilogue, a column pair per thread along each row
#pragma unroll 1
  for (int idx = threadIdx.x; idx < kTcRows * (BN / 2); idx += kTcThreads) {
    const int r = idx / (BN / 2), c = 2 * (idx % (BN / 2));
    if (row0 + r < a.rows)
      row_epilogue<T>(a, row0 + r, n0 + c, ct[r * ldc + c], ct[r * ldc + c + 1]);
  }
}

template <typename T, int BN>
int launch_tc_row(const RowArgs& a, cudaStream_t stream) {
  constexpr int smem = RowSmem<T, BN>::kBytes;
  auto kern = tc_row_kernel<T, BN>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.rows + kTcRows - 1) / kTcRows, a.width / BN);
  kern<<<grid, kTcThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// argument checks; 0 when the launch may go ahead
inline int check_row(const RowArgs& a) {
  if (a.n_prod < 0 || a.n_prod > kMaxProds || a.rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool thin = a.width == kThinWidth;
  // 16-byte staging: K a whole number of 16-byte pieces (4 f32, 8 bf16)
  const int per = a.bf16 ? 8 : 4;
  for (int j = 0; j < a.n_prod; ++j) {
    if (a.k[j] <= 0 || a.k[j] > (thin ? kThinMaxK : kMaxK) || a.a[j] == nullptr ||
        a.w[j] == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    if (thin ? a.k[j] % 4 : (a.k[j] % per || a.lda[j] % per))
      return static_cast<int>(cudaErrorInvalidValue);
    if (!thin && !a.bf16 && a.w_lo[j] == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((a.mode == kBwdSine || a.mode == kBwdRelu) && a.pre == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// the fixed rule on shape: width 16 -> FMA kernel; multiples of kWide<T> ->
// 128 x kWide<T> tensor-core tiles (f32 128: its f32 total beside the
// accumulator must fit the registers; bf16 256); other multiples of 64 ->
// 128 x 64 tiles
template <typename T> constexpr int kWide = Tc<T>::kParts == 2 ? 128 : 256;

template <typename T>
int dispatch_row(const RowArgs& a, cudaStream_t stream) {
  if (a.width == kThinWidth) return launch_row<T, kThinWidth>(a, stream);
  if (a.width > 0 && a.width % kWide<T> == 0) return launch_tc_row<T, kWide<T>>(a, stream);
  if (a.width > 0 && a.width % 64 == 0) return launch_tc_row<T, 64>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

inline int row_entry(const RowArgs* a, cudaStream_t stream) {
  if (const int err = check_row(*a)) return err;
  if (a->rows == 0) return 0;
  return a->bf16 ? dispatch_row<__nv_bfloat16>(*a, stream) : dispatch_row<float>(*a, stream);
}

// ---- the weight-gradient reduction on the tensor cores ------------------------------

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

__host__ __device__ __forceinline__ int red_tiles(const GemmJob& g) {
  return ((g.k + kRedTile - 1) / kRedTile) * ((g.m + kRedTile - 1) / kRedTile);
}

// Transposing load of one stage: columns c0 .. c0 + 127 of X (rows, ncols),
// rows n0 .. n0 + kKc - 1, as four 16-byte chunks of one column's rows.
// f32: thread t takes column c0 + t % 128 and the row groups
// q = t / 128 + 2i (4 rows each). bf16: thread t takes the column pair
// c0 + 2 (t % 64) + {0, 1} (one 32-bit load per row) and the row groups
// t / 64 and t / 64 + 4 (8 rows each).
__device__ __forceinline__ void load_t(const float* x, int ld, int ncols, int c0, int n0,
                                       int n_end, uint4 (&r)[4]) {
  const int col = c0 + threadIdx.x % 128;
  const bool col_ok = col < ncols;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = threadIdx.x / 128 + 2 * i;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + 4 * q + e;
      v[e] = (col_ok && n < n_end) ? x[static_cast<size_t>(n) * ld + col] : 0.0f;
    }
    r[i] = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
}

__device__ __forceinline__ void load_t(const __nv_bfloat16* x, int ld, int ncols, int c0,
                                       int n0, int n_end, uint4 (&r)[4]) {
  const int col = c0 + 2 * (threadIdx.x % 64);
  const bool col_ok = col < ncols;  // ncols is even
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int q = threadIdx.x / 64 + 4 * g;
    uint32_t w[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int n = n0 + 8 * q + e;
      w[e] = (col_ok && n < n_end)
                 ? *reinterpret_cast<const uint32_t*>(x + static_cast<size_t>(n) * ld + col)
                 : 0u;
    }
    // low halves: column col, high halves: column col + 1
    r[2 * g] = make_uint4(__byte_perm(w[0], w[1], 0x5410), __byte_perm(w[2], w[3], 0x5410),
                          __byte_perm(w[4], w[5], 0x5410), __byte_perm(w[6], w[7], 0x5410));
    r[2 * g + 1] = make_uint4(
        __byte_perm(w[0], w[1], 0x7632), __byte_perm(w[2], w[3], 0x7632),
        __byte_perm(w[4], w[5], 0x7632), __byte_perm(w[6], w[7], 0x7632));
  }
}

template <typename T>
__device__ __forceinline__ void store_t(unsigned char* hi, unsigned char* lo,
                                        const uint4 (&r)[4]) {
  if (Tc<T>::kParts == 2) {
    const int row = threadIdx.x % 128;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      put16(hi, lo, tc::sw128(row, threadIdx.x / 128 + 2 * i), r[i], true);
  } else {
    const int row = 2 * (threadIdx.x % 64);
#pragma unroll
    for (int g = 0; g < 2; ++g)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        put16(hi, lo, tc::sw128(row + e, threadIdx.x / 64 + 4 * g), r[2 * g + e], false);
  }
}

template <typename T>
struct RedSmem {
  static constexpr int kStage = 2 * Tc<T>::kParts * kTileA;  // A then B
  static constexpr int kBytes = 2 * kStage + 1024;
};

// one (tile, row chunk) of one dW: 128 x 128 f32 partial sums
template <typename T>
__device__ void red_tile(const GemmJob& g, int tile, int split, int split_rows, int rows,
                         unsigned char* smem) {
  using S = RedSmem<T>;
  constexpr int kKc = Tc<T>::kKc;
  constexpr int kP = Tc<T>::kParts;
  const int tiles_m = (g.m + kRedTile - 1) / kRedTile;
  const int k0 = (tile / tiles_m) * kRedTile, m0 = (tile % tiles_m) * kRedTile;
  const int n_begin = split * split_rows;
  const int n_end = min(rows, n_begin + split_rows);
  const int nc = (n_end - n_begin + kKc - 1) / kKc;
  const int wg = threadIdx.x / 128;
  // f32 bias fold: this thread's column of B, over its rows
  const bool fold = g.bias_part != nullptr && k0 == 0;
  Kahan csum;
  const T* A = static_cast<const T*>(g.a);
  const T* B = static_cast<const T*>(g.b);

  // the tensor cores add into `acc` with truncation, so a long sum drifts;
  // each chunk's sum starts afresh and joins `total` in an f32 add
  float acc[kRedTile / 2], total[kRedTile / 2];
#pragma unroll
  for (int i = 0; i < kRedTile / 2; ++i) acc[i] = total[i] = 0.0f;
  uint4 ra[4], rb[4];

  auto stage = [&](unsigned char* st) {
    store_t<T>(st, st + kTileA, ra);
    store_t<T>(st + kP * kTileA, st + kP * kTileA + kTileA, rb);
    tc::fence_async_smem();
    if (fold) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = *reinterpret_cast<float4*>(&rb[i]);
        csum.add(v.x);
        csum.add(v.y);
        csum.add(v.z);
        csum.add(v.w);
      }
    }
  };
  if (nc > 0) {
    load_t(A, g.lda, g.k, k0, n_begin, n_end, ra);
    load_t(B, g.ldb, g.m, m0, n_begin, n_end, rb);
    stage(smem);
  }
  __syncthreads();
  for (int c = 0; c < nc; ++c) {
    unsigned char* cur = smem + (c & 1) * S::kStage;
    unsigned char* nxt = smem + ((c + 1) & 1) * S::kStage;
    const bool more = c + 1 < nc;
    const int n_next = n_begin + (c + 1) * kKc;
    if (more) {
      load_t(A, g.lda, g.k, k0, n_next, n_end, ra);
      load_t(B, g.ldb, g.m, m0, n_next, n_end, rb);
    }
    const uint32_t a_hi = tc::smem_u32(cur) + wg * 64 * 128;
    const uint32_t b_hi = tc::smem_u32(cur) + kP * kTileA;
    tc::fence_regs(acc);
    tc::wg_fence();
    mma_chunk<T, kRedTile>(acc, a_hi, a_hi + kTileA, b_hi, b_hi + kTileA, true);
    tc::wg_commit();
    tc::wg_wait<0>();
    tc::fence_regs(acc);
#pragma unroll
    for (int i = 0; i < kRedTile / 2; ++i) total[i] += acc[i];
    __syncthreads();
    if (more) stage(nxt);
    __syncthreads();
  }

  float* part = g.part + static_cast<size_t>(split) * g.k * g.m;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int kbase = k0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int i = 0; i < kRedTile / 8; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kk = kbase + 8 * h;
      const int mm = m0 + 8 * i + 2 * (lane % 4);
      if (kk < g.k) {
        if (mm < g.m) part[static_cast<size_t>(kk) * g.m + mm] = total[4 * i + 2 * h];
        if (mm + 1 < g.m) part[static_cast<size_t>(kk) * g.m + mm + 1] = total[4 * i + 2 * h + 1];
      }
    }
  }
  if (fold) {  // the two row groups of each column, in order
    float* cs = reinterpret_cast<float*>(smem);
    __syncthreads();
    cs[threadIdx.x] = csum.s;
    __syncthreads();
    const int col = m0 + threadIdx.x;
    if (threadIdx.x < 128 && col < g.m)
      g.bias_part[static_cast<size_t>(split) * g.m + col] = cs[threadIdx.x] + cs[threadIdx.x + 128];
  }
}

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 64 columns of one bias sum that no GEMM stages (bf16: the f32 gradient):
// 4 row groups, each a compensated chain, then the 4 partials in order
template <typename T>
__device__ void sum_tile(const SumJob& s, int tile, int rows, unsigned char* smem) {
  constexpr int kCols = 64, kGroups = kTcThreads / kCols;
  float* part = reinterpret_cast<float*>(smem);
  const int col = tile * kCols + threadIdx.x % kCols;
  const int grp = threadIdx.x / kCols;
  Kahan acc;
  if (col < s.m) {
    for (int n = grp; n < rows; n += kGroups) {
      const size_t idx = static_cast<size_t>(n) * s.ldb + col;
      acc.add(s.b_f32 ? static_cast<const float*>(s.b)[idx]
                      : to_f32<T>(static_cast<const T*>(s.b)[idx]));
    }
  }
  part[threadIdx.x] = acc.s;
  __syncthreads();
  if (grp == 0 && col < s.m) {
    float total = part[threadIdx.x];
#pragma unroll
    for (int q = 1; q < kGroups; ++q) total += part[q * kCols + threadIdx.x];
    s.out[col] = total;
  }
}

// blocks: the sums first (they walk every row, so they start early), then for
// each GEMM its tiles, chunk-major so that blocks in flight share rows in L2
template <typename T>
__global__ void __launch_bounds__(kTcThreads, 1)
    reduce_kernel(const __grid_constant__ ReduceArgs a) {
  extern __shared__ unsigned char tc_smem_raw[];
  unsigned char* smem = align1024(tc_smem_raw);
  int b = blockIdx.x;
  for (int j = 0; j < a.n_sum; ++j) {
    const int t = (a.sums[j].m + 63) / 64;
    if (b < t) {
      sum_tile<T>(a.sums[j], b, a.rows, smem);
      return;
    }
    b -= t;
  }
  for (int j = 0; j < a.n_gemm; ++j) {
    const int tiles = red_tiles(a.gemms[j]);
    const int t = tiles * a.n_split;
    if (b < t) {
      red_tile<T>(a.gemms[j], b % tiles, b / tiles, a.split_rows, a.rows, smem);
      return;
    }
    b -= t;
  }
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
}

template <typename T>
int launch_reduce_t(const ReduceArgs& a, int blocks, cudaStream_t stream) {
  constexpr int smem = RedSmem<T>::kBytes;
  auto kern = reduce_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<blocks, kTcThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

inline int launch_reduce(const ReduceArgs& a, cudaStream_t stream) {
  if (a.n_gemm < 0 || a.n_gemm > kMaxJobs || a.n_sum < 0 || a.n_sum > kMaxJobs ||
      a.rows < 0 || a.split_rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (a.rows + a.split_rows - 1) / a.split_rows;
  if (a.n_split != (chunks > 1 ? chunks : 1)) return static_cast<int>(cudaErrorInvalidValue);
  long blocks = 0, finish = 0;
  for (int j = 0; j < a.n_sum; ++j) blocks += (a.sums[j].m + 63) / 64;
  for (int j = 0; j < a.n_gemm; ++j) {
    const GemmJob& g = a.gemms[j];
    if (g.part == nullptr || g.out == nullptr || (a.bf16 && g.bias_part != nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    // bf16 stages column pairs with 32-bit loads
    if (a.bf16 && (g.k % 2 || g.m % 2 || g.lda % 2 || g.ldb % 2))
      return static_cast<int>(cudaErrorInvalidValue);
    blocks += static_cast<long>(red_tiles(g)) * a.n_split;
    finish += static_cast<long>(g.k) * g.m + (g.bias_part != nullptr ? g.m : 0);
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
  if (blocks == 0) return 0;
  const int err = a.bf16 ? launch_reduce_t<__nv_bfloat16>(a, static_cast<int>(blocks), stream)
                         : launch_reduce_t<float>(a, static_cast<int>(blocks), stream);
  if (err != 0 || finish == 0) return err;
  finish_kernel<<<static_cast<int>((finish + 255) / 256), 256, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bwd
}  // namespace satnerf
