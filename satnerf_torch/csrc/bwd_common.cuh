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
//  - row_kernel: one layer (or one head layer) for every point. A block takes
//    a 32-row tile, computes up to four products A_j @ W_j into f32 registers
//    (the row-tile GEMM of tile_gemm.cuh, the same as the forward's), adds an
//    optional addend and bias, and applies one epilogue: a forward layer
//    (linear, sine, ReLU: the recompute) or a backward one
//    (ga = g * cos(scale * a) * scale, or ga = [a > 0] g). Its results go to
//    global workspaces in f32 and/or the compute dtype; that is where the TPU
//    kernel's VMEM stash lives on this card.
//  - reduce_kernel: every weight gradient dW = A^T B (f32 sums of
//    compute-dtype products) and every bias gradient db = sum_n B[n] of one
//    backward. Each block owns one 64x64 tile of one dW (or 64 columns of one
//    db) and walks ALL rows in a fixed order, so the result does not depend
//    on the launch configuration and two runs agree bit for bit.
//
// What bounds it on an H100: operations. Per point the flagship backward does
// ~2.8 M (heads) + 3.8-5.7 M (trunk) multiply-adds against a few kB of
// workspace traffic. The design keeps each product in the same f32 FMA loop
// as the forward; tensor cores (wgmma) are left for a later revision.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sine.cuh"
#include "tile_gemm.cuh"

namespace satnerf {
namespace bwd {

using namespace satnerf::tile;

constexpr int kMaxProds = 4;
constexpr int kMaxK = 512;
constexpr int kMaxJobs = 24;

// epilogues of row_kernel (satnerf_torch.ops._bwd mirrors the numbering)
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
  const void* w[kMaxProds];  // (k[j], width) compute dtype, row-major
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

// out (k, m) row-major f32 = A^T B over all rows; A (rows, k), B (rows, m) in
// the compute dtype with row strides lda, ldb
struct GemmJob {
  const void* a;
  const void* b;
  float* out;
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
  int n_gemm, n_sum, rows, bf16;
};

// ---- row kernel ---------------------------------------------------------------

template <typename T>
__device__ __forceinline__ float2 load2(const void* p, bool f32, size_t idx) {
  if (f32) return *reinterpret_cast<const float2*>(static_cast<const float*>(p) + idx);
  return ldg2(static_cast<const T*>(p) + idx);
}

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
  const float b0 = a.bias != nullptr ? __ldg(a.bias + c) : 0.0f;
  const float b1 = a.bias != nullptr ? __ldg(a.bias + c + 1) : 0.0f;
#pragma unroll
  for (int r = 0; r < M::kRpt; ++r) {
    const int row = rbase + r;
    if (row >= a.rows) break;
    float v0 = acc[r][0], v1 = acc[r][1];
    if (a.add != nullptr) {
      const float2 g = load2<T>(a.add, a.add_f32, static_cast<size_t>(row) * a.ld_add + c);
      v0 += g.x;
      v1 += g.y;
    }
    v0 += b0;
    v1 += b1;
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

// argument checks shared by the entry points; 0 when the launch may go ahead
inline int check_row(const RowArgs& a) {
  if (a.n_prod < 0 || a.n_prod > kMaxProds || a.rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int j = 0; j < a.n_prod; ++j)
    if (a.k[j] <= 0 || a.k[j] % 4 || a.k[j] > kMaxK || a.a[j] == nullptr ||
        a.w[j] == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
  if ((a.mode == kBwdSine || a.mode == kBwdRelu) && a.pre == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// ---- column reductions ------------------------------------------------------------

constexpr int kTile = 64;   // dW tile (k and m) per block
constexpr int kChunk = 32;  // rows per shared-memory step

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ int gemm_tiles(const GemmJob& g) {
  return ((g.k + kTile - 1) / kTile) * ((g.m + kTile - 1) / kTile);
}

// one 64x64 tile of out = A^T B: thread (tk, tm) owns a 4x4 block
template <typename T>
__device__ void gemm_tile(const GemmJob& g, int tile, int rows) {
  __shared__ __align__(16) float As[kChunk][kTile];
  __shared__ __align__(16) float Bs[kChunk][kTile];
  const int tiles_m = (g.m + kTile - 1) / kTile;
  const int k0 = (tile / tiles_m) * kTile, m0 = (tile % tiles_m) * kTile;
  const int tk = threadIdx.x / 16, tm = threadIdx.x % 16;
  const T* A = static_cast<const T*>(g.a);
  const T* B = static_cast<const T*>(g.b);
  float acc[4][4] = {};
  for (int n0 = 0; n0 < rows; n0 += kChunk) {
    for (int i = threadIdx.x; i < kChunk * kTile; i += kThreads) {
      const int r = i / kTile, c = i % kTile;
      const int n = n0 + r;
      As[r][c] = (n < rows && k0 + c < g.k)
                     ? to_f32<T>(A[static_cast<size_t>(n) * g.lda + k0 + c]) : 0.0f;
      Bs[r][c] = (n < rows && m0 + c < g.m)
                     ? to_f32<T>(B[static_cast<size_t>(n) * g.ldb + m0 + c]) : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < kChunk; ++r) {
      const float4 av = *reinterpret_cast<const float4*>(&As[r][4 * tk]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[r][4 * tm]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(ar[x], br[y], acc[x][y]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int kk = k0 + 4 * tk + x;
    if (kk >= g.k) break;
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int mm = m0 + 4 * tm + y;
      if (mm < g.m) g.out[static_cast<size_t>(kk) * g.m + mm] = acc[x][y];
    }
  }
}

// 64 columns of one bias sum: 4 row groups, then the 4 partials in order
template <typename T>
__device__ void sum_tile(const SumJob& s, int tile, int rows) {
  __shared__ float part[kThreads / kTile][kTile];
  const int col = tile * kTile + threadIdx.x % kTile;
  const int grp = threadIdx.x / kTile;
  constexpr int kGroups = kThreads / kTile;
  float acc = 0.0f;
  if (col < s.m) {
    for (int n = grp; n < rows; n += kGroups) {
      const size_t idx = static_cast<size_t>(n) * s.ldb + col;
      acc += s.b_f32 ? static_cast<const float*>(s.b)[idx]
                     : to_f32<T>(static_cast<const T*>(s.b)[idx]);
    }
  }
  part[grp][threadIdx.x % kTile] = acc;
  __syncthreads();
  if (grp == 0 && col < s.m) {
    float total = part[0][threadIdx.x];
#pragma unroll
    for (int q = 1; q < kGroups; ++q) total += part[q][threadIdx.x];
    s.out[col] = total;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) reduce_kernel(const ReduceArgs a) {
  int b = blockIdx.x;
  for (int j = 0; j < a.n_gemm; ++j) {
    const int t = gemm_tiles(a.gemms[j]);
    if (b < t) {
      gemm_tile<T>(a.gemms[j], b, a.rows);
      return;
    }
    b -= t;
  }
  for (int j = 0; j < a.n_sum; ++j) {
    const int t = (a.sums[j].m + kTile - 1) / kTile;
    if (b < t) {
      sum_tile<T>(a.sums[j], b, a.rows);
      return;
    }
    b -= t;
  }
}

inline int launch_reduce(const ReduceArgs& a, cudaStream_t stream) {
  if (a.n_gemm < 0 || a.n_gemm > kMaxJobs || a.n_sum < 0 || a.n_sum > kMaxJobs ||
      a.rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int blocks = 0;
  for (int j = 0; j < a.n_gemm; ++j)
    blocks += ((a.gemms[j].k + kTile - 1) / kTile) * ((a.gemms[j].m + kTile - 1) / kTile);
  for (int j = 0; j < a.n_sum; ++j) blocks += (a.sums[j].m + kTile - 1) / kTile;
  if (blocks == 0) return 0;
  if (a.bf16)
    reduce_kernel<__nv_bfloat16><<<blocks, kThreads, 0, stream>>>(a);
  else
    reduce_kernel<float><<<blocks, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bwd
}  // namespace satnerf
