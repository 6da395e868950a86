// Row-tile GEMM helpers on the f32 FMA units, for the backward kernels'
// 16-wide row kernel (bwd_common.cuh); trunk_tc.cuh takes its element stores.
//
// A block of kThreads threads owns a kRows-row tile of points; its activations
// sit in shared memory and the weights stream from global memory (L2). For an
// N-wide output each thread owns one column pair and Map<N>::kRpt rows, and
// accumulates in f32 registers (fmaf). The compute dtype T is float or bf16;
// bf16 operands are widened to f32 before each FMA.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace satnerf {
namespace tile {

constexpr int kRows = 32;     // rows of the point tile per block
constexpr int kThreads = 256;
constexpr int kPad = 4;       // row padding (elements) against bank conflicts

// ---- element access -------------------------------------------------------

__device__ __forceinline__ void lds4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void lds4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}
__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 ldg2(const __nv_bfloat16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.0f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}

// ---- tile GEMM --------------------------------------------------------------

// Thread -> output mapping of an N-wide layer over the 32-row tile: thread t
// owns the column pair 2*(t % (N/2)) and kRpt consecutive rows.
template <int N>
struct Map {
  static constexpr int kPairs = N / 2;
  static constexpr int kGroups = kThreads / kPairs;
  static constexpr int kRpt = kRows / kGroups;
  static_assert(kThreads % kPairs == 0 && kRows % kGroups == 0, "layer width");
};

// acc[r][0..1] += A[row(r), 0:K] @ W[0:K, col pair]; A in shared memory
// (row stride lda), W (K, N) row-major in global memory. K % 4 == 0.
// tid: this thread's index within the kThreads threads that share the tile
// (unsigned, as threadIdx.x: the mapping's divisions stay unsigned).
template <int N, typename T>
__device__ __forceinline__ void gemm_acc(float (&acc)[Map<N>::kRpt][2],
                                         const T* __restrict__ A, int lda, int K,
                                         const T* __restrict__ W, unsigned tid) {
  using M = Map<N>;
  const int pair = tid % M::kPairs;
  const int grp = tid / M::kPairs;
  const T* a_base = A + grp * M::kRpt * lda;
  const T* w = W + 2 * pair;
  float2 wc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wc[j] = ldg2(w + j * N);
  for (int k = 0; k < K; k += 4) {
    float2 wn[4];
    const bool more = k + 4 < K;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wn[j] = more ? ldg2(w + (k + 4 + j) * N) : make_float2(0.0f, 0.0f);
#pragma unroll
    for (int r = 0; r < M::kRpt; ++r) {
      float a[4];
      lds4(a_base + r * lda + k, a);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[r][0] = fmaf(a[j], wc[j].x, acc[r][0]);
        acc[r][1] = fmaf(a[j], wc[j].y, acc[r][1]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) wc[j] = wn[j];
  }
}

template <int N, typename T>
__device__ __forceinline__ void gemm_acc(float (&acc)[Map<N>::kRpt][2],
                                         const T* __restrict__ A, int lda, int K,
                                         const T* __restrict__ W) {
  gemm_acc<N>(acc, A, lda, K, W, threadIdx.x);
}

}  // namespace tile
}  // namespace satnerf
