// The SIREN trunk over one 32-row tile on the f32 FMA units, the loop of K6
// (trunk_fwd.cu trunk_fwd_il_kernel, the interleaved variant off every path);
// K1 and K3 run the tensor-core trunk of trunk_tc.cuh:
//   h_0 = sin(w0 * (x @ W0 + b0)),  h_i = sin(h_{i-1} @ W_i [+ x @ Ws_i] + b_i)
// The tile's activations live in shared memory; the weights stream from L2
// through the row-tile GEMM of tile_gemm.cuh. A skip concat [x, h] is a split
// GEMM accumulated in the same registers. Products sum in f32 (fmaf), the bias
// is added in f32, the sine is the f32 polynomial of sine.cuh, and each
// activation is stored in the compute dtype T (float or bf16).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sine.cuh"
#include "tile_gemm.cuh"

namespace satnerf {
namespace trunk {

using namespace satnerf::tile;

enum Act { kLinear = 0, kSine = 1, kRelu = 2 };

// acc = A @ W [+ A2 @ W2] for this thread's (rows, column pair) of an N-wide
// layer; tid is the thread's index within the kThreads threads of the tile
template <int N, typename T>
__device__ __forceinline__ void layer_acc(float (&acc)[Map<N>::kRpt][2], const T* A,
                                          int lda, int K, const T* W, const T* A2,
                                          int lda2, int K2, const T* W2,
                                          unsigned tid) {
#pragma unroll
  for (int r = 0; r < Map<N>::kRpt; ++r) acc[r][0] = acc[r][1] = 0.0f;
  gemm_acc<N>(acc, A, lda, K, W, tid);
  if (A2 != nullptr) gemm_acc<N>(acc, A2, lda2, K2, W2, tid);
}

// D = act(scale * (acc + bias)), stored in T. kActs: also write the
// pre-activation acc + bias, in T, to row r of the global tile `pre` (row
// stride ldpre) for rows < rows_valid.
template <int N, typename T, bool kActs>
__device__ __forceinline__ void layer_store(float (&acc)[Map<N>::kRpt][2],
                                            const float* __restrict__ bias, T* D,
                                            int ldd, int act, float scale,
                                            int sin_mode, T* pre, int ldpre,
                                            int rows_valid, unsigned tid) {
  using M = Map<N>;
  const int c = 2 * (tid % M::kPairs);
  const int row = (tid / M::kPairs) * M::kRpt;
  const float b0 = __ldg(bias + c), b1 = __ldg(bias + c + 1);
#pragma unroll
  for (int r = 0; r < M::kRpt; ++r) {
    float v0 = acc[r][0] + b0, v1 = acc[r][1] + b1;
    if (kActs && pre != nullptr && row + r < rows_valid)
      st2(pre + static_cast<size_t>(row + r) * ldpre + c, v0, v1);
    if (act == kSine) {
      v0 = satnerf::sin_mode(scale * v0, sin_mode);
      v1 = satnerf::sin_mode(scale * v1, sin_mode);
    } else if (act == kRelu) {
      v0 = fmaxf(v0, 0.0f);
      v1 = fmaxf(v1, 0.0f);
    }
    st2(D + (row + r) * ldd + c, v0, v1);
  }
}

// Copy rows row0.. of a (n, cols) row-major global array into a (kRows, ld)
// shared tile, zero past the last row; `count` threads from index tid.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src, int cols,
                                          int row0, int n, int tid, int count) {
  for (int i = tid; i < kRows * cols; i += count) {
    const int r = i / cols, c = i - r * cols;
    dst[r * ld + c] =
        (row0 + r < n) ? src[static_cast<size_t>(row0 + r) * cols + c] : zero<T>();
  }
}

// The tile's valid rows of H to rows row0.. of out (n, F); `count` threads
// from index tid.
template <typename T, int F>
__device__ __forceinline__ void store_tile(T* out, const T* H, int ldh, int row0,
                                           int rows_valid, int tid, int count) {
  T* og = out + static_cast<size_t>(row0) * F;
  for (int i = tid; i < kRows * F; i += count) {
    const int r = i / F, c = i - r * F;
    if (r < rows_valid) og[static_cast<size_t>(r) * F + c] = H[r * ldh + c];
  }
}

}  // namespace trunk
}  // namespace satnerf
