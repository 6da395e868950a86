// Fused field forward: SIREN trunk + every head for one 32-row tile per block.
//
// Replaces the TPU kernel satnerf_tpu/ops/pallas/field_fused.py:fused_field
// (_fwd_call -> _fwd_kernel, _heads_forward), forward only. Per point:
//   h_0 = sin(w0 * (x @ W0 + b0)),  h_i = sin(h_{i-1} @ W_i [+ x @ Ws_i] + b_i)
//   feats = h @ Wf + bf
//   sv = sin(feats @ Wsv0f + aux @ Wsv0a + b) -> sin(. @ Wsv1 + b) -> sin(. @ Wsv2 + b)
//   HEADS_ON: rgb, sky (ReLU on aux), beta and semantic hidden layers
//   out(16 cols) = shared @ W2s + sv @ W2sv [+ rgb/sky/beta/sem projections] + b
// See satnerf_torch/ops/field_fused.py for the packed layouts and columns.
//
// What bounds it on an H100: operations. The flagship field (8x512 trunk,
// skip at 4, 60 encoded inputs, 256-wide heads) does ~2.8 M multiply-adds
// and ~5.6 k sines per point and reads only ~300 bytes of input per point,
// so it sits far above the card's flops-per-byte ridge.
//
// What the design does about it. The TPU kernel keeps every weight resident
// in a 64 MB VMEM; an H100 block has 227 KB of shared memory. So this kernel
// keeps the ACTIVATIONS of one 32-row tile on chip instead, and streams the
// weights from L2 (8 MB of f32 trunk weights fit the 50 MB L2 many times
// over, so after the first tiles every weight read is an L2 hit):
//  - shared memory holds the x tile, the aux tile, one (32, F) activation
//    buffer H and one (32, FL) head buffer P, ~109 KB in f32 at the flagship
//    widths, so two blocks share an SM; every layer is computed in place
//    (all products land in registers, a barrier, then the write-back);
//  - 256 threads; for an N-wide layer each thread owns two adjacent output
//    columns of 32*N/512 rows, so per 4-deep k step it does one 16-byte
//    shared load per row against 4 prefetched weight pairs (the next step's
//    weights load while this step's FMAs run);
//  - the skip concat [x, h] and [feats, aux] are split GEMMs accumulated in
//    the same registers; the final projections accumulate into two
//    registers per thread across every head, so no head hidden ever leaves
//    the chip and only (N, 16) f32 is written back.
// Products accumulate in f32 (fmaf), the bias is added in f32, the sine is
// the f32 polynomial of sine.cuh, and each activation is stored in the
// compute dtype (float or bf16), as the reference stores it. Tensor cores,
// TMA and warp specialisation are left for a later revision.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sine.cuh"

// Mirror of satnerf_torch.ops.field_fused._FieldArgs (ctypes); keep in sync.
struct FieldArgs {
  const void* x;
  const void* aux;
  void* out;
  const void* w0;
  const void* w_mid;
  const void* w_skip;
  const void* b;
  const void* w_feats;
  const void* b_feats;
  const void* w_sv0_f;
  const void* w_sv0_aux;
  const void* w_sv1;
  const void* w_sv2;
  const void* w_rgb0;
  const void* w_sky0_aux;
  const void* w_b0_f;
  const void* w_b0_aux;
  const void* w_s0_f;
  const void* w_s0_aux;
  const void* w2_shared;
  const void* w2_sv;
  const void* w2_rgb;
  const void* w2_sky;
  const void* w2_beta;
  const void* w2_sem;
  const void* b_heads;
  const void* b_small;
  int n, layers, feat, fl, cx, aux_w, skip_mask, heads_on, has_beta,
      has_semantic, use_s_aux, sin_mode, bf16;
  float w0_scale;
};

namespace {

constexpr int kRows = 32;     // rows of the point tile per block
constexpr int kThreads = 256;
constexpr int kPad = 4;       // row padding (elements) against bank conflicts


// rows of b_heads (satnerf_torch.ops.field_fused.HIDDEN_BIAS_ROWS)
enum HiddenBias { kRgb0 = 0, kSv0, kSv1, kSv2, kSky0, kB0, kS0 };
enum Act { kLinear = 0, kSine = 1, kRelu = 2 };

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
template <int N, typename T>
__device__ __forceinline__ void gemm_acc(float (&acc)[Map<N>::kRpt][2],
                                         const T* __restrict__ A, int lda, int K,
                                         const T* __restrict__ W) {
  using M = Map<N>;
  const int pair = threadIdx.x % M::kPairs;
  const int grp = threadIdx.x / M::kPairs;
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

// D = act(scale * (A @ W [+ A2 @ W2] + bias)), stored in T. D may alias A:
// every product is in registers before the barrier that precedes the write.
template <int N, typename T>
__device__ __forceinline__ void layer(const T* A, int lda, int K, const T* W,
                                      const T* A2, int lda2, int K2, const T* W2,
                                      const float* __restrict__ bias, T* D, int ldd,
                                      int act, float scale, int sin_mode) {
  using M = Map<N>;
  float acc[M::kRpt][2];
#pragma unroll
  for (int r = 0; r < M::kRpt; ++r) acc[r][0] = acc[r][1] = 0.0f;
  gemm_acc<N>(acc, A, lda, K, W);
  if (A2 != nullptr) gemm_acc<N>(acc, A2, lda2, K2, W2);
  const int c = 2 * (threadIdx.x % M::kPairs);
  const int row = (threadIdx.x / M::kPairs) * M::kRpt;
  const float b0 = __ldg(bias + c), b1 = __ldg(bias + c + 1);
  __syncthreads();
#pragma unroll
  for (int r = 0; r < M::kRpt; ++r) {
    float v0 = acc[r][0] + b0, v1 = acc[r][1] + b1;
    if (act == kSine) {
      v0 = satnerf::sin_mode(scale * v0, sin_mode);
      v1 = satnerf::sin_mode(scale * v1, sin_mode);
    } else if (act == kRelu) {
      v0 = fmaxf(v0, 0.0f);
      v1 = fmaxf(v1, 0.0f);
    }
    st2(D + (row + r) * ldd + c, v0, v1);
  }
  __syncthreads();
}

// ---- the kernel ---------------------------------------------------------------

template <typename T, bool kHeadsOn, int F, int FL>
__global__ void __launch_bounds__(kThreads, 2)
field_fused_kernel(const FieldArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int ldh = F + kPad;
  constexpr int ldp = FL + kPad;
  const int ldx = a.cx + kPad;
  const int ldaux = a.aux_w + kPad;
  T* X = reinterpret_cast<T*>(smem_raw);
  T* AX = X + kRows * ldx;
  T* H = AX + kRows * ldaux;
  T* P = H + kRows * ldh;
  const int row0 = blockIdx.x * kRows;
  const int mode = a.sin_mode;

  // x and aux tiles, zero past the last row
  const T* xg = static_cast<const T*>(a.x);
  const T* auxg = static_cast<const T*>(a.aux);
  for (int i = threadIdx.x; i < kRows * a.cx; i += kThreads) {
    const int r = i / a.cx, c = i - r * a.cx;
    X[r * ldx + c] = (row0 + r < a.n) ? xg[static_cast<size_t>(row0 + r) * a.cx + c]
                                      : zero<T>();
  }
  for (int i = threadIdx.x; i < kRows * a.aux_w; i += kThreads) {
    const int r = i / a.aux_w, c = i - r * a.aux_w;
    AX[r * ldaux + c] = (row0 + r < a.n)
                            ? auxg[static_cast<size_t>(row0 + r) * a.aux_w + c]
                            : zero<T>();
  }
  __syncthreads();

  // trunk: layer 0 (w0-scaled sine), then layers 1.. in place in H
  const float* b = static_cast<const float*>(a.b);
  const T* w_mid = static_cast<const T*>(a.w_mid);
  const T* w_skip = static_cast<const T*>(a.w_skip);
  layer<F, T>(X, ldx, a.cx, static_cast<const T*>(a.w0), nullptr, 0, 0, nullptr,
              b, H, ldh, kSine, a.w0_scale, mode);
  int s = 0;
  for (int i = 1; i < a.layers; ++i) {
    const bool skip = (a.skip_mask >> i) & 1;
    layer<F, T>(H, ldh, F, w_mid + static_cast<size_t>(i - 1) * F * F,
                skip ? X : nullptr, ldx, a.cx,
                skip ? w_skip + static_cast<size_t>(s) * a.cx * F : nullptr,
                b + i * F, H, ldh, kSine, 1.0f, mode);
    s += skip;
  }

  // heads. out: this thread's (row, column pair) of the 16-column output
  float out[Map<16>::kRpt][2] = {{0.0f, 0.0f}};
  const float* bh = static_cast<const float*>(a.b_heads);
  const T* AUXn = nullptr;  // "no second operand"
  gemm_acc<16>(out, H, ldh, F, static_cast<const T*>(a.w2_shared));
  layer<F, T>(H, ldh, F, static_cast<const T*>(a.w_feats), AUXn, 0, 0, nullptr,
              static_cast<const float*>(a.b_feats), H, ldh, kLinear, 1.0f, mode);
  // H now holds feats; the sun-visibility chain runs in P
  layer<FL, T>(H, ldh, F, static_cast<const T*>(a.w_sv0_f), AX, ldaux, a.aux_w,
               static_cast<const T*>(a.w_sv0_aux), bh + kSv0 * FL, P, ldp, kSine,
               1.0f, mode);
  layer<FL, T>(P, ldp, FL, static_cast<const T*>(a.w_sv1), AUXn, 0, 0, nullptr,
               bh + kSv1 * FL, P, ldp, kSine, 1.0f, mode);
  layer<FL, T>(P, ldp, FL, static_cast<const T*>(a.w_sv2), AUXn, 0, 0, nullptr,
               bh + kSv2 * FL, P, ldp, kSine, 1.0f, mode);
  gemm_acc<16>(out, P, ldp, FL, static_cast<const T*>(a.w2_sv));

  if (kHeadsOn) {
    layer<FL, T>(H, ldh, F, static_cast<const T*>(a.w_rgb0), AUXn, 0, 0, nullptr,
                 bh + kRgb0 * FL, P, ldp, kSine, 1.0f, mode);
    gemm_acc<16>(out, P, ldp, FL, static_cast<const T*>(a.w2_rgb));
    layer<FL, T>(AX, ldaux, a.aux_w, static_cast<const T*>(a.w_sky0_aux), AUXn, 0,
                 0, nullptr, bh + kSky0 * FL, P, ldp, kRelu, 1.0f, mode);
    gemm_acc<16>(out, P, ldp, FL, static_cast<const T*>(a.w2_sky));
    if (a.has_beta) {
      layer<FL, T>(H, ldh, F, static_cast<const T*>(a.w_b0_f), AX, ldaux, a.aux_w,
                   static_cast<const T*>(a.w_b0_aux), bh + kB0 * FL, P, ldp, kSine,
                   1.0f, mode);
      gemm_acc<16>(out, P, ldp, FL, static_cast<const T*>(a.w2_beta));
    }
    if (a.has_semantic) {
      layer<FL, T>(H, ldh, F, static_cast<const T*>(a.w_s0_f),
                   a.use_s_aux ? AX : AUXn, ldaux, a.aux_w,
                   static_cast<const T*>(a.w_s0_aux), bh + kS0 * FL, P, ldp, kSine,
                   1.0f, mode);
      gemm_acc<16>(out, P, ldp, FL, static_cast<const T*>(a.w2_sem));
    }
  }

  using M = Map<16>;
  const float* bs = static_cast<const float*>(a.b_small);
  const int c = 2 * (threadIdx.x % M::kPairs);
  const int r0 = (threadIdx.x / M::kPairs) * M::kRpt;
  float* og = static_cast<float*>(a.out);
#pragma unroll
  for (int r = 0; r < M::kRpt; ++r) {
    const int row = row0 + r0 + r;
    if (row < a.n)
      st2(og + static_cast<size_t>(row) * 16 + c, out[r][0] + __ldg(bs + c),
          out[r][1] + __ldg(bs + c + 1));
  }
}

template <typename T, bool kHeadsOn, int F, int FL>
int launch(const FieldArgs& a, cudaStream_t stream) {
  const size_t smem = sizeof(T) * kRows *
                      static_cast<size_t>((a.cx + kPad) + (a.aux_w + kPad) +
                                          (F + kPad) + (FL + kPad));
  auto kern = field_fused_kernel<T, kHeadsOn, F, FL>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (a.n + kRows - 1) / kRows;
  kern<<<blocks, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kHeadsOn>
int dispatch_widths(const FieldArgs& a, cudaStream_t stream) {
  // keep in sync with satnerf_torch.ops.field_fused.KERNEL_WIDTHS
  if (a.feat == 512 && a.fl == 256) return launch<T, kHeadsOn, 512, 256>(a, stream);
  if (a.feat == 512 && a.fl == 512) return launch<T, kHeadsOn, 512, 512>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int field_fused_forward(const FieldArgs* a, cudaStream_t stream) {
  if (a->n <= 0) return 0;
  if (a->cx % 4 || a->aux_w % 4 || a->cx > 128 || a->aux_w > 64 || a->layers < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a->bf16) {
    return a->heads_on ? dispatch_widths<__nv_bfloat16, true>(*a, stream)
                       : dispatch_widths<__nv_bfloat16, false>(*a, stream);
  }
  return a->heads_on ? dispatch_widths<float, true>(*a, stream)
                     : dispatch_widths<float, false>(*a, stream);
}
