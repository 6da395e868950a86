// Fused field forward: SIREN trunk + every head for one 32-row tile per block.
//
// Replaces the TPU kernel satnerf_tpu/ops/pallas/field_fused.py:fused_field
// (_fwd_call -> _fwd_kernel, _heads_forward), with its backward residuals.
// Per point:
//   h_0 = sin(w0 * (x @ W0 + b0)),  h_i = sin(h_{i-1} @ W_i [+ x @ Ws_i] + b_i)
//   feats = h @ Wf + bf
//   sv = sin(feats @ Wsv0f + aux @ Wsv0a + b) -> sin(. @ Wsv1 + b) -> sin(. @ Wsv2 + b)
//   HEADS_ON: rgb, sky (ReLU on aux), beta and semantic hidden layers
//   out(16 cols) = shared @ W2s + sv @ W2sv [+ rgb/sky/beta/sem projections] + b
// See satnerf_torch/ops/field_fused.py for the packed layouts and columns.
// The kResid instantiations also write the backward's residuals, as the TPU
// kernel's emit_shared / emit_acts do: the (N, F) trunk output h_{L-1}, and,
// when acts_out is given (trunk_bwd="stored"), the (L, N, F) pre-activations
// a_i = h_{i-1} @ W_i [+ x @ Ws_i] + b_i (before the w0 scale of layer 0), both
// in the compute dtype. The serve path launches the other instantiations.
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

#include "trunk_layers.cuh"

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
  void* shared_out;  // (n, F) compute dtype, kResid only
  void* acts_out;    // (L, n, F) compute dtype or null, kResid only
  int n, layers, feat, fl, cx, aux_w, skip_mask, heads_on, has_beta,
      has_semantic, use_s_aux, sin_mode, bf16;
  float w0_scale;
};

namespace {

using namespace satnerf::tile;
using namespace satnerf::trunk;

// rows of b_heads (satnerf_torch.ops.field_fused.HIDDEN_BIAS_ROWS)
enum HiddenBias { kRgb0 = 0, kSv0, kSv1, kSv2, kSky0, kB0, kS0 };

// ---- the kernel ---------------------------------------------------------------

template <typename T, bool kHeadsOn, bool kResid, int F, int FL>
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
  const int tid = static_cast<int>(threadIdx.x);
  load_tile(X, ldx, static_cast<const T*>(a.x), a.cx, row0, a.n, tid, kThreads);
  load_tile(AX, ldaux, static_cast<const T*>(a.aux), a.aux_w, row0, a.n, tid, kThreads);
  __syncthreads();

  // trunk (trunk_layers.cuh): layer 0 (w0-scaled sine), then layers 1.. in place in H
  const int rows_valid = a.n - row0;
  T* acts = kResid ? static_cast<T*>(a.acts_out) : nullptr;
  T* acts_tile = acts != nullptr ? acts + static_cast<size_t>(row0) * F : nullptr;
  trunk_tile<F, T, kResid>(a, X, ldx, H, ldh, acts_tile, rows_valid);
  if (kResid)  // the trunk output h_{L-1}, the heads backward's residual
    store_tile<T, F>(static_cast<T*>(a.shared_out), H, ldh, row0, rows_valid, tid,
                     kThreads);

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

template <typename T, bool kHeadsOn, bool kResid, int F, int FL>
int launch(const FieldArgs& a, cudaStream_t stream) {
  const size_t smem = sizeof(T) * kRows *
                      static_cast<size_t>((a.cx + kPad) + (a.aux_w + kPad) +
                                          (F + kPad) + (FL + kPad));
  auto kern = field_fused_kernel<T, kHeadsOn, kResid, F, FL>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (a.n + kRows - 1) / kRows;
  kern<<<blocks, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kHeadsOn, bool kResid>
int dispatch_widths(const FieldArgs& a, cudaStream_t stream) {
  // keep in sync with satnerf_torch.ops.field_fused.KERNEL_WIDTHS
  if (a.feat == 512 && a.fl == 256) return launch<T, kHeadsOn, kResid, 512, 256>(a, stream);
  if (a.feat == 512 && a.fl == 512) return launch<T, kHeadsOn, kResid, 512, 512>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, bool kHeadsOn>
int dispatch_resid(const FieldArgs& a, cudaStream_t stream) {
  return a.shared_out != nullptr ? dispatch_widths<T, kHeadsOn, true>(a, stream)
                                 : dispatch_widths<T, kHeadsOn, false>(a, stream);
}

}  // namespace

extern "C" int field_fused_forward(const FieldArgs* a, cudaStream_t stream) {
  if (a->n <= 0) return 0;
  if (a->cx % 4 || a->aux_w % 4 || a->cx > 128 || a->aux_w > 64 || a->layers < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a->acts_out != nullptr && a->shared_out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a->bf16) {
    return a->heads_on ? dispatch_resid<__nv_bfloat16, true>(*a, stream)
                       : dispatch_resid<__nv_bfloat16, false>(*a, stream);
  }
  return a->heads_on ? dispatch_resid<float, true>(*a, stream)
                     : dispatch_resid<float, false>(*a, stream);
}
