// K3: the SIREN trunk alone, for every point; and K6, its interleaved variant.
//
// K3 replaces the TPU kernel satnerf_tpu/ops/pallas/trunk.py:fused_trunk
// (pallas_call at trunk.py:371, body _fwd_kernel :164), with its residuals for
// the "stored" backward (emit_acts):
//   h_0 = sin(w0 * (x @ W0 + b0)),  h_i = sin(h_{i-1} @ W_i [+ x @ Ws_i] + b_i)
// out = h_{L-1} (n, F) in the compute dtype; acts_out, when given, the (L, n, F)
// pre-activations a_i (before the w0 scale of layer 0) in the compute dtype,
// for exactly n rows (the TPU kernel's padded tail is not kept). The heads
// stay plain PyTorch (models/field.py), as they are XLA code in the reference.
//
// What bounds K3 on an H100: operations. The flagship trunk (8x512, skip at
// 4, 60 encoded inputs) does 1.9 M multiply-adds and 4 k sines per point and
// moves ~2 kB per point (input, output) in f32, far above the card's
// flops-per-byte ridge: 1.51 ms as 3xTF32 at 65,536 points. It runs K1's
// tensor-core trunk (trunk_tc.cuh, which says how): a 64-row tile per block,
// its activations in shared memory, every product a wgmma, h_{L-1} stored
// from the last layer's epilogue registers. trunk_fwd_forward takes the
// prepared weights (satnerf_torch/ops/trunk.py:tc_trunk_weights: W^T, K
// padded to a multiple of 16).
//
// K6 replaces the prototype tools/interleave_trunk_proto.py (pallas_call :64,
// body _fwd_kernel_il :33): the same function over two independent 32-row
// sub-tiles per block, one group of 256 threads each, on the f32 FMA trunk
// loop of trunk_layers.cuh. The block runs 2L + 1 phases split by barriers;
// in phase p group A does step p and group B step p - 1, where step 2i is
// layer i's products and step 2i + 1 its epilogue (bias, sine, store). So one
// group's FMAs issue while the other group evaluates its sine polynomial,
// which is what the prototype tried between the TPU's MXU and VPU. It takes
// the packed (in, out) weights. Its redesign (warpgroup ping-pong on wgmma)
// is later work; it is off every path.
//
// Width instantiated: feat 512 (as K4, satnerf_torch/ops/trunk.py FEAT_WIDTHS).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "trunk_layers.cuh"
#include "trunk_tc.cuh"

// Mirror of satnerf_torch.ops.trunk._TrunkArgs (ctypes); keep in sync.
struct TrunkArgs {
  const void* x;    // (n, cx) compute dtype
  void* out;        // (n, F) compute dtype
  const void* w0;   // K3: prepared W^T (tc_trunk_weights); K6: packed (cx, F)
  const void* w_mid;
  const void* w_skip;
  const void* b;    // (L, F) f32
  void* acts_out;   // (L, n, F) compute dtype or null (K3 only)
  int n, layers, feat, cx, skip_mask, sin_mode, bf16;
  float w0_scale;
};

namespace {

using namespace satnerf::tile;
using namespace satnerf::trunk;

constexpr int kFeat = 512;
constexpr int kSubTiles = 2;  // K6: row sub-tiles (thread groups) per block

namespace fw = satnerf::fwd;

template <typename T, int F>
__global__ void __launch_bounds__(fw::kThreads, 1)
    trunk_fwd_kernel(const __grid_constant__ TrunkArgs a, const __grid_constant__ fw::Plan pl) {
  extern __shared__ unsigned char smem_raw[];
  using S = fw::Smem<T, F>;
  unsigned char* smem = fw::align1024(smem_raw);
  T* H = reinterpret_cast<T*>(smem);
  T* X = H + fw::kRows * S::kLdh;
  const int row0 = blockIdx.x * fw::kRows;
  fw::Ring r = fw::make_ring<T, F>(smem);
  fw::produce<T>(pl, r);  // the first two chunks of the stream
  fw::produce<T>(pl, r);
  fw::load_tile(X, S::kLdx, fw::round16(a.cx), static_cast<const T*>(a.x), a.cx, row0, a.n);
  fw::run_trunk<T, F, false>(a, pl, r, fw::ATile<T>{X, S::kLdx}, H,
                             static_cast<T*>(a.acts_out), static_cast<T*>(a.out), row0,
                             nullptr, nullptr);
}

template <typename T, int F>
__global__ void __launch_bounds__(kSubTiles * kThreads, 1)
trunk_fwd_il_kernel(const TrunkArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int ldh = F + kPad;
  const int ldx = a.cx + kPad;
  const int grp = threadIdx.x / kThreads;  // 0: A, 1: B
  const unsigned tid = threadIdx.x % kThreads;
  T* X = reinterpret_cast<T*>(smem_raw) + grp * kRows * (ldx + ldh);
  T* H = X + kRows * ldx;
  const int row0 = (blockIdx.x * kSubTiles + grp) * kRows;
  load_tile(X, ldx, static_cast<const T*>(a.x), a.cx, row0, a.n, tid, kThreads);
  __syncthreads();
  const T* w_mid = static_cast<const T*>(a.w_mid);
  const T* w_skip = static_cast<const T*>(a.w_skip);
  const float* b = static_cast<const float*>(a.b);
  float acc[Map<F>::kRpt][2];
  const int steps = 2 * a.layers;
  for (int p = 0; p <= steps; ++p) {
    const int step = p - grp;
    if (step >= 0 && step < steps) {
      const int i = step / 2;
      if (step % 2 == 0) {  // layer i's products, into registers
        if (i == 0) {
          layer_acc<F, T>(acc, X, ldx, a.cx, static_cast<const T*>(a.w0), nullptr, 0, 0,
                          nullptr, tid);
        } else {
          const bool skip = (a.skip_mask >> i) & 1;
          const int s = __popc(a.skip_mask & ((1 << i) - 1));  // skips before layer i
          layer_acc<F, T>(acc, H, ldh, F, w_mid + static_cast<size_t>(i - 1) * F * F,
                          skip ? X : nullptr, ldx, a.cx,
                          skip ? w_skip + static_cast<size_t>(s) * a.cx * F : nullptr, tid);
        }
      } else if (i == 0) {  // its epilogue, in place in H: layer 0 with the w0
        // scale, the others with the constant 1, as trunk_tile instantiates
        // them, so nvcc contracts each sine argument as it does in K3
        layer_store<F, T, false>(acc, b, H, ldh, kSine, a.w0_scale, a.sin_mode, nullptr,
                                 0, 0, tid);
      } else {
        layer_store<F, T, false>(acc, b + i * F, H, ldh, kSine, 1.0f, a.sin_mode, nullptr,
                                 0, 0, tid);
      }
    }
    __syncthreads();
  }
  store_tile<T, F>(static_cast<T*>(a.out), H, ldh, row0, a.n - row0, tid, kThreads);
}

template <typename T>
int launch(const TrunkArgs& a, cudaStream_t stream) {
  fw::Plan pl;
  pl.njobs = 0;
  if (2 * a.layers > fw::kMaxJobs || fw::round16(a.cx) > fw::kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  fw::add_trunk_jobs(pl, sizeof(T), a.layers, kFeat, fw::round16(a.cx), a.skip_mask, a.w0,
                     a.w_mid, a.w_skip);
  if (const int err = fw::check_plan(pl)) return err;
  constexpr int smem = fw::Smem<T, kFeat>::kBytes;
  auto kern = trunk_fwd_kernel<T, kFeat>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<(a.n + fw::kRows - 1) / fw::kRows, fw::kThreads, smem, stream>>>(a, pl);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_il(const TrunkArgs& a, cudaStream_t stream) {
  const size_t smem = sizeof(T) * kSubTiles * kRows *
                      static_cast<size_t>((a.cx + kPad) + (kFeat + kPad));
  auto kern = trunk_fwd_il_kernel<T, kFeat>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows_per_block = kSubTiles * kRows;
  kern<<<(a.n + rows_per_block - 1) / rows_per_block, kSubTiles * kThreads, smem,
         stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int check(const TrunkArgs& a) {
  if (a.cx % 4 || a.cx > 128 || a.layers < 1 || a.feat != kFeat || (a.skip_mask & 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

extern "C" int trunk_fwd_forward(const TrunkArgs* a, cudaStream_t stream) {
  if (const int err = check(*a)) return err;
  if (a->n <= 0) return 0;
  return a->bf16 ? launch<__nv_bfloat16>(*a, stream) : launch<float>(*a, stream);
}

extern "C" int trunk_fwd_interleaved(const TrunkArgs* a, cudaStream_t stream) {
  if (const int err = check(*a)) return err;
  if (a->acts_out != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (a->n <= 0) return 0;
  return a->bf16 ? launch_il<__nv_bfloat16>(*a, stream) : launch_il<float>(*a, stream);
}
