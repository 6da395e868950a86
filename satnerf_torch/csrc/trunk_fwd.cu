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
// body _fwd_kernel_il :33): the same function, forward only, whose idea is to
// run one half of the work's products while the other half's sines are
// evaluated. trunk_ws.cuh says how it does that on this card: a producer
// warpgroup streams the weights through a four- or eight-slot ring with
// full/empty mbarriers, and two consumer warpgroups take the tensor cores in
// turns (named barriers), each one's epilogue under the other's wgmmas. What
// bounds it is K3's bound (operations: 3xTF32 in f32, bf16 on the tensor
// cores). It keeps K3's order of sums and epilogue, so it equals K3 bit for
// bit. It takes the prepared weights of K3 and, in f32, their tf32 hi and lo
// parts (ops/trunk.py:tc_split_weights). It is off every path.
//
// Widths: K3 takes every trunk width the TPU kernel takes up to 1,024
// (feat % 128 == 0, trunk.py:82) and every encoded input (c_in <= 128,
// trunk.py:83), as run-time values of one kernel per dtype up to 512 and of
// a second past it, whose activations live in global memory (kGlobalH,
// trunk_tc.cuh; satnerf_torch/ops/trunk.py FEAT_WIDTHS, TC_MAX_K); K6 is built for feat
// 512 alone (kIlFeat, ops/trunk.py IL_FEAT_WIDTHS) and at most 64 padded
// inputs (ws::kMaxX, IL_MAX_K).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "trunk_tc.cuh"
#include "trunk_ws.cuh"

// Mirror of satnerf_torch.ops.trunk._TrunkArgs (ctypes); keep in sync.
struct TrunkArgs {
  const void* x;    // (n, cx) compute dtype
  void* out;        // (n, F) compute dtype
  const void* w0;   // prepared W^T (tc_trunk_weights); K6 in f32: the tf32 hi parts
  const void* w_mid;
  const void* w_skip;
  const void* b;    // (L, F) f32
  void* acts_out;   // (L, n, F) compute dtype or null (K3 only)
  int n, layers, feat, cx, skip_mask, sin_mode, bf16;
  float w0_scale;
  const void* w0_lo;  // K6 in f32: the tf32 lo parts (tc_split_weights); else null
  const void* w_mid_lo;
  const void* w_skip_lo;
  void* h_ws;  // K3 at feat > 512: (h_slots, 2, 64, feat) compute dtype, H (trunk_tc.cuh)
  int h_slots;
};

namespace {

constexpr int kIlFeat = 512;  // K6's one width

namespace fw = satnerf::fwd;
namespace tc = satnerf::tc;
namespace ws = satnerf::ws;

// H: the shared tile, or (kGlobalH, feat > 512) this block's two global
// buffers of h_ws, the block walking the tiles (trunk_tc.cuh)
template <typename T, bool kGlobalH>
__global__ void __launch_bounds__(fw::kThreads, 1)
    trunk_fwd_kernel(const __grid_constant__ TrunkArgs a, const __grid_constant__ fw::Plan pl) {
  extern __shared__ unsigned char smem_raw[];
  using S = fw::Smem<T>;
  const int kx = fw::round16(a.cx), ldx = S::ldx(kx);
  unsigned char* smem = fw::align_up(smem_raw, S::kAlign);
  T* H = kGlobalH
             ? static_cast<T*>(a.h_ws) + static_cast<size_t>(blockIdx.x) * 2 * fw::kRows * a.feat
             : reinterpret_cast<T*>(smem);
  T* X = kGlobalH ? reinterpret_cast<T*>(smem) : H + fw::kRows * S::ldh(a.feat);
  fw::Ring r = fw::make_ring<T>(smem, kGlobalH ? 0 : a.feat, kx, 0);
  fw::for_tiles<kGlobalH>(a.n, r, [&](int row0) {
    fw::produce<T>(pl, r);  // the first two chunks of the stream
    fw::produce<T>(pl, r);
    fw::load_tile(X, ldx, kx, static_cast<const T*>(a.x), a.cx, row0, a.n);
    fw::run_trunk<T, false, kGlobalH>(a, pl, r, fw::ATile<T>{X, ldx}, H,
                                      static_cast<T*>(a.acts_out), static_cast<T*>(a.out), row0,
                                      nullptr, nullptr);
  });
}

// K6: the producer warpgroup (threads 256 .. 383) streams the weights, the
// two consumer warpgroups (0 .. 255) run the trunk over the block's 64 rows
template <typename T, int F>
__global__ void __launch_bounds__(ws::kThreads, 1)
    trunk_fwd_il_kernel(const __grid_constant__ TrunkArgs a) {
  extern __shared__ unsigned char smem_raw[];
  using S = ws::Smem<T, F>;
  constexpr int kSlots = ws::Ring<T>::kSlots;
  unsigned char* smem = fw::align_up(smem_raw, 1024u);
  T* H = reinterpret_cast<T*>(smem);
  T* X = H + fw::kRows * S::kLdh;
  const uint32_t ring = tc::smem_u32(smem + S::kRing);
  const uint32_t full = tc::smem_u32(smem + S::kBars), empty = full + 8 * kSlots;
  if (threadIdx.x == 0) {
    for (int j = 0; j < kSlots; ++j) {
      tc::mbar_init(full + 8 * j, 1);      // the producer's arrival with its bytes
      tc::mbar_init(empty + 8 * j, 4);     // the four warps of the warpgroup that read it
    }
    tc::fence_mbar_init();
  }
  __syncthreads();  // the block's one barrier
  const int wg = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (wg == 2) {
    ws::regs_dec<ws::Ring<T>::kProducerRegs>();
    if (threadIdx.x == ws::kConsumers) ws::produce<T, F>(a, ring, full, empty);
    return;
  }
  ws::regs_inc<ws::Ring<T>::kConsumerRegs>();
  ws::consume<T, F>(a, wg, H, X, ring, full, empty, blockIdx.x * fw::kRows);
}

template <typename T, bool kGlobalH>
int launch_t(const TrunkArgs& a, const fw::Plan& pl, cudaStream_t stream) {
  const int smem = fw::Smem<T>::bytes(kGlobalH ? 0 : a.feat, fw::round16(a.cx), 0);
  auto kern = trunk_fwd_kernel<T, kGlobalH>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<fw::grid_blocks(a.n, a.feat, a.h_slots), fw::kThreads, smem, stream>>>(a, pl);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const TrunkArgs& a, cudaStream_t stream) {
  fw::Plan pl;
  pl.njobs = 0;
  const int kx = fw::round16(a.cx);
  if (!fw::width_ok(a.feat) || a.layers > fw::kMaxJobs / fw::passes(a.feat) || kx > fw::kMaxX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (fw::global_h(a.feat) && (a.h_ws == nullptr || a.h_slots < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  fw::add_trunk_jobs(pl, sizeof(T), a.layers, a.feat, kx, a.skip_mask, a.w0, a.w_mid, a.w_skip);
  if (const int err = fw::check_plan(pl)) return err;
  return fw::global_h(a.feat) ? launch_t<T, true>(a, pl, stream)
                              : launch_t<T, false>(a, pl, stream);
}

template <typename T>
int launch_il(const TrunkArgs& a, cudaStream_t stream) {
  constexpr bool f32 = sizeof(T) == 4;
  if (a.feat != kIlFeat || fw::round16(a.cx) > ws::kMaxX ||
      f32 != (a.w0_lo != nullptr && a.w_mid_lo != nullptr && a.w_skip_lo != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = ws::Smem<T, kIlFeat>::kBytes;
  auto kern = trunk_fwd_il_kernel<T, kIlFeat>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<(a.n + fw::kRows - 1) / fw::kRows, ws::kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int check(const TrunkArgs& a) {
  if (a.cx % 4 || a.cx > 128 || a.layers < 1 || (a.skip_mask & 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// the most layers K3's plan of kMaxJobs B operands takes at feat wide (0 at
// a width it does not take)
extern "C" int trunk_fwd_max_layers(int feat) {
  return fw::width_ok(feat) ? fw::kMaxJobs / fw::passes(feat) : 0;
}

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
