// K1: the fused field forward, SIREN trunk + every head, on the tensor cores.
//
// Replaces the TPU kernel satnerf_tpu/ops/pallas/field_fused.py:fused_field
// (_fwd_call -> _fwd_kernel, _heads_forward), with its backward residuals.
// Per point:
//   h_0 = sin(w0 * (x @ W0 + b0)),  h_i = sin(h_{i-1} @ W_i [+ x @ Ws_i] + b_i)
//   feats = h @ Wf + bf
//   sv = sin(feats @ Wsv0f + aux @ Wsv0a + b) -> sin(. @ Wsv1 + b) -> sin(. @ Wsv2 + b)
//   heads_on: rgb, sky (ReLU on aux), beta and semantic hidden layers
//   out(16 cols) = h @ W2s + sv @ W2sv [+ rgb/sky/beta/sem projections] + b
// See satnerf_torch/ops/field_fused.py for the packed layouts and columns.
// With shared_out it also writes the backward's residuals, as the TPU
// kernel's emit_shared / emit_acts do: the (N, F) trunk output h_{L-1}, and,
// when acts_out is given (trunk_bwd="stored"), the (L, N, F) pre-activations
// a_i = h_{i-1} @ W_i [+ x @ Ws_i] + b_i (before the w0 scale of layer 0), both
// in the compute dtype.
//
// What bounds it on an H100: operations. The flagship field (8x512 trunk,
// skip at 4, 60 encoded inputs, 256-wide heads) does ~2.8 M multiply-adds
// and ~5.6 k sines per point and reads ~300 bytes of input per point, far
// above the card's flops-per-byte ridge: at 65,536 points 2.24 ms as 3xTF32
// (f32, three tensor-core passes at 495 TFLOP/s), 0.37 ms in bf16.
//
// What the design does about it (trunk_tc.cuh): one 64-row tile per block,
// its activations in shared memory for the whole field, every product a
// wgmma with the weights streamed from L2 through a two-slot ring; each
// head's hidden layer is projected onto the 16 output columns straight from
// the accumulator, so no head hidden is stored and only (N, 16) f32 leaves
// the chip. Order of the heads: sigma (from h_{L-1}, before feats overwrites
// it), feats in place in H, rgb, sky, beta, semantic, then the sun-visibility
// chain in place in H. The weights arrive prepared by the wrapper
// (ops/field_fused.py:tc_weights): every pointer of FieldArgs but the biases
// is a W^T (out, in) tensor, K padded with zeros to a multiple of 16
// (c_in 60 -> 64, aux 12 -> 16); the 16-wide projections W2^T (16, in) have
// K permuted within groups of 8 in f32.
//
// Ceiling of this design: each tile reads every weight from L2 (~11 MB per
// 64 rows in f32), so L2 bandwidth, not the tensor cores, is the next limit;
// and the epilogue's sines run beside no MMAs.
//
// Widths: the (feat, feat_last) pairs of `admitted` below, every trunk width
// the TPU kernel takes up to 512 (feat % 128 == 0, field_fused.py:96) with
// the heads of field.py's rule (feat_last = feat or feat / 2, a multiple of
// 128), and every encoded input it takes (c_in <= 128, trunk.py:83: 16 to 128
// after padding, mapping_pos_n_freq up to 21). One kernel per dtype takes
// them all: the widths are run-time values of the pass loop and of the x
// tile (trunk_tc.cuh), and a 128- or 384-wide layer ends with a 128-column
// pass.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "trunk_tc.cuh"

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
  void* shared_out;  // (n, F) compute dtype or null (no residuals)
  void* acts_out;    // (L, n, F) compute dtype or null; needs shared_out
  int n, layers, feat, fl, cx, aux_w, skip_mask, heads_on, has_beta,
      has_semantic, use_s_aux, sin_mode, bf16;
  float w0_scale;
};

namespace {

using namespace satnerf::fwd;

// rows of b_heads (satnerf_torch.ops.field_fused.HIDDEN_BIAS_ROWS)
enum HiddenBias { kRgb0 = 0, kSv0, kSv1, kSv2, kSky0, kB0, kS0 };

// the (feat, feat_last) pairs the kernel admits; keep in sync with
// satnerf_torch.ops.field_fused.KERNEL_WIDTHS
bool admitted(const FieldArgs& a) {
  return (a.feat == 128 && a.fl == 128) || (a.feat == 256 && a.fl == 128) ||
         (a.feat == 256 && a.fl == 256) || (a.feat == 384 && a.fl == 384) ||
         (a.feat == 512 && a.fl == 256) || (a.feat == 512 && a.fl == 512);
}

// the plan of B operands, in the order the kernel consumes them
template <typename T>
int build_plan(const FieldArgs& a, Plan& pl) {
  const size_t es = sizeof(T);
  const int F = a.feat, FL = a.fl, kx = round16(a.cx), ka = round16(a.aux_w);
  pl.njobs = 0;
  // passes(F) per trunk layer and for each of sigma and feats, and per pass
  // of the heads 7 hidden layers and 5 projections
  if (passes(F) * (a.layers + 2) + 12 * passes(FL) > kMaxJobs)
    return static_cast<int>(cudaErrorInvalidValue);
  add_trunk_jobs(pl, es, a.layers, F, kx, a.skip_mask, a.w0, a.w_mid, a.w_skip);
  add_proj_jobs(pl, es, F, a.w2_shared);
  add_layer_jobs(pl, es, F, a.w_feats, F);
  if (a.heads_on) {
    add_projected_jobs(pl, es, FL, a.w2_rgb, a.w_rgb0, F);
    add_projected_jobs(pl, es, FL, a.w2_sky, a.w_sky0_aux, ka);
    if (a.has_beta) add_projected_jobs(pl, es, FL, a.w2_beta, a.w_b0_f, F, a.w_b0_aux, ka);
    if (a.has_semantic)
      add_projected_jobs(pl, es, FL, a.w2_sem, a.w_s0_f, F,
                         a.use_s_aux ? a.w_s0_aux : nullptr, a.use_s_aux ? ka : 0);
  }
  add_layer_jobs(pl, es, FL, a.w_sv0_f, F, a.w_sv0_aux, ka);
  add_layer_jobs(pl, es, FL, a.w_sv1, FL);
  add_projected_jobs(pl, es, FL, a.w2_sv, a.w_sv2, FL);
  return check_plan(pl);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    field_fused_kernel(const __grid_constant__ FieldArgs a, const __grid_constant__ Plan pl) {
  extern __shared__ unsigned char smem_raw[];
  using S = Smem<T>;
  const int F = a.feat, FL = a.fl, ldh = S::ldh(F);
  const int kx = round16(a.cx), ka = round16(a.aux_w), ldx = S::ldx(kx);
  unsigned char* smem = align_up(smem_raw, S::kAlign);
  T* H = reinterpret_cast<T*>(smem);
  T* X = H + kRows * ldh;
  // the output accumulators and the aux tile take the x tile's room once the
  // trunk is done with x
  float* keep = reinterpret_cast<float*>(X);
  T* AX = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(X) + S::kKeep);
  const int row0 = blockIdx.x * kRows;
  const int mode = a.sin_mode;

  Ring r = make_ring<T>(smem, F, kx, true);
  produce<T>(pl, r);  // the first two chunks of the stream
  produce<T>(pl, r);
  load_tile(X, ldx, kx, static_cast<const T*>(a.x), a.cx, row0, a.n);
  // (the first layer's barrier publishes the tile)

  const ATile<T> Xt{X, ldx}, Ht{H, ldh}, At{AX, S::kLda}, none{nullptr, 0};
  // the trunk, sigma from h_{L-1} (into keep, after the last read of x) and
  // feats in place in H: jobs 0 .. passes(F) (L + 2) - 1
  run_trunk<T, true>(a, pl, r, Xt, H, static_cast<T*>(a.acts_out),
                     static_cast<T*>(a.shared_out), row0, keep,
                     static_cast<const float*>(a.b_feats));
  // (the first head pass's barrier publishes the tile)
  load_tile(AX, S::kLda, ka, static_cast<const T*>(a.aux), a.aux_w, row0, a.n);

  // the FL-wide hidden layers in plan order: rgb, sky, beta, semantic (each
  // pass projected), then the sun-visibility chain sv0, sv1 in place in H
  // once feats is dead, and sv2 (projected). Each layer's passes: full(FL)
  // of 256 columns, then tail(FL) of 128. One loop, not unrolled.
  const int full = full_passes(FL), tail = tail_passes(FL);
  const float* bh = static_cast<const float*>(a.b_heads);
  int q = passes(F) * (a.layers + 2);
  // a two-pass in-place head layer's first pass (FL 384, 512) waits in local
  // memory in both dtypes: as bf16 registers (Held) it would stay live through
  // every head layer of every width, and at (512, 256) that cost bf16 K1 5.5%
  // against a kernel built for one head pass (NVIDIA H100 80GB HBM3, 700 W,
  // in turns)
  volatile float held[kNW / 2];
  float total[kNW / 2];
#pragma unroll 1
  for (int h = 0; h < 7; ++h) {
    if ((h < 4 && !a.heads_on) || (h == 2 && !a.has_beta) || (h == 3 && !a.has_semantic))
      continue;
    const bool in_place = h == 4 || h == 5;
    const bool with_aux = h == 2 || (h == 3 && a.use_s_aux) || h == 4;
    const int row = h == 0 ? kRgb0 : h == 1 ? kSky0 : h == 2 ? kB0 : h == 3 ? kS0
                  : h == 4 ? kSv0 : h == 5 ? kSv1 : kSv2;
    const ATile<T> a0 = h == 1 ? At : Ht, a1 = with_aux ? At : none;
    const int act = h == 1 ? kRelu : kSine;
    const float* hb = bh + row * FL;
#pragma unroll 1
    for (int p = 0; p < full; ++p) {
      pass<T>(pl, r, q++, a0, a1, total);
      // in place, after the last pass's barrier (nothing reads H any more):
      // the first pass's values go first, so they are not live in its epilogue
      if (in_place && p == 1) store_pass<T>(held, H, ldh);
      epilogue<T>(total, hb + p * kPassCols, act, 1.0f, mode, nullptr, 0, nullptr, 0, nullptr,
                  0, 0, 0);
      if (!in_place) {
        project<T>(pl, r, q++, total, keep, false);
      } else if (p == 0 && full + tail == 2) {
#pragma unroll
        for (int i = 0; i < kNW / 2; ++i) held[i] = total[i];
      }
    }
    if (tail != 0) {  // the 128-column pass
      const int c0 = full * kPassCols;
      float part[kNW / 4];
      pass<T>(pl, r, q++, a0, a1, part);
      if (in_place && full == 1) store_pass<T>(held, H, ldh);
      epilogue<T>(part, hb + c0, act, 1.0f, mode, nullptr, 0, nullptr, 0, nullptr, 0, 0, 0);
      if (!in_place) {
        project<T>(pl, r, q++, part, keep, false);
      } else {
        store_pass<T>(part, H + c0, ldh);
      }
    } else if (in_place) {
      store_pass<T>(total, H + (full - 1) * kPassCols, ldh);
    }
  }

  // the two warpgroups' partial outputs (same rows, same columns), kept by
  // threads t and t + 128, added in order with the bias (project ended on a
  // barrier)
  if (threadIdx.x < 128) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int rr = warp * 16 + (lane >> 2), cc = 2 * (lane & 3);
    const float* bs = static_cast<const float*>(a.b_small);
    float* og = static_cast<float*>(a.out);
    const float* mine = keep + 8 * threadIdx.x;
    const float* other = keep + 8 * (threadIdx.x + 128);
#pragma unroll
    for (int i = 0; i < 8; i += 2) {  // value i: row + 8 ((i / 2) % 2), column 8 (i / 4)
      const int row = rr + 8 * ((i >> 1) & 1), col = 8 * (i >> 2) + cc;
      if (row0 + row < a.n)
        *reinterpret_cast<float2*>(og + static_cast<size_t>(row0 + row) * 16 + col) =
            make_float2(mine[i] + other[i] + __ldg(bs + col),
                        mine[i + 1] + other[i + 1] + __ldg(bs + col + 1));
    }
  }
}

template <typename T>
int launch(const FieldArgs& a, cudaStream_t stream) {
  Plan pl;
  if (const int err = build_plan<T>(a, pl)) return err;
  const int smem = Smem<T>::bytes(a.feat, round16(a.cx), true);
  auto kern = field_fused_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<(a.n + kRows - 1) / kRows, kThreads, smem, stream>>>(a, pl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int field_fused_forward(const FieldArgs* a, cudaStream_t stream) {
  if (a->n <= 0) return 0;
  if (a->cx <= 0 || round16(a->cx) > kMaxX || a->aux_w <= 0 || a->aux_w > 16 ||
      a->layers < 1 || (a->skip_mask & 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a->acts_out != nullptr && a->shared_out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (!admitted(*a)) return static_cast<int>(cudaErrorInvalidValue);
  return a->bf16 ? launch<__nv_bfloat16>(*a, stream) : launch<float>(*a, stream);
}
