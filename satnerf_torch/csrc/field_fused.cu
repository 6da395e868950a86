// K1: the fused field forward, SIREN trunk + every head, on the tensor cores.
//
// Replaces the TPU kernel satnerf_tpu/ops/pallas/field_fused.py:fused_field
// (_fwd_call -> _fwd_kernel, _heads_forward), with its backward residuals.
// Per point:
//   h_0 = sin(w0 * (x @ W0 + b0)),  h_i = sin(h_{i-1} @ W_i [+ x @ Ws_i] + b_i)
//   feats = h @ Wf + bf
//   sv = sin(feats @ Wsv0f + aux @ Wsv0a + b) -> sin(. @ Wsv1 + b) -> sin(. @ Wsv2 + b)
//   heads_on: rgb, sky (ReLU on aux), beta and semantic hidden layers
//   out(out_w cols) = h @ W2s + sv @ W2sv [+ rgb/sky/beta/sem projections] + b
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
// head's hidden layer is projected onto the output columns straight from
// the accumulator, so no head hidden is stored and only (N, out_w) f32
// leaves the chip. Order of the heads: sigma (from h_{L-1}, before feats overwrites
// it), feats in place in H, rgb, sky, beta, semantic, then the sun-visibility
// chain in place in H. The weights arrive prepared by the wrapper
// (ops/field_fused.py:tc_weights): every pointer of FieldArgs but the biases
// is a W^T (out, in) tensor, K padded with zeros to a multiple of 16
// (c_in 60 -> 64, aux 12 -> 16); the projections W2^T (out_w, in), in groups
// of 16 rows, have K permuted within groups of 8 in f32.
//
// Ceiling of this design: each tile reads every weight from L2 (~11 MB per
// 64 rows in f32), so L2 bandwidth, not the tensor cores, is the next limit;
// and the epilogue's sines run beside no MMAs.
//
// Widths: the (feat, feat_last) pairs of `admitted` below, every trunk width
// the TPU kernel takes up to 1,024 (feat % 128 == 0) with the heads of
// field.py's rule (feat_last = feat or feat / 2, a multiple of 128, at most
// 512: field_fused.py:96), and every encoded input it takes (c_in <= 128,
// trunk.py:83: 16 to 128 after padding, mapping_pos_n_freq up to 21). Two
// kernels per dtype take them all: the widths are run-time values of the
// pass loop and of the x tile (trunk_tc.cuh), a 128- or 384-wide layer ends
// with a 128-column pass, and past 512 (768, 1,024) the activations live in
// global memory (kGlobalH: feats and the sun-visibility chain in the block's
// two buffers in turn, each in-place head layer writing the other buffer).
//
// Head widths: every output and aux block the TPU kernel takes (9 + n_classes
// <= 128 and 3 + 2 tau <= 128, field_fused.py:97-98): out_w = 9 + n_classes
// rounded up to 16 (16 to 128) and the aux tile round16(aux_w) (16 to 128).
// Only the semantic head reaches past column 16. The design:
//  - The output accumulators live in global memory (FieldArgs::acc), not in
//    shared memory: per 64-row tile and 16-column group, each thread's 8 f32
//    of the m64n16 accumulator at its own address, read and written by that
//    thread alone (project, trunk_tc.cuh), and summed over the two
//    warpgroups by threads t and t + 128 after the last barrier. No float
//    atomics, and the order of every sum is fixed. 128 columns in
//    shared memory would take 64 KB, which f32 at feat 512 does not have
//    (H 132 KB, the ring 64 KB, the x tile up to 33 KB of 227 KB); a 64 x 128
//    accumulator in registers would spill (254 of 255 in use).
//  - The semantic layer's passes are projected in 16-column groups, one
//    m64n16 projection job per group and pass; group 0 (columns 0-15) is the
//    one every other head adds into.
//  - With the accumulators gone, the aux tile (64, round16(aux_w)) alone
//    takes the x tile's room after the trunk: at f32, feat 512 and both 128
//    wide, 231,696 of the 232,448 bytes a block may have (Smem).
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
  float* acc;        // (blocks, out_w / 16, 256, 8) f32: the output accumulators
  void* h_ws;        // feat > 512: (h_slots, 2, 64, feat) compute dtype, H (trunk_tc.cuh)
  int h_slots;
  int n, layers, feat, fl, cx, aux_w, out_w, skip_mask, heads_on, has_beta,
      has_semantic, use_s_aux, sin_mode, bf16;
  float w0_scale;
};

namespace {

using namespace satnerf::fwd;

// the widest output and aux blocks (the JAX kernels' 128 lanes); keep in sync
// with satnerf_torch.ops.field_fused.MAX_OUT_W, MAX_AUX_W
constexpr int kMaxOut = 128;
constexpr int kMaxAux = 128;
constexpr int kAccGroup = kThreads * 8;  // floats of one 16-column group's accumulators

// rows of b_heads (satnerf_torch.ops.field_fused.HIDDEN_BIAS_ROWS)
enum HiddenBias { kRgb0 = 0, kSv0, kSv1, kSv2, kSky0, kB0, kS0 };

// the (feat, feat_last) pairs the kernel admits; keep in sync with
// satnerf_torch.ops.field_fused.KERNEL_WIDTHS
bool admitted(const FieldArgs& a) {
  return (a.feat == 128 && a.fl == 128) || (a.feat == 256 && a.fl == 128) ||
         (a.feat == 256 && a.fl == 256) || (a.feat == 384 && a.fl == 384) ||
         (a.feat == 512 && a.fl == 256) || (a.feat == 512 && a.fl == 512) ||
         (a.feat == 768 && a.fl == 384) || (a.feat == 1024 && a.fl == 512);
}

// 16-column groups the semantic head projects onto (the others: group 0)
__host__ __device__ inline int sem_groups(const FieldArgs& a) {
  return a.heads_on && a.has_semantic ? a.out_w / 16 : 1;
}

// this block's accumulators of output group g (one tile's at a time)
__device__ __forceinline__ float* acc_group(const FieldArgs& a, int g) {
  return a.acc + (static_cast<size_t>(blockIdx.x) * (a.out_w / 16) + g) * kAccGroup;
}

// a pass's values v projected by jobs q, q + 1, ... while the plan's jobs
// are projections (one for a head's pass, one per output group for the
// semantic head's), each onto the group and with the start its job names.
// A projection consumes v as it goes, so its registers free up step by
// step; v kept whole across several projections spilled in f32 (254
// registers in use). So before the first of several, v goes to `stash` (the
// in-place layers' local-memory room, free while a projected layer runs)
// and each later projection reads it back.
template <typename T, int R>
__device__ __forceinline__ void project_all(const FieldArgs& a, const Plan& pl, Ring& r, int& q,
                                            float (&v)[R], volatile float* stash) {
  const bool more = q + 1 < pl.njobs && pl.jobs[q + 1].rows_log2 == 4;
  if (more) {
#pragma unroll
    for (int i = 0; i < R; ++i) stash[i] = v[i];
  }
  project<T>(pl, r, q, v, acc_group(a, pl.jobs[q].group), pl.jobs[q].fresh != 0);
#pragma unroll 1
  while (++q < pl.njobs && pl.jobs[q].rows_log2 == 4) {
    float w[R];
#pragma unroll
    for (int i = 0; i < R; ++i) w[i] = stash[i];
    project<T>(pl, r, q, w, acc_group(a, pl.jobs[q].group), pl.jobs[q].fresh != 0);
  }
}

// the deepest trunk whose plan holds kMaxJobs B operands: passes(F) per
// trunk layer and for each of sigma and feats, and per pass of the heads 7
// hidden layers, 5 projections and the semantic head's further 16-column
// groups
int max_layers(const FieldArgs& a) {
  return (kMaxJobs - (11 + sem_groups(a)) * passes(a.fl)) / passes(a.feat) - 2;
}

// the plan of B operands, in the order the kernel consumes them
template <typename T>
int build_plan(const FieldArgs& a, Plan& pl) {
  const size_t es = sizeof(T);
  const int F = a.feat, FL = a.fl, kx = round16(a.cx), ka = round16(a.aux_w);
  pl.njobs = 0;
  if (a.layers > max_layers(a)) return static_cast<int>(cudaErrorInvalidValue);
  add_trunk_jobs(pl, es, a.layers, F, kx, a.skip_mask, a.w0, a.w_mid, a.w_skip);
  add_proj_jobs(pl, es, F, a.w2_shared);
  add_layer_jobs(pl, es, F, a.w_feats, F);
  if (a.heads_on) {
    add_projected_jobs(pl, es, FL, a.w2_rgb, a.w_rgb0, F);
    add_projected_jobs(pl, es, FL, a.w2_sky, a.w_sky0_aux, ka);
    if (a.has_beta) add_projected_jobs(pl, es, FL, a.w2_beta, a.w_b0_f, F, a.w_b0_aux, ka);
    if (a.has_semantic)
      add_projected_jobs(pl, es, FL, a.w2_sem, a.w_s0_f, F,
                         a.use_s_aux ? a.w_s0_aux : nullptr, a.use_s_aux ? ka : 0,
                         sem_groups(a));
  }
  add_layer_jobs(pl, es, FL, a.w_sv0_f, F, a.w_sv0_aux, ka);
  add_layer_jobs(pl, es, FL, a.w_sv1, FL);
  add_projected_jobs(pl, es, FL, a.w2_sv, a.w_sv2, FL);
  return check_plan(pl);
}

template <typename T, bool kGlobalH>
__global__ void __launch_bounds__(kThreads, 1)
    field_fused_kernel(const __grid_constant__ FieldArgs a, const __grid_constant__ Plan pl) {
  extern __shared__ unsigned char smem_raw[];
  using S = Smem<T>;
  const int F = a.feat, FL = a.fl;
  // the H tile's row stride: shared (padded against bank conflicts) or global
  const int ldh = kGlobalH ? F : S::ldh(F);
  const int kx = round16(a.cx), ka = round16(a.aux_w), ldx = S::ldx(kx), lda = S::ldx(ka);
  unsigned char* smem = align_up(smem_raw, S::kAlign);
  // H: the shared tile, or this block's two global buffers (trunk_tc.cuh)
  T* H = kGlobalH ? static_cast<T*>(a.h_ws) + static_cast<size_t>(blockIdx.x) * 2 * kRows * F
                  : reinterpret_cast<T*>(smem);
  T* X = kGlobalH ? reinterpret_cast<T*>(smem) : H + kRows * ldh;
  T* AX = X;  // the aux tile takes the x tile's room once the trunk is done with x
  const int mode = a.sin_mode;

  Ring r = make_ring<T>(smem, kGlobalH ? 0 : F, kx, ka);
  const ATile<T> Xt{X, ldx}, At{AX, lda}, none{nullptr, 0};
  for_tiles<kGlobalH>(a.n, r, [&](int row0) {
  produce<T>(pl, r);  // the first two chunks of the stream
  produce<T>(pl, r);
  load_tile(X, ldx, kx, static_cast<const T*>(a.x), a.cx, row0, a.n);
  // (the first layer's barrier publishes the tile)

  // the trunk, sigma from h_{L-1} (into output group 0) and feats in place in
  // H (global: into buffer L % 2): jobs 0 .. passes(F) (L + 2) - 1
  run_trunk<T, true, kGlobalH>(a, pl, r, Xt, H, static_cast<T*>(a.acts_out),
                               static_cast<T*>(a.shared_out), row0, acc_group(a, 0),
                               static_cast<const float*>(a.b_feats));
  // after the last read of x; the first head pass's barrier publishes the tile
  load_tile(AX, lda, ka, static_cast<const T*>(a.aux), a.aux_w, row0, a.n);

  // the FL-wide hidden layers in plan order: rgb, sky, beta, semantic (each
  // pass projected: onto output group 0, the semantic one onto each of its
  // groups in turn, the first pass starting groups 1 .. afresh: project_all),
  // then the sun-visibility chain sv0, sv1 in place in H once feats is dead
  // (global H: sv0 into the other buffer, sv1 back), and sv2 (projected).
  // Each layer's passes: full(FL) of 256 columns, then tail(FL) of 128. One
  // loop, not unrolled.
  const int full = full_passes(FL), tail = tail_passes(FL);
  const float* bh = static_cast<const float*>(a.b_heads);
  int q = passes(F) * (a.layers + 2);
  // the layers' input tile (feats, then the sun-visibility chain) and where
  // an in-place layer writes: H itself, or the other global buffer
  T* hin = kGlobalH ? H + (a.layers & 1) * kRows * F : H;
  T* hout = kGlobalH ? H + ((a.layers + 1) & 1) * kRows * F : H;
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
    const ATile<T> Ht{hin, ldh};
    const ATile<T> a0 = h == 1 ? At : Ht, a1 = with_aux ? At : none;
    const int act = h == 1 ? kRelu : kSine;
    const float* hb = bh + row * FL;
    // global H: an in-place layer's passes go straight to the other buffer
    T* direct = kGlobalH && in_place ? hout : nullptr;
#pragma unroll 1
    for (int p = 0; p < full; ++p) {
      pass<T>(pl, r, q++, a0, a1, total);
      // in place, after the last pass's barrier (nothing reads H any more):
      // the first pass's values go first, so they are not live in its epilogue
      if (!kGlobalH && in_place && p == 1) store_pass<T>(held, H, ldh);
      epilogue<T>(total, hb + p * kPassCols, act, 1.0f, mode, nullptr, 0,
                  direct != nullptr ? direct + p * kPassCols : nullptr, ldh, nullptr, 0, 0, 0);
      if (!in_place) {
        project_all<T>(a, pl, r, q, total, held);
      } else if (!kGlobalH && p == 0 && full + tail == 2) {
#pragma unroll
        for (int i = 0; i < kNW / 2; ++i) held[i] = total[i];
      }
    }
    if (tail != 0) {  // the 128-column pass
      const int c0 = full * kPassCols;
      float part[kNW / 4];
      pass<T>(pl, r, q++, a0, a1, part);
      if (!kGlobalH && in_place && full == 1) store_pass<T>(held, H, ldh);
      epilogue<T>(part, hb + c0, act, 1.0f, mode, nullptr, 0,
                  direct != nullptr ? direct + c0 : nullptr, ldh, nullptr, 0, 0, 0);
      if (!in_place) {
        project_all<T>(a, pl, r, q, part, held);
      } else if (!kGlobalH) {
        store_pass<T>(part, H + c0, ldh);
      }
    } else if (!kGlobalH && in_place) {
      store_pass<T>(total, H + (full - 1) * kPassCols, ldh);
    }
    if (kGlobalH && in_place) {  // the next layer reads what this one wrote
      T* t = hin;
      hin = hout;
      hout = t;
    }
  }

  // the two warpgroups' partial outputs (same rows, same columns), kept by
  // threads t and t + 128, added in order with the bias, group by group
  // (project ended on a barrier: every thread's accumulators are visible);
  // groups no head projected onto (the semantic ones without the heads) read
  // the bias alone
  if (threadIdx.x < 128) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int rr = warp * 16 + (lane >> 2), cc = 2 * (lane & 3);
    const float* bs = static_cast<const float*>(a.b_small);
    float* og = static_cast<float*>(a.out);
    const int ran = sem_groups(a);
#pragma unroll 1
    for (int g = 0; g < a.out_w / 16; ++g) {
      const float* mine = acc_group(a, g) + 8 * threadIdx.x;
      const float* other = mine + 8 * 128;
#pragma unroll
      for (int i = 0; i < 8; i += 2) {  // value i: row + 8 ((i / 2) % 2), column 8 (i / 4)
        const int row = rr + 8 * ((i >> 1) & 1), col = 16 * g + 8 * (i >> 2) + cc;
        const float b0 = __ldg(bs + col), b1 = __ldg(bs + col + 1);
        if (row0 + row < a.n)
          *reinterpret_cast<float2*>(og + static_cast<size_t>(row0 + row) * a.out_w + col) =
              g < ran ? make_float2(mine[i] + other[i] + b0, mine[i + 1] + other[i + 1] + b1)
                      : make_float2(b0, b1);
      }
    }
  }
  });
}

template <typename T, bool kGlobalH>
int launch_t(const FieldArgs& a, const Plan& pl, cudaStream_t stream) {
  const int smem = Smem<T>::bytes(kGlobalH ? 0 : a.feat, round16(a.cx), round16(a.aux_w));
  auto kern = field_fused_kernel<T, kGlobalH>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid_blocks(a.n, a.feat, a.h_slots), kThreads, smem, stream>>>(a, pl);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const FieldArgs& a, cudaStream_t stream) {
  Plan pl;
  if (const int err = build_plan<T>(a, pl)) return err;
  return global_h(a.feat) ? launch_t<T, true>(a, pl, stream) : launch_t<T, false>(a, pl, stream);
}

}  // namespace

// the most trunk layers a launch at a's widths and outputs takes
extern "C" int field_fused_max_layers(const FieldArgs* a) { return max_layers(*a); }

extern "C" int field_fused_forward(const FieldArgs* a, cudaStream_t stream) {
  if (a->n <= 0) return 0;
  if (a->cx <= 0 || round16(a->cx) > kMaxX || a->aux_w <= 0 || round16(a->aux_w) > kMaxAux ||
      a->out_w < 16 || a->out_w > kMaxOut || a->out_w % 16 || a->acc == nullptr ||
      a->layers < 1 || (a->skip_mask & 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a->acts_out != nullptr && a->shared_out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (!admitted(*a)) return static_cast<int>(cudaErrorInvalidValue);
  if (global_h(a->feat) && (a->h_ws == nullptr || a->h_slots < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return a->bf16 ? launch<__nv_bfloat16>(*a, stream) : launch<float>(*a, stream);
}
