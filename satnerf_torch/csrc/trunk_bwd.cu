// K4: the SIREN trunk backward, both engines, for every point.
//
// Replaces the TPU kernel satnerf_tpu/ops/pallas/trunk.py:_fused_trunk_bwd
// (pallas_call at trunk.py:445) with its bodies _bwd_kernel (recompute,
// :185), _bwd_kernel_stored (:255) and the shared reverse sweep _bwd_sweep
// (:221). For layer i = L-1 .. 0:
//   ga_i = g_i * cos(s_i a_i) * s_i        (s_0 = w0, else 1)
//   g_{i-1} = ga_i @ W_i^T,  gx += ga_i @ Ws_i^T at a skip layer
//   gW_i = h_{i-1}^T ga_i, gWs_i = x^T ga_i, gb_i = sum ga_i (f32 ga)
// and gx = ga_0 @ W0^T + the skip terms.
//
// What bounds it: operations, 5.69 M multiply-adds per point for
// "recompute" (3.79 M "stored") at the flagship's 8x512: 4.52 / 3.01 ms at
// 65,536 points on an H100's tensor cores as 3xTF32 in f32 (0.754 / 0.503 in
// bf16), where the kernels take 13.03 / 9.23 ms (bf16 8.69 / 7.03; 18.52 /
// 12.84 and 9.78 / 7.83 before their redesign, 31.84 / 23.41 on the f32 FMA
// units before that; an NVIDIA H100 80GB HBM3 at 700.00 W, chip_smoke.py in
// turns with the parent).
// Every product runs on the tensor cores through the two blocks of
// bwd_common.cuh, which say how and what holds them above the bound: 3xTF32
// in f32 (three passes, about 22 bits), one bf16 pass in bf16.
// The wrapper (satnerf_torch/ops/trunk.py:_trunk_backward_cuda) drives:
//   trunk_bwd_row     "recompute": L forward layers that rebuild the
//                     pre-activations and h_i (B = W^T, stored (out, in));
//                     then, for both engines, one launch per layer of the
//                     reverse sweep (B = the packed (in, out) weight as it
//                     is; the "stored" engine rebuilds h_i = sin(a_i) in the
//                     same launch) and one for gx (64 or 128 wide);
//   trunk_bwd_reduce  every gW and gb: 128x128 tiles of dW over chunks of
//                     rows, each gb folded into the pass that stages its ga
//                     (f32), then the chunks added in order;
//   trunk_bwd_prep    a weight's tiles as the row GEMM's bulk copies read
//                     them (once per weight and backward).
// Keep in sync with ops/trunk.py.
#include "bwd_common.cuh"

using namespace satnerf::bwd;

extern "C" int trunk_bwd_row(const RowArgs* a, cudaStream_t stream) {
  return row_entry(a, stream);
}

extern "C" int trunk_bwd_reduce(const ReduceArgs* a, cudaStream_t stream) {
  return launch_reduce(*a, stream);
}

extern "C" int trunk_bwd_prep(const void* w, int ld, int width, int k, int bn, int bf16,
                              void* tiles, cudaStream_t stream) {
  return prep_entry(w, ld, width, k, bn, bf16, tiles, stream);
}
