// K2: the heads backward of the fused field, for every point.
//
// Replaces the TPU kernel satnerf_tpu/ops/pallas/field_fused.py:
// _fused_field_bwd (pallas_call at field_fused.py:594) -> _heads_bwd_kernel
// (:435). From the trunk output `shared` (N, F), the aux block and the
// incoming gradient of the raw (N, out_w) columns, it recomputes feats and
// every head hidden layer, reverses each head chain (sine layers through the
// polynomial cosine, the sky ReLU through [a > 0]), and produces g_shared
// (N, F), g_aux and every head weight and bias gradient in f32.
//
// What bounds it: operations, 2.77 M multiply-adds per point at the
// flagship's widths (F 512, heads 256): 2.20 ms at 65,536 points on an H100's
// tensor cores as 3xTF32 in f32 (0.37 in bf16), where the kernels take 7.74
// ms (bf16 4.75; 10.61 / 5.54 before their redesign, 17.75 on the f32 FMA
// units before that; an NVIDIA H100 80GB HBM3 at 700.00 W, chip_smoke.py in
// turns with the parent). Every product runs on the tensor cores through the
// two blocks of bwd_common.cuh (3xTF32 in f32, bf16 as it is), K 16 (the raw
// columns, the aux block padded to 16) included; only
// the 16-wide g_aux launch stays on the FMA row kernel, by the fixed rule
// on shape that bwd_common.cuh states.
//
// Head widths: every block the TPU kernel takes (9 + n_classes <= 128,
// 3 + 2 tau <= 128). The raw gradient g is (N, out_w), out_w = 9 + n_classes
// rounded up to 16, and is the A operand (K = out_w) of the rgb, sv2, sky,
// beta and semantic reverse rows and of g_shared; the w2_* reductions are
// (feat_last or F, out_w). The aux block is padded to 16 columns (aux_pad,
// up to 128) as the recompute's A operand; the g_aux launch is aux_pad wide
// when that is 16 (the FMA kernel) and otherwise padded to the tensor-core
// row GEMM's 64-column tiles (64 or 128), its extra columns zero weights.
// The wrapper
// (satnerf_torch/ops/field_fused.py:_heads_backward_cuda) drives:
//   heads_bwd_row     one head layer over all rows (18 launches with every
//                     head on, 10 for the sigma + sun-visibility variant);
//   heads_bwd_reduce  every head dW = A^T B and db = sum B, in 128x128
//                     tiles over chunks of rows, then the chunks in order;
//   heads_bwd_prep    a weight's tiles as the row GEMM's bulk copies read
//                     them (once per weight and launch).
// Keep in sync with ops/field_fused.py.
#include "bwd_common.cuh"

using namespace satnerf::bwd;

extern "C" int heads_bwd_row(const RowArgs* a, cudaStream_t stream) {
  return row_entry(a, stream);
}

extern "C" int heads_bwd_reduce(const ReduceArgs* a, cudaStream_t stream) {
  return launch_reduce(*a, stream);
}

extern "C" int heads_bwd_prep(const void* w, int ld, int width, int k, int bn, int bf16,
                              void* tiles, cudaStream_t stream) {
  return prep_entry(w, ld, width, k, bn, bf16, tiles, stream);
}
