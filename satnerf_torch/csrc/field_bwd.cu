// K2: the heads backward of the fused field, for every point.
//
// Replaces the TPU kernel satnerf_tpu/ops/pallas/field_fused.py:
// _fused_field_bwd -> _heads_bwd_kernel (field_fused.py:435-626). From the
// trunk output `shared` (N, F), the aux block and the incoming gradient of the
// raw (N, 16) columns, it recomputes feats and every head hidden layer,
// reverses each head chain (sine layers through the polynomial cosine, the sky
// ReLU through [a > 0]), and produces g_shared (N, F), g_aux and every head
// weight and bias gradient in f32.
//
// The wrapper (satnerf_torch/ops/field_fused.py:_heads_backward_cuda) drives
// two entry points of bwd_common.cuh, which says what bounds the work and
// how the design handles the TPU kernel's sequential grid:
//   heads_bwd_row     one head layer over all rows (18 launches with every
//                     head on, 10 for the sigma + sun-visibility variant);
//   heads_bwd_reduce  every head dW = A^T B and db = sum B in one launch,
//                     each block walking all rows in a fixed order.
// Widths instantiated: 512 (feat), 256 and 512 (feat_last), 16 (the raw
// columns and the aux block). Keep in sync with ops/field_fused.py.
#include "bwd_common.cuh"

namespace {

using namespace satnerf::bwd;

template <typename T>
int dispatch(const RowArgs& a, cudaStream_t stream) {
  switch (a.width) {
    case 16: return launch_row<T, 16>(a, stream);
    case 256: return launch_row<T, 256>(a, stream);
    case 512: return launch_row<T, 512>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int heads_bwd_row(const RowArgs* a, cudaStream_t stream) {
  if (const int err = check_row(*a)) return err;
  if (a->rows == 0) return 0;
  return a->bf16 ? dispatch<__nv_bfloat16>(*a, stream) : dispatch<float>(*a, stream);
}

extern "C" int heads_bwd_reduce(const ReduceArgs* a, cudaStream_t stream) {
  return launch_reduce(*a, stream);
}
