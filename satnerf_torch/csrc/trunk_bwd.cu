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
// The wrapper (satnerf_torch/ops/trunk.py:_trunk_backward_cuda) drives two
// entry points of bwd_common.cuh, which says what bounds the work and how the
// design handles the TPU kernel's sequential grid and its (L, tile, F) VMEM
// stash (here global workspaces):
//   trunk_bwd_row     "recompute": L forward layers that rebuild the
//                     pre-activations and h_i; then, for both engines, one
//                     launch per layer of the reverse sweep (the "stored"
//                     engine rebuilds h_i = sin(a_i) in the same launch) and
//                     one for gx;
//   trunk_bwd_reduce  every gW and gb in one launch, each block walking all
//                     rows in a fixed order.
// Widths instantiated: 512 (feat), 64 and 128 (gx, the input padded up).
// Keep in sync with ops/trunk.py.
#include "bwd_common.cuh"

namespace {

using namespace satnerf::bwd;

template <typename T>
int dispatch(const RowArgs& a, cudaStream_t stream) {
  switch (a.width) {
    case 64: return launch_row<T, 64>(a, stream);
    case 128: return launch_row<T, 128>(a, stream);
    case 512: return launch_row<T, 512>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int trunk_bwd_row(const RowArgs* a, cudaStream_t stream) {
  if (const int err = check_row(*a)) return err;
  if (a->rows == 0) return 0;
  return a->bf16 ? dispatch<__nv_bfloat16>(*a, stream) : dispatch<float>(*a, stream);
}

extern "C" int trunk_bwd_reduce(const ReduceArgs* a, cudaStream_t stream) {
  return launch_reduce(*a, stream);
}
