// Elementwise launch of the sine and cosine engines of sine.cuh, so that
// chip_smoke.py can hold them against satnerf_torch/ops/fastmath.py on the
// card. Not on any model path.
#include <cuda_runtime.h>

#include "sine.cuh"

namespace {

__global__ void sine_eval_kernel(const float* __restrict__ x,
                                 float* __restrict__ y, int n, int mode,
                                 int cosine) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] = cosine ? satnerf::cos_mode(x[i], mode) : satnerf::sin_mode(x[i], mode);
}

}  // namespace

extern "C" int sine_eval(const float* x, float* y, int n, int mode, int cosine,
                         cudaStream_t stream) {
  if (n <= 0) return 0;
  sine_eval_kernel<<<(n + 255) / 256, 256, 0, stream>>>(x, y, n, mode, cosine);
  return static_cast<int>(cudaGetLastError());
}
