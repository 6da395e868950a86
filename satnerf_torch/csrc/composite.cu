// Fused alpha compositing + irradiance-weighted accumulation, one warp per ray.
//
// Replaces the TPU kernel satnerf_tpu/ops/pallas/composite.py:
// composite_pallas -> _composite_kernel. Per ray of S samples:
//   alpha_j = 1 - exp(-delta_j * relu(sigma_j)),  delta_last = 1e10
//   T_j     = prod_{i<j} (1 - alpha_i + 1e-10)     (exclusive product)
//   w_j     = alpha_j * T_j,  depth = sum w z
//   rgb_c   = clip(sum_j w_j * albedo_jc * (sun_j + (1 - sun_j) * sky_c), 0, 1)
//
// What bounds it on an H100: bytes. Per sample it reads 24 bytes (sigma, z,
// sun, 3 albedo) and writes 8 (w, T), and does ~20 flops and one expf, far
// below the ~20 flops/byte where the SMs would become the limit. The design
// reads each input once, coalesced (lane j of the warp takes sample j of a
// 32-sample step), keeps every intermediate in registers and writes only the
// outputs. The TPU kernel's lane-roll doubling scan becomes a __shfl_up_sync
// product scan inside the warp, carried across 32-sample steps, so any
// S <= 1024 works; depth and rgb are __shfl_xor_sync reductions.
//
// exp(-1e10 * sigma) underflows to 0 for sigma > 0 and is exp(-0) = 1 for
// sigma <= 0, so the last sample never produces a NaN. expf, not __expf.
#include <cuda_runtime.h>

#include "sine.cuh"

namespace {

constexpr int kWarps = 8;  // rays per 256-thread block
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
composite_kernel(const float* __restrict__ sigma, const float* __restrict__ z,
                 const float* __restrict__ albedo, const float* __restrict__ sun,
                 const float* __restrict__ sky, float* __restrict__ w_out,
                 float* __restrict__ t_out, float* __restrict__ depth_out,
                 float* __restrict__ rgb_out, int n_rays, int n_samples) {
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (ray >= n_rays) return;  // uniform per warp: the whole warp leaves

  const size_t base = static_cast<size_t>(ray) * n_samples;
  const float sky_r = sky[3 * ray + 0];
  const float sky_g = sky[3 * ray + 1];
  const float sky_b = sky[3 * ray + 2];

  float carry = 1.0f;  // transmittance entering the current 32-sample step
  float acc_d = 0.0f, acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  for (int s0 = 0; s0 < n_samples; s0 += 32) {
    const int j = s0 + lane;
    const bool valid = j < n_samples;
    float alpha = 0.0f, zj = 0.0f, shifted = 1.0f;
    if (valid) {
      zj = z[base + j];
      const float delta = (j + 1 < n_samples) ? (z[base + j + 1] - zj) : 1e10f;
      alpha = 1.0f - expf(-delta * fmaxf(sigma[base + j], 0.0f));
      shifted = 1.0f - alpha + 1e-10f;
    }
    // inclusive product scan over the warp's 32 samples
    float incl = shifted;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl *= v;
    }
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 1.0f;
    const float t = carry * excl;
    carry *= __shfl_sync(kFull, incl, 31);
    if (valid) {
      const float wt = alpha * t;
      w_out[base + j] = wt;
      t_out[base + j] = t;
      acc_d += wt * zj;
      const float s = sun[base + j];
      const float* a = albedo + 3 * (base + j);
      acc_r += wt * a[0] * (s + (1.0f - s) * sky_r);
      acc_g += wt * a[1] * (s + (1.0f - s) * sky_g);
      acc_b += wt * a[2] * (s + (1.0f - s) * sky_b);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc_d += __shfl_xor_sync(kFull, acc_d, off);
    acc_r += __shfl_xor_sync(kFull, acc_r, off);
    acc_g += __shfl_xor_sync(kFull, acc_g, off);
    acc_b += __shfl_xor_sync(kFull, acc_b, off);
  }
  if (lane == 0) {
    depth_out[ray] = acc_d;
    rgb_out[3 * ray + 0] = fminf(fmaxf(acc_r, 0.0f), 1.0f);
    rgb_out[3 * ray + 1] = fminf(fmaxf(acc_g, 0.0f), 1.0f);
    rgb_out[3 * ray + 2] = fminf(fmaxf(acc_b, 0.0f), 1.0f);
  }
}

}  // namespace

extern "C" int composite_forward(const float* sigma, const float* z,
                                 const float* albedo, const float* sun,
                                 const float* sky, float* w_out, float* t_out,
                                 float* depth_out, float* rgb_out, int n_rays,
                                 int n_samples, cudaStream_t stream) {
  if (n_rays <= 0) return 0;
  const int blocks = (n_rays + kWarps - 1) / kWarps;
  composite_kernel<<<blocks, kWarps * 32, 0, stream>>>(
      sigma, z, albedo, sun, sky, w_out, t_out, depth_out, rgb_out, n_rays,
      n_samples);
  return static_cast<int>(cudaGetLastError());
}
