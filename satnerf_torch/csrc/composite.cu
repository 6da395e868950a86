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
//
// composite_backward_kernel is the training path's backward of the same
// function (the JAX renderer differentiates XLA code there, so the TPU has
// no backward kernel to port). Given dL/dw, dL/dT, dL/ddepth and dL/drgb it
// returns dL/dsigma, dL/dalbedo, dL/dsun and dL/dsky, again one warp per ray
// and bytes-bound. With q_j = 1 - alpha_j + 1e-10, T_j = prod_{i<j} q_i and
// c_k = (dL/dw_k) alpha_k + dL/dT_k, the gradient reaching q_j is T_j R_j with
// the suffix recurrence R_j = c_{j+1} + q_{j+1} R_{j+1}, R_{S-1} = 0, which
// the warp evaluates as a scan of affine maps (R -> c + q R) from the last
// 32-sample step to the first. Nothing is divided by q, which an opaque
// sample makes 1e-10. Then dL/dalpha_j = T_j (dL/dw_j - R_j) and
// dL/dsigma_j = dL/dalpha_j * delta_j * exp(-delta_j relu(sigma_j)) on
// sigma_j >= 0 (torch.clamp's gradient mask). The clip of rgb passes the
// gradient where 0 <= pre-clip rgb <= 1 (torch.clamp again); the pre-clip sum
// is recomputed from the saved weights in the forward's exact order, so the
// mask sees the value the forward clipped.
//
// The sky colour comes per ray (B, 3): every sample of a ray evaluates the
// sky head on the same sun direction, so the kernel's per-ray gradient,
// summed over the ray's samples, is what the reference's per-sample sky
// gradients add up to at the sky head's parameters.
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

__global__ void __launch_bounds__(kWarps * 32)
composite_backward_kernel(const float* __restrict__ sigma, const float* __restrict__ z,
                          const float* __restrict__ albedo, const float* __restrict__ sun,
                          const float* __restrict__ sky, const float* __restrict__ w,
                          const float* __restrict__ t, const float* __restrict__ g_w,
                          const float* __restrict__ g_t, const float* __restrict__ g_depth,
                          const float* __restrict__ g_rgb, float* __restrict__ g_sigma,
                          float* __restrict__ g_albedo, float* __restrict__ g_sun,
                          float* __restrict__ g_sky, int n_rays, int n_samples) {
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (ray >= n_rays) return;  // uniform per warp

  const size_t base = static_cast<size_t>(ray) * n_samples;
  const float sky_c[3] = {sky[3 * ray + 0], sky[3 * ray + 1], sky[3 * ray + 2]};

  // pass 1: the pre-clip rgb, summed as composite_kernel sums it
  float pre[3] = {0.0f, 0.0f, 0.0f};
  for (int s0 = 0; s0 < n_samples; s0 += 32) {
    const int j = s0 + lane;
    if (j < n_samples) {
      const float wt = w[base + j];
      const float s = sun[base + j];
      const float* a = albedo + 3 * (base + j);
#pragma unroll
      for (int c = 0; c < 3; ++c) pre[c] += wt * a[c] * (s + (1.0f - s) * sky_c[c]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int c = 0; c < 3; ++c) pre[c] += __shfl_xor_sync(kFull, pre[c], off);
  float gp[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float gr = g_rgb[3 * ray + c];
    gp[c] = (pre[c] >= 0.0f && pre[c] <= 1.0f) ? gr : 0.0f;
  }
  const float gd = g_depth[ray];

  // pass 2: from the last 32-sample step to the first
  float carry = 0.0f;  // R at the last sample of the current step
  float gsky[3] = {0.0f, 0.0f, 0.0f};
  const int last = ((n_samples - 1) / 32) * 32;
  for (int s0 = last; s0 >= 0; s0 -= 32) {
    const int j = s0 + lane;
    const bool valid = j < n_samples;
    float alpha = 0.0f, q = 1.0f, c_k = 0.0f, gw = 0.0f, tj = 0.0f, delta = 0.0f,
          sg = 0.0f;
    if (valid) {
      const float zj = z[base + j];
      delta = (j + 1 < n_samples) ? (z[base + j + 1] - zj) : 1e10f;
      sg = sigma[base + j];
      alpha = 1.0f - expf(-delta * fmaxf(sg, 0.0f));
      q = 1.0f - alpha + 1e-10f;
      tj = t[base + j];
      const float wt = w[base + j];
      const float s = sun[base + j];
      const float* a = albedo + 3 * (base + j);
      float* ga = g_albedo + 3 * (base + j);
      gw = g_w[base + j] + gd * zj;
      float gs = 0.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float irr = s + (1.0f - s) * sky_c[c];
        gw += gp[c] * a[c] * irr;
        ga[c] = gp[c] * wt * irr;
        gs += gp[c] * wt * a[c] * (1.0f - sky_c[c]);
        gsky[c] += gp[c] * wt * a[c] * (1.0f - s);
      }
      g_sun[base + j] = gs;
      c_k = gw * alpha + g_t[base + j];
    }
    // inclusive suffix scan of the affine maps f_j(R) = c_j + q_j R over the
    // step: lane l ends with (A, M) = f_l o f_{l+1} o ... o f_31
    float A = c_k, M = q;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float a2 = __shfl_down_sync(kFull, A, off);
      const float m2 = __shfl_down_sync(kFull, M, off);
      if (lane + off < 32) {
        A = fmaf(M, a2, A);
        M *= m2;
      }
    }
    // R_j = (f_{j+1} o ... o f_31)(carry): lane l+1's inclusive map
    const float a_next = __shfl_down_sync(kFull, A, 1);
    const float m_next = __shfl_down_sync(kFull, M, 1);
    const float r_j = (lane == 31) ? carry : fmaf(m_next, carry, a_next);
    const float a0 = __shfl_sync(kFull, A, 0);
    const float m0 = __shfl_sync(kFull, M, 0);
    carry = fmaf(m0, carry, a0);  // R at sample s0 - 1
    if (valid) {
      const float g_alpha = tj * (gw - r_j);
      g_sigma[base + j] = (sg >= 0.0f)
                              ? g_alpha * delta * expf(-delta * fmaxf(sg, 0.0f))
                              : 0.0f;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int c = 0; c < 3; ++c) gsky[c] += __shfl_xor_sync(kFull, gsky[c], off);
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) g_sky[3 * ray + c] = gsky[c];
  }
}

}  // namespace

extern "C" int composite_backward(const float* sigma, const float* z,
                                  const float* albedo, const float* sun,
                                  const float* sky, const float* w, const float* t,
                                  const float* g_w, const float* g_t,
                                  const float* g_depth, const float* g_rgb,
                                  float* g_sigma, float* g_albedo, float* g_sun,
                                  float* g_sky, int n_rays, int n_samples,
                                  cudaStream_t stream) {
  if (n_rays <= 0) return 0;
  const int blocks = (n_rays + kWarps - 1) / kWarps;
  composite_backward_kernel<<<blocks, kWarps * 32, 0, stream>>>(
      sigma, z, albedo, sun, sky, w, t, g_w, g_t, g_depth, g_rgb, g_sigma, g_albedo,
      g_sun, g_sky, n_rays, n_samples);
  return static_cast<int>(cudaGetLastError());
}

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
