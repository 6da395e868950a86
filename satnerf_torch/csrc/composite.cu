// Fused alpha compositing + irradiance-weighted accumulation (K5) and its
// backward, one warp per ray.
//
// Replaces the TPU kernel satnerf_tpu/ops/pallas/composite.py:
// composite_pallas -> _composite_kernel. Per ray of S samples:
//   alpha_j = 1 - exp(-delta_j * relu(sigma_j)),  delta_last = 1e10
//   T_j     = prod_{i<j} (1 - alpha_i + 1e-10)     (exclusive product)
//   w_j     = alpha_j * T_j,  depth = sum w z
//   rgb_c   = clip(sum_j w_j * albedo_jc * (sun_j + (1 - sun_j) * sky_c), 0, 1)
//
// What bounds it on an H100: bytes, and at the training shapes (1,024 rays)
// the latency of one pass. Per sample the forward reads 24 bytes (sigma, z,
// sun, 3 albedo) and writes 8 (w, T), with ~25 flops and one expf: far below
// the ~20 flops/byte where the SMs would become the limit. The design:
//
// - Runs of samples per lane. Lane l owns K = ceil(S/32) consecutive samples
//   (capped: kMaxRunForward, kMaxRunBackward; a longer ray is walked in
//   segments of 32 K with a carry), loaded and stored with 8- or 16-byte
//   vector loads where the address allows (albedo as 3K contiguous floats),
//   so every load of a segment is in flight at once. (Staging the warp's
//   span through shared memory for fully coalesced 128-byte accesses was
//   slower on an H100: it cost registers and a round trip per stream.)
//   z[j+1] of a run's last sample comes from the next lane by shuffle.
// - One scan per segment: once per ray in the forward (S <= 256). Each lane
//   multiplies its run's factors serially; one exclusive product scan
//   across the warp gives the run's incoming transmittance; depth and rgb
//   are reduced once at the end. The TPU kernel's lane-roll doubling scan
//   becomes a __shfl_up_sync scan.
// - Strided per-ray inputs. sun is read with a row stride and sky (B, 3)
//   with its own, so the renderer's views sun_v[..., 0] and sky[:, 0, :]
//   launch no copy.
// - Residual for the backward. Under autograd the forward also writes the
//   pre-clip rgb (B, 3), so the backward needs no second pass and its clamp
//   mask sees exactly the value that was clipped.
//
// exp(-1e10 * sigma) underflows to 0 for sigma > 0 and is exp(-0) = 1 for
// sigma <= 0, so the last sample never produces a NaN. expf, not __expf.
//
// composite_backward_kernel is the training path's backward of the same
// function (the JAX renderer differentiates XLA code there, so the TPU has
// no backward kernel to port). Given dL/dw, dL/dT, dL/ddepth and dL/drgb
// (each may be absent: a null pointer reads as zeros) it returns dL/dsigma,
// dL/dalbedo, dL/dsun and dL/dsky in one reverse pass per ray. With
// e_j = exp(-delta_j relu(sigma_j)), alpha_j = 1 - e_j,
// q_j = 1 - alpha_j + 1e-10, T_j = prod_{i<j} q_i and
// c_k = (dL/dw_k) alpha_k + dL/dT_k, the gradient reaching q_j is T_j R_j
// with the suffix recurrence R_j = c_{j+1} + q_{j+1} R_{j+1}, R_{S-1} = 0:
// the affine maps (R -> c + q R) of a lane's run are composed serially in
// the lane and scanned once across the warp per segment, from the last lane
// to the first. Nothing is divided by q, which an opaque sample
// makes 1e-10. Then dL/dalpha_j = T_j (dL/dw_j - R_j) and
// dL/dsigma_j = dL/dalpha_j * delta_j * e_j on sigma_j >= 0 (torch.clamp's
// gradient mask), with e_j kept from the one expf that gave alpha_j (1 - alpha_j
// would lose e_j where it is below ~6e-8, which the last delta of 1e10 turns
// into a large gradient). w_j is recomputed as alpha_j T_j from the saved T,
// as the forward formed it. The clip of rgb passes the gradient where
// 0 <= pre-clip rgb <= 1 (torch.clamp again), read from the forward's
// residual.
//
// The sky colour comes per ray (B, 3): every sample of a ray evaluates the
// sky head on the same sun direction, so the kernel's per-ray gradient,
// summed over the ray's samples, is what the reference's per-sample sky
// gradients add up to at the sky head's parameters.
#include <cuda_runtime.h>

#include <cstdint>

#include "sine.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
// samples per lane and segment, at most: the forward scans once per ray up
// to 256 samples; the backward walks 64-sample segments (its run arrays cost
// registers: with runs of 6 it held fewer warps per SM and ran slower at 192
// samples on an H100 than with runs of 2)
constexpr int kMaxRunForward = 8;
constexpr int kMaxRunBackward = 2;
// rays (warps) per block: on an H100 4 came within 0.5% of the best of 1, 2,
// 4 and 8 at every main-path shape (PERF.md, the K5 rows)
constexpr int kRaysPerBlock = 4;

// a lane's run of N consecutive floats at p, its first n valid (zeros after):
// 16- or 8-byte vector loads where the address allows
template <int N>
__device__ __forceinline__ void load_run(const float* __restrict__ p, int n, float (&v)[N]) {
  const auto a = reinterpret_cast<std::uintptr_t>(p);
  if (n == N) {
    if constexpr (N % 4 == 0) {
      if ((a & 15) == 0) {
#pragma unroll
        for (int i = 0; i < N / 4; ++i) {
          const float4 t = __ldg(reinterpret_cast<const float4*>(p) + i);
          v[4 * i] = t.x, v[4 * i + 1] = t.y, v[4 * i + 2] = t.z, v[4 * i + 3] = t.w;
        }
        return;
      }
    }
    if constexpr (N % 2 == 0) {
      if ((a & 7) == 0) {
#pragma unroll
        for (int i = 0; i < N / 2; ++i) {
          const float2 t = __ldg(reinterpret_cast<const float2*>(p) + i);
          v[2 * i] = t.x, v[2 * i + 1] = t.y;
        }
        return;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = (i < n) ? __ldg(p + i) : 0.0f;
}

// the first n floats of a lane's run to p, as load_run reads them
template <int N>
__device__ __forceinline__ void store_run(float* __restrict__ p, int n, const float (&v)[N]) {
  const auto a = reinterpret_cast<std::uintptr_t>(p);
  if (n == N) {
    if constexpr (N % 4 == 0) {
      if ((a & 15) == 0) {
#pragma unroll
        for (int i = 0; i < N / 4; ++i)
          reinterpret_cast<float4*>(p)[i] =
              make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
        return;
      }
    }
    if constexpr (N % 2 == 0) {
      if ((a & 7) == 0) {
#pragma unroll
        for (int i = 0; i < N / 2; ++i)
          reinterpret_cast<float2*>(p)[i] = make_float2(v[2 * i], v[2 * i + 1]);
        return;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (i < n) p[i] = v[i];
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// delta of each sample of a lane's run [j0, j0 + K): z[j+1] - z[j], with the
// sample after the run taken from the next lane (or, past the segment's last
// lane, from memory), and 1e10 for the ray's last sample
template <int K>
__device__ __forceinline__ void run_deltas(const float* __restrict__ z_ray, const float (&z)[K],
                                           int j0, int n_samples, int lane, float (&delta)[K]) {
  float z_next = __shfl_down_sync(kFull, z[0], 1);
  if (lane == 31 && j0 + K < n_samples) z_next = __ldg(z_ray + j0 + K);
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const float zn = (i + 1 < K) ? z[i + 1] : z_next;
    delta[i] = (j0 + i + 1 < n_samples) ? zn - z[i] : 1e10f;
  }
}

// the arguments of both kernels (the C entry points' in one struct)
struct Args {
  const float* sigma;
  const float* z;
  const float* albedo;
  const float* sun;
  const float* sky;
  int sun_stride, sky_stride, n_rays, n_samples;
  // forward
  float* w;
  float* t;
  float* depth;
  float* rgb;
  float* pre;  // pre-clip rgb (B, 3), or null
  // backward (t and pre as the forward wrote them)
  const float* t_in;
  const float* pre_in;
  const float* g_w;  // each gradient may be null: zeros
  const float* g_t;
  const float* g_depth;
  const float* g_rgb;
  float* g_sigma;
  float* g_albedo;
  float* g_sun;
  float* g_sky;
};

template <int K>
__global__ void __launch_bounds__(kRaysPerBlock * 32) composite_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (ray >= a.n_rays) return;  // uniform per warp: the whole warp leaves

  const int n_samples = a.n_samples;
  const size_t base = static_cast<size_t>(ray) * n_samples;
  const float* sun_ray = a.sun + static_cast<size_t>(ray) * a.sun_stride;
  const float* sky_ray = a.sky + static_cast<size_t>(ray) * a.sky_stride;
  const float sky_c[3] = {__ldg(sky_ray), __ldg(sky_ray + 1), __ldg(sky_ray + 2)};

  float carry = 1.0f;  // transmittance entering the current segment
  float acc_d = 0.0f, acc[3] = {0.0f, 0.0f, 0.0f};
  for (int s0 = 0; s0 < n_samples; s0 += 32 * K) {
    const int j0 = s0 + lane * K;
    const int n = min(max(n_samples - j0, 0), K);  // samples of this lane's run
    float sg[K], zz[K], sn[K], al[3 * K];
    load_run<K>(a.sigma + base + j0, n, sg);
    load_run<K>(a.z + base + j0, n, zz);
    load_run<K>(sun_ray + j0, n, sn);
    load_run<3 * K>(a.albedo + 3 * (base + j0), 3 * n, al);
    float delta[K], alpha[K], q[K];
    run_deltas<K>(a.z + base, zz, j0, n_samples, lane, delta);
    float prod = 1.0f;  // the run's serial product of (1 - alpha + 1e-10)
#pragma unroll
    for (int i = 0; i < K; ++i) {
      alpha[i] = (i < n) ? 1.0f - expf(-delta[i] * fmaxf(sg[i], 0.0f)) : 0.0f;
      q[i] = 1.0f - alpha[i] + 1e-10f;
      prod *= q[i];
    }
    // exclusive product scan of the runs across the warp
    float incl = prod;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl *= v;
    }
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 1.0f;
    float t = carry * excl;
    carry *= __shfl_sync(kFull, incl, 31);
    float tt[K], ww[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      tt[i] = t;
      ww[i] = alpha[i] * t;
      t *= q[i];
      acc_d += ww[i] * zz[i];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        acc[c] += ww[i] * al[3 * i + c] * (sn[i] + (1.0f - sn[i]) * sky_c[c]);
    }
    store_run<K>(a.w + base + j0, n, ww);
    store_run<K>(a.t + base + j0, n, tt);
  }
  acc_d = warp_sum(acc_d);
#pragma unroll
  for (int c = 0; c < 3; ++c) acc[c] = warp_sum(acc[c]);
  if (lane == 0) {
    a.depth[ray] = acc_d;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      a.rgb[3 * ray + c] = fminf(fmaxf(acc[c], 0.0f), 1.0f);
      if (a.pre != nullptr) a.pre[3 * ray + c] = acc[c];
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kRaysPerBlock * 32) composite_backward_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (ray >= a.n_rays) return;  // uniform per warp

  const int n_samples = a.n_samples;
  const size_t base = static_cast<size_t>(ray) * n_samples;
  const float* sun_ray = a.sun + static_cast<size_t>(ray) * a.sun_stride;
  const float* sky_ray = a.sky + static_cast<size_t>(ray) * a.sky_stride;
  const float sky_c[3] = {__ldg(sky_ray), __ldg(sky_ray + 1), __ldg(sky_ray + 2)};
  float gp[3];  // dL/d(pre-clip rgb): torch.clamp passes it on [0, 1]
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float p = __ldg(a.pre_in + 3 * ray + c);
    gp[c] = (a.g_rgb != nullptr && p >= 0.0f && p <= 1.0f) ? __ldg(a.g_rgb + 3 * ray + c)
                                                           : 0.0f;
  }
  const float gd = (a.g_depth != nullptr) ? __ldg(a.g_depth + ray) : 0.0f;

  float carry = 0.0f;  // R at the last sample of the current segment
  float gsky[3] = {0.0f, 0.0f, 0.0f};
  const int seg = 32 * K;
  for (int s0 = ((n_samples - 1) / seg) * seg; s0 >= 0; s0 -= seg) {
    const int j0 = s0 + lane * K;
    const int n = min(max(n_samples - j0, 0), K);
    float sg[K], zz[K], sn[K], tt[K], gw[K], gt[K], al[3 * K];
    load_run<K>(a.sigma + base + j0, n, sg);
    load_run<K>(a.z + base + j0, n, zz);
    load_run<K>(sun_ray + j0, n, sn);
    load_run<K>(a.t_in + base + j0, n, tt);
    load_run<K>(a.g_w + base + j0, a.g_w != nullptr ? n : 0, gw);  // absent: zeros
    load_run<K>(a.g_t + base + j0, a.g_t != nullptr ? n : 0, gt);
    load_run<3 * K>(a.albedo + 3 * (base + j0), 3 * n, al);
    float delta[K];
    run_deltas<K>(a.z + base, zz, j0, n_samples, lane, delta);

    float q[K], ck[K], de[K], ga[3 * K], gs[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const bool valid = i < n;
      const float e = valid ? expf(-delta[i] * fmaxf(sg[i], 0.0f)) : 1.0f;
      const float alpha = 1.0f - e;
      q[i] = 1.0f - alpha + 1e-10f;
      const float wt = alpha * tt[i];
      float g = gw[i] + gd * zz[i];
      float s_acc = 0.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float irr = sn[i] + (1.0f - sn[i]) * sky_c[c];
        g += gp[c] * al[3 * i + c] * irr;
        ga[3 * i + c] = gp[c] * wt * irr;
        s_acc += gp[c] * wt * al[3 * i + c] * (1.0f - sky_c[c]);
        if (valid) gsky[c] += gp[c] * wt * al[3 * i + c] * (1.0f - sn[i]);
      }
      gs[i] = s_acc;
      gw[i] = g;  // the full dL/dw_j from here on
      ck[i] = valid ? g * alpha + gt[i] : 0.0f;
      if (!valid) q[i] = 1.0f;  // identity map past the ray's end
      de[i] = (valid && sg[i] >= 0.0f) ? delta[i] * e : 0.0f;
    }
    store_run<3 * K>(a.g_albedo + 3 * (base + j0), 3 * n, ga);
    store_run<K>(a.g_sun + base + j0, n, gs);

    // the run's map f_j0 o ... o f_{j0+K-1}, f_j(R) = c_j + q_j R, as (A, M)
    float A = 0.0f, M = 1.0f;
#pragma unroll
    for (int i = K - 1; i >= 0; --i) {
      A = fmaf(q[i], A, ck[i]);
      M *= q[i];
    }
    // inclusive suffix scan over the lanes: lane l ends with F_l o ... o F_31
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float a2 = __shfl_down_sync(kFull, A, off);
      const float m2 = __shfl_down_sync(kFull, M, off);
      if (lane + off < 32) {
        A = fmaf(M, a2, A);
        M *= m2;
      }
    }
    // R after this lane's run: (F_{l+1} o ... o F_31)(carry)
    const float a_next = __shfl_down_sync(kFull, A, 1);
    const float m_next = __shfl_down_sync(kFull, M, 1);
    float r = (lane == 31) ? carry : fmaf(m_next, carry, a_next);
    carry = fmaf(__shfl_sync(kFull, M, 0), carry, __shfl_sync(kFull, A, 0));
    float gsig[K];
#pragma unroll
    for (int i = K - 1; i >= 0; --i) {
      gsig[i] = tt[i] * (gw[i] - r) * de[i];
      r = fmaf(q[i], r, ck[i]);
    }
    store_run<K>(a.g_sigma + base + j0, n, gsig);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) gsky[c] = warp_sum(gsky[c]);
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) a.g_sky[3 * ray + c] = gsky[c];
  }
}

// samples per lane and segment: K = ceil(S/32) up to the cap
int run_length(int n_samples, int cap) {
  const int k = (n_samples + 31) / 32;
  return k < cap ? k : cap;
}

int blocks(const Args& a) { return (a.n_rays + kRaysPerBlock - 1) / kRaysPerBlock; }

template <int K>
int launch_forward(const Args& a, cudaStream_t stream) {
  composite_kernel<K><<<blocks(a), kRaysPerBlock * 32, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch_backward(const Args& a, cudaStream_t stream) {
  composite_backward_kernel<K><<<blocks(a), kRaysPerBlock * 32, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int composite_forward(const float* sigma, const float* z, const float* albedo,
                                 const float* sun, int sun_stride, const float* sky,
                                 int sky_stride, float* w_out, float* t_out,
                                 float* depth_out, float* rgb_out, float* pre_out,
                                 int n_rays, int n_samples, cudaStream_t stream) {
  Args a{};
  a.sigma = sigma, a.z = z, a.albedo = albedo, a.sun = sun, a.sky = sky;
  a.sun_stride = sun_stride, a.sky_stride = sky_stride;
  a.n_rays = n_rays, a.n_samples = n_samples;
  a.w = w_out, a.t = t_out, a.depth = depth_out, a.rgb = rgb_out, a.pre = pre_out;
  if (n_rays <= 0) return 0;
  if (n_samples < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (run_length(n_samples, kMaxRunForward)) {
    case 1: return launch_forward<1>(a, stream);
    case 2: return launch_forward<2>(a, stream);
    case 3: return launch_forward<3>(a, stream);
    case 4: return launch_forward<4>(a, stream);
    case 5: return launch_forward<5>(a, stream);
    case 6: return launch_forward<6>(a, stream);
    case 7: return launch_forward<7>(a, stream);
    default: return launch_forward<8>(a, stream);
  }
}

extern "C" int composite_backward(const float* sigma, const float* z, const float* albedo,
                                  const float* sun, int sun_stride, const float* sky,
                                  int sky_stride, const float* t, const float* pre,
                                  const float* g_w, const float* g_t, const float* g_depth,
                                  const float* g_rgb, float* g_sigma, float* g_albedo,
                                  float* g_sun, float* g_sky, int n_rays, int n_samples,
                                  cudaStream_t stream) {
  Args a{};
  a.sigma = sigma, a.z = z, a.albedo = albedo, a.sun = sun, a.sky = sky;
  a.sun_stride = sun_stride, a.sky_stride = sky_stride;
  a.n_rays = n_rays, a.n_samples = n_samples;
  a.t_in = t, a.pre_in = pre, a.g_w = g_w, a.g_t = g_t, a.g_depth = g_depth, a.g_rgb = g_rgb;
  a.g_sigma = g_sigma, a.g_albedo = g_albedo, a.g_sun = g_sun, a.g_sky = g_sky;
  if (n_rays <= 0) return 0;
  if (n_samples < 1) return static_cast<int>(cudaErrorInvalidValue);
  return run_length(n_samples, kMaxRunBackward) == 1 ? launch_backward<1>(a, stream)
                                                     : launch_backward<2>(a, stream);
}
