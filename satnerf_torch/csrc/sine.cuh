// Polynomial sine engines shared by the kernels of satnerf_torch.
//
// Replaces the in-kernel sine of the TPU kernels,
// satnerf_tpu/ops/pallas/trunk.py:_reduce/_sin_poly/_sin_f32, with the same
// constants and arithmetic as satnerf_tpu/ops/fastmath.py (and its port,
// satnerf_torch/ops/fastmath.py):
//   n = rint(x / 2pi)                     round half to even, as jnp.round
//   r = x - n*PI2_HI - n*PI2_LO           Cody-Waite ("poly"), or
//   r = x - n*PI2_F32                     one-term ("poly5", "poly7f")
//   fold r into [-pi/2, pi/2]; r + r^3 * P(r^2), P of degree 7 (or 5).
//
// rintf, never roundf (which rounds half away from zero). No __sinf and no
// --use_fast_math: they would swap in the hardware approximation. nvcc
// would contract `x - n * PI2` into one fmaf. That is harmless for the
// two-term reduction (n * PI2_HI is exact for |n| < 2^16) but not for the
// one-term one: there the rounded product n * PI2_F32 carries up to 3e-5 of
// error at |x| = 1e3, which the reference keeps and an fmaf drops. So the
// reduction products are rounded on their own (__fmul_rn is never fused)
// and the kernels reduce exactly as the reference does; the Horner steps
// may contract (about one ulp).
#pragma once

#include <cuda_runtime.h>

namespace satnerf {

// constants as float32, rounded from the same double values the reference uses
constexpr float kInvPi2 = static_cast<float>(0.15915494309189535);  // 1/(2pi)
constexpr float kPi2Hi = 6.28125f;
constexpr float kPi2Lo = static_cast<float>(6.283185307179586 - 6.28125);
constexpr float kPi2F32 = static_cast<float>(6.283185307179586);
constexpr float kHalfPi = static_cast<float>(1.5707963267948966);
constexpr float kPi = static_cast<float>(3.141592653589793);
constexpr float kS1 = static_cast<float>(-1.666516854544e-01);
constexpr float kS2 = static_cast<float>(8.305977379154e-03);
constexpr float kS3 = static_cast<float>(-1.831411277453e-04);
constexpr float kQ1 = static_cast<float>(-1.660786383418e-01);
constexpr float kQ2 = static_cast<float>(7.633781238515e-03);

enum SinMode : int { kPoly = 0, kPoly5 = 1, kPoly7f = 2 };

template <bool kTwoTerm, bool kDegree7>
__device__ __forceinline__ float sin_poly(float x) {
  const float n = rintf(x * kInvPi2);
  float r;
  if (kTwoTerm) {
    r = x - __fmul_rn(n, kPi2Hi);
    r = r - __fmul_rn(n, kPi2Lo);
  } else {
    r = x - __fmul_rn(n, kPi2F32);
  }
  r = (r > kHalfPi) ? (kPi - r) : r;
  r = (r < -kHalfPi) ? (-kPi - r) : r;
  const float r2 = r * r;
  float p;
  if (kDegree7) {
    p = kS3 * r2 + kS2;
    p = p * r2 + kS1;
  } else {
    p = kQ2 * r2 + kQ1;
  }
  return r + r * r2 * p;
}

__device__ __forceinline__ float fast_sin(float x) { return sin_poly<true, true>(x); }
__device__ __forceinline__ float fast_sin5(float x) { return sin_poly<false, false>(x); }
__device__ __forceinline__ float fast_sin7f(float x) { return sin_poly<false, true>(x); }

// mode is uniform across a launch, so the branch does not diverge
__device__ __forceinline__ float sin_mode(float x, int mode) {
  if (mode == kPoly5) return fast_sin5(x);
  if (mode == kPoly7f) return fast_sin7f(x);
  return fast_sin(x);
}

}  // namespace satnerf

// human-readable CUDA error for the Python wrappers (one copy per library)
extern "C" const char* satnerf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
