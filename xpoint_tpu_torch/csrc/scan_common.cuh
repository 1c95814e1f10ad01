// Device helpers shared by the selective-scan kernels
// (selective_scan_bidir.cu, selective_scan_bidir_bwd.cu,
// selective_scan_fused.cu, linear_scan.cu): operand conversion and the one
// softplus / exp that the forward and backward kernels all evaluate, so that
// the backward differentiates the function the forward computed.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace xp {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);   // round to nearest even, like torch's cast
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// 2^x and log2(x) as the hardware's approximations, one operation each
// (__expf / __logf wrap them in denormal handling that nothing here needs).
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// softplus(x) = max(x, 0) + log1p(e), e = exp(-|x|) in (0, 1]. The scans
// evaluate it for every element in more than one pass, and with expf /
// log1pf in their accurate forms that arithmetic, not the bytes, sets the
// kernels' time. log1p(e) is its series below e = 1/32 (truncation e^4 / 5
// relative, < 2e-7) and ln(1 + e) above (lg2.approx is good to 2^-22
// absolute on [1, 2] and the result is >= 0.03: < 1e-5 relative, 2e-7
// absolute on delta). x = -inf gives exactly 0.
__device__ __forceinline__ float softplus_approx(float x) {
  const float e = ex2_approx(-fabsf(x) * kLog2e);
  const float series =
      e * (1.f - e * (0.5f - e * (1.f / 3.f - 0.25f * e)));
  const float log1p_e = e < 0.03125f ? series : lg2_approx(1.f + e) * kLn2;
  return fmaxf(x, 0.f) + log1p_e;
}

}  // namespace xp
