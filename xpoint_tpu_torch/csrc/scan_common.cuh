// Device helpers shared by the selective-scan kernels
// (selective_scan_bidir.cu, selective_scan_bidir_bwd.cu,
// selective_scan_fused.cu, linear_scan.cu): operand conversion and the fused
// softplus.
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

// softplus(x) = log(1 + e^x) = max(x, 0) + log1p(e^-|x|), the overflow-free
// form (jax.nn.softplus is logaddexp(x, 0)).
__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

}  // namespace xp
