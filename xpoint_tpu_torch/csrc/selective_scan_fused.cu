// Single-direction fused N=1 selective scan in SS2D's (B, K, L, Dim) layout.
//
// Replaces xpoint_tpu/ops/selective_scan_pallas.py::_fused_scan_kernel
// (pallas_call in _fused_scan_lm), reached from SS2D's unidi / bidi scan
// modes through selective_scan_fused_bkld. Contract, for lane (b, k, d) and
// t = 0 .. L-1, with c = k * Dim + d:
//
//   delta = softplus(dt[b, k, t, d] + bias[c])
//   a     = exp(delta * A[c])
//   h     = a * h + delta * u[b, k, t, d] * Bs[b, k, t]   (fp32 carry, h0 = 0)
//   y[b, k, t, d] = Cs[b, k, t] * h + D[c] * u[b, k, t, d]
//
// u, dt, Bs, Cs and y share one dtype (fp32 or bf16); A, D, bias are fp32
// (K * Dim,). It is the forward of selective_scan_bidir.cu with one
// direction and no checkpoints. The Pallas kernel's (L, M) relayout, its
// B/C planes broadcast over Dim and its in-chunk Hillis-Steele scan are TPU
// forms and are not carried over.
//
// Bound: bytes (dt and u read, y written: 6 B per (t, lane) in bf16, plus
// B/C at 1/Dim of that). Design: one thread per lane walks L sequentially;
// neighbouring threads hold neighbouring d, so every load and store is
// coalesced, and the B/C scalar of a (b, k) group is a broadcast load. The
// operands of kChunk steps are loaded before they are consumed. Only
// B*K*Dim threads exist, so the kernel is latency-bound like the
// bidirectional one; the chunked redesign is shared with it.
#include "scan_common.cuh"

namespace {

using xp::from_f32;
using xp::softplus;
using xp::to_f32;

constexpr int kThreads = 64;
constexpr int kChunk = 16;

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_scan_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                  const T* __restrict__ bs, const T* __restrict__ cs,
                  const float* __restrict__ A, const float* __restrict__ Dv,
                  const float* __restrict__ bias, T* __restrict__ y,
                  int L, int M, int Dim, int KDim) {
  const int m = blockIdx.x * kThreads + threadIdx.x;    // (b, k, d) flat
  if (m >= M) return;
  const int g = m / Dim;                                // (b, k) group
  const int d = m - g * Dim;
  const int c = m % KDim;                               // k * Dim + d
  const float a_c = A[c];
  const float d_c = Dv[c];
  const float bias_c = bias[c];
  const size_t base = static_cast<size_t>(g) * L * Dim + d;
  const size_t gbase = static_cast<size_t>(g) * L;

  float h = 0.f;
  for (int s0 = 0; s0 < L; s0 += kChunk) {
    float uu[kChunk], dd[kChunk], bb[kChunk], cv[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int t = s0 + i;
      if (t < L) {
        const size_t off = base + static_cast<size_t>(t) * Dim;
        uu[i] = to_f32(u[off]);
        dd[i] = to_f32(dt[off]);
        bb[i] = to_f32(bs[gbase + t]);
        cv[i] = to_f32(cs[gbase + t]);
      }
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int t = s0 + i;
      if (t < L) {
        const float delta = softplus(dd[i] + bias_c);
        const float a = expf(delta * a_c);
        h = a * h + delta * uu[i] * bb[i];
        y[base + static_cast<size_t>(t) * Dim] =
            from_f32<T>(cv[i] * h + d_c * uu[i]);
      }
    }
  }
}

template <typename T>
int launch(const void* u, const void* dt, const void* bs, const void* cs,
           const float* A, const float* Dv, const float* bias, void* y,
           int L, int M, int Dim, int KDim, cudaStream_t stream) {
  const int blocks = (M + kThreads - 1) / kThreads;
  fused_scan_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt),
      static_cast<const T*>(bs), static_cast<const T*>(cs), A, Dv, bias,
      static_cast<T*>(y), L, M, Dim, KDim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (u, dt, bs, cs and y share it).
// u, dt, y: (B, K, L, Dim); bs, cs: (B, K, L); A, Dv, bias: fp32 (K * Dim,).
// M = B * K * Dim, KDim = K * Dim.
extern "C" int xp_selective_scan_fused(
    int dtype, const void* u, const void* dt, const void* bs, const void* cs,
    const float* A, const float* Dv, const float* bias, void* y, int L,
    int M, int Dim, int KDim, void* stream) {
  if (L <= 0 || M <= 0 || Dim <= 0 || KDim <= 0 || KDim % Dim != 0 ||
      M % KDim != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(u, dt, bs, cs, A, Dv, bias, y, L, M, Dim, KDim, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(u, dt, bs, cs, A, Dv, bias, y, L, M, Dim,
                                 KDim, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* xp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
