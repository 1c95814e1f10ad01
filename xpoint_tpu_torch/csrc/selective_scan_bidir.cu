// Bidirectional N=1 selective scan, token layout, flip-free.
//
// Replaces xpoint_tpu/ops/selective_scan_pallas.py::_fused_bidir_kernel
// (pallas_call in _fused_bidir_lm), reached from SS2D's cross2d path through
// selective_scan_fused_bidir_tok. Contract (one (L, M) lane plane, lane
// m = (b * 2 + j) * Dim + d, group g = m / Dim):
//
//   forward lanes, t = 0 .. L-1 and reversed lanes, t = L-1 .. 0:
//     delta = softplus(dt[t, m] + bias[c])      c = lane constant index
//     a     = exp(delta * A[c])
//     h     = a * h + delta * u[t, m] * Bc[t, g]    (fp32 carry, h0 = 0)
//     y[t, m] = Cc[t, g] * h + D[c] * u[t, m]
//
// with c = m % (2 Dim) on forward lanes and 2 Dim + m % (2 Dim) on reversed
// lanes (A, D, bias are (4 Dim,) fp32, ordered k = 2 r + j). u is shared
// by both directions; outputs are written at their own token positions, so
// no flipped copy exists anywhere.
//
// With checkpoints (hck_f, hck_r not null, fp32 (ceil(L / 256), M)), the
// kernel also writes each lane's ENTRY state of every 256-token chunk c,
// the residuals the backward kernel (selective_scan_bidir_bwd.cu) rebuilds
// h from: forward lanes the state entering chunk c from the left (h at
// t = 256 c - 1, zero for c = 0), reversed lanes the state entering it from
// the right (h at t = min(256 (c + 1), L), zero for the last chunk).
//
// Bound: bytes. Per call it reads u, dt_f, dt_r (and the compact B/C, 1/Dim
// of that) and writes y_f, y_r: 10 bytes per (t, m) in bf16, a few flops
// each. Design: one thread per (lane, direction) walks L sequentially.
// Neighbouring threads hold neighbouring lanes, so every load and store is
// coalesced; the B/C scalar of a group is one broadcast load per warp. The
// operands of CHUNK steps are loaded before they are consumed, so a thread
// has CHUNK loads in flight instead of one. Only 2 M threads exist (3,072
// at the flagship's first stage), far too few to fill the card: a chunked
// two-pass scan over L is the redesign that fixes it.
#include "scan_common.cuh"

namespace {

using xp::from_f32;
using xp::softplus;
using xp::to_f32;

constexpr int kThreads = 64;
constexpr int kChunk = 16;
constexpr int kCkptChunk = 256;   // checkpoint chunk (the JAX DEFAULT_CHUNK)

template <typename T>
__global__ void __launch_bounds__(kThreads)
bidir_scan_kernel(const T* __restrict__ u,
                  const T* __restrict__ dt_f, const T* __restrict__ dt_r,
                  const T* __restrict__ bc_f, const T* __restrict__ cc_f,
                  const T* __restrict__ bc_r, const T* __restrict__ cc_r,
                  const float* __restrict__ A, const float* __restrict__ Dv,
                  const float* __restrict__ bias,
                  T* __restrict__ y_f, T* __restrict__ y_r,
                  float* __restrict__ hck_f, float* __restrict__ hck_r,
                  int L, int M, int Dim) {
  const int m = blockIdx.x * kThreads + threadIdx.x;
  if (m >= M) return;
  const bool rev = blockIdx.y == 1;
  const int G = M / Dim;
  const int g = m / Dim;
  const int c = m % (2 * Dim) + (rev ? 2 * Dim : 0);
  const float a_c = A[c];
  const float d_c = Dv[c];
  const float bias_c = bias[c];
  const T* __restrict__ dt = rev ? dt_r : dt_f;
  const T* __restrict__ bc = rev ? bc_r : bc_f;
  const T* __restrict__ cc = rev ? cc_r : cc_f;
  T* __restrict__ y = rev ? y_r : y_f;
  float* __restrict__ hck = rev ? hck_r : hck_f;

  float h = 0.f;
  for (int s0 = 0; s0 < L; s0 += kChunk) {
    float uu[kChunk], dd[kChunk], bb[kChunk], cv[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int step = s0 + i;
      if (step < L) {
        const size_t t = rev ? (size_t)(L - 1 - step) : (size_t)step;
        uu[i] = to_f32(u[t * M + m]);
        dd[i] = to_f32(dt[t * M + m]);
        bb[i] = to_f32(bc[t * G + g]);
        cv[i] = to_f32(cc[t * G + g]);
      }
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int step = s0 + i;
      if (step < L) {
        const size_t t = rev ? (size_t)(L - 1 - step) : (size_t)step;
        if (hck != nullptr &&
            (rev ? (t == (size_t)L - 1 || (t + 1) % kCkptChunk == 0)
                 : t % kCkptChunk == 0))
          hck[t / kCkptChunk * M + m] = h;   // entry state of t's chunk
        const float delta = softplus(dd[i] + bias_c);
        const float a = expf(delta * a_c);
        h = a * h + delta * uu[i] * bb[i];
        y[t * M + m] = from_f32<T>(cv[i] * h + d_c * uu[i]);
      }
    }
  }
}

template <typename T>
int launch(const void* u, const void* dt_f, const void* dt_r,
           const void* bc_f, const void* cc_f, const void* bc_r,
           const void* cc_r, const float* A, const float* Dv,
           const float* bias, void* y_f, void* y_r, float* hck_f,
           float* hck_r, int L, int M, int Dim, cudaStream_t stream) {
  const dim3 grid((M + kThreads - 1) / kThreads, 2);
  bidir_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt_f),
      static_cast<const T*>(dt_r), static_cast<const T*>(bc_f),
      static_cast<const T*>(cc_f), static_cast<const T*>(bc_r),
      static_cast<const T*>(cc_r), A, Dv, bias, static_cast<T*>(y_f),
      static_cast<T*>(y_r), hck_f, hck_r, L, M, Dim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (u, dt, bc, cc and y share it).
// hck_f / hck_r: null, or fp32 (ceil(L / 256), M) checkpoint outputs.
extern "C" int xp_selective_scan_bidir(
    int dtype, const void* u, const void* dt_f, const void* dt_r,
    const void* bc_f, const void* cc_f, const void* bc_r, const void* cc_r,
    const float* A, const float* Dv, const float* bias, void* y_f,
    void* y_r, float* hck_f, float* hck_r, int L, int M, int Dim,
    void* stream) {
  if (L <= 0 || M <= 0 || Dim <= 0 || M % (2 * Dim) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(u, dt_f, dt_r, bc_f, cc_f, bc_r, cc_r, A, Dv, bias,
                         y_f, y_r, hck_f, hck_r, L, M, Dim, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(u, dt_f, dt_r, bc_f, cc_f, bc_r, cc_r, A,
                                 Dv, bias, y_f, y_r, hck_f, hck_r, L, M, Dim,
                                 s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* xp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
