// Backward of the bidirectional N=1 selective scan (selective_scan_bidir.cu),
// token layout, flip-free.
//
// Replaces xpoint_tpu/ops/selective_scan_pallas.py::_fused_bidir_bwd_kernel
// (pallas_call in _fused_bidir_bwd_lm), reached from SS2D's cross2d path
// through the custom VJP of selective_scan_fused_bidir_tok. Contract (lane m
// of an (L, M) plane, group g = m / Dim, lane constant index c as in the
// forward kernel), per lane set:
//
//   forward lanes (h_t = a_t h_{t-1} + b_t):  dh_t = g_t C_t + a_{t+1} dh_{t+1}
//   reversed lanes (h_t = a_t h_{t+1} + b_t): dh_t = g_t C_t + a_{t-1} dh_{t-1}
//   da_t     = dh_t * h_prev_t     (h_{t-1} forward, h_{t+1} reversed)
//   ddt[t,m] = (dh_t u_t B_t + da_t A_c a_t) * sigmoid(dt_t + bias_c)
//   du[t,m] += g_t D_c + dh_t delta_t B_t        (both lane sets add)
//   dB[t,g] += dh_t delta_t u_t,  dC[t,g] += g_t h_t   (sum over the group)
//   dA[m] = sum_t da_t a_t delta_t, dD[m] = sum_t g_t u_t, dbias[m] = sum_t ddt
//
// h is not stored by the forward: the forward kernel's checkpoints (the
// entry state of every 256-token chunk, fp32 (ceil(L / 256), M)) let each
// thread rebuild it one chunk at a time.
//
// Bound: bytes. It reads u, dt_f, dt_r, g_f, g_r (the compact B/C are 1/Dim
// of that) and writes du, ddt_f, ddt_r: about 16 bytes per (t, m) in bf16
// plus the fp32 du accumulator, a few tens of flops each. Design, K1's: one
// thread per (lane, direction), one warp per block, neighbouring threads on
// neighbouring lanes so every load and store is coalesced. A thread walks
// its chunks in the ADJOINT order (forward lanes last chunk first, reversed
// lanes first chunk first); per chunk it recomputes h over the chunk's
// <= 256 steps from the checkpoint into shared memory (its own column of a
// 256 x 32 fp32 tile, 32 KiB a block, no barrier needed), then walks the
// chunk back with the fp32 adjoint carry e = a dh. The operands of 16 steps
// are loaded before they are consumed. dA/dD/dbias stay in registers until
// the end. dB/dC: when a warp lies inside one group (Dim % 32 == 0, every
// flagship stage) a shuffle reduction and one atomicAdd per warp and step,
// else one atomicAdd per thread. du gets one atomicAdd from each lane set
// into a zeroed fp32 plane; with exactly two addends onto zero the sum does
// not depend on their order. Only 2 M threads exist, so the kernel is
// latency-bound; the forward's span-parallel design (selective_scan_bidir.cu)
// is the redesign that fixes it.
#include "scan_common.cuh"

namespace {

using xp::from_f32;
using xp::softplus;
using xp::to_f32;

constexpr int kThreads = 32;     // one warp per block
constexpr int kCkptChunk = 256;  // the forward kernel's checkpoint chunk
constexpr int kPre = 16;         // steps whose operands are loaded ahead

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// Add v into *dst: summed over the warp first when all its lanes share dst.
__device__ __forceinline__ void group_add(float* dst, float v, bool warp_group) {
  if (warp_group) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if ((threadIdx.x & 31) == 0) atomicAdd(dst, v);
  } else {
    atomicAdd(dst, v);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bidir_scan_bwd_kernel(const T* __restrict__ u,
                      const T* __restrict__ dt_f, const T* __restrict__ dt_r,
                      const T* __restrict__ bc_f, const T* __restrict__ cc_f,
                      const T* __restrict__ bc_r, const T* __restrict__ cc_r,
                      const T* __restrict__ g_f, const T* __restrict__ g_r,
                      const float* __restrict__ hck_f,
                      const float* __restrict__ hck_r,
                      const float* __restrict__ A, const float* __restrict__ Dv,
                      const float* __restrict__ bias,
                      float* __restrict__ du,
                      T* __restrict__ ddt_f, T* __restrict__ ddt_r,
                      float* __restrict__ dbc_f, float* __restrict__ dcc_f,
                      float* __restrict__ dbc_r, float* __restrict__ dcc_r,
                      float* __restrict__ dconst, int L, int M, int Dim) {
  __shared__ float hs[kCkptChunk][kThreads];
  const int m = blockIdx.x * kThreads + threadIdx.x;
  if (m >= M) return;
  const bool rev = blockIdx.y == 1;
  const int G = M / Dim;
  const int g = m / Dim;
  const int c = m % (2 * Dim) + (rev ? 2 * Dim : 0);
  // Dim % 32 == 0 makes M a multiple of 32: every warp is full and in one group
  const bool warp_group = Dim % 32 == 0;
  const float a_c = A[c];
  const float d_c = Dv[c];
  const float bias_c = bias[c];
  const T* __restrict__ dt = rev ? dt_r : dt_f;
  const T* __restrict__ bc = rev ? bc_r : bc_f;
  const T* __restrict__ cc = rev ? cc_r : cc_f;
  const T* __restrict__ gy = rev ? g_r : g_f;
  const float* __restrict__ hck = rev ? hck_r : hck_f;
  T* __restrict__ ddt = rev ? ddt_r : ddt_f;
  float* __restrict__ dbc = rev ? dbc_r : dbc_f;
  float* __restrict__ dcc = rev ? dcc_r : dcc_f;
  const int tid = threadIdx.x;

  const int n_chunks = (L + kCkptChunk - 1) / kCkptChunk;
  float e = 0.f;                          // a_next * dh_next
  float acc_dA = 0.f, acc_dD = 0.f, acc_db = 0.f;
  for (int k = 0; k < n_chunks; ++k) {
    const int ch = rev ? k : n_chunks - 1 - k;
    const size_t t0 = (size_t)ch * kCkptChunk;
    const int n = min(kCkptChunk, L - (int)t0);
    const float h_entry = hck[(size_t)ch * M + m];

    // 1. rebuild h over the chunk in the lane set's scan order
    float h = h_entry;
    for (int s0 = 0; s0 < n; s0 += kPre) {
      float uu[kPre], dd[kPre], bb[kPre];
#pragma unroll
      for (int i = 0; i < kPre; ++i) {
        const int s = s0 + i;
        if (s < n) {
          const size_t t = t0 + (rev ? n - 1 - s : s);
          uu[i] = to_f32(u[t * M + m]);
          dd[i] = to_f32(dt[t * M + m]);
          bb[i] = to_f32(bc[t * G + g]);
        }
      }
#pragma unroll
      for (int i = 0; i < kPre; ++i) {
        const int s = s0 + i;
        if (s < n) {
          const float delta = softplus(dd[i] + bias_c);
          h = expf(delta * a_c) * h + delta * uu[i] * bb[i];
          hs[rev ? n - 1 - s : s][tid] = h;
        }
      }
    }

    // 2. adjoint back through the chunk, in the opposite order
    for (int s0 = 0; s0 < n; s0 += kPre) {
      float uu[kPre], dd[kPre], bb[kPre], cv[kPre], gg[kPre];
#pragma unroll
      for (int i = 0; i < kPre; ++i) {
        const int s = s0 + i;
        if (s < n) {
          const size_t t = t0 + (rev ? s : n - 1 - s);
          uu[i] = to_f32(u[t * M + m]);
          dd[i] = to_f32(dt[t * M + m]);
          gg[i] = to_f32(gy[t * M + m]);
          bb[i] = to_f32(bc[t * G + g]);
          cv[i] = to_f32(cc[t * G + g]);
        }
      }
#pragma unroll
      for (int i = 0; i < kPre; ++i) {
        const int s = s0 + i;
        if (s < n) {
          const int j = rev ? s : n - 1 - s;
          const size_t t = t0 + j;
          const float x = dd[i] + bias_c;
          const float delta = softplus(x);
          const float a = expf(delta * a_c);
          const float h_t = hs[j][tid];
          const float h_prev = rev ? (j + 1 < n ? hs[j + 1][tid] : h_entry)
                                   : (j > 0 ? hs[j - 1][tid] : h_entry);
          const float dh = gg[i] * cv[i] + e;
          const float da = dh * h_prev;
          const float ddt_raw = (dh * uu[i] * bb[i] + da * a_c * a) * sigmoid(x);
          acc_dA += da * a * delta;
          acc_dD += gg[i] * uu[i];
          acc_db += ddt_raw;
          e = a * dh;
          ddt[t * M + m] = from_f32<T>(ddt_raw);
          atomicAdd(&du[t * M + m], gg[i] * d_c + dh * delta * bb[i]);
          group_add(&dbc[t * G + g], dh * delta * uu[i], warp_group);
          group_add(&dcc[t * G + g], gg[i] * h_t, warp_group);
        }
      }
    }
  }
  const size_t base = (size_t)(rev ? 3 : 0) * M + m;
  dconst[base] = acc_dA;
  dconst[base + M] = acc_dD;
  dconst[base + 2 * (size_t)M] = acc_db;
}

template <typename T>
int launch(const void* u, const void* dt_f, const void* dt_r,
           const void* bc_f, const void* cc_f, const void* bc_r,
           const void* cc_r, const void* g_f, const void* g_r,
           const float* hck_f, const float* hck_r, const float* A,
           const float* Dv, const float* bias, float* du, void* ddt_f,
           void* ddt_r, float* dbc_f, float* dcc_f, float* dbc_r,
           float* dcc_r, float* dconst, int L, int M, int Dim,
           cudaStream_t stream) {
  const dim3 grid((M + kThreads - 1) / kThreads, 2);
  bidir_scan_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(dt_f),
      static_cast<const T*>(dt_r), static_cast<const T*>(bc_f),
      static_cast<const T*>(cc_f), static_cast<const T*>(bc_r),
      static_cast<const T*>(cc_r), static_cast<const T*>(g_f),
      static_cast<const T*>(g_r), hck_f, hck_r, A, Dv, bias, du,
      static_cast<T*>(ddt_f), static_cast<T*>(ddt_r), dbc_f, dcc_f, dbc_r,
      dcc_r, dconst, L, M, Dim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (u, dt, bc, cc, g and ddt share it).
// du (L, M), dbc_* / dcc_* (L, M / Dim) are fp32 and must be zeroed by the
// caller; dconst is fp32 (2, 3, M): [direction][dA, dD, dbias][lane].
extern "C" int xp_selective_scan_bidir_bwd(
    int dtype, const void* u, const void* dt_f, const void* dt_r,
    const void* bc_f, const void* cc_f, const void* bc_r, const void* cc_r,
    const void* g_f, const void* g_r, const float* hck_f, const float* hck_r,
    const float* A, const float* Dv, const float* bias, float* du,
    void* ddt_f, void* ddt_r, float* dbc_f, float* dcc_f, float* dbc_r,
    float* dcc_r, float* dconst, int L, int M, int Dim, void* stream) {
  if (L <= 0 || M <= 0 || Dim <= 0 || M % (2 * Dim) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(u, dt_f, dt_r, bc_f, cc_f, bc_r, cc_r, g_f, g_r,
                         hck_f, hck_r, A, Dv, bias, du, ddt_f, ddt_r, dbc_f,
                         dcc_f, dbc_r, dcc_r, dconst, L, M, Dim, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(u, dt_f, dt_r, bc_f, cc_f, bc_r, cc_r, g_f,
                                 g_r, hck_f, hck_r, A, Dv, bias, du, ddt_f,
                                 ddt_r, dbc_f, dcc_f, dbc_r, dcc_r, dconst, L,
                                 M, Dim, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* xp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
