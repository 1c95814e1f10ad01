// First-order linear recurrence h = a * h_prev + b along one axis.
//
// Replaces xpoint_tpu/ops/selective_scan_pallas.py::_scan_kernel
// (pallas_call in _scan_lm), the recurrence under linear_scan and its custom
// VJP: the backward of the single-direction fused scan, the N > 1 selective
// scan and cascade2d all reach it. Contract, for operands of shape
// (G, L, D) (contiguous; G = 1, D = M is JAX's (L, M) plane; G = B*K,
// D = Dim is SS2D's (B, K, L, Dim)), independently per lane (g, d):
//
//   forward:  h[t] = c(t) * h[t-1] + b[t],  t = 0 .. L-1,   h[-1] = 0
//   reverse:  h[t] = c(t) * h[t+1] + b[t],  t = L-1 .. 0,   h[L]  = 0
//   c(t) = a[t + shift], taken as 1 where t + shift lies outside [0, L)
//
// a and b share one dtype (fp32 or bf16) and are read as fp32; h is fp32.
// reverse = 1, shift = 1 is the recurrence's own adjoint,
// dh[t] = g[t] + a[t+1] * dh[t+1], for which JAX flips and shifts three
// planes; here it is an index offset. The Pallas kernel's padding to 256 x
// 512 blocks, its Hillis-Steele in-chunk scan and its carry scratch between
// sequential grid steps are TPU forms and are not carried over.
//
// Bound: bytes (a and b read, h written once: 12 B per element in fp32; two
// FMAs per element never bind). Design: the recurrence is associative,
// (A1, B1) o (A2, B2) = (A1 A2, A2 B1 + B2), so L is cut into segments that
// are scanned at once. A block owns 32 neighbouring lanes and all of L and
// walks L in spans of kWarps * kSteps steps. In a span, warp w takes the
// kSteps steps of segment w, thread = lane: it loads its kSteps coefficients
// and inputs into registers (all loads in flight together, each warp load
// one contiguous 128-byte run when D is a multiple of 32), composes them to
// the segment's (product of a, h from a zero entry state) and puts that
// summary into shared memory. After one barrier every thread combines the
// summaries of the segments before its own with the span's entry state, in
// scan order, replays its registers from there and stores h; the
// combination of all segments is the next span's entry state. Every element
// is read once and written once, and M * kWarps threads are at work instead
// of M. The carry pass is sequential over kWarps summaries only.
#include "scan_common.cuh"

namespace {

using xp::to_f32;

constexpr int kLanes = 32;                  // lanes per block, a warp's width
constexpr int kWarps = 16;                  // segments per span
constexpr int kSteps = 16;                  // steps per segment
constexpr int kSpan = kWarps * kSteps;

template <typename T>
__global__ void __launch_bounds__(kLanes * kWarps)
linear_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   float* __restrict__ h, int L, int D, int M, int reverse,
                   int shift) {
  __shared__ float seg_a[kWarps][kLanes];
  __shared__ float seg_h[kWarps][kLanes];
  const int lane = threadIdx.x;
  const int w = threadIdx.y;
  const int m = blockIdx.x * kLanes + lane;             // (g, d) flat
  const bool live = m < M;
  const int g = live ? m / D : 0;
  const size_t base = static_cast<size_t>(g) * L * D + (live ? m - g * D : 0);
  const size_t stride = static_cast<size_t>(D);

  float entry = 0.f;                 // state entering the span, per lane
  for (int s0 = 0; s0 < L; s0 += kSpan) {
    const int s_first = s0 + w * kSteps;
    float av[kSteps], bv[kSteps];
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int s = s_first + i;                        // step in scan order
      av[i] = 1.f;                                      // inert past the end
      bv[i] = 0.f;
      if (live && s < L) {
        const int t = reverse ? L - 1 - s : s;
        const int tc = t + shift;
        if (tc >= 0 && tc < L) av[i] = to_f32(a[base + tc * stride]);
        bv[i] = to_f32(b[base + t * stride]);
      }
    }
    float prod = 1.f, last = 0.f;
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      last = av[i] * last + bv[i];
      prod *= av[i];
    }
    seg_a[w][lane] = prod;
    seg_h[w][lane] = last;
    __syncthreads();
    float x = entry, h_in = entry;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) {
      if (j == w) h_in = x;
      x = seg_a[j][lane] * x + seg_h[j][lane];
    }
    entry = x;
    float hv = h_in;
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int s = s_first + i;
      hv = av[i] * hv + bv[i];
      if (live && s < L) {
        const int t = reverse ? L - 1 - s : s;
        h[base + t * stride] = hv;
      }
    }
    __syncthreads();                 // the summaries are rewritten next span
  }
}

template <typename T>
int launch(const void* a, const void* b, float* h, int L, int D, int M,
           int reverse, int shift, cudaStream_t stream) {
  const dim3 block(kLanes, kWarps);
  const int blocks = (M + kLanes - 1) / kLanes;
  linear_scan_kernel<T><<<blocks, block, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), h, L, D, M, reverse,
      shift);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (a and b share it); h is fp32.
// a, b, h: (G, L, D) contiguous, M = G * D lanes.
extern "C" int xp_linear_scan(int dtype, const void* a, const void* b,
                              float* h, int L, int D, int M, int reverse,
                              int shift, void* stream) {
  if (L <= 0 || D <= 0 || M <= 0 || M % D != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(a, b, h, L, D, M, reverse, shift, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, b, h, L, D, M, reverse, shift, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* xp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
