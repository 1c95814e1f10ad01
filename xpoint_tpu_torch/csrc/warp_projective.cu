// Image warp by a homography: out[i, b, y, x, c] = src(Hinv_i @ [x, y, 1]).
//
// Replaces xpoint_tpu/ops/warp_tiled.py::_warp_pallas_kernel (pallas_call in
// _warp_one_pallas), reached from homographic adaptation through
// ops/warp_projective.py::warp_multi / warp_batch. What is kept is the
// function: exact projective source coordinates per output pixel, bilinear
// or nearest (round half to even) sampling, 'zeros' or REFLECT_101 padding,
// non-finite coordinates saturated to +-1e7. The TPU kernel's two-pass
// separable contraction, aligned source windows, padded canvas and
// pre-rotated source worked around slow gathers and are not carried over:
// this is the single-pass 4-tap sample, reflection by index arithmetic.
//
// Layout: channels-last fp32. src is (B, H, W, C) shared by all n inverse
// homographies (src_n_stride = 0, the "multi" form) or (n, H, W, C) with one
// image per homography (B = 1, src_n_stride = H*W*C, the "batch" form); out
// is (n, B, H, W, C). One thread per output pixel (grid z = i, y = row,
// x blocks along the row) computes the source position once and loops over
// the B*C values that share it.
//
// The coordinate arithmetic uses __fmul_rn / __fadd_rn / __fdiv_rn so that
// nvcc contracts nothing into FMAs: the plain PyTorch version
// (ops/warp.py::warp_from_inverse) rounds each product, sum and quotient on
// its own, and a coordinate that differs in its last bit flips a
// nearest-mode pixel or a bounds test.
//
// Bound: bytes (source read once, output written once: 4 B per output
// value, some tens of flops per pixel). Neighbouring threads write
// neighbouring pixels (coalesced for C = 1, C contiguous floats each
// otherwise); the four taps are gathers served by L1/L2. Shared-memory
// source tiles and vector loads are later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kCoordMax = 1e7f;
enum { kBilinear = 0, kNearest = 1 };
enum { kZeros = 0, kReflect = 1 };

__device__ __forceinline__ float finite_coord(float v) {
  if (isnan(v)) v = -kCoordMax;
  return fminf(fmaxf(v, -kCoordMax), kCoordMax);
}

// REFLECT_101 into [0, size-1]: python-style remainder by 2 (size - 1),
// then the mirror of the upper half
__device__ __forceinline__ float reflect_101(float c, int size) {
  const float last = static_cast<float>(size - 1);
  const float period = 2.0f * last;
  float r = fmodf(c, period);
  if (r != 0.f && r < 0.f) r = __fadd_rn(r, period);
  return r > last ? __fsub_rn(period, r) : r;
}

__device__ __forceinline__ int clampi(int v, int hi) {
  return min(max(v, 0), hi);
}

template <int MODE, int PAD>
__global__ void __launch_bounds__(kThreads)
warp_kernel(const float* __restrict__ src, const float* __restrict__ hinv,
            float* __restrict__ out, int B, int H, int W, int C,
            long long src_n_stride) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  if (x >= W) return;
  const int y = blockIdx.y;
  const int i = blockIdx.z;
  const float* __restrict__ h = hinv + 9 * i;
  const float xd = static_cast<float>(x);
  const float yd = static_cast<float>(y);
  const float den = __fadd_rn(
      __fadd_rn(__fmul_rn(__ldg(h + 6), xd), __fmul_rn(__ldg(h + 7), yd)),
      __ldg(h + 8));
  float xs = finite_coord(__fdiv_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(__ldg(h + 0), xd),
                          __fmul_rn(__ldg(h + 1), yd)), __ldg(h + 2)), den));
  float ys = finite_coord(__fdiv_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(__ldg(h + 3), xd),
                          __fmul_rn(__ldg(h + 4), yd)), __ldg(h + 5)), den));
  if (PAD == kReflect) {
    xs = reflect_101(xs, W);
    ys = reflect_101(ys, H);
  }
  const float* __restrict__ s = src + static_cast<long long>(i) * src_n_stride;
  const long long plane = static_cast<long long>(H) * W * C;   // one image
  float* __restrict__ o = out + static_cast<long long>(i) * B * plane
                          + (static_cast<long long>(y) * W + x) * C;

  if (MODE == kNearest) {
    const int yi = static_cast<int>(rintf(ys));   // half to even
    const int xi = static_cast<int>(rintf(xs));
    const bool inb = PAD == kReflect ||
                     (yi >= 0 && yi <= H - 1 && xi >= 0 && xi <= W - 1);
    const long long off =
        (static_cast<long long>(clampi(yi, H - 1)) * W + clampi(xi, W - 1)) * C;
    for (int b = 0; b < B; ++b)
      for (int c = 0; c < C; ++c)
        o[b * plane + c] = inb ? s[b * plane + off + c] : 0.f;
    return;
  }

  const float y0 = floorf(ys);
  const float x0 = floorf(xs);
  const float wy = __fsub_rn(ys, y0);
  const float wx = __fsub_rn(xs, x0);
  const int y0i = static_cast<int>(y0);
  const int x0i = static_cast<int>(x0);
  const int y1i = y0i + 1;
  const int x1i = x0i + 1;
  const bool y0in = PAD == kReflect || (y0i >= 0 && y0i <= H - 1);
  const bool y1in = PAD == kReflect || (y1i >= 0 && y1i <= H - 1);
  const bool x0in = PAD == kReflect || (x0i >= 0 && x0i <= W - 1);
  const bool x1in = PAD == kReflect || (x1i >= 0 && x1i <= W - 1);
  const long long r0 = static_cast<long long>(clampi(y0i, H - 1)) * W;
  const long long r1 = static_cast<long long>(clampi(y1i, H - 1)) * W;
  const int c0 = clampi(x0i, W - 1);
  const int c1 = clampi(x1i, W - 1);
  const long long o00 = (r0 + c0) * C, o01 = (r0 + c1) * C;
  const long long o10 = (r1 + c0) * C, o11 = (r1 + c1) * C;
  const float ux = 1.f - wx;
  const float uy = 1.f - wy;
  for (int b = 0; b < B; ++b) {
    const float* __restrict__ sb = s + b * plane;
    for (int c = 0; c < C; ++c) {
      const float v00 = (y0in && x0in) ? sb[o00 + c] : 0.f;
      const float v01 = (y0in && x1in) ? sb[o01 + c] : 0.f;
      const float v10 = (y1in && x0in) ? sb[o10 + c] : 0.f;
      const float v11 = (y1in && x1in) ? sb[o11 + c] : 0.f;
      const float top = v00 * ux + v01 * wx;
      const float bot = v10 * ux + v11 * wx;
      o[b * plane + c] = top * uy + bot * wy;
    }
  }
}

template <int MODE, int PAD>
int launch(const float* src, const float* hinv, float* out, int n, int B,
           int H, int W, int C, long long src_n_stride,
           cudaStream_t stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, H, n);
  warp_kernel<MODE, PAD><<<grid, kThreads, 0, stream>>>(
      src, hinv, out, B, H, W, C, src_n_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// mode: 0 bilinear, 1 nearest; padding: 0 zeros, 1 REFLECT_101.
// src: fp32 (B, H, W, C) with src_n_stride 0, or (n, H, W, C) with B = 1 and
// src_n_stride = H*W*C; hinv: fp32 (n, 3, 3) inverse homographies;
// out: fp32 (n, B, H, W, C).
extern "C" int xp_warp_projective(
    int mode, int padding, const float* src, const float* hinv, float* out,
    int n, int B, int H, int W, int C, long long src_n_stride,
    void* stream) {
  if (n <= 0 || B <= 0 || H <= 0 || W <= 0 || C <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (H > 65535 || n > 65535)           // grid = (x blocks, H, n)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define XP_WARP_CASE(M, P)                                                  \
  if (mode == M && padding == P)                                            \
    return launch<M, P>(src, hinv, out, n, B, H, W, C, src_n_stride, s);
  XP_WARP_CASE(kBilinear, kZeros)
  XP_WARP_CASE(kBilinear, kReflect)
  XP_WARP_CASE(kNearest, kZeros)
  XP_WARP_CASE(kNearest, kReflect)
#undef XP_WARP_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* xp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
