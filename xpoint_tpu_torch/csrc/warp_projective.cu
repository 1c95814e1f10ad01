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
// is (n, B, H, W, C).
//
// The coordinate arithmetic uses __fmul_rn / __fadd_rn / __fdiv_rn so that
// nvcc contracts nothing into FMAs: the plain PyTorch version
// (ops/warp.py::warp_from_inverse) rounds each product, sum and quotient on
// its own, and a coordinate that differs in its last bit flips a
// nearest-mode pixel or a bounds test.
//
// Bound: bytes (source read once, output written once: 4 B per output
// value, some tens of flops per pixel). A thread with one pixel moves a few
// bytes behind some hundred operations and a single round of gathers, so
// the kernel was bound by issue and by gathers in flight. Design: a thread
// computes 4 neighbouring pixels of a row, the source position of each
// formed on its own exactly as above; the 16 taps of a bilinear sample are
// all loaded before any is blended (2-channel taps as one float2 each), and
// the 4 pixels leave as one float4 store for C = 1 and two for C = 2. The
// nine coefficients are read once per thread. A warp covers 32 x 4 pixels
// (8 threads along a row, 4 rows), so that under any rotation its taps fall
// into few cache lines and its stores are whole 128-byte lines; a block is
// two warps (a 32 x 8 tile): the kernel lives on latency (coefficients,
// then gathers, then the store), and many small blocks keep every SM
// supplied where blocks of 256 threads left it waiting on whole waves.
// Other C loop over the channels with scalar loads and
// stores; so do images whose W is no multiple of 4 or whose pointers are
// not 16-byte aligned (the same kernel, by a flag computed from the shape).
#include <cuda_runtime.h>

namespace {

constexpr int kPix = 4;        // neighbouring pixels of a row per thread
constexpr int kTileX = 8;      // threads along a row: 32 pixels
constexpr int kTileY = 8;      // rows per block
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

// Stores the kPix x NC values of one thread at o (pixel stride C floats):
// whole float4s when vec, else scalars with the row's end guarded.
template <int NC>
__device__ __forceinline__ void store_pixels(float* __restrict__ o,
                                             const float (&v)[kPix][NC],
                                             int C, int n_pix, bool vec) {
  if (vec) {
    if constexpr (NC == 1) {
      *reinterpret_cast<float4*>(o) =
          make_float4(v[0][0], v[1][0], v[2][0], v[3][0]);
    } else {
      *reinterpret_cast<float4*>(o) =
          make_float4(v[0][0], v[0][1], v[1][0], v[1][1]);
      *reinterpret_cast<float4*>(o + 4) =
          make_float4(v[2][0], v[2][1], v[3][0], v[3][1]);
    }
    return;
  }
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    if (p < n_pix) {
#pragma unroll
      for (int k = 0; k < NC; ++k) o[p * C + k] = v[p][k];
    }
  }
}

// One tap of all NC channels, zero when it lies outside: one float2 load
// for two channels where the pointers allow it.
template <int NC>
__device__ __forceinline__ void load_tap(const float* __restrict__ at,
                                         bool inside, bool vec,
                                         float (&t)[NC]) {
  if constexpr (NC == 2) {
    if (vec) {
      const float2 q = inside ? *reinterpret_cast<const float2*>(at)
                              : make_float2(0.f, 0.f);
      t[0] = q.x;
      t[1] = q.y;
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < NC; ++k) t[k] = inside ? at[k] : 0.f;
}

// CT: the channel count when it is 1 or 2 (held in registers, vector
// stores), 0 for any other (a loop over the channels).
template <int MODE, int PAD, int CT>
__global__ void __launch_bounds__(kTileX * kTileY)
warp_kernel(const float* __restrict__ src, const float* __restrict__ hinv,
            float* __restrict__ out, int B, int H, int W, int C_any,
            long long src_n_stride, int vec_ok) {
  constexpr int NC = CT > 0 ? CT : 1;          // channels held at once
  const int C = CT > 0 ? CT : C_any;
  const int x0 = (blockIdx.x * kTileX + threadIdx.x) * kPix;
  const int y = blockIdx.y * kTileY + threadIdx.y;
  if (x0 >= W || y >= H) return;
  const int i = blockIdx.z;
  const int n_pix = min(kPix, W - x0);
  const bool vec = vec_ok != 0 && CT > 0;
  float h[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) h[k] = __ldg(hinv + 9 * i + k);
  const float yd = static_cast<float>(y);
  float xs[kPix], ys[kPix];
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const float xd = static_cast<float>(x0 + p);
    const float den = __fadd_rn(
        __fadd_rn(__fmul_rn(h[6], xd), __fmul_rn(h[7], yd)), h[8]);
    xs[p] = finite_coord(__fdiv_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(h[0], xd), __fmul_rn(h[1], yd)), h[2]),
        den));
    ys[p] = finite_coord(__fdiv_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(h[3], xd), __fmul_rn(h[4], yd)), h[5]),
        den));
    if (PAD == kReflect) {
      xs[p] = reflect_101(xs[p], W);
      ys[p] = reflect_101(ys[p], H);
    }
  }
  const float* __restrict__ s = src + static_cast<long long>(i) * src_n_stride;
  const long long plane = static_cast<long long>(H) * W * C;   // one image
  float* __restrict__ o = out + static_cast<long long>(i) * B * plane
                          + (static_cast<long long>(y) * W + x0) * C;

  if constexpr (MODE == kNearest) {
    int off[kPix];
    bool inb[kPix];
#pragma unroll
    for (int p = 0; p < kPix; ++p) {
      const int yi = static_cast<int>(rintf(ys[p]));   // half to even
      const int xi = static_cast<int>(rintf(xs[p]));
      inb[p] = PAD == kReflect ||
               (yi >= 0 && yi <= H - 1 && xi >= 0 && xi <= W - 1);
      off[p] = (clampi(yi, H - 1) * W + clampi(xi, W - 1)) * C;
    }
    for (int b = 0; b < B; ++b) {
      const float* __restrict__ sb = s + b * plane;
      for (int c0 = 0; c0 < C; c0 += NC) {
        float v[kPix][NC];
#pragma unroll
        for (int p = 0; p < kPix; ++p)
#pragma unroll
          for (int k = 0; k < NC; ++k)
            v[p][k] = inb[p] ? sb[off[p] + c0 + k] : 0.f;
        store_pixels<NC>(o + b * plane + c0, v, C, n_pix, vec);
      }
    }
  } else {
    // bilinear: per pixel the four tap offsets, which taps lie inside, and
    // the weights
    int o00[kPix], o01[kPix], o10[kPix], o11[kPix];
    bool i00[kPix], i01[kPix], i10[kPix], i11[kPix];
    float wx[kPix], wy[kPix];
#pragma unroll
    for (int p = 0; p < kPix; ++p) {
      const float y0 = floorf(ys[p]);
      const float x0f = floorf(xs[p]);
      wy[p] = __fsub_rn(ys[p], y0);
      wx[p] = __fsub_rn(xs[p], x0f);
      const int y0i = static_cast<int>(y0);
      const int x0i = static_cast<int>(x0f);
      const int y1i = y0i + 1;
      const int x1i = x0i + 1;
      const bool y0in = PAD == kReflect || (y0i >= 0 && y0i <= H - 1);
      const bool y1in = PAD == kReflect || (y1i >= 0 && y1i <= H - 1);
      const bool x0in = PAD == kReflect || (x0i >= 0 && x0i <= W - 1);
      const bool x1in = PAD == kReflect || (x1i >= 0 && x1i <= W - 1);
      const int r0 = clampi(y0i, H - 1) * W;
      const int r1 = clampi(y1i, H - 1) * W;
      const int c0 = clampi(x0i, W - 1);
      const int c1 = clampi(x1i, W - 1);
      o00[p] = (r0 + c0) * C;
      o01[p] = (r0 + c1) * C;
      o10[p] = (r1 + c0) * C;
      o11[p] = (r1 + c1) * C;
      i00[p] = y0in && x0in;
      i01[p] = y0in && x1in;
      i10[p] = y1in && x0in;
      i11[p] = y1in && x1in;
    }
    for (int b = 0; b < B; ++b) {
      const float* __restrict__ sb = s + b * plane;
      for (int c0 = 0; c0 < C; c0 += NC) {
        // all taps of the 4 pixels first, then the blends
        float t00[kPix][NC], t01[kPix][NC], t10[kPix][NC], t11[kPix][NC];
#pragma unroll
        for (int p = 0; p < kPix; ++p) {
          load_tap<NC>(sb + o00[p] + c0, i00[p], vec, t00[p]);
          load_tap<NC>(sb + o01[p] + c0, i01[p], vec, t01[p]);
          load_tap<NC>(sb + o10[p] + c0, i10[p], vec, t10[p]);
          load_tap<NC>(sb + o11[p] + c0, i11[p], vec, t11[p]);
        }
        float v[kPix][NC];
#pragma unroll
        for (int p = 0; p < kPix; ++p) {
          const float ux = 1.f - wx[p];
          const float uy = 1.f - wy[p];
#pragma unroll
          for (int k = 0; k < NC; ++k) {
            const float top = t00[p][k] * ux + t01[p][k] * wx[p];
            const float bot = t10[p][k] * ux + t11[p][k] * wx[p];
            v[p][k] = top * uy + bot * wy[p];
          }
        }
        store_pixels<NC>(o + b * plane + c0, v, C, n_pix, vec);
      }
    }
  }
}

template <int MODE, int PAD>
int launch(const float* src, const float* hinv, float* out, int n, int B,
           int H, int W, int C, long long src_n_stride,
           cudaStream_t stream) {
  const dim3 block(kTileX, kTileY);
  const dim3 grid((W + kTileX * kPix - 1) / (kTileX * kPix),
                  (H + kTileY - 1) / kTileY, n);
  // float4 stores (and float2 taps) need whole groups of 4 pixels a row and
  // aligned pointers; every plane and row offset is then a multiple of 16 B
  const int vec_ok = W % kPix == 0 &&
      reinterpret_cast<unsigned long long>(out) % 16 == 0 &&
      reinterpret_cast<unsigned long long>(src) % 16 == 0;
  if (C == 1)
    warp_kernel<MODE, PAD, 1><<<grid, block, 0, stream>>>(
        src, hinv, out, B, H, W, C, src_n_stride, vec_ok);
  else if (C == 2)
    warp_kernel<MODE, PAD, 2><<<grid, block, 0, stream>>>(
        src, hinv, out, B, H, W, C, src_n_stride, vec_ok);
  else
    warp_kernel<MODE, PAD, 0><<<grid, block, 0, stream>>>(
        src, hinv, out, B, H, W, C, src_n_stride, vec_ok);
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
  if (n > 65535 || (H + kTileY - 1) / kTileY > 65535)   // grid y, z
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(H) * W * C > 2147483647LL)   // int tap offsets
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
