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
// Checkpoints (hck_f, hck_r, fp32 (ceil(L / 256), M), always written): each
// lane's ENTRY state of every 256-token chunk c, the residuals the backward
// kernel (selective_scan_bidir_bwd.cu) rebuilds h from: forward lanes the
// state entering chunk c from the left (h at t = 256 c - 1, zero for c = 0),
// reversed lanes the state entering it from the right (h at
// t = min(256 (c + 1), L), zero for the last chunk).
//
// Bound: bytes. Per call the function reads u, dt_f, dt_r (and the compact
// B/C, 1/Dim of that) and writes y_f, y_r: 10 bytes per (t, m) in bf16.
//
// Design: a span-parallel scan in three passes. The recurrence is
// associative, (A1, B1) o (A2, B2) = (A1 A2, A2 B1 + B2), so L is cut into
// spans of 128 tokens (two to a checkpoint chunk) that are worked on at once.
//   1. span_summary_kernel, grid (lane groups, spans): a block owns 32
//      neighbouring lanes and one span, as 8 warps x 16 steps. A thread
//      loads the 16 steps of its lane and segment (u, dt_f, dt_r, B_f, B_r;
//      all loads in flight together), forms (a, b) for BOTH directions (they
//      share u), composes each direction's segment in its own scan order
//      and puts the (product of a, h from a zero entry) pairs into shared
//      memory. Warp 0 folds the 8 forward segments left to right, warp 1
//      the reversed ones right to left, into the span's summary, written
//      as fp32 (4, spans, M).
//   2. span_carry_kernel: the L / 128 span summaries of a lane and
//      direction, composed in scan order to each span's entry state, fp32
//      (2, spans, M), by 32 threads a lane with the same segment scheme;
//      the entry states of the spans that a chunk is entered through are
//      hck_f / hck_r.
//   3. span_output_kernel, same grid and loads as pass 1: after the segment
//      summaries meet in shared memory a thread folds the segments before
//      its own (in scan order) onto the span's entry state, replays its
//      registers from there and stores y = C h + D u for both directions.
// A launch of one span (L <= 128) runs pass 3 alone from a zero entry, with
// 4 or 8 steps per segment when L <= 32 or 64 so that all warps have steps.
// Tokens beyond L are inert (dt = -inf gives a = 1, b = 0); nothing divides,
// so a product of a that underflows to 0 is harmless. Every sum is taken in
// a fixed order: two runs give the same bits. L * M / 16 threads work where
// the sequential design had 2 M, in blocks of 256 threads so that two or
// more share an SM and one's loads overlap another's arithmetic. The price
// is that passes 1 and 3 both read the operands and both evaluate softplus
// and exp: 16 bytes per (t, m) against the 10 of the bound, and twice the
// transcendental work, which is why those are the hardware's approximations
// here (see softplus_approx in scan_common.cuh).
#include <math.h>

#include <type_traits>

#include "scan_common.cuh"

namespace {

using xp::ex2_approx;
using xp::from_f32;
using xp::kLog2e;
using xp::softplus_approx;
using xp::to_f32;

constexpr int kLanes = 32;          // lanes per block, a warp's width
constexpr int kWarps = 8;           // segments per span
constexpr int kMaxSteps = 16;       // steps per segment
constexpr int kSpan = kWarps * kMaxSteps;
constexpr int kCkptChunk = 256;     // checkpoint chunk (the JAX DEFAULT_CHUNK)
constexpr int kSpansPerChunk = kCkptChunk / kSpan;
constexpr int kCarryRuns = 32;      // most runs of spans per lane in pass 2
constexpr int kBlocksPerSM = 512 / (kLanes * kWarps);

template <typename T>
struct Operands {
  const T* u;
  const T* dt_f;
  const T* dt_r;
  const T* bc_f;
  const T* cc_f;
  const T* bc_r;
  const T* cc_r;
  const float* A;
  const float* Dv;
  const float* bias;
  int L, M, Dim;
};

// One thread's place: its lane (m clamped into the plane, so that a block's
// spare threads load valid addresses; live says whether it stores), the
// lane's group and constants, A premultiplied by log2(e).
struct Lane {
  int m, g;
  bool live;
  float A2_f, A2_r, bias_f, bias_r, D_f, D_r;
};

template <typename T>
__device__ __forceinline__ Lane lane_of(const Operands<T>& p) {
  Lane l;
  const int m = blockIdx.x * kLanes + threadIdx.x;
  l.live = m < p.M;
  l.m = min(m, p.M - 1);
  l.g = l.m / p.Dim;
  const int c = l.m % (2 * p.Dim);
  l.A2_f = __ldg(p.A + c) * kLog2e;
  l.A2_r = __ldg(p.A + 2 * p.Dim + c) * kLog2e;
  l.bias_f = __ldg(p.bias + c);
  l.bias_r = __ldg(p.bias + 2 * p.Dim + c);
  l.D_f = __ldg(p.Dv + c);
  l.D_r = __ldg(p.Dv + 2 * p.Dim + c);
  return l;
}

// The tokens t0 .. t0 + kSteps - 1 of one thread as rows of the (L, M) and
// (L, G) planes: one 64-bit element offset per plane shape (e0, s0) plus a
// row count that fits 32 bits. kFull says that the whole span lies inside
// the scan; otherwise a token at or beyond L reads row L - 1 (a valid
// address; its values are discarded), so no load is predicated.
template <bool kFull>
struct Rows {
  size_t e0, s0;
  int t0, first, last;
  __device__ __forceinline__ int row(int i) const {
    return kFull ? i : min(t0 + i, last) - first;
  }
  __device__ __forceinline__ bool inside(int i) const {
    return kFull || t0 + i <= last;
  }
};

template <bool kFull, typename T>
__device__ __forceinline__ Rows<kFull> rows_of(const Operands<T>& p,
                                               const Lane& l, int t0) {
  Rows<kFull> r;
  r.t0 = t0;
  r.last = p.L - 1;
  r.first = min(t0, r.last);
  r.e0 = static_cast<size_t>(r.first) * p.M + l.m;
  r.s0 = static_cast<size_t>(r.first) * (p.M / p.Dim) + l.g;
  return r;
}

// base + row * row_elems as one widening multiply-add: the 64-bit address
// of a row costs one operation and holds no register between uses.
template <typename P>
__device__ __forceinline__ P* at_row(P* base, int row, unsigned row_elems) {
  using Byte = typename std::conditional<std::is_const<P>::value, const char,
                                         char>::type;
  const unsigned row_bytes = row_elems * static_cast<unsigned>(sizeof(P));
  return reinterpret_cast<P*>(
      reinterpret_cast<Byte*>(base) +
      static_cast<unsigned long long>(static_cast<unsigned>(row)) * row_bytes);
}

// Loads the thread's kSteps tokens (all loads issued before any is used)
// and forms u and both directions' (a, b). A token beyond L takes
// dt = -inf: delta = 0, so it is the inert (a, b) = (1, 0) with no branch
// in the arithmetic.
template <typename T, int kSteps, bool kFull>
__device__ __forceinline__ void form_steps(
    const Operands<T>& p, const Lane& l, const Rows<kFull>& r,
    float (&uu)[kSteps], float (&af)[kSteps], float (&bf)[kSteps],
    float (&ar)[kSteps], float (&br)[kSteps]) {
  const int G = p.M / p.Dim;
  const T* __restrict__ pu = p.u + r.e0;
  const T* __restrict__ pdf = p.dt_f + r.e0;
  const T* __restrict__ pdr = p.dt_r + r.e0;
  const T* __restrict__ pbf = p.bc_f + r.s0;
  const T* __restrict__ pbr = p.bc_r + r.s0;
  T ru[kSteps], rdf[kSteps], rdr[kSteps], rbf[kSteps], rbr[kSteps];
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    ru[i] = __ldg(at_row(pu, r.row(i), p.M));
    rdf[i] = __ldg(at_row(pdf, r.row(i), p.M));
    rdr[i] = __ldg(at_row(pdr, r.row(i), p.M));
    rbf[i] = __ldg(at_row(pbf, r.row(i), G));
    rbr[i] = __ldg(at_row(pbr, r.row(i), G));
  }
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const float uv = to_f32(ru[i]);
    const float df = softplus_approx(
        r.inside(i) ? to_f32(rdf[i]) + l.bias_f : -INFINITY);
    const float dr = softplus_approx(
        r.inside(i) ? to_f32(rdr[i]) + l.bias_r : -INFINITY);
    uu[i] = uv;
    af[i] = ex2_approx(df * l.A2_f);
    bf[i] = df * uv * to_f32(rbf[i]);
    ar[i] = ex2_approx(dr * l.A2_r);
    br[i] = dr * uv * to_f32(rbr[i]);
  }
}

// The segment's (product of a, h from a zero entry) of each direction, into
// seg[0..3][w][lane] = a_f, h_f, a_r, h_r. Forward composes left to right,
// reversed right to left.
template <int kSteps>
__device__ __forceinline__ void put_segment_summaries(
    float (&seg)[4][kWarps][kLanes], const float (&af)[kSteps],
    const float (&bf)[kSteps], const float (&ar)[kSteps],
    const float (&br)[kSteps]) {
  float pf = 1.f, hf = 0.f, pr = 1.f, hr = 0.f;
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    hf = af[i] * hf + bf[i];
    pf *= af[i];
    hr = ar[kSteps - 1 - i] * hr + br[kSteps - 1 - i];
    pr *= ar[kSteps - 1 - i];
  }
  seg[0][threadIdx.y][threadIdx.x] = pf;
  seg[1][threadIdx.y][threadIdx.x] = hf;
  seg[2][threadIdx.y][threadIdx.x] = pr;
  seg[3][threadIdx.y][threadIdx.x] = hr;
}

template <typename T, bool kFull>
__device__ __forceinline__ void span_summary(
    const Operands<T>& p, float* __restrict__ sums, int n_spans,
    float (&seg)[4][kWarps][kLanes]) {
  const Lane l = lane_of(p);
  const int w = threadIdx.y;
  const int s = blockIdx.y;
  const Rows<kFull> r = rows_of<kFull>(p, l, s * kSpan + w * kMaxSteps);
  float uu[kMaxSteps], af[kMaxSteps], bf[kMaxSteps], ar[kMaxSteps],
      br[kMaxSteps];
  form_steps<T, kMaxSteps, kFull>(p, l, r, uu, af, bf, ar, br);
  put_segment_summaries<kMaxSteps>(seg, af, bf, ar, br);
  __syncthreads();
  if (w < 2 && l.live) {              // warp 0: forward, warp 1: reversed
    float prod = 1.f, x = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      const int j = w == 0 ? k : kWarps - 1 - k;
      const float a = seg[2 * w][j][threadIdx.x];
      x = a * x + seg[2 * w + 1][j][threadIdx.x];
      prod *= a;
    }
    const size_t plane = static_cast<size_t>(n_spans) * p.M;
    const size_t at = static_cast<size_t>(s) * p.M + l.m;
    sums[2 * w * plane + at] = prod;
    sums[(2 * w + 1) * plane + at] = x;
  }
}

// Pass 1: sums is fp32 (4, n_spans, M): product of a and h from a zero
// entry over the whole span, forward then reversed.
template <typename T>
__global__ void __launch_bounds__(kLanes * kWarps, kBlocksPerSM)
span_summary_kernel(Operands<T> p, float* __restrict__ sums, int n_spans) {
  __shared__ float seg[4][kWarps][kLanes];
  if ((static_cast<int>(blockIdx.y) + 1) * kSpan <= p.L)
    span_summary<T, true>(p, sums, n_spans, seg);
  else
    span_summary<T, false>(p, sums, n_spans, seg);
}

// Pass 2: the entry state of every span, in scan order, into entry (fp32
// (2, n_spans, M)); those through which a checkpoint chunk is entered (its
// first span on forward lanes, its last on reversed lanes) also into hck.
// The same segment scheme one level up: a block owns 32 lanes of one
// direction, thread (lane, j) the j-th of blockDim.y <= 32 runs of spans in
// scan order; it composes its run, the run summaries meet in shared memory,
// it folds the runs before its own and replays its run.
__global__ void __launch_bounds__(kLanes * kCarryRuns)
span_carry_kernel(const float* __restrict__ sums, float* __restrict__ entry,
                  float* __restrict__ hck_f, float* __restrict__ hck_r,
                  int n_spans, int M) {
  __shared__ float run_a[kCarryRuns][kLanes];
  __shared__ float run_h[kCarryRuns][kLanes];
  const int lane = threadIdx.x;
  const int j = threadIdx.y;
  const int m = blockIdx.x * kLanes + lane;
  const bool live = m < M;
  const bool rev = blockIdx.y == 1;
  const size_t plane = static_cast<size_t>(n_spans) * M;
  const float* __restrict__ pa = sums + (rev ? 2 : 0) * plane + min(m, M - 1);
  const float* __restrict__ ph = pa + plane;
  const int runs = blockDim.y;
  const int per = (n_spans + runs - 1) / runs;
  const int k0 = min(j * per, n_spans);
  const int k1 = min(k0 + per, n_spans);
  float prod = 1.f, x = 0.f;
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const size_t at = static_cast<size_t>(rev ? n_spans - 1 - k : k) * M;
    const float a = __ldg(pa + at);
    x = a * x + __ldg(ph + at);
    prod *= a;
  }
  run_a[j][lane] = prod;
  run_h[j][lane] = x;
  __syncthreads();
  x = 0.f;
#pragma unroll
  for (int i = 0; i < kCarryRuns; ++i)
    if (i < j) x = run_a[i][lane] * x + run_h[i][lane];
  if (!live) return;
  float* __restrict__ pe = entry + (rev ? plane : 0) + m;
  float* __restrict__ hck = (rev ? hck_r : hck_f) + m;
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const int s = rev ? n_spans - 1 - k : k;
    const size_t at = static_cast<size_t>(s) * M;
    pe[at] = x;
    const bool enters_chunk =
        rev ? (s % kSpansPerChunk == kSpansPerChunk - 1 || s == n_spans - 1)
            : s % kSpansPerChunk == 0;
    if (enters_chunk) hck[static_cast<size_t>(s / kSpansPerChunk) * M] = x;
    x = __ldg(pa + at) * x + __ldg(ph + at);
  }
}

template <typename T, int kSteps, bool kFull>
__device__ __forceinline__ void span_output(
    const Operands<T>& p, T* __restrict__ y_f, T* __restrict__ y_r,
    const float* __restrict__ entry, float* __restrict__ hck_f,
    float* __restrict__ hck_r, int n_spans,
    float (&seg)[4][kWarps][kLanes]) {
  const Lane l = lane_of(p);
  const int w = threadIdx.y;
  const int lane = threadIdx.x;
  const int s = blockIdx.y;
  const int G = p.M / p.Dim;
  const Rows<kFull> r =
      rows_of<kFull>(p, l, s * (kWarps * kSteps) + w * kSteps);
  float hf = 0.f, hr = 0.f;
  if (n_spans > 1) {
    const size_t at = static_cast<size_t>(s) * p.M + l.m;
    hf = __ldg(entry + at);
    hr = __ldg(entry + static_cast<size_t>(n_spans) * p.M + at);
  } else if (w == 0 && l.live) {
    hck_f[l.m] = 0.f;
    hck_r[l.m] = 0.f;
  }
  float uu[kSteps], af[kSteps], bf[kSteps], ar[kSteps], br[kSteps];
  form_steps<T, kSteps, kFull>(p, l, r, uu, af, bf, ar, br);
  put_segment_summaries<kSteps>(seg, af, bf, ar, br);
  __syncthreads();
  // the segments before this one, in scan order (w is uniform in a warp)
#pragma unroll
  for (int j = 0; j < kWarps; ++j) {
    if (j < w) hf = seg[0][j][lane] * hf + seg[1][j][lane];
    if (kWarps - 1 - j > w)
      hr = seg[2][kWarps - 1 - j][lane] * hr + seg[3][kWarps - 1 - j][lane];
  }

  if (!l.live) return;      // no barrier follows; spare lanes store nothing

  T cv[kSteps];
  const T* __restrict__ pcf = p.cc_f + r.s0;
  T* __restrict__ pyf = y_f + r.e0;
#pragma unroll
  for (int i = 0; i < kSteps; ++i) cv[i] = __ldg(at_row(pcf, r.row(i), G));
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    hf = af[i] * hf + bf[i];
    if (r.inside(i))
      *at_row(pyf, r.row(i), p.M) =
          from_f32<T>(to_f32(cv[i]) * hf + l.D_f * uu[i]);
  }
  const T* __restrict__ pcr = p.cc_r + r.s0;
  T* __restrict__ pyr = y_r + r.e0;
#pragma unroll
  for (int i = 0; i < kSteps; ++i) cv[i] = __ldg(at_row(pcr, r.row(i), G));
#pragma unroll
  for (int i = kSteps - 1; i >= 0; --i) {
    hr = ar[i] * hr + br[i];
    if (r.inside(i))
      *at_row(pyr, r.row(i), p.M) =
          from_f32<T>(to_f32(cv[i]) * hr + l.D_r * uu[i]);
  }
}

// Pass 3: y of both directions from the span entry states. With one span
// the entry is zero, entry is not read and the zero is written to hck here.
template <typename T, int kSteps>
__global__ void __launch_bounds__(kLanes * kWarps, kBlocksPerSM)
span_output_kernel(Operands<T> p, T* __restrict__ y_f, T* __restrict__ y_r,
                   const float* __restrict__ entry, float* __restrict__ hck_f,
                   float* __restrict__ hck_r, int n_spans) {
  __shared__ float seg[4][kWarps][kLanes];
  if ((static_cast<int>(blockIdx.y) + 1) * (kWarps * kSteps) <= p.L)
    span_output<T, kSteps, true>(p, y_f, y_r, entry, hck_f, hck_r, n_spans,
                                 seg);
  else
    span_output<T, kSteps, false>(p, y_f, y_r, entry, hck_f, hck_r, n_spans,
                                  seg);
}

template <typename T>
int launch(const void* u, const void* dt_f, const void* dt_r,
           const void* bc_f, const void* cc_f, const void* bc_r,
           const void* cc_r, const float* A, const float* Dv,
           const float* bias, void* y_f, void* y_r, float* hck_f,
           float* hck_r, float* scratch, int L, int M, int Dim,
           cudaStream_t stream) {
  const Operands<T> p{static_cast<const T*>(u), static_cast<const T*>(dt_f),
                      static_cast<const T*>(dt_r), static_cast<const T*>(bc_f),
                      static_cast<const T*>(cc_f), static_cast<const T*>(bc_r),
                      static_cast<const T*>(cc_r), A, Dv, bias, L, M, Dim};
  T* yf = static_cast<T*>(y_f);
  T* yr = static_cast<T*>(y_r);
  const int n_spans = (L + kSpan - 1) / kSpan;
  const dim3 block(kLanes, kWarps);
  const dim3 grid((M + kLanes - 1) / kLanes, n_spans);
  if (n_spans > 1) {
    float* sums = scratch;
    float* entry = scratch + 4 * static_cast<size_t>(n_spans) * M;
    span_summary_kernel<T><<<grid, block, 0, stream>>>(p, sums, n_spans);
    span_carry_kernel<<<dim3(grid.x, 2),
                        dim3(kLanes, n_spans < kCarryRuns ? n_spans
                                                          : kCarryRuns),
                        0, stream>>>(sums, entry, hck_f, hck_r, n_spans, M);
    span_output_kernel<T, kMaxSteps><<<grid, block, 0, stream>>>(
        p, yf, yr, entry, hck_f, hck_r, n_spans);
  } else if (L <= 4 * kWarps) {
    span_output_kernel<T, 4><<<grid, block, 0, stream>>>(
        p, yf, yr, nullptr, hck_f, hck_r, n_spans);
  } else if (L <= 8 * kWarps) {
    span_output_kernel<T, 8><<<grid, block, 0, stream>>>(
        p, yf, yr, nullptr, hck_f, hck_r, n_spans);
  } else {
    span_output_kernel<T, kMaxSteps><<<grid, block, 0, stream>>>(
        p, yf, yr, nullptr, hck_f, hck_r, n_spans);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The fp32 values of scratch that a call with these L and M needs: the span
// summaries (4, spans, M) and entry states (2, spans, M); 0 for one span.
extern "C" long long xp_selective_scan_bidir_scratch(int L, int M) {
  const long long n_spans = (L + kSpan - 1) / kSpan;
  return n_spans > 1 ? 6 * n_spans * M : 0;
}

// dtype: 0 = float32, 1 = bfloat16 (u, dt, bc, cc and y share it).
// hck_f / hck_r: fp32 (ceil(L / 256), M) checkpoint outputs, always written.
// scratch: fp32, xp_selective_scan_bidir_scratch(L, M) values (may be null
// when that is 0).
extern "C" int xp_selective_scan_bidir(
    int dtype, const void* u, const void* dt_f, const void* dt_r,
    const void* bc_f, const void* cc_f, const void* bc_r, const void* cc_r,
    const float* A, const float* Dv, const float* bias, void* y_f,
    void* y_r, float* hck_f, float* hck_r, float* scratch, int L, int M,
    int Dim, void* stream) {
  if (L <= 0 || M <= 0 || Dim <= 0 || M % (2 * Dim) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M > (1 << 26))       // 16 rows of M elements as a 32-bit offset
    return static_cast<int>(cudaErrorInvalidValue);
  if (hck_f == nullptr || hck_r == nullptr ||
      (L > kSpan && scratch == nullptr) ||
      (L + kSpan - 1) / kSpan > 65535)               // grid y = spans
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(u, dt_f, dt_r, bc_f, cc_f, bc_r, cc_r, A, Dv, bias,
                         y_f, y_r, hck_f, hck_r, scratch, L, M, Dim, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(u, dt_f, dt_r, bc_f, cc_f, bc_r, cc_r, A,
                                 Dv, bias, y_f, y_r, hck_f, hck_r, scratch, L,
                                 M, Dim, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* xp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
