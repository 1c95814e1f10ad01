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
// (K * Dim,). softplus and exp are the forms every scan kernel here uses
// (softplus_approx, ex2_approx in scan_common.cuh). The Pallas kernel's
// (L, M) relayout, its B/C planes broadcast over Dim and its in-chunk
// Hillis-Steele scan are TPU forms and are not carried over.
//
// Bound: bytes (dt and u read, y written: 6 B per (t, lane) in bf16, plus
// B/C at 1/Dim of that). The sequential design (one thread per lane walking
// all of L) was bound by latency, with only B*K*Dim threads. This one is the
// span design of selective_scan_bidir.cu with one direction, in SS2D's
// layout: L is cut into spans of 64 tokens, and a block owns 32
// consecutive d of one (b, k) group and one span, as 4 warps x 16 steps in
// registers, so that every row load is 32 neighbouring elements and B/C are
// one broadcast load a step. Blocks of 128 threads, four to an SM (128
// registers a thread): on an H100 that was faster than 8 warps x 16 steps
// (1.45x) or x 8 steps, or than 2 warps a block; the carry over a span's
// segments is a chain of latencies, which many small blocks hide best.
//   1. span_summary_kernel: each thread composes its segment from u, dt, B
//      into (product of a, h from a zero entry); the segments meet in
//      shared memory and warp 0 folds them in order into the span's
//      summary, fp32 (2, spans, M), M = B*K*Dim lanes.
//   2. span_carry_kernel: the span summaries of a lane composed in order to
//      every span's entry state, fp32 (spans, M), up to 32 threads a lane.
//   3. span_output_kernel: the segments meet again, a thread folds those
//      before its own onto the span's entry, replays its registers and
//      stores y = C h + D u.
// A launch of one span (L <= 64) runs pass 3 alone from a zero entry, with
// 4 or 8 steps per segment when L <= 16 or 32. Tokens beyond L are inert
// (dt = -inf gives a = 1, b = 0); d beyond Dim compute on a clamped lane
// and store nothing. Every sum is taken in a fixed order, so two runs give
// the same bits. Passes 1 and 3 both read u and dt: 10 bytes per (t, lane)
// against the bound's 6.
#include <math.h>

#include "scan_common.cuh"

namespace {

using xp::ex2_approx;
using xp::from_f32;
using xp::kLog2e;
using xp::softplus_approx;
using xp::to_f32;

constexpr int kLanes = 32;          // d per block, a warp's width
constexpr int kWarps = 4;           // segments per span
constexpr int kMaxSteps = 16;       // steps per segment
constexpr int kSpan = kWarps * kMaxSteps;
constexpr int kCarryRuns = 32;      // most runs of spans per lane in pass 2
constexpr int kBlocksPerSM = 512 / (kLanes * kWarps);

template <typename T>
struct Operands {
  const T* u;
  const T* dt;
  const T* bs;
  const T* cs;
  const float* A;
  const float* Dv;
  const float* bias;
  int L, M, Dim, KDim, n_spans;
};

// One thread's lane: group (b, k), d (clamped into the group; live says
// whether it stores), the flat lane m = group * Dim + d, the element offset
// of its token 0 and the lane constants (A premultiplied by log2 e).
struct Lane {
  size_t e0;
  int grp, m;
  bool live;
  float A2, bias, D;
};

template <typename T>
__device__ __forceinline__ Lane lane_of(const Operands<T>& p) {
  Lane l;
  const int per_group = (p.Dim + kLanes - 1) / kLanes;
  l.grp = blockIdx.x / per_group;
  const int d = (blockIdx.x % per_group) * kLanes + threadIdx.x;
  l.live = d < p.Dim;
  const int dc = min(d, p.Dim - 1);
  l.m = l.grp * p.Dim + dc;
  l.e0 = static_cast<size_t>(l.grp) * p.L * p.Dim + dc;
  const int c = l.m % p.KDim;
  l.A2 = __ldg(p.A + c) * kLog2e;
  l.bias = __ldg(p.bias + c);
  l.D = __ldg(p.Dv + c);
  return l;
}

// The tokens t0 .. t0 + kS - 1 of one thread: a token at or beyond L reads
// row L - 1 (a valid address; its values are discarded).
struct Rows {
  int t0, last;
  __device__ __forceinline__ int row(int i) const { return min(t0 + i, last); }
  __device__ __forceinline__ bool inside(int i) const {
    return t0 + i <= last;
  }
};

// Loads the thread's kS tokens (all loads issued before any is used) and
// forms u and (a, b).
template <typename T, int kS>
__device__ __forceinline__ void form_steps(const Operands<T>& p,
                                           const Lane& l, const Rows& r,
                                           float (&uu)[kS], float (&a)[kS],
                                           float (&b)[kS]) {
  const size_t g0 = static_cast<size_t>(l.grp) * p.L;
  T ru[kS], rd[kS], rb[kS];
#pragma unroll
  for (int i = 0; i < kS; ++i) {
    const size_t e = l.e0 + static_cast<size_t>(r.row(i)) * p.Dim;
    ru[i] = __ldg(p.u + e);
    rd[i] = __ldg(p.dt + e);
    rb[i] = __ldg(p.bs + g0 + r.row(i));
  }
#pragma unroll
  for (int i = 0; i < kS; ++i) {
    const float delta = softplus_approx(
        r.inside(i) ? to_f32(rd[i]) + l.bias : -INFINITY);
    uu[i] = to_f32(ru[i]);
    a[i] = ex2_approx(delta * l.A2);
    b[i] = delta * uu[i] * to_f32(rb[i]);
  }
}

template <int kS>
__device__ __forceinline__ void put_segment_summary(
    float (&seg)[2][kWarps][kLanes], const float (&a)[kS],
    const float (&b)[kS]) {
  float P = 1.f, H = 0.f;
#pragma unroll
  for (int i = 0; i < kS; ++i) {
    H = a[i] * H + b[i];
    P *= a[i];
  }
  seg[0][threadIdx.y][threadIdx.x] = P;
  seg[1][threadIdx.y][threadIdx.x] = H;
}

// Pass 1: sums is fp32 (2, n_spans, M): product of a and h from a zero
// entry over the whole span.
template <typename T>
__global__ void __launch_bounds__(kLanes * kWarps, kBlocksPerSM)
span_summary_kernel(Operands<T> p, float* __restrict__ sums) {
  __shared__ float seg[2][kWarps][kLanes];
  const Lane l = lane_of(p);
  const int s = blockIdx.y;
  const Rows r{s * kSpan + static_cast<int>(threadIdx.y) * kMaxSteps,
               p.L - 1};
  float uu[kMaxSteps], a[kMaxSteps], b[kMaxSteps];
  form_steps<T, kMaxSteps>(p, l, r, uu, a, b);
  put_segment_summary<kMaxSteps>(seg, a, b);
  __syncthreads();
  if (threadIdx.y != 0 || !l.live) return;
  float prod = 1.f, x = 0.f;
#pragma unroll
  for (int j = 0; j < kWarps; ++j) {
    const float aj = seg[0][j][threadIdx.x];
    x = aj * x + seg[1][j][threadIdx.x];
    prod *= aj;
  }
  const size_t at = static_cast<size_t>(s) * p.M + l.m;
  sums[at] = prod;
  sums[static_cast<size_t>(p.n_spans) * p.M + at] = x;
}

// Pass 2: the entry state of every span into entry (fp32 (n_spans, M)). A
// block owns 32 lanes; thread (lane, j) the j-th of blockDim.y <= 32 runs
// of spans: it composes its run, the run summaries meet in shared memory,
// it folds the runs before its own and replays its run.
__global__ void __launch_bounds__(kLanes * kCarryRuns)
span_carry_kernel(const float* __restrict__ sums, float* __restrict__ entry,
                  int n_spans, int M) {
  __shared__ float run_a[kCarryRuns][kLanes];
  __shared__ float run_h[kCarryRuns][kLanes];
  const int lane = threadIdx.x;
  const int j = threadIdx.y;
  const int m = blockIdx.x * kLanes + lane;
  const bool live = m < M;
  const float* __restrict__ pa = sums + min(m, M - 1);
  const float* __restrict__ ph = pa + static_cast<size_t>(n_spans) * M;
  const int runs = blockDim.y;
  const int per = (n_spans + runs - 1) / runs;
  const int k0 = min(j * per, n_spans);
  const int k1 = min(k0 + per, n_spans);
  float prod = 1.f, x = 0.f;
  for (int k = k0; k < k1; ++k) {
    const size_t at = static_cast<size_t>(k) * M;
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
  for (int k = k0; k < k1; ++k) {
    const size_t at = static_cast<size_t>(k) * M;
    entry[at + m] = x;
    x = __ldg(pa + at) * x + __ldg(ph + at);
  }
}

// Pass 3: y from the span entry states (zero, and entry not read, with one
// span).
template <typename T, int kS>
__global__ void __launch_bounds__(kLanes * kWarps, kBlocksPerSM)
span_output_kernel(Operands<T> p, T* __restrict__ y,
                   const float* __restrict__ entry) {
  __shared__ float seg[2][kWarps][kLanes];
  const Lane l = lane_of(p);
  const int w = threadIdx.y;
  const int s = blockIdx.y;
  const Rows r{s * (kWarps * kS) + w * kS, p.L - 1};
  float h = p.n_spans > 1
                ? __ldg(entry + static_cast<size_t>(s) * p.M + l.m)
                : 0.f;
  float uu[kS], a[kS], b[kS];
  form_steps<T, kS>(p, l, r, uu, a, b);
  put_segment_summary<kS>(seg, a, b);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kWarps; ++j)
    if (j < w) h = seg[0][j][threadIdx.x] * h + seg[1][j][threadIdx.x];
  if (!l.live) return;      // no barrier follows; spare lanes store nothing
  const size_t g0 = static_cast<size_t>(l.grp) * p.L;
  T cv[kS];
#pragma unroll
  for (int i = 0; i < kS; ++i) cv[i] = __ldg(p.cs + g0 + r.row(i));
#pragma unroll
  for (int i = 0; i < kS; ++i) {
    h = a[i] * h + b[i];
    if (r.inside(i))
      y[l.e0 + static_cast<size_t>(r.row(i)) * p.Dim] =
          from_f32<T>(to_f32(cv[i]) * h + l.D * uu[i]);
  }
}

template <typename T>
int launch(const Operands<T>& p, T* y, float* scratch, cudaStream_t stream) {
  const int ns = p.n_spans;
  const dim3 block(kLanes, kWarps);
  const int groups = p.M / p.Dim;
  const dim3 grid(groups * ((p.Dim + kLanes - 1) / kLanes), ns);
  if (ns > 1) {
    float* sums = scratch;
    float* entry = scratch + 2 * static_cast<size_t>(ns) * p.M;
    span_summary_kernel<T><<<grid, block, 0, stream>>>(p, sums);
    span_carry_kernel<<<(p.M + kLanes - 1) / kLanes,
                        dim3(kLanes, ns < kCarryRuns ? ns : kCarryRuns), 0,
                        stream>>>(sums, entry, ns, p.M);
    span_output_kernel<T, kMaxSteps><<<grid, block, 0, stream>>>(p, y, entry);
  } else if (p.L <= 4 * kWarps) {
    span_output_kernel<T, 4><<<grid, block, 0, stream>>>(p, y, nullptr);
  } else if (p.L <= 8 * kWarps) {
    span_output_kernel<T, 8><<<grid, block, 0, stream>>>(p, y, nullptr);
  } else {
    span_output_kernel<T, kMaxSteps><<<grid, block, 0, stream>>>(p, y,
                                                                 nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The fp32 values of scratch that a call with these L and M needs: the span
// summaries (2, spans, M) and entry states (spans, M); 0 for one span.
extern "C" long long xp_selective_scan_fused_scratch(int L, int M) {
  const long long n_spans = (L + kSpan - 1) / kSpan;
  return n_spans > 1 ? 3 * n_spans * M : 0;
}

// dtype: 0 = float32, 1 = bfloat16 (u, dt, bs, cs and y share it).
// u, dt, y: (B, K, L, Dim); bs, cs: (B, K, L); A, Dv, bias: fp32 (K * Dim,).
// M = B * K * Dim, KDim = K * Dim. scratch: fp32,
// xp_selective_scan_fused_scratch(L, M) values (may be null when that is 0).
extern "C" int xp_selective_scan_fused(
    int dtype, const void* u, const void* dt, const void* bs, const void* cs,
    const float* A, const float* Dv, const float* bias, void* y,
    float* scratch, int L, int M, int Dim, int KDim, void* stream) {
  if (L <= 0 || M <= 0 || Dim <= 0 || KDim <= 0 || KDim % Dim != 0 ||
      M % KDim != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_spans = (L + kSpan - 1) / kSpan;
  if (n_spans > 65535 || (n_spans > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const Operands<float> p{
        static_cast<const float*>(u), static_cast<const float*>(dt),
        static_cast<const float*>(bs), static_cast<const float*>(cs),
        A, Dv, bias, L, M, Dim, KDim, n_spans};
    return launch<float>(p, static_cast<float*>(y), scratch, s);
  }
  if (dtype == 1) {
    using bf = __nv_bfloat16;
    const Operands<bf> p{static_cast<const bf*>(u), static_cast<const bf*>(dt),
                         static_cast<const bf*>(bs), static_cast<const bf*>(cs),
                         A, Dv, bias, L, M, Dim, KDim, n_spans};
    return launch<bf>(p, static_cast<bf*>(y), scratch, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* xp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
