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
//   du[t,m]  = sum over both lane sets of g_t D_c + dh_t delta_t B_t
//   dB[t,g]  = sum over the group of dh_t delta_t u_t,  dC[t,g] = of g_t h_t
//   dA[m] = sum_t da_t a_t delta_t, dD[m] = sum_t g_t u_t, dbias[m] = sum_t ddt
//
// h is not stored by the forward: its checkpoints (the entry state of every
// 256-token chunk, fp32 (ceil(L / 256), M)) are where h is rebuilt from,
// with the forward's own delta = softplus_approx(x) and a = 2^(delta A
// log2 e) (scan_common.cuh), so the gradient is that of the function the
// forward computed. sigmoid is 1 / (1 + 2^(-x log2 e)) with ex2.approx and
// rcp.approx: within 3e-7 relative of the exact value, and 0 at x = -inf.
//
// Bound: bytes. The function reads u, dt_f, dt_r, g_f, g_r and writes du,
// ddt_f, ddt_r: 16 bytes per (t, m) in bf16 (the compact B/C and dB/dC are
// 1/Dim of that), a few tens of flops each. The sequential design (one
// thread per lane and direction walking all of L twice) was bound by
// latency, with only 2 M threads. This one is K1's span design applied to
// the adjoint: with e_t = a_t dh_t the adjoint is the linear recurrence
// e_t = a_t gC_t + a_t e_next, run in the opposite order to h, so it
// composes by spans like the forward. L is cut into spans of 32 tokens
// (eight to a checkpoint chunk); a block owns 32 neighbouring lanes and one
// span, as 8 warps x 4 steps in registers.
//   1. span_summary_kernel: from u, dt, g, B, C of both directions a thread
//      forms its segment's (product of a, h from a zero entry in scan
//      order, e from a zero entry in adjoint order); the segments meet in
//      shared memory and four warps fold them into the span's summaries,
//      fp32 (6, spans, M).
//   2. span_carry_kernel: per lane and direction, the span summaries
//      composed in adjoint order into every span's adjoint entry (as K1's
//      carry, up to 32 threads a lane), and each chunk's checkpoint carried
//      over the chunk's spans in scan order into every span's h entry: a
//      span that does not start its chunk takes h from the fold of the
//      spans before it; a block on a whole chunk would need 8 times pass
//      3's registers.
//   3. span_output_kernel, same grid: per direction, one after the other
//      (u and the du sum stay in registers between them), the segment
//      summaries meet in shared memory, a thread folds the segments before
//      its own onto the span's h entry and adjoint entry, rebuilds h
//      forward and dh backward, and forms ddt, the du term and the dB/dC
//      and dA/dD/dbias terms. du is summed over both directions in
//      registers (fp32, forward first) and stored once in the operands'
//      dtype.
//   4. finish_kernel: the partial sums below, in a fixed order.
// Pass 3 is the kernel's time (two thirds of it), and a chain of
// latencies, not bytes or issue, binds it: h and dh are rebuilt in four
// dependent folds a direction with barriers between, and the lanes of a
// step are summed for dB/dC. So blocks are small and many: 4 steps a
// thread hold pass 3 at 64 registers (a 36-byte spill), four 256-thread
// blocks an SM. Measured on an H100 at the training shapes: 8 warps x 8
// steps with two blocks an SM took 1.17x the time, 16 x 4 or 4 x 4 1.06x;
// a serial sum of each step's lanes in place of the two-level one below
// added 0.35 ms to the 3 ms of a train step.
// No float is added atomically: dB/dC of one warp's step are summed over
// its lanes (each group's lanes apart) in a fixed order, per 32-lane slice,
// into scratch, and pass 4 sums a group's slices in slice order; dA/dD/
// dbias are summed over a block's segments in segment order into one
// partial per span, and pass 4 sums the spans in span order. Two runs on
// the same inputs give the same bits. Tokens beyond L are inert (dt = -inf
// gives a = 1, b = 0, sigmoid 0, and g = 0 there); lanes beyond M compute
// on a clamped lane and store nothing. A launch of one span (L <= 32) runs
// pass 3 alone from the checkpoint and a zero adjoint entry. Passes 1 and 3
// both read the operands: 26 bytes per (t, m) against the bound's 16.
#include <math.h>

#include "scan_common.cuh"

namespace {

using xp::ex2_approx;
using xp::from_f32;
using xp::kLog2e;
using xp::softplus_approx;
using xp::to_f32;

constexpr int kLanes = 32;          // lanes per block, a warp's width
constexpr int kWarps = 8;           // segments per span
constexpr int kSteps = 4;           // steps per segment
constexpr int kSpan = kWarps * kSteps;
constexpr int kCkptChunk = 256;     // the forward kernel's checkpoint chunk
constexpr int kSpansPerChunk = kCkptChunk / kSpan;
constexpr int kCarryRuns = 32;      // most runs of spans per lane in pass 2
constexpr int kSums = 6;            // P_f, H_f, E_f, P_r, H_r, E_r
constexpr int kBlocksPerSM = 4;     // passes 1 and 3: 64 registers a thread
static_assert(kCkptChunk % kSpan == 0, "spans tile a checkpoint chunk");
constexpr int kFinishThreads = 256;

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float sigmoid_approx(float x) {
  return rcp_approx(1.f + ex2_approx(-x * kLog2e));
}

template <typename T>
struct Operands {
  const T* u;
  const T* dt[2];
  const T* bc[2];
  const T* cc[2];
  const T* g[2];
  const float* hck[2];
  const float* A;
  const float* Dv;
  const float* bias;
  int L, M, Dim, n_spans;
};

template <typename T>
struct Outputs {
  T* du;
  T* ddt[2];
  T* dbcc;          // (4, L, G): dB_f, dB_r, dC_f, dC_r
  float* dconst;    // (6, M): dA_f, dD_f, dbias_f, dA_r, dD_r, dbias_r
};

// Scratch between the passes (fp32): span summaries (6, spans, M), the h
// and adjoint entries of every span (2, spans, M) each, the dA/dD/dbias
// partials (spans, 6, M) and the dB/dC partials (4, L, slices, J), J the
// most groups a 32-lane slice touches.
struct Scratch {
  float* sums;
  float* hent;
  float* eent;
  float* cpart;
  float* bcpart;
  int slices, J;
};

int groups_per_slice(int Dim) {
  return Dim % kLanes == 0 ? 1 : (Dim + kLanes - 2) / Dim + 1;
}

// One thread's lane (m clamped into the plane; live says whether it stores)
// and the lane constants of both directions.
struct Lane {
  int m, g;
  bool live;
  float A2[2], A[2], bias[2], D[2];
};

template <typename T>
__device__ __forceinline__ Lane lane_of(const Operands<T>& p) {
  Lane l;
  const int m = blockIdx.x * kLanes + threadIdx.x;
  l.live = m < p.M;
  l.m = min(m, p.M - 1);
  l.g = l.m / p.Dim;
  const int c = l.m % (2 * p.Dim);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l.A[r] = __ldg(p.A + 2 * r * p.Dim + c);
    l.A2[r] = l.A[r] * kLog2e;
    l.bias[r] = __ldg(p.bias + 2 * r * p.Dim + c);
    l.D[r] = __ldg(p.Dv + 2 * r * p.Dim + c);
  }
  return l;
}

// A thread's tokens t0 .. t0 + kS - 1: a token at or beyond L reads row
// L - 1 (a valid address; its values are discarded), so no load is
// predicated. e0 / s0 are the element offsets of row `first` in the (L, M)
// and (L, G) planes.
struct Rows {
  size_t e0, s0;
  int t0, first, last;
  __device__ __forceinline__ int row(int i) const {
    return min(t0 + i, last) - first;
  }
  __device__ __forceinline__ bool inside(int i) const {
    return t0 + i <= last;
  }
};

template <typename T>
__device__ __forceinline__ Rows rows_of(const Operands<T>& p, const Lane& l,
                                        int t0) {
  Rows r;
  r.t0 = t0;
  r.last = p.L - 1;
  r.first = min(t0, r.last);
  r.e0 = static_cast<size_t>(r.first) * p.M + l.m;
  r.s0 = static_cast<size_t>(r.first) * (p.M / p.Dim) + l.g;
  return r;
}

template <typename T, int kS>
__device__ __forceinline__ void load_u(const Operands<T>& p, const Rows& r,
                                       float (&uu)[kS]) {
  T ru[kS];
#pragma unroll
  for (int i = 0; i < kS; ++i) ru[i] = __ldg(p.u + r.e0 + r.row(i) * p.M);
#pragma unroll
  for (int i = 0; i < kS; ++i) uu[i] = to_f32(ru[i]);
}

// One direction's steps: delta, a, sigmoid(x), B, g (0 beyond L) and gC.
template <typename T, int kS, int kDir>
struct Steps {
  float delta[kS], a[kS], sig[kS], bv[kS], gv[kS], gc[kS];

  __device__ __forceinline__ void form(const Operands<T>& p, const Lane& l,
                                       const Rows& r, bool with_sig) {
    const int G = p.M / p.Dim;
    T rdt[kS], rg[kS], rb[kS], rc[kS];
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      rdt[i] = __ldg(p.dt[kDir] + r.e0 + r.row(i) * p.M);
      rg[i] = __ldg(p.g[kDir] + r.e0 + r.row(i) * p.M);
      rb[i] = __ldg(p.bc[kDir] + r.s0 + r.row(i) * G);
      rc[i] = __ldg(p.cc[kDir] + r.s0 + r.row(i) * G);
    }
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const float x =
          r.inside(i) ? to_f32(rdt[i]) + l.bias[kDir] : -INFINITY;
      delta[i] = softplus_approx(x);
      a[i] = ex2_approx(delta[i] * l.A2[kDir]);
      if (with_sig) sig[i] = sigmoid_approx(x);
      bv[i] = to_f32(rb[i]);
      gv[i] = r.inside(i) ? to_f32(rg[i]) : 0.f;
      gc[i] = gv[i] * to_f32(rc[i]);
    }
  }

  // step k of the scan order (forward lanes left to right) and of the
  // adjoint order (the opposite)
  static __device__ __forceinline__ int scan(int k) {
    return kDir == 0 ? k : kS - 1 - k;
  }
  static __device__ __forceinline__ int adjoint(int k) {
    return kDir == 0 ? kS - 1 - k : k;
  }

  // (product of a, h from a zero entry, e from a zero entry)
  __device__ __forceinline__ void summary(const float (&uu)[kS], float& P,
                                          float& H, float& E) const {
    P = 1.f;
    H = 0.f;
    E = 0.f;
#pragma unroll
    for (int k = 0; k < kS; ++k) {
      const int i = scan(k);
      H = a[i] * H + delta[i] * uu[i] * bv[i];
      P *= a[i];
    }
#pragma unroll
    for (int k = 0; k < kS; ++k) {
      const int i = adjoint(k);
      E = a[i] * (gc[i] + E);
    }
  }
};

// Segment j's position in direction kDir's scan order is before w's.
template <int kDir>
__device__ __forceinline__ bool scan_before(int j, int w) {
  return kDir == 0 ? j < w : j > w;
}

template <typename T>
__global__ void __launch_bounds__(kLanes * kWarps, kBlocksPerSM)
span_summary_kernel(Operands<T> p, float* __restrict__ sums) {
  __shared__ float seg[kSums][kWarps][kLanes];
  const Lane l = lane_of(p);
  const int w = threadIdx.y;
  const int lane = threadIdx.x;
  const int s = blockIdx.y;
  const Rows r = rows_of(p, l, s * kSpan + w * kSteps);
  float uu[kSteps];
  load_u<T, kSteps>(p, r, uu);
  {
    Steps<T, kSteps, 0> f;
    f.form(p, l, r, false);
    f.summary(uu, seg[0][w][lane], seg[1][w][lane], seg[2][w][lane]);
  }
  {
    Steps<T, kSteps, 1> b;
    b.form(p, l, r, false);
    b.summary(uu, seg[3][w][lane], seg[4][w][lane], seg[5][w][lane]);
  }
  __syncthreads();
  if (!l.live) return;
  // fold q = 0: forward (P, H) in scan order, q = 1: forward E in adjoint
  // order, q = 2 and 3 the same for the reversed lanes; warp w folds q = w,
  // w + kWarps, ...
  const size_t plane = static_cast<size_t>(p.n_spans) * p.M;
  const size_t at = static_cast<size_t>(s) * p.M + l.m;
  for (int q = w; q < 4; q += kWarps) {
    const int dir = q / 2;
    const bool adj = q % 2 == 1;
    const bool ascending = (dir == 0) != adj;
    float prod = 1.f, x = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      const int j = ascending ? k : kWarps - 1 - k;
      const float a = seg[3 * dir][j][lane];
      x = a * x + seg[3 * dir + (adj ? 2 : 1)][j][lane];
      prod *= a;
    }
    if (adj) {
      sums[(3 * dir + 2) * plane + at] = x;
    } else {
      sums[3 * dir * plane + at] = prod;
      sums[(3 * dir + 1) * plane + at] = x;
    }
  }
}

// Pass 2. A block owns 32 lanes of one direction; thread (lane, j) the j-th
// of blockDim.y <= 32 runs of spans in adjoint order: it composes its run,
// the run summaries meet in shared memory, it folds the runs before its own
// and replays its run, writing each span's adjoint entry. Then thread j
// carries the checkpoints of chunks j, j + runs, ... over their spans in
// scan order, writing each span's h entry.
__global__ void __launch_bounds__(kLanes * kCarryRuns)
span_carry_kernel(const float* __restrict__ sums,
                  const float* __restrict__ hck_f,
                  const float* __restrict__ hck_r, float* __restrict__ hent,
                  float* __restrict__ eent, int n_spans, int M) {
  __shared__ float run_a[kCarryRuns][kLanes];
  __shared__ float run_e[kCarryRuns][kLanes];
  const int lane = threadIdx.x;
  const int j = threadIdx.y;
  const int m = blockIdx.x * kLanes + lane;
  const bool live = m < M;
  const int dir = blockIdx.y;
  const size_t plane = static_cast<size_t>(n_spans) * M;
  const float* __restrict__ pP = sums + 3 * dir * plane + min(m, M - 1);
  const float* __restrict__ pH = pP + plane;
  const float* __restrict__ pE = pP + 2 * plane;
  const int runs = blockDim.y;
  const int per = (n_spans + runs - 1) / runs;
  const int k0 = min(j * per, n_spans);
  const int k1 = min(k0 + per, n_spans);
  // adjoint order: forward lanes from the last span, reversed from the first
  float prod = 1.f, x = 0.f;
  for (int k = k0; k < k1; ++k) {
    const size_t at = static_cast<size_t>(dir == 0 ? n_spans - 1 - k : k) * M;
    const float a = __ldg(pP + at);
    x = a * x + __ldg(pE + at);
    prod *= a;
  }
  run_a[j][lane] = prod;
  run_e[j][lane] = x;
  __syncthreads();
  x = 0.f;
#pragma unroll
  for (int i = 0; i < kCarryRuns; ++i)
    if (i < j) x = run_a[i][lane] * x + run_e[i][lane];
  if (!live) return;
  float* __restrict__ pe = eent + dir * plane + m;
  for (int k = k0; k < k1; ++k) {
    const size_t at = static_cast<size_t>(dir == 0 ? n_spans - 1 - k : k) * M;
    pe[at] = x;
    x = __ldg(pP + at) * x + __ldg(pE + at);
  }
  const float* __restrict__ hck = (dir == 0 ? hck_f : hck_r) + m;
  float* __restrict__ ph = hent + dir * plane + m;
  const int n_chunks = (n_spans + kSpansPerChunk - 1) / kSpansPerChunk;
  for (int c = j; c < n_chunks; c += runs) {
    const int s0 = c * kSpansPerChunk;
    const int n = min(kSpansPerChunk, n_spans - s0);
    x = __ldg(hck + static_cast<size_t>(c) * M);
    for (int i = 0; i < n; ++i) {
      const size_t at = static_cast<size_t>(dir == 0 ? s0 + i
                                                     : s0 + n - 1 - i) * M;
      ph[at] = x;
      x = __ldg(pP + at) * x + __ldg(pH + at);
    }
  }
}

// One direction of pass 3 for one thread: h and dh rebuilt over its
// segment, ddt stored, the du term added into du, the dB/dC terms summed
// over the warp's lanes into scratch, dA/dD/dbias into acc.
template <typename T, int kS, int kDir>
__device__ __forceinline__ void output_direction(
    const Operands<T>& p, const Outputs<T>& o, const Scratch& sc,
    const Lane& l, const Rows& r, const float (&uu)[kS], float (&du)[kS],
    float (&acc)[3], float (&seg)[3][kWarps][kLanes],
    float (&red)[2][kS][kLanes + 1]) {
  const int w = threadIdx.y;
  const int lane = threadIdx.x;
  const int s = blockIdx.y;
  Steps<T, kS, kDir> st;
  st.form(p, l, r, true);
  st.summary(uu, seg[0][w][lane], seg[1][w][lane], seg[2][w][lane]);
  __syncthreads();
  float h, e = 0.f;
  if (p.n_spans > 1) {
    const size_t at =
        (static_cast<size_t>(kDir) * p.n_spans + s) * p.M + l.m;
    h = __ldg(sc.hent + at);
    e = __ldg(sc.eent + at);
  } else {
    h = __ldg(p.hck[kDir] + l.m);
  }
  // the segments before this one: in scan order onto h, in adjoint order
  // onto e
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    const int jh = kDir == 0 ? k : kWarps - 1 - k;
    const int je = kWarps - 1 - jh;
    if (scan_before<kDir>(jh, w)) h = seg[0][jh][lane] * h + seg[1][jh][lane];
    if (scan_before<kDir>(w, je)) e = seg[0][je][lane] * e + seg[2][je][lane];
  }
  const float h_in = h;
  float hv[kS];
#pragma unroll
  for (int k = 0; k < kS; ++k) {
    const int i = st.scan(k);
    h = st.a[i] * h + st.delta[i] * uu[i] * st.bv[i];
    hv[i] = h;
  }
  T* __restrict__ pddt = o.ddt[kDir] + r.e0;
  float dA = 0.f, dD = 0.f, dbias = 0.f;
#pragma unroll
  for (int k = 0; k < kS; ++k) {
    const int i = st.adjoint(k);
    const float dh = st.gc[i] + e;
    e = st.a[i] * dh;
    const float hp = kDir == 0 ? (i > 0 ? hv[i - 1] : h_in)
                               : (i < kS - 1 ? hv[i + 1] : h_in);
    const float da = dh * hp;
    const float ddt = (dh * uu[i] * st.bv[i] + da * l.A[kDir] * st.a[i])
                      * st.sig[i];
    dA += da * st.a[i] * st.delta[i];
    dD += st.gv[i] * uu[i];
    dbias += ddt;
    const float term = st.gv[i] * l.D[kDir] + dh * st.delta[i] * st.bv[i];
    du[i] = kDir == 0 ? term : du[i] + term;
    red[0][i][lane] = l.live ? dh * st.delta[i] * uu[i] : 0.f;
    red[1][i][lane] = l.live ? st.gv[i] * hv[i] : 0.f;
    if (l.live && r.inside(i)) pddt[r.row(i) * p.M] = from_f32<T>(ddt);
  }
  acc[0] = dA;
  acc[1] = dD;
  acc[2] = dbias;
  __syncwarp();
  // dB (q = 0) and dC (q = 1) of step i summed over the warp's lanes: one
  // partial per group the 32-lane slice touches
  if (p.Dim % kLanes == 0) {
    // the slice lies in one group (J = 1, every flagship width): row
    // (q, i) = lane % 2 kS is summed in 32 / 2kS parts of 2 kS lanes, one
    // part a thread, and the parts are added by shuffles in a fixed order
    constexpr int kRows = 2 * kS;
    const int row = lane % kRows;
    const int part = lane / kRows;
    const int q = row / kS;
    const int i = row % kS;
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < kRows; ++k) sum += red[q][i][part * kRows + k];
#pragma unroll
    for (int o = kLanes / 2; o >= kRows; o >>= 1)
      sum += __shfl_down_sync(0xffffffffu, sum, o);
    if (part == 0 && r.inside(i))
      sc.bcpart[(static_cast<size_t>(2 * q + kDir) * p.L + r.t0 + i) *
                    sc.slices + blockIdx.x] = sum;
  } else if (lane < 2 * kS) {
    // in lane order, a partial closed at each group's end
    const int q = lane / kS;
    const int i = lane % kS;
    if (r.inside(i)) {
      const int t = r.t0 + i;
      const int m0 = blockIdx.x * kLanes;
      const int n_live = min(kLanes, p.M - m0);
      float* __restrict__ part =
          sc.bcpart +
          ((static_cast<size_t>(2 * q + kDir) * p.L + t) * sc.slices +
           blockIdx.x) * sc.J;
      int next = (m0 / p.Dim + 1) * p.Dim;    // first lane of the next group
      int j = 0;
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < kLanes; ++k) {
        if (k < n_live) {
          sum += red[q][i][k];
          if (m0 + k + 1 == next || k == n_live - 1) {
            part[j++] = sum;
            sum = 0.f;
            next += p.Dim;
          }
        }
      }
    }
  }
  __syncwarp();
}

template <typename T>
__global__ void __launch_bounds__(kLanes * kWarps, kBlocksPerSM)
span_output_kernel(Operands<T> p, Outputs<T> o, Scratch sc) {
  constexpr int kS = kSteps;
  __shared__ float seg[2][3][kWarps][kLanes];
  __shared__ float red[kWarps][2][kS][kLanes + 1];
  const Lane l = lane_of(p);
  const int w = threadIdx.y;
  const int lane = threadIdx.x;
  const int s = blockIdx.y;
  const Rows r = rows_of(p, l, s * (kWarps * kS) + w * kS);
  float uu[kS], du[kS], acc_f[3], acc_r[3];
  load_u<T, kS>(p, r, uu);
  output_direction<T, kS, 0>(p, o, sc, l, r, uu, du, acc_f, seg[0], red[w]);
  output_direction<T, kS, 1>(p, o, sc, l, r, uu, du, acc_r, seg[1], red[w]);
  if (l.live) {
    T* __restrict__ pdu = o.du + r.e0;
#pragma unroll
    for (int i = 0; i < kS; ++i)
      if (r.inside(i)) pdu[r.row(i) * p.M] = from_f32<T>(du[i]);
  }
  // dA/dD/dbias over the block's segments in segment order: one partial
  // per span and lane
  __syncthreads();
  // seg viewed as [6][kWarps][kLanes]
  float(*cf)[kWarps][kLanes] =
      reinterpret_cast<float(*)[kWarps][kLanes]>(&seg[0][0][0][0]);
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    cf[q][w][lane] = acc_f[q];
    cf[3 + q][w][lane] = acc_r[q];
  }
  __syncthreads();
  if (!l.live) return;
  for (int q = w; q < kSums; q += kWarps) {
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) sum += cf[q][j][lane];
    sc.cpart[(static_cast<size_t>(s) * kSums + q) * p.M + l.m] = sum;
  }
}

// Pass 4: dconst (6, M) = the span partials summed in span order; compact
// dB/dC (4, L, G) = each group's slice partials summed in slice order and
// rounded once to the operands' dtype.
template <typename T>
__global__ void __launch_bounds__(kFinishThreads)
finish_kernel(Outputs<T> o, Scratch sc, int L, int M, int Dim,
              int n_spans) {
  const size_t idx =
      static_cast<size_t>(blockIdx.x) * kFinishThreads + threadIdx.x;
  const size_t n_const = static_cast<size_t>(kSums) * M;
  const int G = M / Dim;
  if (idx < n_const) {
    const int q = static_cast<int>(idx / M);
    const int m = static_cast<int>(idx % M);
    float sum = 0.f;
    for (int s = 0; s < n_spans; ++s)
      sum += sc.cpart[(static_cast<size_t>(s) * kSums + q) * M + m];
    o.dconst[idx] = sum;
    return;
  }
  const size_t k = idx - n_const;                 // (q, t, g) flat
  if (k >= static_cast<size_t>(4) * L * G) return;
  const int g = static_cast<int>(k % G);
  const size_t qt = k / G;                        // q * L + t
  const int first = g * Dim / kLanes;
  const int last = ((g + 1) * Dim - 1) / kLanes;
  const float* __restrict__ part =
      sc.bcpart + qt * sc.slices * sc.J;
  float sum = 0.f;
  for (int bx = first; bx <= last; ++bx)
    sum += part[static_cast<size_t>(bx) * sc.J + (g - bx * kLanes / Dim)];
  o.dbcc[k] = from_f32<T>(sum);
}

size_t n_spans_of(int L) { return (L + kSpan - 1) / kSpan; }

template <typename T>
int launch(const Operands<T>& p, const Outputs<T>& o, float* scratch,
           cudaStream_t stream) {
  const int L = p.L, M = p.M, Dim = p.Dim, ns = p.n_spans;
  const size_t plane = static_cast<size_t>(ns) * M;
  Scratch sc;
  sc.slices = (M + kLanes - 1) / kLanes;
  sc.J = groups_per_slice(Dim);
  const bool multi = ns > 1;
  sc.sums = multi ? scratch : nullptr;
  sc.hent = multi ? scratch + kSums * plane : nullptr;
  sc.eent = multi ? sc.hent + 2 * plane : nullptr;
  sc.cpart = scratch + (multi ? (kSums + 4) * plane : 0);
  sc.bcpart = sc.cpart + kSums * plane;
  const dim3 block(kLanes, kWarps);
  const dim3 grid(sc.slices, ns);
  if (multi) {
    span_summary_kernel<T><<<grid, block, 0, stream>>>(p, sc.sums);
    span_carry_kernel<<<dim3(sc.slices, 2),
                        dim3(kLanes, ns < kCarryRuns ? ns : kCarryRuns), 0,
                        stream>>>(sc.sums, p.hck[0], p.hck[1], sc.hent,
                                  sc.eent, ns, M);
  }
  span_output_kernel<T><<<grid, block, 0, stream>>>(p, o, sc);
  const size_t items = static_cast<size_t>(kSums) * M +
                       static_cast<size_t>(4) * L * (M / Dim);
  finish_kernel<T><<<static_cast<unsigned>(
                         (items + kFinishThreads - 1) / kFinishThreads),
                     kFinishThreads, 0, stream>>>(o, sc, L, M, Dim, ns);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(const void* u, const void* dt_f, const void* dt_r,
                 const void* bc_f, const void* cc_f, const void* bc_r,
                 const void* cc_r, const void* g_f, const void* g_r,
                 const float* hck_f, const float* hck_r, const float* A,
                 const float* Dv, const float* bias, void* du, void* ddt_f,
                 void* ddt_r, void* dbcc, float* dconst, float* scratch,
                 int L, int M, int Dim, cudaStream_t stream) {
  const auto in = [](const void* x) { return static_cast<const T*>(x); };
  const Operands<T> p{in(u), {in(dt_f), in(dt_r)}, {in(bc_f), in(bc_r)},
                      {in(cc_f), in(cc_r)}, {in(g_f), in(g_r)},
                      {hck_f, hck_r}, A, Dv, bias, L, M, Dim,
                      static_cast<int>(n_spans_of(L))};
  const Outputs<T> o{static_cast<T*>(du),
                     {static_cast<T*>(ddt_f), static_cast<T*>(ddt_r)},
                     static_cast<T*>(dbcc), dconst};
  return launch<T>(p, o, scratch, stream);
}

}  // namespace

// The fp32 values of scratch a call with these L, M and Dim needs.
extern "C" long long xp_selective_scan_bidir_bwd_scratch(int L, int M,
                                                         int Dim) {
  const long long ns = static_cast<long long>(n_spans_of(L));
  const long long slices = (M + kLanes - 1) / kLanes;
  return (ns > 1 ? (kSums + 4) * ns * M : 0) + kSums * ns * M +
         4LL * L * slices * groups_per_slice(Dim);
}

// dtype: 0 = float32, 1 = bfloat16 (u, dt, bc, cc, g and the outputs du,
// ddt, dbcc share it). du, ddt_f, ddt_r: (L, M); dbcc: (4, L, M / Dim) =
// dB_f, dB_r, dC_f, dC_r; dconst: fp32 (2, 3, M) = [direction][dA, dD,
// dbias][lane]; scratch: fp32, xp_selective_scan_bidir_bwd_scratch(L, M,
// Dim) values. Every output is written; nothing needs zeroing.
extern "C" int xp_selective_scan_bidir_bwd(
    int dtype, const void* u, const void* dt_f, const void* dt_r,
    const void* bc_f, const void* cc_f, const void* bc_r, const void* cc_r,
    const void* g_f, const void* g_r, const float* hck_f, const float* hck_r,
    const float* A, const float* Dv, const float* bias, void* du,
    void* ddt_f, void* ddt_r, void* dbcc, float* dconst, float* scratch,
    int L, int M, int Dim, void* stream) {
  if (L <= 0 || M <= 0 || Dim <= 0 || M % (2 * Dim) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M > (1 << 26) || n_spans_of(L) > 65535 || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_typed<float>(u, dt_f, dt_r, bc_f, cc_f, bc_r, cc_r, g_f,
                               g_r, hck_f, hck_r, A, Dv, bias, du, ddt_f,
                               ddt_r, dbcc, dconst, scratch, L, M, Dim, s);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(u, dt_f, dt_r, bc_f, cc_f, bc_r, cc_r,
                                       g_f, g_r, hck_f, hck_r, A, Dv, bias,
                                       du, ddt_f, ddt_r, dbcc, dconst,
                                       scratch, L, M, Dim, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* xp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
