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
// Design: one launch, spans chained by a carry handed from block to block
// (the TPU kernel walks L in 256-token chunks in order with its carry in
// VMEM; here every span is worked on at once and only the carry waits).
// The recurrence is associative, (A1, H1) then (A2, H2) = (A1 A2, A2 H1 +
// H2). A scan of more than 64 tokens runs bidir_chain_kernel on spans of
// T = 128 tokens (two to a checkpoint chunk); a shorter one, a single span,
// runs bidir_span_kernel.
//   Blocks of bidir_chain_kernel: 32 neighbouring lanes x 9 warps, 8 scan
//   warps (warp w the segment of steps 16 w .. 16 w + 15 of the span) and
//   one chain warp; a block does ONE direction of one span. The scan warps
//   copy the span's u and dt into shared memory with cp.async (16 bytes a
//   copy where every row is 16-byte aligned, else 4) and its B and C, form
//   (a, b) of their steps once (one softplus and one exp a step), compose
//   each segment's (product of a, h from a zero entry) in scan order and,
//   once the 8 summaries are shared, replay their steps from a zero span
//   entry: h0 (the segments before theirs folded from zero) and the product
//   P of a since the span's start, keeping y0 = C h0 + D u and C P in the
//   registers that held a and b. Meanwhile the chain warp folds the
//   summaries into the span's (A, H), publishes them, waits for the span's
//   entry e, publishes its exit and writes the checkpoint where a 256-token
//   chunk is entered. Then y = y0 + C P e (h = h0 + P e) is stored straight
//   from registers: the chain's wait overlaps the replay instead of
//   stopping the block. __launch_bounds__(288, 4): at most 56 registers.
//   bidir_span_kernel (L <= 64; no chain, no ticket): block i does both
//   directions of lane group i, forward on warps 0 .. 7 and reversed on
//   warps 8 .. 15 (4 or 8 steps a thread) at once, loading straight into
//   registers, with one barrier between the segment summaries and the
//   replay: at such lengths latency, not bytes, sets the time.
//   Bytes per (t, m): each direction reads u and its own dt once and
//   writes its y: 6 bytes a direction, 12 against the bound's 10 (u is read
//   by both directions, whose chains run in opposite orders). The
//   three-pass design this replaces read 16 and evaluated softplus and exp
//   twice.
//   The chain and its tickets. The grid holds 2 x groups x spans blocks;
//   blockIdx.x & 1 is the direction, and each direction hands out its
//   work from its own atomic ticket, in the order the blocks start: ticket
//   t is chain position k = t / groups of lane group t % groups, and
//   position k is span k on forward lanes and span spans - 1 - k on
//   reversed lanes (the two chains run in opposite orders). A block waits
//   only for lower positions of its own chain, which hold lower tickets of
//   its direction, drawn by blocks that have started: the oldest block
//   still waiting always waits on finished blocks, so the launch finishes
//   whatever the grid is against the resident set. The block that draws a
//   direction's last ticket sets it back to 0 for the next call.
//   Composition order. Position k needs entry(k) = exit(k - 1), with
//   exit(k) = A(k) entry(k) + H(k) as one fmaf. The chain warp reads
//   exit(k - K) (K = 4; zero when k < K) and the summaries of positions
//   k - K + 1 .. k - 1, and folds them in position order: exactly the fmafs
//   of the strict chain entry(k) = A(k-1) entry(k-1) + H(k-1) from
//   exit(k - K), so every entry has the bits of the strict chain whatever
//   the timing (no decoupled look-back: a block never takes whichever
//   predecessor happens to be done). The chain's critical path is spans / K
//   hops instead of spans, and two runs give the same bits, as every sum
//   in a block is taken in a fixed order too.
//   Memory ordering (the helpers live in scan_chain.cuh, shared with the
//   backward). A published value and its flag are one 64-bit word:
//   the call's tag (high 32 bits, never 0) and the fp32 value (low 32
//   bits), stored with st.relaxed.gpu.b64 and polled with
//   ld.relaxed.gpu.b64 (__nanosleep between polls), both single-copy
//   atomic at device scope: a reader that sees the tag sees the value of
//   the same store, and nothing else is read through the chain, so no
//   fence or release / acquire pair is needed. Tickets are atomicAdd /
//   atomicExch on their own words.
//   Workspace. The wrapper passes a zeroed buffer it keeps per device and
//   stream (xp_selective_scan_bidir_workspace words of 64 bits: the two
//   tickets, then per direction, position and lane the words A, H and
//   exit) and a tag one higher than the last call on that buffer's
//   stream. Calls on one stream run one after another, so no two calls
//   have live words in one buffer, and a word left by an earlier call
//   carries an older tag and is never taken; calls on other streams have
//   other buffers. Nothing is cleared between calls (no memset launch, no
//   host synchronisation); the wrapper hands out a fresh zeroed buffer
//   before the 32-bit tag wraps.
// Tokens beyond L are inert (dt = -inf gives a = 1, b = 0); lanes beyond M
// (M need not be a multiple of 32) compute on lane M - 1's constants and
// zeros, keep their own chain words and store nothing. Nothing divides, so
// a product of a that underflows to 0 is harmless.
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "scan_chain.cuh"
#include "scan_common.cuh"

namespace {

using xp::barrier;
using xp::copy_async;
using xp::ex2_approx;
using xp::from_f32;
using xp::kLog2e;
using xp::prepare;
using xp::publish;
using xp::softplus_approx;
using xp::to_f32;
using xp::wait_async;

constexpr int kLanes = 32;          // lanes per block, a warp's width
constexpr int kWarps = 8;           // segments per span: the scan warps
constexpr int kScanThreads = kLanes * kWarps;
constexpr int kThreads = kScanThreads + kLanes;     // and the chain warp
constexpr int kMaxSteps = 16;       // steps per segment
constexpr int kSpan = kWarps * kMaxSteps;
constexpr int kCkptChunk = 256;     // checkpoint chunk (the JAX DEFAULT_CHUNK)
constexpr int kSpansPerChunk = kCkptChunk / kSpan;
constexpr int kLookback = 4;        // K: a block waits for exit(k - K)
constexpr int kBlocksPerSM = 4;
constexpr int kTicketWords = 2;     // the two tickets, padded to 16 bytes

template <typename T>
struct Operands {
  const T* u;
  const T* dt[2];
  const T* bc[2];
  const T* cc[2];
  const float* A;
  const float* Dv;
  const float* bias;
  T* y[2];
  float* hck[2];
  int L, M, Dim;
  int max_groups;       // most groups 32 neighbouring lanes touch
};

// The chain words: A, H and exit, each (2, spans, groups * 32) words of
// (tag << 32 | fp32 bits), indexed by direction, chain position, lane.
struct Chain {
  unsigned* tickets;
  unsigned long long* agg_a;
  unsigned long long* agg_h;
  unsigned long long* exit;
  unsigned tag;
  int spans, groups;
};

// A bidir_chain_kernel block's dynamic shared memory: the (span, 32) tiles
// of u and dt and the (span, max_groups) tiles of B and C.
template <typename T>
struct Tiles {
  T* u;
  T* dt;
  T* bc;
  T* cc;
  __device__ __forceinline__ Tiles(unsigned char* base, int max_groups) {
    u = reinterpret_cast<T*>(base);
    dt = u + kSpan * kLanes;
    bc = dt + kSpan * kLanes;
    cc = bc + kSpan * max_groups;
  }
  static size_t bytes(int max_groups) {
    return sizeof(T) * 2 * static_cast<size_t>(kSpan) * (kLanes + max_groups);
  }
};

struct Shared {
  float seg_a[2][kWarps][kLanes];   // segment summaries, per direction
  float seg_h[2][kWarps][kLanes];
  float entry[kLanes];
  int ticket;
};

// One span of 32 lanes: first token t0, first lane m0, and the groups
// g_lo .. g_lo + n_g - 1 its lanes belong to.
struct Span {
  int t0, m0, g_lo, n_g;
};

template <typename T>
__device__ __forceinline__ Span span_of(const Operands<T>& p, int s,
                                        int group) {
  Span x;
  x.t0 = s * kSpan;
  x.m0 = group * kLanes;
  x.g_lo = x.m0 / p.Dim;
  x.n_g = (min(x.m0 + kLanes, p.M) - 1) / p.Dim - x.g_lo + 1;
  return x;
}

// Rows t0 .. t0 + 127 (clamped to the scan) of lanes m0 .. m0 + 31 of an
// (L, M) plane into a (span, 32) tile, kChunk bytes a copy, by the scan
// warps; rows beyond L and lanes beyond M are zero.
template <typename T, int kChunk>
__device__ __forceinline__ void stage_plane(T* tile, const T* plane,
                                            const Operands<T>& p,
                                            const Span& x) {
  constexpr int kPer = kChunk / static_cast<int>(sizeof(T));
  constexpr int kPerRow = kLanes / kPer;
  const int tid = threadIdx.y * kLanes + threadIdx.x;
  for (int c = tid; c < kSpan * kPerRow; c += kScanThreads) {
    const int t = c / kPerRow;
    const int m = x.m0 + (c % kPerRow) * kPer;
    const bool valid = x.t0 + t < p.L && m < p.M;
    const T* src = plane + static_cast<size_t>(min(x.t0 + t, p.L - 1)) * p.M +
                   (valid ? m : 0);
    copy_async<kChunk>(tile + t * kLanes + (m - x.m0), src, valid);
  }
}

// The span's B and C of direction dir into their tiles, by the scan warps.
template <typename T>
__device__ __forceinline__ void stage_compact(const Tiles<T>& tl,
                                              const Operands<T>& p,
                                              const Span& x, int dir) {
  const int tid = threadIdx.y * kLanes + threadIdx.x;
  const int G = p.M / p.Dim;
  for (int i = tid; i < kSpan * x.n_g; i += kScanThreads) {
    const int t = i / x.n_g;
    const int j = i - t * x.n_g;
    const size_t at =
        static_cast<size_t>(min(x.t0 + t, p.L - 1)) * G + x.g_lo + j;
    tl.bc[t * p.max_groups + j] = __ldg(p.bc[dir] + at);
    tl.cc[t * p.max_groups + j] = __ldg(p.cc[dir] + at);
  }
}

// A scan thread's steps of one direction: the lane's constants (m clamped
// into the plane: spare lanes compute on zeros and store nothing; A
// premultiplied by log2(e)), then (a, b) of each step, formed once (a
// token beyond L takes dt = -inf: delta = 0, the inert (a, b) = (1, 0)),
// and the segment's (product of a, h from a zero entry) in scan order
// into the shared summaries.
template <typename T, bool kFull, bool kRev>
struct Steps {
  static constexpr int dir = kRev ? 1 : 0;
  static constexpr int kSteps = kMaxSteps;
  float a[kSteps], b[kSteps];
  float Dv;
  int gl, r0;

  __device__ __forceinline__ void form(const Operands<T>& p, const Span& x,
                                       const Tiles<T>& tl, Shared& sh,
                                       int w) {
    const int lane = threadIdx.x;
    const int m = min(x.m0 + lane, p.M - 1);
    gl = m / p.Dim - x.g_lo;
    const int cix = dir * 2 * p.Dim + m % (2 * p.Dim);
    const float A2 = __ldg(p.A + cix) * kLog2e;
    const float bias = __ldg(p.bias + cix);
    Dv = __ldg(p.Dv + cix);
    r0 = w * kSteps;
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int t = r0 + i;
      const bool inside = kFull || x.t0 + t < p.L;
      const float d = softplus_approx(
          inside ? to_f32(tl.dt[t * kLanes + lane]) + bias : -INFINITY);
      a[i] = ex2_approx(d * A2);
      b[i] = d * to_f32(tl.u[t * kLanes + lane]) *
             to_f32(tl.bc[t * p.max_groups + gl]);
    }
    float pa = 1.f, h = 0.f;
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int i = kRev ? kSteps - 1 - j : j;
      h = fmaf(a[i], h, b[i]);
      pa *= a[i];
    }
    sh.seg_a[dir][w][lane] = pa;
    sh.seg_h[dir][w][lane] = h;
  }

  // The replay from a zero span entry, once the summaries are shared: h0
  // from the segments before this one folded from (1, 0), P the product of
  // a since the span's start; a[i] takes y0 = C h0 + D u and b[i] takes
  // C P, so that y = y0 + C P e for the span's entry e (h = h0 + P e).
  __device__ __forceinline__ void replay_from_zero(const Operands<T>& p,
                                                   const Tiles<T>& tl,
                                                   const Shared& sh, int w) {
    const int lane = threadIdx.x;
    float h = 0.f, P = 1.f;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) {
      const int q = kRev ? kWarps - 1 - j : j;
      if (kRev ? q > w : q < w) {
        h = fmaf(sh.seg_a[dir][q][lane], h, sh.seg_h[dir][q][lane]);
        P *= sh.seg_a[dir][q][lane];
      }
    }
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int i = kRev ? kSteps - 1 - j : j;
      const int t = r0 + i;
      h = fmaf(a[i], h, b[i]);
      P *= a[i];
      const float c = to_f32(tl.cc[t * p.max_groups + gl]);
      a[i] = c * h + Dv * to_f32(tl.u[t * kLanes + lane]);
      b[i] = c * P;
    }
  }

  // y = y0 + C P e of the live lanes' steps inside the scan, stored
  // straight from registers (a warp's 32 lanes are neighbours in a row).
  __device__ __forceinline__ void store_y(const Operands<T>& p,
                                         const Span& x, float e) const {
    const int m = x.m0 + threadIdx.x;
    if (m >= p.M) return;
    T* y = p.y[dir] + m;
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int t = x.t0 + r0 + i;
      if (kFull || t < p.L)
        y[static_cast<size_t>(t) * p.M] = from_f32<T>(fmaf(b[i], e, a[i]));
    }
  }
};

// One direction (kRev: reversed lanes, right to left) of span s, chain
// position k, lane group `group`: the scan warps form the steps and replay
// them from a zero entry while the chain warp folds the segment summaries,
// publishes the span's summary, waits for its entry and publishes its
// exit; then y = y0 + C P e.
template <typename T, int kChunk, bool kFull, bool kRev>
__device__ __forceinline__ void chain_span(const Operands<T>& p,
                                           const Chain& c, Shared& sh,
                                           const Tiles<T>& tl, int group,
                                           int k, int s) {
  constexpr int dir = kRev ? 1 : 0;
  const Span x = span_of(p, s, group);
  const bool scan_warp = threadIdx.y < kWarps;
  if (scan_warp) {
    stage_plane<T, kChunk>(tl.u, p.u, p, x);
    stage_plane<T, kChunk>(tl.dt, p.dt[dir], p, x);
    stage_compact(tl, p, x, dir);
    wait_async();
  }
  __syncthreads();
  if (scan_warp) {
    Steps<T, kFull, kRev> st;
    st.form(p, x, tl, sh, threadIdx.y);
    barrier<1, kThreads>();                            // summaries shared
    st.replay_from_zero(p, tl, sh, threadIdx.y);
    barrier<1, kThreads>();                            // entry known
    st.store_y(p, x, sh.entry[threadIdx.x]);
  } else {
    barrier<1, kThreads>();
    const int lane = threadIdx.x;
    float A = 1.f, H = 0.f;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) {
      const int q = kRev ? kWarps - 1 - j : j;
      H = fmaf(sh.seg_a[dir][q][lane], H, sh.seg_h[dir][q][lane]);
      A *= sh.seg_a[dir][q][lane];
    }
    const size_t plane = static_cast<size_t>(c.groups) * kLanes;
    const size_t lane_at =
        static_cast<size_t>(dir) * c.spans * plane + x.m0 + lane;
    const size_t at = lane_at + static_cast<size_t>(k) * plane;
    if (k + 1 < c.spans) {
      publish(c.agg_a + at, c.tag, A);
      publish(c.agg_h + at, c.tag, H);
    }
    const float e = xp::chain_entry<kLookback>(c.agg_a, c.agg_h, c.exit,
                                                 c.tag, lane_at, plane, k);
    if (k + kLookback < c.spans) publish(c.exit + at, c.tag, fmaf(A, e, H));
    sh.entry[lane] = e;
    // the span through which a chunk is entered: its first from the left,
    // its last (or the scan's last) from the right
    const bool enters_chunk =
        kRev ? (s % kSpansPerChunk == kSpansPerChunk - 1 || k == 0)
             : s % kSpansPerChunk == 0;
    if (enters_chunk && x.m0 + lane < p.M)
      p.hck[dir][static_cast<size_t>(s / kSpansPerChunk) * p.M + x.m0 +
                 lane] = e;
    barrier<1, kThreads>();
  }
}

// Block (32 lanes) x (8 scan warps + 1 chain warp) of a scan of several
// spans: blockIdx.x & 1 is the direction, and the block's span and lane
// group come from the direction's ticket.
template <typename T, int kChunk>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
bidir_chain_kernel(Operands<T> p, Chain c) {
  __shared__ Shared sh;
  extern __shared__ __align__(16) unsigned char dyn[];
  const Tiles<T> tl(dyn, p.max_groups);
  const int dir = blockIdx.x & 1;
  if (threadIdx.x == 0 && threadIdx.y == kWarps) {
    const unsigned per_dir =
        static_cast<unsigned>(c.groups) * static_cast<unsigned>(c.spans);
    const unsigned t = atomicAdd(c.tickets + dir, 1u);
    if (t == per_dir - 1) atomicExch(c.tickets + dir, 0u);
    sh.ticket = static_cast<int>(t);
  }
  __syncthreads();
  const int k = sh.ticket / c.groups;
  const int group = sh.ticket - k * c.groups;
  const int s = dir ? c.spans - 1 - k : k;
  const bool full = (s + 1) * kSpan <= p.L;
  if (dir == 0) {
    if (full)
      chain_span<T, kChunk, true, false>(p, c, sh, tl, group, k, s);
    else
      chain_span<T, kChunk, false, false>(p, c, sh, tl, group, k, s);
  } else {
    if (full)
      chain_span<T, kChunk, true, true>(p, c, sh, tl, group, k, s);
    else
      chain_span<T, kChunk, false, true>(p, c, sh, tl, group, k, s);
  }
}

// A scan of at most 64 tokens (one span: no chain, both entries zero, no
// ticket): block i does both directions of lane group i, the forward ones
// on warps 0 .. 7 and the reversed ones on warps 8 .. 15 at once. So little
// work a block has that latency rules: a thread loads its steps into
// registers (u, dt, B and C, all loads in flight together), forms (a, b)
// as the scan warps of bidir_chain_kernel do, and after one barrier
// replays from the segments before its own and stores y.
template <typename T, int kSteps, bool kFull, bool kRev>
__device__ __forceinline__ void one_span(const Operands<T>& p, Shared& sh,
                                         int w) {
  constexpr int dir = kRev ? 1 : 0;
  const int lane = threadIdx.x;
  const int m0 = blockIdx.x * kLanes;
  const int m = min(m0 + lane, p.M - 1);
  const bool live = m0 + lane < p.M;
  const int G = p.M / p.Dim;
  const int g = m / p.Dim;
  const int cix = dir * 2 * p.Dim + m % (2 * p.Dim);
  const float A2 = __ldg(p.A + cix) * kLog2e;
  const float bias = __ldg(p.bias + cix);
  const float Dv = __ldg(p.Dv + cix);
  const int r0 = w * kSteps;
  auto row = [&](int i) { return kFull ? r0 + i : min(r0 + i, p.L - 1); };
  T uu[kSteps], rd[kSteps], rb[kSteps];
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    uu[i] = __ldg(p.u + static_cast<size_t>(row(i)) * p.M + m);
    rd[i] = __ldg(p.dt[dir] + static_cast<size_t>(row(i)) * p.M + m);
    rb[i] = __ldg(p.bc[dir] + static_cast<size_t>(row(i)) * G + g);
  }
  float a[kSteps], b[kSteps];
#pragma unroll
  for (int i = 0; i < kSteps; ++i) {
    const bool inside = kFull || r0 + i < p.L;
    const float d =
        softplus_approx(inside ? to_f32(rd[i]) + bias : -INFINITY);
    a[i] = ex2_approx(d * A2);
    b[i] = d * to_f32(uu[i]) * to_f32(rb[i]);
  }
  T rc[kSteps];
#pragma unroll
  for (int i = 0; i < kSteps; ++i)
    rc[i] = __ldg(p.cc[dir] + static_cast<size_t>(row(i)) * G + g);
  {
    float pa = 1.f, h = 0.f;
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int i = kRev ? kSteps - 1 - j : j;
      h = fmaf(a[i], h, b[i]);
      pa *= a[i];
    }
    sh.seg_a[dir][w][lane] = pa;
    sh.seg_h[dir][w][lane] = h;
  }
  if (w == 0 && live) p.hck[dir][m] = 0.f;
  barrier<1, 2 * kScanThreads>();
  float h = 0.f;
#pragma unroll
  for (int j = 0; j < kWarps; ++j) {
    const int q = kRev ? kWarps - 1 - j : j;
    if (kRev ? q > w : q < w)
      h = fmaf(sh.seg_a[dir][q][lane], h, sh.seg_h[dir][q][lane]);
  }
  if (!live) return;               // no barrier follows
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const int i = kRev ? kSteps - 1 - j : j;
    h = fmaf(a[i], h, b[i]);
    if (kFull || r0 + i < p.L)
      p.y[dir][static_cast<size_t>(r0 + i) * p.M + m] =
          from_f32<T>(to_f32(rc[i]) * h + Dv * to_f32(uu[i]));
  }
}

template <typename T, int kSteps>
__global__ void __launch_bounds__(2 * kScanThreads, 2)
bidir_span_kernel(Operands<T> p) {
  __shared__ Shared sh;
  constexpr int kRows = kWarps * kSteps;
  const int w = threadIdx.y % kWarps;
  const bool full = kRows <= p.L;
  if (threadIdx.y < kWarps) {
    if (full)
      one_span<T, kSteps, true, false>(p, sh, w);
    else
      one_span<T, kSteps, false, false>(p, sh, w);
  } else {
    if (full)
      one_span<T, kSteps, true, true>(p, sh, w);
    else
      one_span<T, kSteps, false, true>(p, sh, w);
  }
}

long long spans_of(int L) { return (L + kSpan - 1) / kSpan; }
long long groups_of(int M) { return (M + kLanes - 1) / kLanes; }
int max_groups_of(int Dim) { return min(kLanes, (kLanes - 1) / Dim + 2); }

// What a launch is made of: resident blocks an SM, threads and dynamic
// shared memory a block, blocks; for the measurements.
struct Shape {
  int per_sm, threads, smem, blocks;
};

template <typename T, int kSteps>
int launch_span(const Operands<T>& p, const Chain& c, cudaStream_t stream,
                Shape* shape) {
  int per_sm = 0;
  int err = prepare(bidir_span_kernel<T, kSteps>, 2 * kScanThreads, 0, 0,
                    &per_sm);
  if (shape != nullptr) {
    *shape = {per_sm, 2 * kScanThreads, 0, c.groups};
  } else if (err == 0) {
    bidir_span_kernel<T, kSteps>
        <<<c.groups, dim3(kLanes, 2 * kWarps), 0, stream>>>(p);
    err = static_cast<int>(cudaGetLastError());
  }
  return err;
}

// A scan of at most 64 tokens: bidir_span_kernel, 4 or 8 steps a thread;
// anything longer: bidir_chain_kernel (spans of 128). With shape != null
// nothing is launched; shape is filled in.
template <typename T, int kChunk>
int launch_kernel(const Operands<T>& p, const Chain& c, cudaStream_t stream,
                  Shape* shape) {
  if (p.L <= 4 * kWarps) return launch_span<T, 4>(p, c, stream, shape);
  if (p.L <= 8 * kWarps) return launch_span<T, 8>(p, c, stream, shape);
  const size_t smem = Tiles<T>::bytes(p.max_groups);
  const unsigned blocks = 2u * c.groups * c.spans;
  int per_sm = 0;
  int err = prepare(bidir_chain_kernel<T, kChunk>, kThreads, smem,
                    Tiles<T>::bytes(kLanes), &per_sm);
  if (shape != nullptr) {
    *shape = {per_sm, kThreads, static_cast<int>(smem),
              static_cast<int>(blocks)};
  } else if (err == 0) {
    bidir_chain_kernel<T, kChunk>
        <<<blocks, dim3(kLanes, kWarps + 1), smem, stream>>>(p, c);
    err = static_cast<int>(cudaGetLastError());
  }
  return err;
}

bool aligned16(const void* x) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

// Fills the launch's arguments and launches it, or (shape != null) only
// reports what the launch would be.
template <typename T>
int launch(const void* u, const void* dt_f, const void* dt_r,
           const void* bc_f, const void* cc_f, const void* bc_r,
           const void* cc_r, const float* A, const float* Dv,
           const float* bias, void* y_f, void* y_r, float* hck_f,
           float* hck_r, unsigned long long* ws, unsigned tag, int L, int M,
           int Dim, cudaStream_t stream, Shape* shape) {
  Operands<T> p;
  p.u = static_cast<const T*>(u);
  p.dt[0] = static_cast<const T*>(dt_f);
  p.dt[1] = static_cast<const T*>(dt_r);
  p.bc[0] = static_cast<const T*>(bc_f);
  p.bc[1] = static_cast<const T*>(bc_r);
  p.cc[0] = static_cast<const T*>(cc_f);
  p.cc[1] = static_cast<const T*>(cc_r);
  p.A = A;
  p.Dv = Dv;
  p.bias = bias;
  p.y[0] = static_cast<T*>(y_f);
  p.y[1] = static_cast<T*>(y_r);
  p.hck[0] = hck_f;
  p.hck[1] = hck_r;
  p.L = L;
  p.M = M;
  p.Dim = Dim;
  p.max_groups = max_groups_of(Dim);
  Chain c;
  c.spans = static_cast<int>(spans_of(L));
  c.groups = static_cast<int>(groups_of(M));
  const size_t plane = 2 * static_cast<size_t>(c.spans) * c.groups * kLanes;
  c.tickets = reinterpret_cast<unsigned*>(ws);
  c.agg_a = ws + kTicketWords;
  c.agg_h = c.agg_a + plane;
  c.exit = c.agg_h + plane;
  c.tag = tag;
  // 16-byte copies where every row of u and dt starts 16-byte aligned
  const bool wide = (static_cast<size_t>(M) * sizeof(T)) % 16 == 0 &&
                    aligned16(u) && aligned16(dt_f) && aligned16(dt_r);
  return wide ? launch_kernel<T, 16>(p, c, stream, shape)
              : launch_kernel<T, 4>(p, c, stream, shape);
}

}  // namespace
// The 64-bit words of workspace a call with these L and M needs: the two
// tickets, then A, H and exit words per direction, chain position and
// lane (M rounded up to the block's 32 lanes).
extern "C" long long xp_selective_scan_bidir_workspace(int L, int M) {
  return kTicketWords + 3 * 2 * spans_of(L) * groups_of(M) * kLanes;
}

// The launch a call with these dtype, L, M and Dim makes (16-byte-aligned
// operands), for the measurements: out[0 .. 3] = resident blocks an SM,
// threads a block, dynamic shared memory bytes a block, blocks.
extern "C" int xp_selective_scan_bidir_shape(int dtype, int L, int M,
                                             int Dim, int* out) {
  if (L <= 0 || M <= 0 || Dim <= 0 || M % (2 * Dim) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Shape shape{};
  alignas(16) static char probe[16];
  const int err =
      dtype == 0
          ? launch<float>(probe, probe, probe, probe, probe, probe, probe,
                          nullptr, nullptr, nullptr, probe, probe, nullptr,
                          nullptr, nullptr, 1, L, M, Dim, nullptr, &shape)
          : launch<__nv_bfloat16>(probe, probe, probe, probe, probe, probe,
                                  probe, nullptr, nullptr, nullptr, probe,
                                  probe, nullptr, nullptr, nullptr, 1, L, M,
                                  Dim, nullptr, &shape);
  out[0] = shape.per_sm;
  out[1] = shape.threads;
  out[2] = shape.smem;
  out[3] = shape.blocks;
  return err;
}

// dtype: 0 = float32, 1 = bfloat16 (u, dt, bc, cc and y share it; u, dt_f
// and dt_r at least 4-byte aligned). hck_f / hck_r: fp32
// (ceil(L / 256), M) checkpoint outputs, always written. workspace:
// xp_selective_scan_bidir_workspace(L, M) 64-bit words, zeroed before the
// first call and reused only by calls on the same stream, each with a tag
// (never 0) higher than the last one given with it.
extern "C" int xp_selective_scan_bidir(
    int dtype, const void* u, const void* dt_f, const void* dt_r,
    const void* bc_f, const void* cc_f, const void* bc_r, const void* cc_r,
    const float* A, const float* Dv, const float* bias, void* y_f,
    void* y_r, float* hck_f, float* hck_r, void* workspace, unsigned tag,
    int L, int M, int Dim, void* stream) {
  if (L <= 0 || M <= 0 || Dim <= 0 || M % (2 * Dim) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (hck_f == nullptr || hck_r == nullptr || workspace == nullptr ||
      tag == 0 || 2 * spans_of(L) * groups_of(M) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* x : {u, dt_f, dt_r})
    if (reinterpret_cast<uintptr_t>(x) % 4 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* ws = static_cast<unsigned long long*>(workspace);
  if (dtype == 0)
    return launch<float>(u, dt_f, dt_r, bc_f, cc_f, bc_r, cc_r, A, Dv, bias,
                         y_f, y_r, hck_f, hck_r, ws, tag, L, M, Dim, s,
                         nullptr);
  if (dtype == 1)
    return launch<__nv_bfloat16>(u, dt_f, dt_r, bc_f, cc_f, bc_r, cc_r, A,
                                 Dv, bias, y_f, y_r, hck_f, hck_r, ws, tag, L,
                                 M, Dim, s, nullptr);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* xp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
