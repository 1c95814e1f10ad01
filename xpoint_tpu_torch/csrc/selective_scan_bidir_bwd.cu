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
// 1/Dim of that), a few tens of flops and five transcendentals each.
//
// Design: one launch for the recurrence, spans chained by the adjoint carry
// (K1's design, selective_scan_bidir.cu, run on the adjoint), and a small
// finishing launch over the partial sums. With e_t = a_t dh_t the adjoint
// is the linear recurrence e_t = a_t (gC_t + e_next) in the opposite order
// to h, so it composes by spans like h: (P1, E1) then (P2, E2) = (P1 P2,
// P2 E1 + E2), P the product of a.
//   Spans are 256 tokens, the checkpoint chunk: a span's h entry is its
//   checkpoint, so h needs no carry and no wait, and only the adjoint
//   chains. A scan of more than 64 tokens runs bwd_chain_kernel (one span
//   up to 256 tokens); a shorter one runs bwd_span_kernel.
//   Blocks of bwd_chain_kernel: 32 neighbouring lanes x 17 warps, 16 scan
//   warps (warp w the segment of steps 16 w .. 16 w + 15 of the span) and
//   one chain warp, two blocks an SM; a block does ONE direction of one
//   span. Each scan warp
//   copies its segment's rows of u, dt and g into shared memory with
//   cp.async (16 bytes a copy where every row is 16-byte aligned, else 4),
//   and of the compact B and C, and starts as soon as they are in (no block
//   barrier), so each operand element is read from device memory once a
//   direction. Each thread then makes three passes over its 16 steps from
//   shared memory (the instructions a step, not the bytes, set the time:
//   delta is formed twice, in passes 1 and 3, a from it in every pass, the
//   sigmoid in pass 3; 16 steps of them do not fit in registers beside the
//   rest):
//     1. in scan order, its segment's summaries from zero entries: P, h,
//        and the adjoint e = sum_t gC_t (product of a up to t); delta of
//        every step into a shared fp32 tile;
//     2. once the 16 summaries are shared, h from the segment's h entry
//        (the checkpoint with the segments before it folded on), with
//        delta from the tile (no softplus again) and h_prev of every step
//        into the tile in its place (in registers they spilled); dC needs
//        no adjoint;
//     3. once the span's adjoint entry is known, the adjoint in adjoint
//        order from the segment's entry (q e + e0: e0 and q the segments
//        after it in adjoint order folded from zero, formed before the
//        wait), storing ddt from registers and the du term over h_prev.
//   Meanwhile the chain warp folds the segments' adjoint summaries into
//   the span's (P, E), publishes them, waits for the span's entry e,
//   publishes its exit and takes the block's part in du (below): pass 2
//   and the entry folds overlap the wait.
//   bwd_span_kernel (L <= 64; no chain, no ticket): block i does both
//   directions of lane group i, forward on warps 0 .. 7 and reversed on
//   warps 8 .. 15 at once, from one staged copy of u (4 or 8 steps a
//   thread), the adjoint entry of the span 0; the reversed warps hand their
//   du terms to the forward warps through shared memory. Two blocks share
//   an SM.
//   Bytes per (t, m): a chain launch reads u once a direction, dt and g
//   once and writes ddt once (16 bytes for both directions); du passes one
//   fp32 term between the two blocks of a span (8 bytes) and is written
//   once: 26, against the three-pass design's 26 with every operand read
//   twice and every transcendental evaluated in two launches. A span launch
//   moves the bound's 16.
//   The chain and its tickets. The grid holds 2 x groups x spans blocks;
//   blockIdx.x & 1 is the direction, and each direction hands out its work
//   from its own atomic ticket, in the order the blocks start: ticket t is
//   chain position k = t / groups of lane group t % groups, and position k
//   is span spans - 1 - k on forward lanes and span k on reversed lanes
//   (the adjoint chains run opposite to K1's). A block waits for its entry
//   only on lower positions of its own chain, which hold lower tickets of
//   its direction, drawn by blocks that have started. Entry(k) is folded
//   from exit(k - K) (K = 4) and the summaries between, in position order:
//   the strict chain's fmafs, so the bits do not depend on the timing
//   (scan_chain.cuh). Chain words are tagged 64-bit words as K1's.
//   du over both directions. The two blocks of a span (one a direction)
//   pass one fp32 du term over. Once its entry is known, a block's chain
//   warp arrives at the span's pair counter (a tagged 64-bit word raised by
//   atomicCAS: a word of an earlier call counts 0, so the counters, whose
//   place depends on the call's shape, need no clearing; only the tickets,
//   at a fixed place, are set back to 0). The first block to arrive hands
//   its terms over: its pass 3 writes them to scratch, then it fences and
//   publishes a tagged flag. The second adds them: if the flag is up when
//   it arrives (the usual case: the two chains reach a span at different
//   times), its pass 3 reads the other term (fetched to L2 during its
//   pass 2) beside its own and stores du; else it keeps its terms in shared
//   memory, waits for the flag after its pass 3 and then stores du. du is
//   stored once in the operands' dtype, the forward term first (for two
//   fp32 terms the order cannot change the bits). Why the launch finishes
//   at any grid size: a block waits only (a) for chain entries, on blocks
//   of lower tickets of its direction, which have started, and whose
//   oldest waiting block waits on finished blocks; and (b) as the second
//   of a pair, on a block that arrived at the counter after its own last
//   chain wait and publishes with no further wait. A block that waits is
//   never waited on by a block that has not started.
//   Workspace. The wrapper passes a zeroed buffer it keeps per device and
//   stream (xp_selective_scan_bidir_bwd_workspace words of 64 bits: the
//   tickets, the pair counters and flags, then per direction, position and
//   lane the words P, E and exit; every word after the tickets is tagged)
//   and a tag one higher than the last call on that buffer's stream; calls
//   on one stream run one after another and other streams have other
//   buffers. Nothing is cleared between calls.
//   No float is added atomically, and every sum is taken in a fixed order,
//   so two runs on the same inputs give the same bits: dB and dC of a step
//   are summed over a warp's lanes (each group's lanes apart) in a fixed
//   tree, one partial per 32-lane slice, into scratch; dA, dD and dbias per
//   thread in adjoint order, over the span's segments in order into one
//   partial per span; finish_kernel sums a group's slices in slice order
//   and the spans in span order.
// Tokens beyond L are inert (dt = -inf gives a = 1, b = 0, sigmoid 0, and
// g = 0 there); lanes beyond M compute on lane M - 1's constants and zeros
// (their terms are 0), keep their own chain words and store nothing.
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
constexpr int kWarps = 16;          // segments per span: a direction's warps
constexpr int kScanThreads = kLanes * kWarps;
constexpr int kThreads = kScanThreads + kLanes;     // and the chain warp
constexpr int kMaxSteps = 16;       // steps per segment
constexpr int kSpan = kWarps * kMaxSteps;
constexpr int kCkptChunk = 256;     // the forward kernel's checkpoint chunk
static_assert(kSpan == kCkptChunk, "a span is one checkpoint chunk");
constexpr int kLookback = 4;        // K: a block waits for exit(k - K)
constexpr int kChainBlocksPerSM = 2;
constexpr int kTicketWords = 2;     // the two tickets, padded to 16 bytes
constexpr int kSums = 6;            // dA, dD, dbias of each direction
constexpr int kBatch = 8;           // steps whose dB (dC) are summed together
constexpr int kShortSegs = 8;       // bwd_span_kernel: segments a direction
constexpr int kShortSpan = kShortSegs * 8;          // its longest scan
constexpr int kShortThreads = 2 * kLanes * kShortSegs;
constexpr int kFinishThreads = 256;
// What a block does with its du terms (see the header): keeps them in
// shared memory until its pair's other block has handed its own over,
// hands them over, or adds the other block's, handed over already.
constexpr int kKeep = 0, kHand = 1, kAdd = 2;

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
  T* du;
  T* ddt[2];
  int L, M, Dim, G, spans;
  int slices, J;    // 32-lane slices of M; most groups a slice touches
  int max_groups;   // most groups 32 neighbouring lanes touch
};

// A direction's shared tiles of one span: u, dt and g (rows x 32 lanes),
// B and C (rows x max_groups: the groups of the block's lanes) and an fp32
// value of every step (rows x 32): delta after pass 1, h_prev after pass
// 2, the du term after pass 3.
template <typename T>
struct Tiles {
  const T* u;
  const T* dt;
  const T* g;
  const T* bc;
  const T* cc;
  float* h;
};

// Scratch (fp32): du terms passed between the two blocks of a span (L, M;
// chain launches only), the dA/dD/dbias partials (spans, 6, M) and the
// dB/dC partials (4, L, slices, J): dB_f, dB_r, dC_f, dC_r.
struct Scratch {
  float* duterm;
  float* cpart;
  float* bcpart;
};

// The chain words: P, E and exit, each (2, spans, groups * 32) words of
// (tag << 32 | fp32 bits), indexed by direction, chain position, lane; the
// pair counters and du flags, (spans, groups) each.
struct Chain {
  unsigned* tickets;
  unsigned long long* pairs;
  unsigned long long* flags;
  unsigned long long* agg_p;
  unsigned long long* agg_e;
  unsigned long long* exit;
  unsigned tag;
  int groups;
};

// Segment summaries of one direction (P, h, e from zero entries), shared
// between the scan warps and the chain warp; later the dA/dD/dbias partials.
template <int kS>
struct Sums {
  float p[kS][kLanes];
  float h[kS][kLanes];
  float e[kS][kLanes];
};

int groups_per_slice(int Dim) {
  return Dim % kLanes == 0 ? 1 : (Dim + kLanes - 2) / Dim + 1;
}

// Sums each of v[0 .. V-1] over the warp's 32 lanes in a fixed tree (V / 2
// values exchanged at offset 16, V / 4 at 8, ..., then a butterfly) and
// returns in lane l the total of v[l / (32 / V)].
template <int V>
__device__ __forceinline__ float warp_sums(float (&v)[V]) {
  const int lane = threadIdx.x;
#pragma unroll
  for (int n = V / 2, o = 16; n >= 1; n >>= 1, o >>= 1) {
    const bool hi = lane & o;
#pragma unroll
    for (int i = 0; i < n; ++i) {
      const float send = hi ? v[i] : v[i + n];
      const float keep = hi ? v[i + n] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  float s = v[0];
#pragma unroll
  for (int o = 16 / V; o >= 1; o >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// Rows t0 .. t0 + rows - 1 (clamped to the scan) of lanes m0 .. m0 + 31 of
// an (L, M) plane into a (rows, 32) tile, kChunk bytes a copy, by kBy
// threads; rows beyond L and lanes beyond M are zero.
template <typename T, int kChunk, int kBy>
__device__ __forceinline__ void stage_plane(T* tile, const T* plane, int L,
                                            int M, int t0, int m0, int rows,
                                            int tid) {
  constexpr int kPer = kChunk / static_cast<int>(sizeof(T));
  constexpr int kPerRow = kLanes / kPer;
  for (int c = tid; c < rows * kPerRow; c += kBy) {
    const int t = c / kPerRow;
    const int m = m0 + (c % kPerRow) * kPer;
    const bool valid = t0 + t < L && m < M;
    const T* src = plane + static_cast<size_t>(min(t0 + t, L - 1)) * M +
                   (valid ? m : 0);
    copy_async<kChunk>(tile + t * kLanes + (m - m0), src, valid);
  }
}

// The span's B and C of one direction (rows t0 .. t0 + rows - 1, clamped
// to the scan; the groups of lanes m0 .. m0 + 31) into their tiles, by kBy
// threads.
template <typename T, int kBy>
__device__ __forceinline__ void stage_compact(T* tb, T* tc, const T* bc,
                                              const T* cc,
                                              const Operands<T>& p, int t0,
                                              int m0, int rows, int tid) {
  const int g_lo = m0 / p.Dim;
  const int n_g = (min(m0 + kLanes, p.M) - 1) / p.Dim - g_lo + 1;
  for (int i = tid; i < rows * n_g; i += kBy) {
    const int t = i / n_g;
    const int j = i - t * n_g;
    const size_t at =
        static_cast<size_t>(min(t0 + t, p.L - 1)) * p.G + g_lo + j;
    tb[t * p.max_groups + j] = __ldg(bc + at);
    tc[t * p.max_groups + j] = __ldg(cc + at);
  }
}

// One direction (kRev: reversed lanes, scanned right to left) of one
// segment of a span for one thread: warp w's steps w kSteps .. w kSteps +
// kSteps - 1 of the span's tiles (step i is row r0 + i), lane m0 + lane.
template <typename T, int kS, int kSteps, bool kFull, bool kRev>
struct Segment {
  static constexpr int dir = kRev ? 1 : 0;
  static constexpr int kB = kSteps < kBatch ? kSteps : kBatch;
  const Operands<T>& p;
  const Tiles<T> tl;
  int lane, w, m0, m, g, gl, t0, r0;
  bool live;
  float A, A2, bias, Dv;

  __device__ __forceinline__ Segment(const Operands<T>& p_,
                                     const Tiles<T>& tl_, int m0_, int t0_,
                                     int w_)
      : p(p_), tl(tl_), lane(threadIdx.x), w(w_), m0(m0_), t0(t0_),
        r0(w_ * kSteps) {
    live = m0 + lane < p.M;
    m = min(m0 + lane, p.M - 1);
    g = m / p.Dim;
    gl = g - m0 / p.Dim;
    const int cix = dir * 2 * p.Dim + m % (2 * p.Dim);
    A = __ldg(p.A + cix);
    A2 = A * kLog2e;
    bias = __ldg(p.bias + cix);
    Dv = __ldg(p.Dv + cix);
  }

  static __device__ __forceinline__ int scan(int j) {
    return kRev ? kSteps - 1 - j : j;
  }
  static __device__ __forceinline__ int adjoint(int j) {
    return kRev ? j : kSteps - 1 - j;
  }
  __device__ __forceinline__ bool inside(int i) const {
    return kFull || t0 + r0 + i < p.L;
  }
  __device__ __forceinline__ float uval(int i) const {
    return to_f32(tl.u[(r0 + i) * kLanes + lane]);
  }
  __device__ __forceinline__ float gval(int i) const {
    return to_f32(tl.g[(r0 + i) * kLanes + lane]);
  }
  __device__ __forceinline__ float bval(int i) const {
    return to_f32(tl.bc[(r0 + i) * p.max_groups + gl]);
  }
  __device__ __forceinline__ float cval(int i) const {
    return to_f32(tl.cc[(r0 + i) * p.max_groups + gl]);
  }
  // x = dt + bias (-inf beyond L), delta and a of step i
  __device__ __forceinline__ void step(int i, float& x, float& d,
                                       float& a) const {
    x = inside(i) ? to_f32(tl.dt[(r0 + i) * kLanes + lane]) + bias
                  : -INFINITY;
    d = softplus_approx(x);
    a = ex2_approx(d * A2);
  }

  // Pass 1: the segment's (P, h, e) from zero entries in scan order; delta
  // of every step into the tile (pass 2 takes it from there).
  __device__ __forceinline__ void summarise(Sums<kS>& sm) const {
    float P = 1.f, H = 0.f, E = 0.f;
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int i = scan(j);
      float x, d, a;
      step(i, x, d, a);
      hp(i) = d;
      P *= a;
      H = fmaf(a, H, d * uval(i) * bval(i));
      E = fmaf(gval(i) * cval(i), P, E);
    }
    sm.p[w][lane] = P;
    sm.h[w][lane] = H;
    sm.e[w][lane] = E;
  }

  // The segment's h entry (the segments before it in scan order folded
  // onto the span's h entry h) and the zero-entry part of its adjoint entry
  // (e0, and q the product of a of the segments after it in adjoint order).
  __device__ __forceinline__ void entries(const Sums<kS>& sm, float& h,
                                          float& e0, float& q) const {
    e0 = 0.f;
    q = 1.f;
#pragma unroll
    for (int k = 0; k < kS; ++k) {
      const int js = kRev ? kS - 1 - k : k;           // scan order
      if (kRev ? js > w : js < w) h = fmaf(sm.p[js][lane], h, sm.h[js][lane]);
      const int ja = kS - 1 - js;                     // adjoint order
      if (kRev ? ja < w : ja > w) {
        e0 = fmaf(sm.p[ja][lane], e0, sm.e[ja][lane]);
        q *= sm.p[ja][lane];
      }
    }
  }

  // dB (kind 0) or dC (kind 1) of kB steps, v[b] of step step_of(j0 + b),
  // summed over the lanes of each group of the warp's slice into scratch.
  template <bool kAdj>
  __device__ __forceinline__ void slice_sums(float (&v)[kB], int kind,
                                             int j0, const Scratch& sc) const {
    const int slice = m0 / kLanes;
    float* part = sc.bcpart + (static_cast<size_t>(2 * kind + dir) * p.L) *
                                  p.slices * p.J;
    if (p.Dim % kLanes == 0) {
      // the slice lies in one group: a transposing tree, one step a lane
      const float s = warp_sums<kB>(v);
      constexpr int kPer = kLanes / kB;
      if (lane % kPer == 0) {
        const int j = j0 + lane / kPer;
        const int i = kAdj ? adjoint(j) : scan(j);
        if (inside(i))
          part[static_cast<size_t>(t0 + r0 + i) * p.slices + slice] = s;
      }
      return;
    }
    // groups that do not fill slices: an inclusive scan over each group's
    // run of lanes, closed at its last live lane
    const int n_live = min(kLanes, p.M - m0);
    const int first = max(g * p.Dim - m0, 0);
    const int last = min((g + 1) * p.Dim - 1 - m0, n_live - 1);
    const int jg = g - m0 / p.Dim;
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      float s = v[b];
#pragma unroll
      for (int o = 1; o < kLanes; o <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, s, o);
        if (lane - o >= first) s += up;
      }
      const int i = kAdj ? adjoint(j0 + b) : scan(j0 + b);
      if (live && lane == last && inside(i))
        part[(static_cast<size_t>(t0 + r0 + i) * p.slices + slice) * p.J +
             jg] = s;
    }
  }

  __device__ __forceinline__ float& hp(int i) const {
    return tl.h[(r0 + i) * kLanes + lane];
  }

  // Pass 2: h in scan order from the segment's entry h, with delta from
  // the tile and a formed from it, h_prev of every step into the tile in
  // its place; dC = g h summed over the group into scratch.
  __device__ __forceinline__ void replay_h(float h, const Scratch& sc) const {
    float dc[kB];
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int i = scan(j);
      const float d = hp(i);
      const float a = ex2_approx(d * A2);
      hp(i) = h;
      h = fmaf(a, h, d * uval(i) * bval(i));
      dc[j % kB] = gval(i) * h;
      if (j % kB == kB - 1) slice_sums<false>(dc, 1, j - kB + 1, sc);
    }
  }

  // Pass 3: the adjoint in adjoint order from the segment's entry e: ddt
  // stored, dB summed over the group into scratch, dA / dD / dbias into
  // acc; the du term of step i by `role`: kKeep over the tile's h_prev of
  // step i (used at step i), kHand into the pair's fp32 terms (`terms`,
  // this lane's of row t0 + r0), kAdd added to the terms there and du
  // stored.
  __device__ __forceinline__ void replay_adjoint(float e, float (&acc)[3],
                                                 const Scratch& sc, int role,
                                                 float* terms) const {
    float db[kB];
    float dA = 0.f, dD = 0.f, dbias = 0.f;
    T* __restrict__ pddt = p.ddt[dir] + m;
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int i = adjoint(j);
      float x, d, a;
      step(i, x, d, a);
      const float sig = sigmoid_approx(x);
      const float uu = uval(i), gg = gval(i), bb = bval(i);
      const float dh = gg * cval(i) + e;
      e = a * dh;
      const float da = dh * hp(i);
      const float ddt = (dh * uu * bb + da * A * a) * sig;
      dA += da * a * d;
      dD += gg * uu;
      dbias += ddt;
      const float term = gg * Dv + dh * d * bb;
      if (role == kKeep) {
        hp(i) = term;
      } else if (live && inside(i)) {
        float* at = terms + static_cast<size_t>(i) * p.M;
        if (role == kHand) {
          *at = term;
        } else {
          const float o = __ldcg(at);
          p.du[static_cast<size_t>(t0 + r0 + i) * p.M + m] =
              from_f32<T>(kRev ? o + term : term + o);
        }
      }
      db[j % kB] = dh * d * uu;
      if (j % kB == kB - 1) slice_sums<true>(db, 0, j - kB + 1, sc);
      if (live && inside(i))
        pddt[static_cast<size_t>(t0 + r0 + i) * p.M] = from_f32<T>(ddt);
    }
    acc[0] = dA;
    acc[1] = dD;
    acc[2] = dbias;
  }

  // du = forward term + reversed term of the live steps, stored once; the
  // other block's terms (kGlobal) are read from L2, written by another SM.
  template <bool kGlobal>
  __device__ __forceinline__ void store_du(const float* other,
                                           size_t stride) const {
    if (!live) return;
#pragma unroll
    for (int i = 0; i < kSteps; ++i)
      if (inside(i)) {
        const float o = kGlobal ? __ldcg(other + i * stride)
                                : other[i * stride];
        const float du = kRev ? o + hp(i) : hp(i) + o;
        p.du[static_cast<size_t>(t0 + r0 + i) * p.M + m] = from_f32<T>(du);
      }
  }
};

// dA / dD / dbias of a direction's segments (acc of warp w in sm, summed
// in warp order) into the span's partial, by warps 0 .. 2.
template <typename T>
__device__ __forceinline__ void span_partial(const Operands<T>& p,
                                             const Scratch& sc,
                                             const Sums<kWarps>& sm, int dir,
                                             int s, int w, int m) {
  if (w >= 3 || m >= p.M) return;
  const float(*src)[kLanes] = w == 0 ? sm.p : w == 1 ? sm.h : sm.e;
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < kWarps; ++j) sum += src[j][threadIdx.x];
  sc.cpart[(static_cast<size_t>(s) * kSums + 3 * dir + w) * p.M + m] = sum;
}

// One direction of span s, chain position k, lane group `group`: each scan
// warp stages and summarises its segment, and rebuilds h while the chain
// warp folds, publishes and waits for the span's adjoint entry, then
// arrives at the span's pair counter (its role for du, in `role`); then
// the adjoint pass, the span's dA/dD/dbias partial and du as the role
// says.
template <typename T, int kChunk, bool kFull, bool kRev>
__device__ __forceinline__ void chain_span(const Operands<T>& p,
                                           const Scratch& sc, const Chain& c,
                                           Sums<kWarps>& sm, float* entry,
                                           int& role, unsigned char* dyn,
                                           int group, int k, int s) {
  constexpr int dir = kRev ? 1 : 0;
  const int m0 = group * kLanes;
  const int t0 = s * kSpan;
  float* th = reinterpret_cast<float*>(dyn);
  T* tu = reinterpret_cast<T*>(th + kSpan * kLanes);
  T* tdt = tu + kSpan * kLanes;
  T* tg = tdt + kSpan * kLanes;
  T* tb = tg + kSpan * kLanes;
  T* tc = tb + kSpan * p.max_groups;
  const int w = threadIdx.y;
  const int lane = threadIdx.x;
  const size_t pair = static_cast<size_t>(s) * c.groups + group;
  if (w == kWarps) {
    // the chain warp
    barrier<1, kThreads>();                          // summaries shared
    float P = 1.f, E = 0.f;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) {
      const int ja = kRev ? j : kWarps - 1 - j;      // adjoint order
      E = fmaf(sm.p[ja][lane], E, sm.e[ja][lane]);
      P *= sm.p[ja][lane];
    }
    const size_t plane = static_cast<size_t>(c.groups) * kLanes;
    const size_t lane_at =
        static_cast<size_t>(dir) * p.spans * plane + m0 + lane;
    const size_t at = lane_at + static_cast<size_t>(k) * plane;
    if (k + 1 < p.spans) {
      publish(c.agg_p + at, c.tag, P);
      publish(c.agg_e + at, c.tag, E);
    }
    const float e = xp::chain_entry<kLookback>(c.agg_p, c.agg_e, c.exit,
                                               c.tag, lane_at, plane, k);
    if (k + kLookback < p.spans) publish(c.exit + at, c.tag, fmaf(P, e, E));
    entry[lane] = e;
    if (lane == 0) {
      // past the block's last chain wait: the first block of the pair
      // hands its terms over, the second adds them if they are there
      int r = kHand;
      if (xp::arrive(c.pairs + pair, c.tag) != 0) {
        r = kKeep;
        if (xp::tagged(xp::peek(c.flags + pair), c.tag)) {
          __threadfence();
          r = kAdd;
        }
      }
      role = r;
    }
    barrier<1, kThreads>();                          // entry known
    return;
  }
  // each scan warp stages its own segment's rows
  const int r0 = w * kMaxSteps;
  stage_plane<T, kChunk, kLanes>(tu + r0 * kLanes, p.u, p.L, p.M, t0 + r0,
                                 m0, kMaxSteps, lane);
  stage_plane<T, kChunk, kLanes>(tdt + r0 * kLanes, p.dt[dir], p.L, p.M,
                                 t0 + r0, m0, kMaxSteps, lane);
  stage_plane<T, kChunk, kLanes>(tg + r0 * kLanes, p.g[dir], p.L, p.M,
                                 t0 + r0, m0, kMaxSteps, lane);
  stage_compact<T, kLanes>(tb + r0 * p.max_groups, tc + r0 * p.max_groups,
                           p.bc[dir], p.cc[dir], p, t0 + r0, m0, kMaxSteps,
                           lane);
  wait_async();
  __syncwarp();
  Segment<T, kWarps, kMaxSteps, kFull, kRev> seg(
      p, {tu, tdt, tg, tb, tc, th}, m0, t0, w);
  seg.summarise(sm);
  barrier<1, kThreads>();                            // summaries shared
  float h = seg.live ? __ldg(p.hck[dir] + static_cast<size_t>(s) * p.M +
                             seg.m)
                     : 0.f;
  float* terms =
      sc.duterm + static_cast<size_t>(t0 + r0) * p.M + m0 + lane;
  // the other block's du terms, if it has handed them over already (then
  // this block adds them in pass 3), on their way to L2 while pass 2 runs
  // (measured faster at the flagship's train shapes)
  if (lane < kMaxSteps &&
      xp::tagged(xp::peek(c.flags + pair), c.tag) && seg.inside(lane))
    asm volatile("prefetch.global.L2 [%0];" ::"l"(
        terms - lane + static_cast<size_t>(lane) * p.M));
  float e0, q;
  seg.entries(sm, h, e0, q);
  seg.replay_h(h, sc);
  barrier<1, kThreads>();                            // entry known
  const int how = role;
  float acc[3];
  seg.replay_adjoint(fmaf(q, entry[lane], e0), acc, sc, how, terms);
  // every thread is past its reads of the summaries (the chain warp before
  // the last barrier): they take the dA/dD/dbias partials
  sm.p[w][lane] = acc[0];
  sm.h[w][lane] = acc[1];
  sm.e[w][lane] = acc[2];
  if (how == kHand) __threadfence();
  barrier<2, kScanThreads>();
  span_partial(p, sc, sm, dir, s, w, m0 + lane);
  if (how == kHand) {
    if (w == 0 && lane == 0) {
      __threadfence();
      publish(c.flags + pair, c.tag, 0.f);
    }
  } else if (how == kKeep) {
    if (w == 0 && lane == 0) {
      while (!xp::tagged(xp::peek(c.flags + pair), c.tag)) __nanosleep(32);
      __threadfence();
    }
    barrier<2, kScanThreads>();
    seg.template store_du<true>(terms, p.M);
  }
}

// Block (32 lanes) x (16 scan warps + 1 chain warp) of a scan of several
// spans: blockIdx.x & 1 is the direction, and the block's span and lane
// group come from the direction's ticket.
template <typename T, int kChunk>
__global__ void __launch_bounds__(kThreads, kChainBlocksPerSM)
bwd_chain_kernel(Operands<T> p, Scratch sc, Chain c) {
  __shared__ Sums<kWarps> sm;
  __shared__ float entry[kLanes];
  __shared__ int ticket, role;
  extern __shared__ __align__(16) unsigned char dyn[];
  const int dir = blockIdx.x & 1;
  if (threadIdx.x == 0 && threadIdx.y == kWarps) {
    const unsigned per_dir =
        static_cast<unsigned>(c.groups) * static_cast<unsigned>(p.spans);
    const unsigned t = atomicAdd(c.tickets + dir, 1u);
    if (t == per_dir - 1) atomicExch(c.tickets + dir, 0u);
    ticket = static_cast<int>(t);
  }
  __syncthreads();
  const int k = ticket / c.groups;
  const int group = ticket - k * c.groups;
  const int s = dir ? k : p.spans - 1 - k;
  const bool full = (s + 1) * kSpan <= p.L;
  if (dir == 0) {
    if (full)
      chain_span<T, kChunk, true, false>(p, sc, c, sm, entry, role, dyn,
                                         group, k, s);
    else
      chain_span<T, kChunk, false, false>(p, sc, c, sm, entry, role, dyn,
                                          group, k, s);
  } else {
    if (full)
      chain_span<T, kChunk, true, true>(p, sc, c, sm, entry, role, dyn,
                                        group, k, s);
    else
      chain_span<T, kChunk, false, true>(p, sc, c, sm, entry, role, dyn,
                                         group, k, s);
  }
}

// bwd_span_kernel's static shared memory: both directions' segment
// summaries and dA/dD/dbias partials.
struct SpanShared {
  Sums<kShortSegs> sm[2];
  float accs[2][3][kShortSegs][kLanes];
};

// A scan of at most 64 tokens (one span: no chain, adjoint entries zero,
// no ticket): one direction of lane group blockIdx.x on warps w + 8 dir.
template <typename T, int kSteps, bool kRev>
__device__ __forceinline__ void one_span(const Operands<T>& p,
                                         const Scratch& sc, SpanShared& sh,
                                         const Tiles<T>& tl,
                                         const float* th_other, int w) {
  constexpr int dir = kRev ? 1 : 0;
  const int lane = threadIdx.x;
  Segment<T, kShortSegs, kSteps, false, kRev> seg(p, tl, blockIdx.x * kLanes,
                                                  0, w);
  seg.summarise(sh.sm[dir]);
  barrier<1, kShortThreads>();                       // summaries shared
  float h = seg.live ? __ldg(p.hck[dir] + seg.m) : 0.f;
  float e0, q;
  seg.entries(sh.sm[dir], h, e0, q);
  seg.replay_h(h, sc);
  float acc[3];
  seg.replay_adjoint(e0, acc, sc, kKeep, nullptr);
#pragma unroll
  for (int n = 0; n < 3; ++n) sh.accs[dir][n][w][lane] = acc[n];
  barrier<1, kShortThreads>();                       // terms shared
  // the reversed lanes' du terms are in their tile
  if (!kRev)
    seg.template store_du<false>(th_other + seg.r0 * kLanes + lane, kLanes);
  if (w < 3 && seg.live) {
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kShortSegs; ++j) sum += sh.accs[dir][w][j][lane];
    sc.cpart[static_cast<size_t>(3 * dir + w) * p.M + seg.m0 + lane] = sum;
  }
}

// Its dynamic shared memory: the two directions' fp32 tiles (delta, h_prev,
// du terms), the tiles of u, dt_f, dt_r, g_f and g_r, and both
// directions' B and C.
template <typename T>
size_t span_smem(int steps, int max_groups) {
  return static_cast<size_t>(kShortSegs) * steps *
         (kLanes * (2 * sizeof(float) + 5 * sizeof(T)) +
          4 * max_groups * sizeof(T));
}

// Block i: both directions of lane group i, the forward ones on warps
// 0 .. 7 and the reversed ones on warps 8 .. 15 at once, from one staged
// copy of u, dt_f, dt_r, g_f and g_r (4-byte copies).
template <typename T, int kSteps>
__global__ void __launch_bounds__(kShortThreads, 2)
bwd_span_kernel(Operands<T> p, Scratch sc) {
  constexpr int kRows = kShortSegs * kSteps;
  __shared__ SpanShared sh;
  extern __shared__ __align__(16) unsigned char dyn[];
  float* th = reinterpret_cast<float*>(dyn);     // h_f, h_r
  T* tu = reinterpret_cast<T*>(th + 2 * kRows * kLanes);
  T* tdt = tu + kRows * kLanes;                   // dt_f, dt_r
  T* tg = tdt + 2 * kRows * kLanes;               // g_f, g_r
  T* tb = tg + 2 * kRows * kLanes;                // bc_f, bc_r
  T* tc = tb + 2 * kRows * p.max_groups;          // cc_f, cc_r
  const int m0 = blockIdx.x * kLanes;
  const int tid = threadIdx.y * kLanes + threadIdx.x;
  stage_plane<T, 4, kShortThreads>(tu, p.u, p.L, p.M, 0, m0, kRows, tid);
  for (int r = 0; r < 2; ++r) {
    stage_plane<T, 4, kShortThreads>(tdt + r * kRows * kLanes, p.dt[r], p.L,
                                     p.M, 0, m0, kRows, tid);
    stage_plane<T, 4, kShortThreads>(tg + r * kRows * kLanes, p.g[r], p.L,
                                     p.M, 0, m0, kRows, tid);
    stage_compact<T, kShortThreads>(tb + r * kRows * p.max_groups,
                                    tc + r * kRows * p.max_groups, p.bc[r],
                                    p.cc[r], p, 0, m0, kRows, tid);
  }
  wait_async();
  __syncthreads();
  const int w = threadIdx.y % kShortSegs;
  const int r = threadIdx.y / kShortSegs;
  const Tiles<T> tl{tu, tdt + r * kRows * kLanes, tg + r * kRows * kLanes,
                    tb + r * kRows * p.max_groups,
                    tc + r * kRows * p.max_groups, th + r * kRows * kLanes};
  // the forward warps read the reversed lanes' du terms from their tile
  const float* th_r = th + kRows * kLanes;
  if (r == 0)
    one_span<T, kSteps, false>(p, sc, sh, tl, th_r, w);
  else
    one_span<T, kSteps, true>(p, sc, sh, tl, th_r, w);
}

// dconst (6, M) = the span partials summed in span order; compact dB/dC
// (4, L, G) = each group's slice partials summed in slice order and
// rounded once to the operands' dtype.
template <typename T>
__global__ void __launch_bounds__(kFinishThreads)
finish_kernel(Operands<T> p, Scratch sc, T* dbcc, float* dconst) {
  const size_t idx =
      static_cast<size_t>(blockIdx.x) * kFinishThreads + threadIdx.x;
  const int L = p.L, M = p.M, Dim = p.Dim, G = p.G;
  const size_t n_const = static_cast<size_t>(kSums) * M;
  if (idx < n_const) {
    const int q = static_cast<int>(idx / M);
    const int m = static_cast<int>(idx % M);
    float sum = 0.f;
    for (int s = 0; s < p.spans; ++s)
      sum += sc.cpart[(static_cast<size_t>(s) * kSums + q) * M + m];
    dconst[idx] = sum;
    return;
  }
  const size_t k = idx - n_const;                 // (q, t, g) flat
  if (k >= static_cast<size_t>(4) * L * G) return;
  const int g = static_cast<int>(k % G);
  const size_t qt = k / G;                        // q * L + t
  const int first = g * Dim / kLanes;
  const int last = ((g + 1) * Dim - 1) / kLanes;
  const float* __restrict__ part = sc.bcpart + qt * p.slices * p.J;
  float sum = 0.f;
  for (int bx = first; bx <= last; ++bx)
    sum += part[static_cast<size_t>(bx) * p.J + (g - bx * kLanes / Dim)];
  dbcc[k] = from_f32<T>(sum);
}

long long spans_of(int L) { return (L + kSpan - 1) / kSpan; }
long long groups_of(int M) { return (M + kLanes - 1) / kLanes; }
// steps a segment of the one-span kernel: 4, 8 or 16
int span_steps(int L) { return L <= 4 * kShortSegs ? 4 : 8; }

// What the recurrence's launch is made of: resident blocks an SM, threads
// and dynamic shared memory a block, blocks; for the measurements.
struct Shape {
  int per_sm, threads, smem, blocks;
};

template <typename T, int kSteps>
int launch_span(const Operands<T>& p, const Scratch& sc, cudaStream_t stream,
                Shape* shape) {
  const size_t smem = span_smem<T>(kSteps, p.max_groups);
  int per_sm = 0;
  int err = prepare(bwd_span_kernel<T, kSteps>, kShortThreads, smem,
                    span_smem<T>(kSteps, kLanes), &per_sm);
  if (shape != nullptr) {
    *shape = {per_sm, kShortThreads, static_cast<int>(smem), p.slices};
  } else if (err == 0) {
    bwd_span_kernel<T, kSteps>
        <<<p.slices, dim3(kLanes, 2 * kShortSegs), smem, stream>>>(p, sc);
    err = static_cast<int>(cudaGetLastError());
  }
  return err;
}

// bwd_chain_kernel's dynamic shared memory: the span's fp32 tile (delta,
// h_prev, du terms), its tiles of u, dt and g, and its B and C.
template <typename T>
size_t chain_smem(int max_groups) {
  return static_cast<size_t>(kSpan) *
         (kLanes * (sizeof(float) + 3 * sizeof(T)) +
          2 * max_groups * sizeof(T));
}

int max_groups_of(int Dim) { return min(kLanes, (kLanes - 1) / Dim + 2); }

template <typename T, int kChunk>
int launch_chain(const Operands<T>& p, const Scratch& sc, const Chain& c,
                 cudaStream_t stream, Shape* shape) {
  const size_t smem = chain_smem<T>(p.max_groups);
  const unsigned blocks = 2u * c.groups * p.spans;
  int per_sm = 0;
  int err = prepare(bwd_chain_kernel<T, kChunk>, kThreads, smem,
                    chain_smem<T>(kLanes), &per_sm);
  if (shape != nullptr) {
    *shape = {per_sm, kThreads, static_cast<int>(smem),
              static_cast<int>(blocks)};
  } else if (err == 0) {
    bwd_chain_kernel<T, kChunk>
        <<<blocks, dim3(kLanes, kWarps + 1), smem, stream>>>(p, sc, c);
    err = static_cast<int>(cudaGetLastError());
  }
  return err;
}

bool aligned16(const void* x) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

// The recurrence's launch (L <= 64: bwd_span_kernel; longer:
// bwd_chain_kernel), or (shape != null) only what it would be.
template <typename T>
int launch_recurrence(const Operands<T>& p, const Scratch& sc,
                      const Chain& c, cudaStream_t stream, Shape* shape) {
  if (p.L <= kShortSpan)
    return span_steps(p.L) == 4 ? launch_span<T, 4>(p, sc, stream, shape)
                                : launch_span<T, 8>(p, sc, stream, shape);
  // 16-byte copies where every row of u, dt and g starts 16-byte aligned
  const void* planes[] = {p.u, p.dt[0], p.dt[1], p.g[0], p.g[1]};
  bool wide = (static_cast<size_t>(p.M) * sizeof(T)) % 16 == 0;
  for (const void* x : planes) wide = wide && aligned16(x);
  return wide ? launch_chain<T, 16>(p, sc, c, stream, shape)
              : launch_chain<T, 4>(p, sc, c, stream, shape);
}

// Scratch and workspace layouts of a call: fp32 values and 64-bit words.
struct Layout {
  long long duterm, cpart, bcpart, scratch;      // fp32 offsets, total
  long long pairs, flags, agg, words;            // word offsets, total
};

Layout layout_of(int L, int M, int Dim) {
  Layout y;
  const long long spans = spans_of(L), groups = groups_of(M);
  y.duterm = 0;
  y.cpart = L <= kShortSpan ? 0 : static_cast<long long>(L) * M;
  y.bcpart = y.cpart + kSums * spans * M;
  y.scratch = y.bcpart + 4LL * L * groups * groups_per_slice(Dim);
  const long long pairs = spans * groups;
  y.pairs = kTicketWords;
  y.flags = y.pairs + pairs;
  y.agg = y.flags + pairs;
  y.words = y.agg + 3 * 2 * pairs * kLanes;
  return y;
}

template <typename T>
int launch(const void* const* in, const float* const* consts, void* du,
           void* ddt_f, void* ddt_r, void* dbcc, float* dconst,
           float* scratch, unsigned long long* ws, unsigned tag, int L,
           int M, int Dim, cudaStream_t stream, Shape* shape) {
  const auto op = [](const void* x) { return static_cast<const T*>(x); };
  Operands<T> p;
  p.u = op(in[0]);
  p.dt[0] = op(in[1]);
  p.dt[1] = op(in[2]);
  p.bc[0] = op(in[3]);
  p.cc[0] = op(in[4]);
  p.bc[1] = op(in[5]);
  p.cc[1] = op(in[6]);
  p.g[0] = op(in[7]);
  p.g[1] = op(in[8]);
  p.hck[0] = consts[0];
  p.hck[1] = consts[1];
  p.A = consts[2];
  p.Dv = consts[3];
  p.bias = consts[4];
  p.du = static_cast<T*>(du);
  p.ddt[0] = static_cast<T*>(ddt_f);
  p.ddt[1] = static_cast<T*>(ddt_r);
  p.L = L;
  p.M = M;
  p.Dim = Dim;
  p.G = M / Dim;
  p.spans = static_cast<int>(spans_of(L));
  p.slices = static_cast<int>(groups_of(M));
  p.J = groups_per_slice(Dim);
  p.max_groups = max_groups_of(Dim);
  const Layout y = layout_of(L, M, Dim);
  const Scratch sc{scratch + y.duterm, scratch + y.cpart, scratch + y.bcpart};
  Chain c;
  c.tickets = reinterpret_cast<unsigned*>(ws);
  c.pairs = ws + y.pairs;
  c.flags = ws + y.flags;
  const size_t plane = 2 * static_cast<size_t>(p.spans) * p.slices * kLanes;
  c.agg_p = ws + y.agg;
  c.agg_e = c.agg_p + plane;
  c.exit = c.agg_e + plane;
  c.tag = tag;
  c.groups = p.slices;
  int err = launch_recurrence<T>(p, sc, c, stream, shape);
  if (shape != nullptr || err != 0) return err;
  const size_t items = static_cast<size_t>(kSums) * M +
                       static_cast<size_t>(4) * L * p.G;
  finish_kernel<T><<<static_cast<unsigned>(
                         (items + kFinishThreads - 1) / kFinishThreads),
                     kFinishThreads, 0, stream>>>(p, sc,
                                                  static_cast<T*>(dbcc),
                                                  dconst);
  return static_cast<int>(cudaGetLastError());
}

int check_sizes(int L, int M, int Dim) {
  if (L <= 0 || M <= 0 || Dim <= 0 || M % (2 * Dim) != 0 || M > (1 << 26) ||
      2 * spans_of(L) * groups_of(M) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// The fp32 values of scratch a call with these dtype, L, M and Dim needs.
extern "C" long long xp_selective_scan_bidir_bwd_scratch(int dtype, int L,
                                                         int M, int Dim) {
  return dtype == 0 || dtype == 1 ? layout_of(L, M, Dim).scratch : 0;
}

// The 64-bit words of workspace a call with these L, M and Dim needs: the
// two tickets, the pair counters and du flags, then the P, E and exit
// words per direction, chain position and lane (M rounded up to the
// block's 32 lanes).
extern "C" long long xp_selective_scan_bidir_bwd_workspace(int L, int M,
                                                           int Dim) {
  return layout_of(L, M, Dim).words;
}

// The recurrence's launch for these dtype, L, M and Dim (16-byte-aligned
// operands), for the measurements: out[0 .. 3] = resident blocks an SM,
// threads a block, dynamic shared memory bytes a block, blocks.
extern "C" int xp_selective_scan_bidir_bwd_shape(int dtype, int L, int M,
                                                 int Dim, int* out) {
  int err = check_sizes(L, M, Dim);
  if (err != 0) return err;
  Shape shape{};
  alignas(16) static char probe[16];
  const void* in[9] = {probe, probe, probe, probe, probe,
                       probe, probe, probe, probe};
  const float* consts[5] = {nullptr, nullptr, nullptr, nullptr, nullptr};
  err = dtype == 0
            ? launch<float>(in, consts, probe, probe, probe, probe, nullptr,
                            nullptr, nullptr, 1, L, M, Dim, nullptr, &shape)
            : launch<__nv_bfloat16>(in, consts, probe, probe, probe, probe,
                                    nullptr, nullptr, nullptr, 1, L, M, Dim,
                                    nullptr, &shape);
  out[0] = shape.per_sm;
  out[1] = shape.threads;
  out[2] = shape.smem;
  out[3] = shape.blocks;
  return err;
}

// dtype: 0 = float32, 1 = bfloat16 (u, dt, bc, cc, g and the outputs du,
// ddt, dbcc share it; u, dt_f, dt_r, g_f and g_r at least 4-byte aligned).
// du, ddt_f, ddt_r: (L, M); dbcc: (4, L, M / Dim) = dB_f, dB_r, dC_f, dC_r;
// dconst: fp32 (2, 3, M) = [direction][dA, dD, dbias][lane]; scratch: fp32,
// xp_selective_scan_bidir_bwd_scratch(L, M, Dim) values; workspace:
// xp_selective_scan_bidir_bwd_workspace(L, M, Dim) 64-bit words, zeroed
// before the first call and reused only by calls on the same stream, each
// with a tag (never 0) higher than the last one given with it. Every output
// is written; nothing needs zeroing.
extern "C" int xp_selective_scan_bidir_bwd(
    int dtype, const void* u, const void* dt_f, const void* dt_r,
    const void* bc_f, const void* cc_f, const void* bc_r, const void* cc_r,
    const void* g_f, const void* g_r, const float* hck_f, const float* hck_r,
    const float* A, const float* Dv, const float* bias, void* du,
    void* ddt_f, void* ddt_r, void* dbcc, float* dconst, float* scratch,
    void* workspace, unsigned tag, int L, int M, int Dim, void* stream) {
  int err = check_sizes(L, M, Dim);
  if (err != 0) return err;
  if (scratch == nullptr || workspace == nullptr || tag == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* x : {u, dt_f, dt_r, g_f, g_r})
    if (reinterpret_cast<uintptr_t>(x) % 4 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
  const void* in[9] = {u, dt_f, dt_r, bc_f, cc_f, bc_r, cc_r, g_f, g_r};
  const float* consts[5] = {hck_f, hck_r, A, Dv, bias};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* ws = static_cast<unsigned long long*>(workspace);
  if (dtype == 0)
    return launch<float>(in, consts, du, ddt_f, ddt_r, dbcc, dconst, scratch,
                         ws, tag, L, M, Dim, s, nullptr);
  if (dtype == 1)
    return launch<__nv_bfloat16>(in, consts, du, ddt_f, ddt_r, dbcc, dconst,
                                 scratch, ws, tag, L, M, Dim, s, nullptr);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* xp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
