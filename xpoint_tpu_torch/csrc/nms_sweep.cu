// Grid box-NMS fixed point: every sweep of one call in one cooperative launch.
//
// Replaces xpoint_tpu/ops/nms.py::_nms_sweep_kernel (pallas_call at :112, in
// _grid_nms_keep_pallas). A sweep is, per pixel of each (H, W) plane,
//
//   keep_out = valid & !(max over the overlap set of S > p),
//   S = keep_in ? p : -inf,
//
// where the overlap set of equal size x size boxes is the strip set
// {(dy, dx): |dx| <= widths[|dy|]} (ops/nms.py::overlap_widths) and pixels
// outside the image count as -inf. The first sweep reads keep_in = valid;
// the sweeps run until one changes nothing (that sweep counts) or H * W have
// run, as ops/nms.py::grid_nms_keep_plain does.
//
// Bound on this card (H100 SXM, 3.35 TB/s, 67 TFLOP/s fp32): the function
// reads p (4 B) and valid (1 B) once and writes keep (1 B) once, 6 B a pixel
// a call, and makes ~2 max_w + 2 |{dy: widths[dy] >= 0}| - 1 comparisons a
// pixel a sweep (25 at size 8, IoU 0.1): for the flagship serving call (16
// planes of 512^2, ~12 sweeps) 0.0075 ms of bytes against ~0.019 ms of
// operations. A design that stages every sweep through device memory moves
// 6 B a pixel a sweep: 0.083 ms at the memory rate for the same call. At
// box 24 (32) the comparisons are 77 (105) a pixel a sweep: 0.048 ms
// (0.066 ms) for 16 planes of 512^2 at 10 sweeps, bound by operations.
//
// The TPU kernel keeps a whole plane in VMEM and loops inside the kernel. A
// 512^2 plane does not fit one SM's shared memory, so here the state lives
// in device memory (p, valid, two keep planes and a flag a tile: 7 B a pixel,
// 29 MiB for the serving call, resident in the 50 MB L2) and one
// cooperative launch runs every sweep: its blocks (as many as can be resident
// at once, at most one a tile) walk the (plane, 32 x 32 tile) list with a
// grid stride, and a grid barrier (cooperative_groups::this_grid().sync())
// ends each sweep. No host round trip: the host neither relaunches nor reads
// a flag between sweeps. A tile stages S over its halo of (size - 1) rows
// and max_w columns in shared memory (p by cp.async, every load of the tile
// issued before the first is waited for), takes the horizontal running
// maxima for each distinct strip width (the row_max of neighbor_max,
// nms.py:70-84) four columns a thread from a window in registers, then
// combines them over the (2 size - 1) shifted rows, again four columns a
// thread with 16-byte shared loads. From the third sweep on a tile is
// computed only where it or one of its eight neighbours changed in the sweep
// before (the halo is < 32, so nothing else reaches it); else its keep is
// that of two sweeps ago, which the ping-pong plane it would write already
// holds. What holds it above its bound: on the serving heatmaps every tile
// changes in each of the first six of ~12 sweeps; a tile's time goes first
// to staging (the wait for its L2 loads, which four blocks an SM cover only
// in part), then to the grid barrier and the wait for the slowest block.
//
// Boxes larger than 16 (a halo wider than the staged tile allows) take a
// second instance of the same launch, nms_kernel<kBanded>: the same
// cooperative loop, grid barrier, change flags and quiet-tile skipping, with
// another tile body, sweep_tile_banded. Its halo is the strip set's own: hy
// = the largest |dy| with a width >= 0 and hx = the largest width (19 and 19
// at size 24, IoU 0.1; 26 and 26 at 32; 52 and 52 at 64), both clamped to
// the plane. The staged instance's one plane of horizontal maxima a distinct
// width does not carry over (12 widths at size 24, 17 at 32, 32 at 64: up to
// 557 KB a tile), so each staged row holds a sparse table instead: level l
// is the maximum over 2^l columns from q, built from level l - 1 with one
// fmaxf, and a window of 2w + 1 columns is the larger of two entries of
// level floor(log2(2w + 1)). The offsets of those two entries a |dy| are
// fixed for the launch; each block computes them once into shared memory
// (dytab, after the table). The (32 + 2 hy) staged rows pass through shared
// memory a band of rows at a time, sized to kBandBytes so that four blocks
// fit an SM: a warp stages S = keep_in ? p : -inf over its row (keep_in with
// __ldcg, p through the read-only path, 32 adjacent columns a load) and
// builds the row's levels, the row being its own (__syncwarp between
// levels); after a barrier each thread folds the band into the four pixels
// it owns (one column, rows 8 apart: a warp shares |dy| and reads 32
// adjacent floats, no bank conflict). A pixel costs two shared reads a row
// of its overlap set a sweep, where reading the set from device memory
// costs 2 max_w + 1 loads a row. Shared memory a block (table + offsets):
// 40,480 B at size 24 (6 levels x 24 rows x 70 columns, 3 bands), 48,600 B
// at 32 (6 x 24 x 84, 4 bands), 30,888 B at 64 (7 x 8 x 136, 17 bands).
// Where all levels of one row cannot fit (a box thousands of pixels wide),
// the top levels are dropped and a window reads one entry every
// 2^(levels - 1) columns. A tile's halo may reach past its eight neighbours
// (hy or hx > 32), so the skipping looks at every tile within ceil(halo /
// 32) tiles. What holds it above its bound (2.81 ms against 0.048 ms at size
// 24 on 16 planes of 512^2, 12 sweeps, NVIDIA H100 80GB HBM3, 700.00 W):
// per-phase clock64 counters in a copy of this file put a block's time at
// 39% staging and table, 31% folding, 24% waiting at the grid barrier for
// the slowest block and 5% writing keep, with 61% of tile visits computed
// (the rest quiet). The staged area is 4.8 times the tile's at size 24 (6.9
// at 32, 18 at 64), and the fold spends ~10 instructions a row for its two
// fmaxf. Neither the band size (32 to 96 KB a block, two to four blocks an
// SM, with and without spills) nor issuing a warp's staging loads eight
// chunks at a time moved the time by more than 5%.
//
// Where blocks share memory within the launch, and how each case is handled:
//  - the keep planes are written by one block and read by others after a
//    barrier, so they are read with __ldcg (L2, never the non-coherent
//    read-only path or a stale L1 line), the banded instance's staging
//    included; p and valid are read-only for the whole launch and keep
//    __restrict__, and the widths table is read with __ldg;
//  - shared memory is the block's own: the banded table is rewritten a
//    band at a time, after a barrier that ends the last band's fold (the
//    first band's writes follow the barrier that ended the tile before),
//    and each row's levels are written and read by one warp alone;
//  - the changed flag: every block that flipped a pixel in sweep i ORs into
//    flag[i % 3]; after the barrier every block reads it (volatile) and all
//    agree whether to stop. Block 0 clears flag[(i + 1) % 3] during sweep i:
//    the last reads of that flag (sweep i - 2's) ended before the barrier
//    that closed sweep i - 1. The wrapper's one memset clears all three;
//  - the per-tile change flags alternate between two arrays by sweep parity,
//    written for every tile in every sweep, so a sweep reads only the array
//    the sweep before wrote;
//  - the answer: sweep i writes keep plane i & 1. After a sweep that changed
//    nothing both planes hold the answer; when the H * W cap stops an odd
//    last sweep, the blocks copy plane 1 to plane 0 after its barrier, so
//    plane 0 (the wrapper's output) always holds the last sweep's mask.
//    Block 0 writes the sweep count to state[3]; the host reads it only if
//    it asks.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxSize = 16;
constexpr int kTileH = 32;
constexpr int kTileW = 32;                 // one warp's lanes
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChecked = kThreads / 9;     // tiles checked a round, 9 each
constexpr int kBanded = 0;                 // nms_kernel<kBanded>: boxes > 16
// the banded instance's table a block aims at: four blocks an SM
constexpr int kBandBytes = 48 * 1024;

struct StripSet {
  int size;                  // box side; vertical halo is size - 1
  int max_w;                 // horizontal halo
  unsigned int slot_mask;    // bit w: w is one of the widths (a slot of R)
  int dy_slot[kMaxSize];     // |dy| -> slot of widths[|dy|], -1 if none
};

// The banded instance's plan (boxes above 16), fixed by the host for a call.
struct BandPlan {
  int hy;                    // vertical halo: largest |dy| with a width >= 0
  int hx;                    // horizontal halo: the largest width
  int span;                  // staged columns a row: kTileW + 2 hx
  int rows;                  // staged rows a band
  int levels;                // sparse-table levels kept (level l: 2^l columns)
  int capped;                // levels < 1 + floor(log2(2 hx + 1))
  int table;                 // floats of the table, even (the offsets follow)
};

struct NmsArgs {
  const float* p;            // (n_planes, H, W) scores
  const uint8_t* valid;      // (n_planes, H, W) 0/1: eligible pixels
  uint8_t* keep[2];          // ping-pong keep planes; keep[0] is the answer
  uint8_t* tile_flip;        // 2 x n_tiles: a tile changed, by sweep parity
  int* state;                // flags[3] by sweep mod 3, sweep count
  int H, W, tiles_x, tiles_per_plane, n_tiles;
  int reach_y, reach_x;      // tiles a halo reaches, each way (at least 1)
  long long max_sweeps;
  StripSet ss;               // the staged instance's strip set
  BandPlan bp;               // the banded instance's plan
  const int* widths;         // the banded instance's: size ints, on device
};

// shared-memory row pitch of the staged S for a halo bound, 16-byte aligned
__host__ __device__ constexpr int stage_pitch(int max_halo) {
  return (kTileW + 2 * max_halo + 3) / 4 * 4;
}

__device__ __forceinline__ void copy4_async(float* dst, const float* src) {
  const unsigned int d =
      static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

// One sweep of the 32 x 32 tile at (y0, x0) of a plane; returns whether any
// of its pixels changed (the same value in every thread of the block).
// kMaxHalo bounds size - 1 and max_w: it fixes the staged row width, so that
// no index needs a division by a runtime width. Shared memory holds S over
// the halo (SH rows of kSW floats; column q is image column x0 - kMaxHalo +
// q) and the horizontal maxima R (n_slots x SH x 32). A thread takes four
// adjacent columns in the horizontal and vertical passes, reading S and R
// 16 bytes at a time; its own pixels are row tid / 8, columns 4 (tid % 8)
// to 4 (tid % 8) + 3 of the tile.
template <int kMaxHalo>
__device__ int sweep_tile(const float* __restrict__ pp,
                          const uint8_t* __restrict__ vv, const uint8_t* kin,
                          uint8_t* kout, int H, int W, int y0, int x0,
                          const StripSet& ss, const int* row_base, float* S,
                          float* R) {
  constexpr int kSpan = kTileW + 2 * kMaxHalo;        // staged columns
  constexpr int kSW = stage_pitch(kMaxHalo);          // row pitch, 16 B
  constexpr int kStage = ((kTileH + 2 * kMaxHalo) * kSW + kThreads - 1) /
                         kThreads;
  constexpr int kGroups = kTileW / 4;                 // 4-column groups
  constexpr int kRowJobs = ((kTileH + 2 * kMaxHalo) * kGroups + kThreads -
                            1) / kThreads;
  constexpr int kWin = (4 + 2 * kMaxHalo + 3) / 4 * 4;  // window, float4s
  static_assert(kGroups * kTileH == kThreads, "one 4-pixel group a thread");
  static_assert(4 * (kGroups - 1) + kWin <= kSW, "window inside the row");
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const int hy = ss.size - 1;
  const int hx = ss.max_w;
  const unsigned int mask = ss.slot_mask;
  const int SH = kTileH + 2 * hy;

  // every global load of the tile first, so that their latencies overlap:
  // p over the halo straight into shared memory (cp.async: p is read-only),
  // keep_in over the halo, and p, keep_in and valid of the own pixels
  static_assert(kStage <= 32, "keep_in bits of the halo in one word");
  unsigned int halo_keep = 0;             // bit k: keep_in of element k
#pragma unroll
  for (int k = 0; k < kStage; ++k) {
    const int e = tid + kThreads * k;
    const int r = e / kSW;
    const int q = e % kSW;
    const int gy = y0 - hy + r;
    const int gx = x0 - kMaxHalo + q;
    if (r < SH && q < kSpan && gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const int o = gy * W + gx;
      copy4_async(S + e, pp + o);
      halo_keep |= static_cast<unsigned int>(__ldcg(kin + o) != 0) << k;
    }
  }
  const int own_r = tid / kGroups;
  const int own_c = 4 * (tid % kGroups);
  const int gy = y0 + own_r;
  float own_p[4];
  unsigned int own_bits = 0;              // bit k: keep_in, bit 4 + k: valid
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int gx = x0 + own_c + k;
    own_p[k] = 0.f;
    if (gy < H && gx < W) {
      const int o = gy * W + gx;
      own_p[k] = pp[o];
      own_bits |= (static_cast<unsigned int>(__ldcg(kin + o) != 0) << k) |
                  (static_cast<unsigned int>(vv[o] != 0) << (4 + k));
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  // S = keep_in ? p : -inf, -inf outside the image
#pragma unroll
  for (int k = 0; k < kStage; ++k) {
    const int e = tid + kThreads * k;
    if (e / kSW < SH && !((halo_keep >> k) & 1u)) S[e] = -INFINITY;
  }
  __syncthreads();

  // horizontal running maxima |dx| <= w of four adjacent columns, from a
  // window of S in registers, stored for each distinct width
#pragma unroll 1
  for (int job = 0; job < kRowJobs; ++job) {
    const int j = tid + kThreads * job;
    const int r = j / kGroups;
    if (r >= SH) break;
    const int c = 4 * (j % kGroups);
    float win[kWin];
#pragma unroll
    for (int t = 0; t < kWin; t += 4) {
      const float4 v = *reinterpret_cast<const float4*>(S + r * kSW + c + t);
      win[t] = v.x;
      win[t + 1] = v.y;
      win[t + 2] = v.z;
      win[t + 3] = v.w;
    }
    float m[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) m[k] = win[kMaxHalo + k];
    float4* out = reinterpret_cast<float4*>(R + r * kTileW + c);
    int slot = 0;
    if (mask & 1u) {
      out[0] = make_float4(m[0], m[1], m[2], m[3]);
      slot = 1;
    }
#pragma unroll
    for (int w = 1; w <= kMaxHalo; ++w) {
      if (w > hx) break;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        m[k] = fmaxf(m[k], fmaxf(win[kMaxHalo + k + w], win[kMaxHalo + k - w]));
      if ((mask >> w) & 1u) {
        out[slot * SH * kGroups] = make_float4(m[0], m[1], m[2], m[3]);
        ++slot;
      }
    }
  }
  __syncthreads();

  // vertical combine over |dy| <= size - 1, each row at its strip's width
  float nm[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j <= 2 * kMaxHalo; ++j) {
    if (j > 2 * hy) break;
    const int base = row_base[j];
    if (base < 0) continue;
    const float4 v = *reinterpret_cast<const float4*>(
        R + base + own_r * kTileW + own_c);
    nm[0] = fmaxf(nm[0], v.x);
    nm[1] = fmaxf(nm[1], v.y);
    nm[2] = fmaxf(nm[2], v.z);
    nm[3] = fmaxf(nm[3], v.w);
  }

  int flipped = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int gx = x0 + own_c + k;
    if (gy < H && gx < W) {
      const unsigned int nk =
          ((own_bits >> (4 + k)) & 1u) && !(nm[k] > own_p[k]);
      flipped |= nk != ((own_bits >> k) & 1u);
      kout[gy * W + gx] = static_cast<uint8_t>(nk);
    }
  }
  return __syncthreads_or(flipped);
}

// The banded instance's vertical combine over one band: nm[j] takes the
// maximum over the band's staged rows r that row j of the thread reaches
// (|r - (row + hy)| <= hy) of the horizontal maximum at that row's width,
// read from the sparse table at the two offsets dytab[|dy|] gives (or, with
// the levels capped, at every 2^(levels - 1) columns from the first to the
// second). `col` is the table at the thread's column.
template <bool kCapped>
__device__ __forceinline__ void band_combine(float (&nm)[4], const float* col,
                                             const int2* dytab, int rb,
                                             int n, int hy, int span,
                                             int step) {
#pragma unroll
  for (int j = 0; j < kTileH / kWarps; ++j) {
    const int yj = threadIdx.y + kWarps * j;  // its staged row is yj + hy
    const int hi = min(rb + n, yj + 2 * hy + 1);
    float m = nm[j];
#pragma unroll 2
    for (int r = max(rb, yj); r < hi; ++r) {
      const int d = r - yj - hy;
      const int2 o = dytab[d < 0 ? -d : d];
      if (o.x < 0) continue;                  // no strip at this |dy|
      const float* row = col + (r - rb) * span;
      float v = row[o.y];
      if constexpr (kCapped) {
        for (int q = o.x; q < o.y; q += step) v = fmaxf(v, row[q]);
      } else {
        v = fmaxf(v, row[o.x]);
      }
      m = fmaxf(m, v);
    }
    nm[j] = m;
  }
}

// One sweep of the 32 x 32 tile at (y0, x0) for boxes above 16. The staged
// rows (the tile's and bp.hy above and below it) go through shared memory a
// band of bp.rows at a time: a warp stages S = keep_in ? p : -inf over a row
// of bp.span columns (column q is image column x0 - hx + q) and builds that
// row's sparse table in place (level l holds the maximum over 2^l columns
// from q; __syncwarp between levels, the row being the warp's own), then,
// after a barrier, every thread folds the band into the four pixels it owns
// (column lane, rows warp + 8 j) with band_combine. A window of 2w + 1
// columns is the maximum of two entries of level floor(log2(2w + 1)).
// Returns whether any pixel changed (the same value in every thread).
__device__ int sweep_tile_banded(const float* __restrict__ pp,
                                 const uint8_t* __restrict__ vv,
                                 const uint8_t* kin, uint8_t* kout, int H,
                                 int W, int y0, int x0, const BandPlan& bp,
                                 const int2* dytab, float* T) {
  const int lane = threadIdx.x;
  const int gx = x0 + lane;
  const int hy = bp.hy, hx = bp.hx, span = bp.span;
  const int level = bp.rows * span;             // floats a level
  // the own pixels' loads first, so that they overlap the staging
  float own_p[kTileH / kWarps];
  unsigned int own_bits = 0;                    // bit j: keep_in, 4 + j: valid
#pragma unroll
  for (int j = 0; j < kTileH / kWarps; ++j) {
    const int gy = y0 + threadIdx.y + kWarps * j;
    own_p[j] = 0.f;
    if (gy < H && gx < W) {
      const int o = gy * W + gx;
      own_p[j] = pp[o];
      own_bits |= (static_cast<unsigned int>(__ldcg(kin + o) != 0) << j) |
                  (static_cast<unsigned int>(vv[o] != 0) << (4 + j));
    }
  }
  float nm[kTileH / kWarps];
#pragma unroll
  for (int j = 0; j < kTileH / kWarps; ++j) nm[j] = -INFINITY;

  const int SH = kTileH + 2 * hy;
  for (int rb = 0; rb < SH; rb += bp.rows) {
    const int n = min(bp.rows, SH - rb);
    if (rb > 0) __syncthreads();                // the last band is folded
    for (int b = threadIdx.y; b < n; b += kWarps) {
      float* row = T + b * span;
      const int gy = y0 - hy + rb + b;
      const bool in_y = gy >= 0 && gy < H;
#pragma unroll 4
      for (int q = lane; q < span; q += 32) {
        const int x = x0 - hx + q;
        float v = -INFINITY;
        if (in_y && x >= 0 && x < W) {
          const int o = gy * W + x;
          const float pv = pp[o];
          v = __ldcg(kin + o) ? pv : -INFINITY;
        }
        row[q] = v;
      }
      for (int l = 1; l < bp.levels; ++l) {
        __syncwarp();
        const float* src = row + (l - 1) * level;
        float* dst = row + l * level;
        const int h = 1 << (l - 1);
        for (int q = lane; q + 2 * h <= span; q += 32)
          dst[q] = fmaxf(src[q], src[q + h]);
      }
    }
    __syncthreads();
    const float* col = T + lane;
    if (bp.capped)
      band_combine<true>(nm, col, dytab, rb, n, hy, span,
                         1 << (bp.levels - 1));
    else
      band_combine<false>(nm, col, dytab, rb, n, hy, span, 0);
  }

  int flipped = 0;
#pragma unroll
  for (int j = 0; j < kTileH / kWarps; ++j) {
    const int gy = y0 + threadIdx.y + kWarps * j;
    if (gy < H && gx < W) {
      const unsigned int nk =
          ((own_bits >> (4 + j)) & 1u) && !(nm[j] > own_p[j]);
      flipped |= nk != ((own_bits >> j) & 1u);
      kout[gy * W + gx] = static_cast<uint8_t>(nk);
    }
  }
  return __syncthreads_or(flipped);
}

// Four blocks an SM (64 registers, a few spilled) cover more of the tiles'
// load latency than two without spills. kMaxHalo: the staged instance's
// halo bound, or kBanded for boxes above 16.
template <int kMaxHalo>
__global__ void __launch_bounds__(kThreads, 4) nms_kernel(const NmsArgs a) {
  extern __shared__ float smem[];
  __shared__ unsigned int dirty;          // tiles of this round to compute
  // offset in R of the row dy + size - 1 of its strip's width, -1 if none
  __shared__ int row_base[2 * kMaxSize - 1];
  cg::grid_group grid = cg::this_grid();
  const int SH = kTileH + 2 * (a.ss.size - 1);
  float* S = smem;                        // SH x stage_pitch(kMaxHalo)
  float* R = smem + SH * stage_pitch(kMaxHalo);  // n_slots x SH x kTileW
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const int tiles_y = a.tiles_per_plane / a.tiles_x;
  // tiles whose change can reach a tile, itself included
  const int reach_w = 2 * a.reach_x + 1;
  const int n_reach = (2 * a.reach_y + 1) * reach_w;
  // the banded instance's offsets a |dy|, after its table
  int2* dytab = reinterpret_cast<int2*>(smem + a.bp.table);
  if constexpr (kMaxHalo == kBanded) {    // read after the first barrier
    for (int d = tid; d <= a.bp.hy; d += kThreads) {
      const int w = d < a.ss.size ? min(__ldg(a.widths + d), a.W - 1) : -1;
      int2 o = make_int2(-1, -1);
      if (w >= 0) {
        const int k = min(31 - __clz(2 * w + 1), a.bp.levels - 1);
        const int base = k * a.bp.rows * a.bp.span + a.bp.hx;
        o = make_int2(base - w, base + w - (1 << k) + 1);
      }
      dytab[d] = o;
    }
  } else if (tid < 2 * a.ss.size - 1) {   // read after the first barrier
    const int hy = a.ss.size - 1;
    const int s = a.ss.dy_slot[tid < hy ? hy - tid : tid - hy];
    row_base[tid] = s < 0 ? -1 : (s * SH + tid) * kTileW;
  }

  long long sweep = 0;
  int changed = 0;
  for (;;) {
    const uint8_t* kin = sweep == 0 ? a.valid : a.keep[(sweep + 1) & 1];
    uint8_t* kout = a.keep[sweep & 1];
    uint8_t* flips_now = a.tile_flip + (sweep & 1) * a.n_tiles;
    const uint8_t* flips_before = a.tile_flip + ((sweep + 1) & 1) * a.n_tiles;
    int* flag = a.state + sweep % 3;
    if (blockIdx.x == 0 && tid == 0) atomicExch(a.state + (sweep + 1) % 3, 0);

    int any = 0;
    for (long long k0 = 0; blockIdx.x + k0 * gridDim.x < a.n_tiles;
         k0 += kChecked) {
      // which of this block's next kChecked tiles to compute: all in the
      // first two sweeps (plane 1 holds nothing yet), then those where the
      // tile or a tile its halo reaches changed in the sweep before (9
      // threads a tile; with the staged instance's halo < 32 those are the
      // eight neighbours, one each)
      __syncthreads();                    // the last round's bits are read
      if (tid == 0) dirty = sweep < 2 ? ~0u : 0u;
      __syncthreads();
      if (sweep >= 2 && tid < 9 * kChecked) {
        const long long t = blockIdx.x + (k0 + tid / 9) * gridDim.x;
        if (t < a.n_tiles) {
          const int plane = static_cast<int>(t / a.tiles_per_plane);
          const int in_plane = static_cast<int>(t % a.tiles_per_plane);
          for (int n = tid % 9; n < n_reach; n += 9) {
            const int ny = in_plane / a.tiles_x + n / reach_w - a.reach_y;
            const int nx = in_plane % a.tiles_x + n % reach_w - a.reach_x;
            if (ny >= 0 && ny < tiles_y && nx >= 0 && nx < a.tiles_x &&
                __ldcg(flips_before + plane * a.tiles_per_plane +
                       ny * a.tiles_x + nx))
              atomicOr(&dirty, 1u << (tid / 9));
          }
        }
      }
      __syncthreads();
      const unsigned int bits = dirty;
      for (int k = 0; k < kChecked; ++k) {
        const long long t = blockIdx.x + (k0 + k) * gridDim.x;
        if (t >= a.n_tiles) break;
        int flipped = 0;
        if ((bits >> k) & 1u) {
          const int plane = static_cast<int>(t / a.tiles_per_plane);
          const int in_plane = static_cast<int>(t % a.tiles_per_plane);
          const size_t off = (size_t)plane * a.H * a.W;
          const int y0 = in_plane / a.tiles_x * kTileH;
          const int x0 = in_plane % a.tiles_x * kTileW;
          if constexpr (kMaxHalo == kBanded)
            flipped = sweep_tile_banded(a.p + off, a.valid + off, kin + off,
                                        kout + off, a.H, a.W, y0, x0, a.bp,
                                        dytab, smem);
          else
            flipped = sweep_tile<kMaxHalo>(
                a.p + off, a.valid + off, kin + off, kout + off, a.H, a.W,
                y0, x0, a.ss, row_base, S, R);
        }
        if (tid == 0) flips_now[t] = static_cast<uint8_t>(flipped);
        any |= flipped;
      }
    }
    if (any && tid == 0) atomicOr(flag, 1);
    grid.sync();
    changed = *static_cast<volatile int*>(flag);
    ++sweep;
    if (!changed || sweep >= a.max_sweeps) break;
  }

  // stopped by the cap after an odd sweep: its mask is in plane 1
  if (changed && ((sweep - 1) & 1)) {
    const size_t n = (size_t)a.n_tiles / a.tiles_per_plane * a.H * a.W;
    for (size_t i = (size_t)blockIdx.x * kThreads + tid; i < n;
         i += (size_t)gridDim.x * kThreads)
      a.keep[0][i] = __ldcg(a.keep[1] + i);
  }
  if (blockIdx.x == 0 && tid == 0) a.state[3] = static_cast<int>(sweep);
}

// the grid of the last launch's configuration: resident blocks on this
// device at this shared memory size
int g_device = -1;
size_t g_smem = 0;
const void* g_kernel = nullptr;
int g_resident = 0;
int g_per_sm = 0;
int g_blocks = 0;                          // blocks of the last launch
BandPlan g_plan = {};                      // the last launch's band plan

// The fields of NmsArgs both instances share, with the tiles a halo of
// halo_y rows and halo_x columns reaches; cudaErrorInvalidValue for a shape
// the launch cannot index.
int init_args(NmsArgs& a, const float* p, const uint8_t* valid, uint8_t* keep,
              uint8_t* scratch, int* state, int n_planes, int H, int W,
              int halo_y, int halo_x) {
  if (n_planes <= 0 || H <= 0 || W <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_tiles = (long long)((H + kTileH - 1) / kTileH) *
                            ((W + kTileW - 1) / kTileW) * n_planes;
  if (n_tiles >= (1LL << 31) || (long long)H * W >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  a.p = p;
  a.valid = valid;
  a.keep[0] = keep;
  a.keep[1] = scratch;
  a.tile_flip = scratch + (size_t)n_planes * H * W;
  a.state = state;
  a.H = H;
  a.W = W;
  a.tiles_x = (W + kTileW - 1) / kTileW;
  a.tiles_per_plane = a.tiles_x * ((H + kTileH - 1) / kTileH);
  a.n_tiles = static_cast<int>(n_tiles);
  a.max_sweeps = (long long)H * W;
  a.reach_y = halo_y > kTileH ? (halo_y + kTileH - 1) / kTileH : 1;
  a.reach_x = halo_x > kTileW ? (halo_x + kTileW - 1) / kTileW : 1;
  a.bp = BandPlan{};
  a.widths = nullptr;
  return 0;
}

// One cudaMemsetAsync of the flags and one cooperative launch of `kernel`
// with as many blocks as can be resident (at most one a tile).
int launch(const NmsArgs& a, const void* kernel, size_t smem, void* stream) {
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device != g_device || smem != g_smem || kernel != g_kernel) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_device = device;
    g_smem = smem;
    g_kernel = kernel;
    g_per_sm = per_sm;
    g_resident = per_sm * sms;
  }
  // no resident block (too much shared memory): the launch below is refused
  const int blocks = a.n_tiles < g_resident
                         ? a.n_tiles
                         : (g_resident > 0 ? g_resident : 1);
  g_blocks = blocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(a.state, 0, 4 * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  NmsArgs arg = a;
  void* args[] = {&arg};
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(32, kWarps),
                                    args, smem, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of scratch xp_nms and xp_nms_banded need: the second keep plane and
// two tile flags.
extern "C" long long xp_nms_scratch(int n_planes, int H, int W) {
  const long long tiles = (long long)((H + kTileH - 1) / kTileH) *
                          ((W + kTileW - 1) / kTileW) * n_planes;
  return (long long)n_planes * H * W + 2 * tiles;
}

// p: (n_planes, H, W) fp32 scores; valid: (n_planes, H, W) uint8 0/1;
// keep: (n_planes, H, W) uint8, the answer; scratch: xp_nms_scratch bytes;
// state: 4 device ints, zeroed here (the flags) and the sweep count in
// state[3] after the launch. widths: size host ints
// (ops/nms.py::overlap_widths), 1 <= size <= 16. One cudaMemsetAsync and one
// cooperative launch on `stream`; returns the first CUDA error, a refused
// launch included.
extern "C" int xp_nms(const float* p, const uint8_t* valid, uint8_t* keep,
                      uint8_t* scratch, int* state, int n_planes, int H, int W,
                      int size, const int* widths, void* stream) {
  if (size < 1 || size > kMaxSize)
    return static_cast<int>(cudaErrorInvalidValue);
  NmsArgs a;
  StripSet& ss = a.ss;
  ss.max_w = 0;
  int n_slots = 0;           // distinct non-negative widths, ascending
  ss.slot_mask = 0;
  for (int d = 0; d < size; ++d)
    if (widths[d] > ss.max_w) ss.max_w = widths[d];
  int slot_of_w[kMaxSize];
  for (int w = 0; w <= ss.max_w; ++w) {
    bool used = false;
    for (int d = 0; d < size; ++d) used = used || widths[d] == w;
    slot_of_w[w] = used ? n_slots++ : -1;
    if (used) ss.slot_mask |= 1u << w;
  }
  for (int d = 0; d < kMaxSize; ++d)
    ss.dy_slot[d] = d < size && widths[d] >= 0 ? slot_of_w[widths[d]] : -1;
  const int err = init_args(a, p, valid, keep, scratch, state, n_planes, H, W,
                            size - 1, ss.max_w);
  if (err) return err;
  ss.size = size;

  // boxes up to 8 (every config) take the narrower staged rows
  const int max_halo = size <= 8 ? 7 : 15;
  const void* kernel = size <= 8
                           ? reinterpret_cast<const void*>(nms_kernel<7>)
                           : reinterpret_cast<const void*>(nms_kernel<15>);
  const int SH = kTileH + 2 * (size - 1);
  const size_t smem = sizeof(float) * (size_t)SH *
                      (stage_pitch(max_halo) + (size_t)n_slots * kTileW);
  g_plan = BandPlan{};
  return launch(a, kernel, smem, stream);
}

// As xp_nms for boxes above 16 (any size: the banded instance). widths:
// `size` ints, on the host (to plan the launch) and on the device (for the
// kernel), equal; a size below 1 has an empty overlap set. A width past the
// plane (>= W) acts as W - 1, and rows past it (|dy| >= H) hold nothing, so
// the halo is clamped to the plane. One staged row of one level and the
// offsets must fit a block's shared memory (227 KB): a box some 18,000
// pixels across on a plane of over 14,000 in both directions is refused
// with cudaErrorInvalidValue. Where all levels of a row do not fit, the top
// levels are dropped and a wide window takes one read every 2^(levels - 1)
// columns.
extern "C" int xp_nms_banded(const float* p, const uint8_t* valid,
                             uint8_t* keep, uint8_t* scratch, int* state,
                             int n_planes, int H, int W, int size,
                             const int* widths, const int* widths_device,
                             void* stream) {
  BandPlan bp = {};
  bp.hy = -1;
  for (int d = 0; d < size; ++d)
    if (widths[d] >= 0) {
      bp.hy = d;
      bp.hx = std::max(bp.hx, std::min(widths[d], W - 1));
    }
  bp.hy = std::max(0, std::min(bp.hy, H - 1));  // no strip: never read
  NmsArgs a;
  const int err = init_args(a, p, valid, keep, scratch, state, n_planes, H, W,
                            bp.hy, bp.hx);
  if (err) return err;
  int device, smem_max;
  cudaError_t cerr = cudaGetDevice(&device);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  cerr = cudaDeviceGetAttribute(&smem_max,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                device);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  bp.span = kTileW + 2 * bp.hx;
  const int all_levels = 32 - __builtin_clz(2 * bp.hx + 1);
  const long long offsets = 8LL * (bp.hy + 1);   // an int2 a |dy|
  const long long room = smem_max - offsets - 4;  // - 4: the table is even
  bp.levels = all_levels;
  while (bp.levels > 1 && 4LL * bp.levels * bp.span > room) --bp.levels;
  const long long row = 4LL * bp.levels * bp.span;
  if (row > room) return static_cast<int>(cudaErrorInvalidValue);
  bp.capped = bp.levels < all_levels;
  long long rows = kBandBytes / row;
  if (rows >= kWarps) rows -= rows % kWarps;     // whole rows a warp
  rows = std::min({std::max(rows, 1LL), (long long)(kTileH + 2 * bp.hy),
                   room / row});
  bp.rows = static_cast<int>(rows);
  bp.table = (bp.levels * bp.rows * bp.span + 1) / 2 * 2;
  a.bp = bp;
  a.ss.size = size;
  a.widths = widths_device;
  g_plan = bp;
  const size_t smem = 4 * (size_t)bp.table + (size_t)offsets;
  return launch(a, reinterpret_cast<const void*>(nms_kernel<kBanded>), smem,
                stream);
}

// The last launch's shape, for reports: dynamic shared memory bytes a
// block, resident blocks an SM, blocks launched, and its band rows, table
// levels and staged columns (0 for the staged instance).
extern "C" void xp_nms_last_launch(long long* out) {
  const long long v[6] = {(long long)g_smem, g_per_sm, g_blocks,
                          g_plan.rows, g_plan.levels, g_plan.span};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
}

extern "C" const char* xp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
