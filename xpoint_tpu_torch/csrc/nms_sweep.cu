// Grid box-NMS fixed point: every sweep of one call in one launch.
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
// run, as ops/nms.py::grid_nms_keep_plain does. A plane that has converged
// does not change when swept again, so each plane may stop at its own fixed
// point: the call's count is the largest of a plane's. Every instance also
// adds the sweeps each plane ran to the caller's 64-bit counter, when one is
// given (plane_sweeps; the resident one each plane's own count, the staged
// and banded ones, which sweep every plane each time, sweeps x planes): the
// work of the call, never read back by the launch.
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
// Three instances, chosen by the call's shape:
//
// The resident instance (nms_resident_kernel: boxes up to 16 on planes that
// fit a cluster, in calls whose clusters hold at least a quarter of the
// SMs: every serving path's). The TPU kernel keeps a whole plane in VMEM
// and loops there; here a plane stays in one thread-block cluster's shared
// memory and converges there. One launch (cudaLaunchKernelEx, a cluster
// dimension, no cooperative launch, no grid barrier) holds a cluster of C
// blocks for each plane; block `rank` owns rows [rank R, rank R + R), R =
// ceil(H / C). It stages, once a call, p over its own rows and the hy halo
// rows above and below them from device memory (cp.async, fp32, a margin of
// kPad columns each side) and valid over its own rows as bits; the keep
// masks are two ping-pong planes of bits over the same staged rows.
//  - The split: C is the one of 1..16 (above 8 where the device allows
//    non-portable clusters) whose blocks fit shared memory and whose walk
//    is shortest: waves of resident clusters (cudaOccupancyMaxActiveClusters,
//    read once a device and shape) x blocks sharing an SM x a block's walk
//    (walk_cost: the row steps its warps issue plus 7 times the longest
//    walk of a warp, fitted to timings on an H100; it also sets the tile
//    height). The flagship serving call (16 planes of 512^2, size 8)
//    takes C = 6: 86 rows a block, 227,280 B of shared memory
//    (98 staged rows of 528 floats, 2 x 98 + 86 rows of 18 words of bits),
//    tiles of 29 rows, one block an SM, 17 clusters resident, one wave on
//    96 SMs; a single 512^2 plane C = 16 (32 rows, 101,568 B, tiles of 16).
//  - The fit rule: a split fits where a block's shared memory (4 B x
//    ((R + 2 hy) pitch + (3 R + 4 hy) bit words)) is within the opt-in limit
//    less the kernel's static shared memory (232,448 - 2,128 B on an H100):
//    at W = 512 and size 8, H up to 1,392 (16 blocks of 87 rows);
//    xp_nms_fit_rows gives the largest H a width takes. JAX's
//    _nms_vmem_ok takes the Pallas kernel where H W 4 8 <= 12 MiB (p and
//    ~6 live sweep planes in VMEM) with W % 128 == 0 and H % 8 == 0. Planes
//    that do not fit (say (1, 2048, 2048)) take the staged instance below
//    (the banded one timed 1.46 ms there against the staged one's 0.57 ms
//    at size 8, NVIDIA H100 80GB HBM3, 700.00 W), and so do calls whose
//    clusters would hold under a quarter of the SMs (res_take: the one or
//    two planes of evaluation, the CLIs, the sweeps and the HA export; 16
//    blocks of 132 SMs took 0.151 ms at (1, 512, 512), size 8, where the
//    staged launch over every SM took 0.078).
//  - The halo: at the start of each sweep a block copies its halo rows'
//    keep_in bits (18 words a row at 512 columns) from the blocks that own
//    them, through distributed shared memory (cluster.map_shared_rank); p's
//    halo rows never change and were staged with the own rows.
//  - A sweep: each warp takes tiles of `seg` rows x 32 kCols columns (16
//    warps, 4 columns a lane for the compiled-in strip sets of boxes 8 and
//    4 at IoU 0.1; 8 warps otherwise) and walks their rows once from hy
//    above to hy below, building S from p and the keep bits in shared
//    memory, the horizontal running maxima for each width and the pending
//    output rows' maxima in registers (res_tile); keep_out goes to the
//    other ping-pong plane as bits, whole words.
//  - One barrier a sweep: sweep i reads plane i & 1 and writes plane (i + 1)
//    & 1. A neighbour reads a block's plane i & 1 (its own rows, the halo
//    copy) and its tiles' change records of parity (i - 1) & 1 during sweep
//    i; the block wrote them in sweep i - 1, before the barrier that ended
//    it, and writes them next in sweep i + 1, after the barrier that ends
//    sweep i, which the reader must also reach. So one cluster.sync() a sweep
//    orders every access.
//  - The flag: a block that flipped a pixel in sweep i ORs 1 into rank 0's
//    shared word i % 3 before the barrier; after it every block reads that
//    word, so all agree to stop after the same sweep. Rank 0 clears word
//    (i + 1) % 3 during sweep i: its last reads (sweep i - 2's) ended
//    before the barrier that closed sweep i - 1, and its next writes follow
//    the barrier that closes sweep i. The three words are cleared before
//    the first barrier, which also lets every block start before any
//    reads another's shared memory.
//  - No block exits early: every block of a plane runs the same sweeps,
//    and after the last barrier each reads rank 0's word, so the loop ends
//    with one more cluster.sync() before any block leaves. Each plane stops
//    at its own fixed point (or its H * W cap) and writes its mask from
//    shared memory to keep once, four pixels a store; rank 0 puts the
//    plane's count into state[3] with atomicMax and adds it to the
//    plane-sweep counter.
//  - Quiet tiles: each computed tile records the first and last row and
//    bit word where its pixels changed. From the third sweep on a tile is
//    computed only where such a record of a tile near it (in this block or
//    another) meets the rows within hy and the words within hx of the
//    tile, that is where a pixel its strip sets reach changed in the sweep
//    before; else its keep is that of two sweeps ago, which the plane it
//    would write already holds.
//  - What holds it (a clock64 profile of a copy of this file, thread 0 of
//    each block summing per phase; the serving heatmaps, 16 x 512^2, size
//    8, 12 sweeps; NVIDIA H100 80GB HBM3, 700.00 W): 82% of a block's
//    cycles walking tiles, 11% at the cluster barrier (waiting for the
//    slowest block), 3% staging, 2% in the halo copy and the quiet-tile
//    check, 2% writing the answer; 77% of tile visits computed. A walk
//    costs ~184 instructions a row step for 4 columns (SASS: 101 of them
//    the comparisons, 12 a column for the running maxima and 13 for the
//    pending rows; 18 building S from the keep bits) and walks 2 hy rows
//    more than a tile's own (34 for 22 in that profile), so the kernel is
//    bound by issuing instructions, not by memory: ~3x the comparisons of
//    the bound. One plane's cluster holds at most 16 of the 132 SMs, so a
//    call of one or two planes is slower than a launch over every SM
//    (PERF.md): those take the staged instance. Sending the keep bits by
//    ballots instead of shuffles, eight
//    columns a lane and 8 warps instead of 16 were no faster.
//
// The staged instance (nms_kernel<7> and <15>: boxes up to 16 on planes that
// do not fit a cluster, or in calls of too few clusters to fill a quarter
// of the SMs). The state lives in device memory (p, valid, two
// keep planes and a flag a tile, resident in the 50 MB L2) and one
// cooperative launch runs every sweep: its blocks (as many as can be
// resident at once, at most one a tile) walk the (plane, 32 x 32 tile) list
// with a grid stride, and a grid barrier (cooperative_groups::this_grid()
// .sync()) ends each sweep. A tile stages S over its halo of (size - 1)
// rows and max_w columns in shared memory (p by cp.async), takes the
// horizontal running maxima for each distinct strip width four columns a
// thread from a window in registers, then combines them over the
// (2 size - 1) shifted rows. From the third sweep on a tile is computed only
// where it or one of its eight neighbours changed in the sweep before. What
// holds it: each sweep stages every tile's halo from L2 again and waits at
// the grid barrier for the slowest block.
//
// The banded instance (boxes larger than 16: a halo wider than the staged
// tile allows) is a second instance of that launch, nms_kernel<kBanded>: the
// same cooperative loop, grid barrier, change flags and quiet-tile skipping,
// with another tile body, sweep_tile_banded. Its halo is the strip set's
// own: hy = the largest |dy| with a width >= 0 and hx = the largest width
// (19 and 19 at size 24, IoU 0.1; 26 and 26 at 32; 52 and 52 at 64), both
// clamped to the plane. The staged instance's one plane of horizontal maxima
// a distinct width does not carry over (12 widths at size 24, 17 at 32, 32
// at 64: up to 557 KB a tile), so each staged row holds a sparse table
// instead: level l is the maximum over 2^l columns from q, built from level
// l - 1 with one fmaxf, and a window of 2w + 1 columns is the larger of two
// entries of level floor(log2(2w + 1)). The offsets of those two entries a
// |dy| are fixed for the launch; each block computes them once into shared
// memory (dytab, after the table). The (32 + 2 hy) staged rows pass through
// shared memory a band of rows at a time, sized to kBandBytes so that four
// blocks fit an SM: a warp stages S = keep_in ? p : -inf over its row
// (keep_in with __ldcg, p through the read-only path, 32 adjacent columns a
// load) and builds the row's levels, the row being its own (__syncwarp
// between levels); after a barrier each thread folds the band into the four
// pixels it owns (one column, rows 8 apart: a warp shares |dy| and reads 32
// adjacent floats, no bank conflict). A pixel costs two shared reads a row
// of its overlap set a sweep, where reading the set from device memory costs
// 2 max_w + 1 loads a row. Shared memory a block (table + offsets): 40,480 B
// at size 24 (6 levels x 24 rows x 70 columns, 3 bands), 48,600 B at 32 (6 x
// 24 x 84, 4 bands), 30,888 B at 64 (7 x 8 x 136, 17 bands). Where all
// levels of one row cannot fit (a box thousands of pixels wide), the top
// levels are dropped and a window reads one entry every 2^(levels - 1)
// columns. A tile's halo may reach past its eight neighbours (hy or hx >
// 32), so the skipping looks at every tile within ceil(halo / 32) tiles.
// What holds it above its bound (2.81 ms against 0.048 ms at size 24 on 16
// planes of 512^2, 12 sweeps, NVIDIA H100 80GB HBM3, 700.00 W): per-phase
// clock64 counters in a copy of this file put a block's time at 39% staging
// and table, 31% folding, 24% waiting at the grid barrier for the slowest
// block and 5% writing keep, with 61% of tile visits computed (the rest
// quiet). The staged area is 4.8 times the tile's at size 24 (6.9 at 32, 18
// at 64), and the fold spends ~10 instructions a row for its two fmaxf.
// Neither the band size (32 to 96 KB a block, two to four blocks an SM, with
// and without spills) nor issuing a warp's staging loads eight chunks at a
// time moved the time by more than 5%.
//
// Where blocks of the cooperative instances share memory within the launch,
// and how each case is handled:
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
#include <climits>
#include <math.h>
#include <mutex>
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
  unsigned long long* plane_sweeps;  // += sweeps x planes, or null
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
  if (blockIdx.x == 0 && tid == 0) {
    a.state[3] = static_cast<int>(sweep);
    if (a.plane_sweeps != nullptr)
      atomicAdd(a.plane_sweeps, static_cast<unsigned long long>(sweep) *
                                    (a.n_tiles / a.tiles_per_plane));
  }
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
  a.plane_sweeps = nullptr;
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


// ---------------------------------------------------------------------------
// The resident instance (boxes up to 16 on planes that fit a cluster): one
// thread-block cluster a plane, each block owning a run of whole rows.

constexpr int kMaxTiles = 64;              // tiles a block (in shared memory)
constexpr int kMaxCluster = 16;            // blocks a cluster (non-portable)

// Strip sets compiled in, so that their widths fold into register indices:
// the main paths' boxes, 8 (spec 1) and 4 (spec 2) at IoU 0.1. Spec 0 reads
// the widths at run time.
__host__ __device__ constexpr int spec_width(int spec, int d) {
  return spec == 1   ? (d < 3 ? 6 : d < 5 ? 5 : d == 5 ? 4 : d == 6 ? 2 : -1)
         : spec == 2 ? (d < 2 ? 3 : d == 2 ? 2 : d == 3 ? 1 : -1)
                     : -1;
}

struct ResArgs {
  const float* p;            // (n_planes, H, W) scores
  const uint8_t* valid;      // (n_planes, H, W) 0/1
  uint8_t* keep;             // (n_planes, H, W) 0/1: the answer
  int* state;                // state[3]: the largest sweep count of a plane
  unsigned long long* plane_sweeps;  // += each plane's sweeps, or null
  int H, W;
  int C;                     // blocks a cluster (a plane)
  int rows;                  // rows a block owns (the last may own fewer)
  int seg;                   // rows of a tile
  int nseg, nch;             // tiles a block: nseg runs of rows x nch chunks
  int hy, hx;                // the strip set's vertical and horizontal halo
  int wd[kMaxSize];          // widths[|dy|], -1 where no strip
  int ppitch;                // floats a staged row of p
  int bpitch;                // 32-bit words a row of bits
  int max_sweeps;            // H * W
  int vec_p, vec_v, vec_k;   // 16-byte p and valid loads, 4-byte keep stores
};

// kN floats from shared memory, kCols at a time (16 or 8 bytes)
template <int kCols, int kN>
__device__ __forceinline__ void load_row(float (&out)[kN], const float* src) {
  static_assert(kN % kCols == 0 && (kCols == 4 || kCols == 2), "vector");
#pragma unroll
  for (int i = 0; i < kN; i += kCols) {
    if constexpr (kCols == 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + i);
      out[i] = v.x;
      out[i + 1] = v.y;
      out[i + 2] = v.z;
      out[i + 3] = v.w;
    } else {
      const float2 v = *reinterpret_cast<const float2*>(src + i);
      out[i] = v.x;
      out[i + 1] = v.y;
    }
  }
}

__device__ __forceinline__ void copy16_async(float* dst, const float* src) {
  const unsigned int d =
      static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// 16 bytes of 0/1 to 16 bits
__device__ __forceinline__ uint32_t pack_bytes(uint4 u) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  uint32_t out = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t x = __vcmpne4(w[i], 0u) & 0x01010101u;
    out |= ((x | x >> 7 | x >> 14 | x >> 21) & 0xFu) << (4 * i);
  }
  return out;
}

// One sweep of a tile by one warp: own rows [o0, o0 + n) of the block,
// columns [32 kCols ch, 32 kCols (ch + 1)), kCols adjacent columns a lane.
// The lane walks the rows from o0 - kHalo to o0 + n - 1 + kHalo once: for
// each row that reaches an own row (|dy| <= hy) it builds S = keep_in ? p :
// -inf over its window of kCols + 2 kPad columns from shared memory, the
// horizontal running maxima m[w] for |dx| <= w, and folds m[widths[|dy|]]
// into the pending output rows it reaches. Output row o0 + i collects in
// acc[i % kP] (kP = 2 kHalo + 1 rows are pending at once; the loop is
// unrolled by kP so that every index into acc is fixed) and is complete
// when the walk is kHalo rows past it: keep_out = valid & !(acc > p) goes
// into the lane's bits of the row, and the accumulator starts afresh.
// Returns where the tile's pixels changed (the same in every lane): the
// first and last image rows and bit words with a change, x > y where none
// did.
template <int kHalo, int kPad, int kCols, int kSpec>
__device__ int4 res_tile(const ResArgs& a, const float* P, const uint32_t* kin,
                        uint32_t* kout, const uint32_t* V, int o0, int n,
                        int ch, int ybase, int r0) {
  constexpr int kP = 2 * kHalo + 1;
  constexpr int kWin = kCols + 2 * kPad;
  constexpr int kHx = kSpec ? spec_width(kSpec, 0) : kHalo;
  constexpr int kLanesWord = 32 / kCols;
  static_assert(kHx <= kPad && kPad % 4 == 0 && kPad < 32, "window");
  const int lane = threadIdx.x & 31;
  const int c = (ch * 32 + lane) * kCols;
  const int hy = kSpec ? kHalo : a.hy;
  const int hx = kSpec ? kHx : a.hx;
  float acc[kP][kCols];
#pragma unroll
  for (int i = 0; i < kP; ++i)
#pragma unroll
    for (int k = 0; k < kCols; ++k) acc[i][k] = -INFINITY;
  const int steps = n + 2 * kHalo;
  const int jlo = kHalo - hy, jhi = n - 1 + kHalo + hy;
  const int sb = c + 32 - kPad;             // bit of the window's first column
  const uint32_t* kin_w = kin + (sb >> 5);
  const int own_w = (c >> 5) + 1;           // word and shift of the own bits
  const int own_sh = c & 31;
  int rlo = INT_MAX, rhi = -1, wlo = INT_MAX, whi = -1;   // changes
  for (int jb = 0; jb < steps; jb += kP) {
#pragma unroll
    for (int t = 0; t < kP; ++t) {
      const int j = jb + t;
      if (j >= steps) break;
      if (kSpec || (j >= jlo && j <= jhi)) {   // the row reaches an output
        const int ly = o0 - kHalo + j - ybase;
        float S[kWin];
        load_row<kCols>(S, P + ly * a.ppitch + c);
        const uint32_t* br = kin_w + ly * a.bpitch;
        const uint64_t bits =
            ((static_cast<uint64_t>(br[1]) << 32) | br[0]) >> (sb & 31);
#pragma unroll
        for (int i = 0; i < kWin; ++i)
          if (!((bits >> i) & 1u)) S[i] = -INFINITY;
        float m[kHx + 1][kCols];
#pragma unroll
        for (int k = 0; k < kCols; ++k) m[0][k] = S[kPad + k];
#pragma unroll
        for (int w = 1; w <= kHx; ++w) {
          if (w > hx) break;
#pragma unroll
          for (int k = 0; k < kCols; ++k)
            m[w][k] = fmaxf(m[w - 1][k],
                            fmaxf(S[kPad + k + w], S[kPad + k - w]));
        }
#pragma unroll
        for (int d = 0; d <= kHalo; ++d) {
          if (d > hy) break;
          const int wd = kSpec ? spec_width(kSpec, d) : a.wd[d];
          float v[kCols];
#pragma unroll
          for (int k = 0; k < kCols; ++k) v[k] = -INFINITY;
#pragma unroll
          for (int w = 0; w <= kHx; ++w) {
            if (w == wd) {
#pragma unroll
              for (int k = 0; k < kCols; ++k) v[k] = m[w][k];
            }
          }
          // this row is dy = +d from output j - kHalo - d, -d from
          // output j - kHalo + d
#pragma unroll
          for (int k = 0; k < kCols; ++k) {
            float& below = acc[(t + kP - kHalo - d) % kP][k];
            below = fmaxf(below, v[k]);
            if (d) {
              float& above = acc[(t + kP - kHalo + d) % kP][k];
              above = fmaxf(above, v[k]);
            }
          }
        }
      }
      if (j >= 2 * kHalo) {                 // output row o0 + j - 2 kHalo
        const int o = o0 + j - 2 * kHalo;
        const int ly = o - ybase;
        float pv[kCols];
        load_row<kCols>(pv, P + ly * a.ppitch + kPad + c);
        uint32_t nk = 0;                    // not suppressed, then valid
#pragma unroll
        for (int k = 0; k < kCols; ++k)
          nk |= static_cast<uint32_t>(!(acc[(t + 1) % kP][k] > pv[k])) << k;
        uint32_t word = (nk << own_sh) & V[(o - r0) * a.bpitch + own_w];
#pragma unroll
        for (int x = 1; x < kLanesWord; x <<= 1)
          word |= __shfl_xor_sync(0xffffffffu, word, x);
        if ((lane & (kLanesWord - 1)) == 0) {  // the word's lane writes it
          if (word != kin[ly * a.bpitch + own_w]) {
            rlo = min(rlo, o);
            rhi = o;
            wlo = min(wlo, own_w);
            whi = max(whi, own_w);
          }
          kout[ly * a.bpitch + own_w] = word;
        }
      }
#pragma unroll
      for (int k = 0; k < kCols; ++k) acc[(t + 1) % kP][k] = -INFINITY;
    }
  }
  return make_int4(__reduce_min_sync(0xffffffffu, rlo),
                   __reduce_max_sync(0xffffffffu, rhi),
                   __reduce_min_sync(0xffffffffu, wlo),
                   __reduce_max_sync(0xffffffffu, whi));
}

// One cluster of a.C blocks a plane; block `rank` owns rows [rank rows,
// rank rows + rows). Shared memory: p over the own rows and hy rows each
// side (fp32, kPad columns of margin each side), two ping-pong keep planes
// over the same rows as bits (32 columns of zero margin each side) and
// valid over the own rows as bits.
template <int kHalo, int kPad, int kCols, int kSpec, int kThreads>
__global__ void __launch_bounds__(kThreads, 1)
    nms_resident_kernel(const ResArgs a) {
  constexpr int kWarps = kThreads / 32;
  extern __shared__ __align__(16) float res_smem[];
  __shared__ int4 changes[2][kMaxTiles];   // res_tile's, by sweep parity
  __shared__ uint8_t dirty[kMaxTiles];     // tiles of this sweep to compute
  __shared__ unsigned int chg[3];          // rank 0's: changed, by sweep mod 3
  __shared__ int go_on;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int plane = blockIdx.x / a.C;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hy = kSpec ? kHalo : a.hy;
  const int hx = kSpec ? spec_width(kSpec, 0) : a.hx;
  constexpr int kCw = 32 * kCols;          // columns a tile
  const int r0 = rank * a.rows;
  const int r1 = min(r0 + a.rows, a.H);
  const int own = max(r1 - r0, 0);
  const int lrows = a.rows + 2 * hy;       // staged rows
  const int ybase = r0 - hy;               // image row of staged row 0
  float* P = res_smem;
  uint32_t* K0 = reinterpret_cast<uint32_t*>(P + (size_t)lrows * a.ppitch);
  uint32_t* K1 = K0 + lrows * a.bpitch;
  uint32_t* V = K1 + lrows * a.bpitch;
  const size_t off = (size_t)plane * a.H * a.W;
  const float* pp = a.p + off;
  const uint8_t* vv = a.valid + off;

  // p of the own rows and the halo, once a call, straight into shared memory
  const int ylo = max(0, ybase), yhi = min(a.H, r1 + hy);
  if (a.vec_p) {
    const int q = a.W >> 2;
    for (int i = tid; i < (yhi - ylo) * q; i += kThreads) {
      const int y = ylo + i / q, x = (i % q) << 2;
      copy16_async(P + (y - ybase) * a.ppitch + kPad + x,
                   pp + (size_t)y * a.W + x);
    }
  } else {
    for (int i = tid; i < (yhi - ylo) * a.W; i += kThreads) {
      const int y = ylo + i / a.W, x = i % a.W;
      copy4_async(P + (y - ybase) * a.ppitch + kPad + x,
                  pp + (size_t)y * a.W + x);
    }
  }
  for (int i = tid; i < (2 * lrows + a.rows) * a.bpitch; i += kThreads)
    K0[i] = 0;
  if (rank == 0 && tid < 3) chg[tid] = 0;
  __syncthreads();
  // valid of the own rows as bits; sweep 0 reads keep_in = valid
  const int nw = (a.W + 31) >> 5;
  for (int i = tid; i < own * nw; i += kThreads) {
    const int r = i / nw, wi = i % nw, x0 = wi << 5;
    const uint8_t* src = vv + (size_t)(r0 + r) * a.W + x0;
    uint32_t word = 0;
    if (a.vec_v && x0 + 32 <= a.W) {
      word = pack_bytes(*reinterpret_cast<const uint4*>(src)) |
             pack_bytes(*reinterpret_cast<const uint4*>(src + 16)) << 16;
    } else {
      for (int b = 0; b < 32 && x0 + b < a.W; ++b)
        word |= static_cast<uint32_t>(src[b] != 0) << b;
    }
    V[r * a.bpitch + wi + 1] = word;
    K0[(r + hy) * a.bpitch + wi + 1] = word;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  cluster.sync();          // every block has started, staged and cleared

  const int ntiles = a.nseg * a.nch;
  int s = 0;
  for (;; ++s) {
    uint32_t* kin = (s & 1) ? K1 : K0;
    uint32_t* kout = (s & 1) ? K0 : K1;
    // keep_in of the halo rows, from the blocks that own them (their last
    // sweep's output, complete at the barrier that ended it), by all warps
    // but the last, which meanwhile checks the tiles
    for (int i = tid; i < 2 * hy * a.bpitch && warp < kWarps - 1;
         i += kThreads - 32) {
      const int h = i / a.bpitch, wi = i % a.bpitch;
      const int y = h < hy ? ybase + h : r1 + h - hy;
      if (y < 0 || y >= a.H) continue;
      const int b = y / a.rows;
      const uint32_t* src = cluster.map_shared_rank(kin, b);
      kin[(h < hy ? h : own + h) * a.bpitch + wi] =
          src[(y - (b * a.rows - hy)) * a.bpitch + wi];
    }
    if (rank == 0 && tid == 0) chg[(s + 1) % 3] = 0;
    // which tiles to compute: all in the first two sweeps, then those
    // within the strip set's reach of a pixel that changed in the sweep
    // before (the tiles near it, in this block or another, give where their
    // pixels changed); else the tile's keep is that of two sweeps ago,
    // which kout already holds
    for (int t = lane; t < ntiles && warp == kWarps - 1; t += 32) {
      const int q = t / a.nch, ch = t % a.nch;
      const int o0 = r0 + q * a.seg, o1 = min(o0 + a.seg, r1);
      int d = o0 < o1 && s < 2;
      if (o0 < o1 && s >= 2) {
        const int x_lo = max(0, ch * kCw - hx), x_hi = ch * kCw + kCw - 1 + hx;
        const int c_lo = x_lo / kCw, c_hi = min(a.nch - 1, x_hi / kCw);
        const int w_lo = x_lo / 32 + 1, w_hi = x_hi / 32 + 1;
        int4* prev = changes[(s - 1) & 1];
        for (int y = max(0, o0 - hy); y < min(a.H, o1 + hy) && !d;) {
          const int b = y / a.rows, qq = (y - b * a.rows) / a.seg;
          const int4* f = cluster.map_shared_rank(prev, b) + qq * a.nch;
          for (int cc = c_lo; cc <= c_hi; ++cc) {
            const int4 e = f[cc];
            d |= e.x <= o1 - 1 + hy && e.y >= o0 - hy && e.z <= w_hi &&
                 e.w >= w_lo;
          }
          y = min(b * a.rows + (qq + 1) * a.seg, (b + 1) * a.rows);
        }
      }
      dirty[t] = static_cast<uint8_t>(d);
    }
    __syncthreads();
    int any = 0;
    for (int t = warp; t < ntiles; t += kWarps) {
      int4 f = make_int4(INT_MAX, -1, INT_MAX, -1);
      if (dirty[t]) {
        const int o0 = r0 + t / a.nch * a.seg;
        f = res_tile<kHalo, kPad, kCols, kSpec>(
            a, P, kin, kout, V, o0, min(a.seg, r1 - o0), t % a.nch, ybase,
            r0);
      }
      if (lane == 0) changes[s & 1][t] = f;
      any |= f.x <= f.y;
    }
    if (__syncthreads_or(any) && tid == 0)
      atomicOr(cluster.map_shared_rank(&chg[s % 3], 0), 1u);
    cluster.sync();
    if (tid == 0)
      go_on = *static_cast<volatile unsigned int*>(
          cluster.map_shared_rank(&chg[s % 3], 0)) != 0;
    __syncthreads();
    if (!go_on || s + 1 >= a.max_sweeps) break;
  }

  // the last sweep's mask to device memory, once, in whole lines
  const uint32_t* res = (s & 1) ? K0 : K1;
  const int nq = (a.W + 3) >> 2;
  for (int i = tid; i < own * nq; i += kThreads) {
    const int r = i / nq, x = (i % nq) << 2;
    const uint32_t nib =
        (res[(r + hy) * a.bpitch + (x >> 5) + 1] >> (x & 31)) & 0xFu;
    uint8_t* dst = a.keep + off + (size_t)(r0 + r) * a.W + x;
    if (a.vec_k) {
      *reinterpret_cast<uint32_t*>(dst) = (nib & 1u) | (nib >> 1 & 1u) << 8 |
                                          (nib >> 2 & 1u) << 16 |
                                          (nib >> 3) << 24;
    } else {
      for (int k = 0; k < 4 && x + k < a.W; ++k)
        dst[k] = static_cast<uint8_t>((nib >> k) & 1u);
    }
  }
  if (rank == 0 && tid == 0) {
    atomicMax(a.state + 3, s + 1);
    if (a.plane_sweeps != nullptr)
      atomicAdd(a.plane_sweeps, static_cast<unsigned long long>(s + 1));
  }
  cluster.sync();          // no block leaves while another may read it
}

// The instances: the compiled-in strip sets (512 threads a block: they fit
// 128 registers), then any strip set with halos up to 7 (four columns a
// lane) or 15 (two columns a lane, for registers), 256 threads a block.
// Serving the flagship's call with the general instance took 1.13 ms
// against 0.30 with the compiled-in set (NVIDIA H100 80GB HBM3, 700.00 W):
// read at run time, each row's width picks cost compares and selects.
struct ResInstance {
  const void* fn;
  int halo, pad, cols, spec, threads;
};
#define XP_RES(h, p, c, s, t) \
  {reinterpret_cast<const void*>(nms_resident_kernel<h, p, c, s, t>), h, p, \
   c, s, t}
const ResInstance kResInstances[] = {
    XP_RES(6, 8, 4, 1, 512), XP_RES(3, 4, 4, 2, 512),
    XP_RES(7, 8, 4, 0, 256), XP_RES(15, 16, 2, 0, 256)};
#undef XP_RES

// The resident plan of a call: instance, split and shared memory.
struct ResPlan {
  const ResInstance* inst;
  int C, rows, seg, nseg, nch, ppitch, bpitch;
  size_t smem;
  int clusters;            // clusters resident at once on this device
  int per_sm;              // blocks resident an SM
  int waves;               // ceil(planes / clusters)
  long long cost;          // walk_cost of a block's tiles
};

// the strip set's halos: hy the largest |dy| with a width >= 0, hx the
// largest width (0 where there is none)
void strip_halos(int size, const int* widths, int& hy, int& hx) {
  hy = 0;
  hx = 0;
  for (int d = 0; d < size; ++d)
    if (widths[d] >= 0) {
      hy = d;
      hx = std::max(hx, widths[d]);
    }
}

const ResInstance* res_instance(int size, const int* widths) {
  for (int spec = 1; spec <= 2; ++spec) {
    bool same = true;
    for (int d = 0; d < kMaxSize; ++d)
      same = same && (d < size ? widths[d] : -1) == spec_width(spec, d);
    if (same) return &kResInstances[spec - 1];
  }
  int hy, hx;
  strip_halos(size, widths, hy, hx);
  return std::max(hy, hx) <= 7 ? &kResInstances[2] : &kResInstances[3];
}

// The time a block takes to walk `tiles` tiles of `seg` rows, in row steps:
// the steps it issues plus 7 times the longest walk a warp makes (a step
// costs a warp about 7 times what it takes of the SM's issue rate: fitted
// to timings of tile heights from 2 to 86 rows on an H100).
long long walk_cost(const ResInstance& in, int tiles, int seg) {
  const int warps = in.threads / 32;
  const long long steps = seg + 2 * in.halo;
  return tiles * steps + 7 * ((tiles + warps - 1) / warps) * steps;
}

// Shared memory of a split: C blocks of `rows` rows (the fit rule).
void res_layout(const ResInstance& in, int H, int W, int hy, int C,
                ResPlan& pl) {
  const int cw = 32 * in.cols;
  pl.inst = &in;
  pl.rows = (H + C - 1) / C;
  pl.C = (H + pl.rows - 1) / pl.rows;       // no block without rows
  pl.nch = (W + cw - 1) / cw;
  pl.ppitch = pl.nch * cw + 2 * in.pad;
  pl.bpitch = pl.nch * cw / 32 + 2;
  const long long lrows = pl.rows + 2LL * hy;
  pl.smem = 4 * (size_t)(lrows * pl.ppitch + (2 * lrows + pl.rows) * pl.bpitch);
  // tile height: the one whose block walk costs least (at most kMaxTiles)
  pl.cost = -1;
  for (int n = 1; n <= std::min(pl.rows, kMaxTiles / std::max(pl.nch, 1));
       ++n) {
    const int seg = (pl.rows + n - 1) / n;
    const long long c = walk_cost(in, (pl.rows + seg - 1) / seg * pl.nch, seg);
    if (pl.cost < 0 || c < pl.cost) {
      pl.cost = c;
      pl.seg = seg;
      pl.nseg = (pl.rows + seg - 1) / seg;
    }
  }
}

struct ClusterOcc {
  int device;
  const void* fn;
  int C;
  size_t smem;
  int clusters;
  int per_sm;
};
std::mutex g_res_mutex;
constexpr int kOccCache = 1024;
ClusterOcc g_occ[kOccCache];
int g_n_occ = 0;                           // entries made (a ring)
int g_smem_optin[64] = {};                 // by device, 0 until read
int g_sms[64] = {};

// Clusters of C blocks resident at once (0: none fits) and blocks an SM,
// cached (the last kOccCache answers).
int res_clusters(int device, const ResInstance& in, int C, size_t smem,
                 int& per_sm, int& err) {
  for (int i = 0; i < std::min(g_n_occ, kOccCache); ++i)
    if (g_occ[i].device == device && g_occ[i].fn == in.fn && g_occ[i].C == C &&
        g_occ[i].smem == smem) {
      per_sm = g_occ[i].per_sm;
      return g_occ[i].clusters;
    }
  cudaError_t e;
  if (C > 8) {
    e = cudaFuncSetAttribute(in.fn,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) {                // not on this device: no cluster
      cudaGetLastError();
      return 0;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(in.threads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, in.fn, &cfg);
  if (e != cudaSuccess) {                  // a size the device refuses
    cudaGetLastError();
    n = 0;
  }
  per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, in.fn,
                                                    in.threads, smem);
  if (e != cudaSuccess) {
    err = static_cast<int>(e);
    return 0;
  }
  g_occ[g_n_occ++ % kOccCache] = ClusterOcc{device, in.fn, C, smem, n, per_sm};
  return n;
}

// Dynamic shared memory an instance's block may take on this device (the
// opt-in limit less its static shared memory), its attribute set to that
// once; 0 on a CUDA error (err set).
struct DynLimit {
  int device;
  const void* fn;
  size_t bytes;
};
DynLimit g_dyn[64];
int g_n_dyn = 0;

size_t res_max_dyn(int device, const ResInstance& in, int& err) {
  for (int i = 0; i < g_n_dyn; ++i)
    if (g_dyn[i].device == device && g_dyn[i].fn == in.fn)
      return g_dyn[i].bytes;
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, in.fn);
  if (e == cudaSuccess) {
    const size_t bytes = g_smem_optin[device] - fa.sharedSizeBytes;
    e = cudaFuncSetAttribute(in.fn,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
    if (e == cudaSuccess) {
      if (g_n_dyn < 64) g_dyn[g_n_dyn++] = DynLimit{device, in.fn, bytes};
      return bytes;
    }
  }
  err = static_cast<int>(e);
  return 0;
}

// The split for a call: among clusters of 1 to 16 blocks (above 8 where the
// device allows them), those whose blocks fit shared memory; the one whose
// waves x blocks sharing an SM x walk_cost is least (the time its busiest
// SM walks), the smaller cluster on a tie. Returns false where no split
// fits (the call then takes another instance); err is set on a CUDA error.
bool res_plan_uncached(int device, int n_planes, int H, int W, int size,
                       const int* widths, ResPlan& best, int& err) {
  const ResInstance& in = *res_instance(size, widths);
  int hy, hx;
  strip_halos(size, widths, hy, hx);
  const size_t max_dyn = res_max_dyn(device, in, err);
  if (err) return false;
  bool found = false;
  long long best_cost = 0;
  int last_C = 0;
  for (int cand = 1; cand <= kMaxCluster; ++cand) {
    ResPlan pl;
    res_layout(in, H, W, hy, std::min(cand, H), pl);
    if (pl.C == last_C) continue;          // the same split as the last
    last_C = pl.C;
    if (pl.nch > kMaxTiles || pl.smem > max_dyn) continue;
    pl.clusters = res_clusters(device, in, pl.C, pl.smem, pl.per_sm, err);
    if (err) return false;
    if (pl.clusters <= 0) continue;
    pl.waves = (n_planes + pl.clusters - 1) / pl.clusters;
    const long long in_wave = (long long)std::min(n_planes, pl.clusters) * pl.C;
    const long long per_sm = (in_wave + g_sms[device] - 1) / g_sms[device];
    const long long cost = pl.waves * per_sm * pl.cost;
    if (!found || cost < best_cost) {
      best = pl;
      best_cost = cost;
      found = true;
    }
  }
  return found;
}

// The last calls' plans, by device, shape and strip set (a call's host
// path then plans nothing anew).
struct PlanEntry {
  int key[5 + kMaxSize];
  bool found;
  ResPlan plan;
};
constexpr int kPlanCache = 32;
PlanEntry g_plans[kPlanCache];
int g_n_plans = 0;

bool res_plan(int device, int n_planes, int H, int W, int size,
              const int* widths, ResPlan& best, int& err) {
  int key[5 + kMaxSize] = {device, n_planes, H, W, size};
  for (int d = 0; d < kMaxSize; ++d) key[5 + d] = d < size ? widths[d] : -2;
  const int n = std::min(g_n_plans, kPlanCache);
  for (int i = 0; i < n; ++i)
    if (std::equal(key, key + 5 + kMaxSize, g_plans[i].key)) {
      best = g_plans[i].plan;
      return g_plans[i].found;
    }
  const bool found =
      res_plan_uncached(device, n_planes, H, W, size, widths, best, err);
  if (err) return false;
  PlanEntry& e = g_plans[g_n_plans++ % kPlanCache];
  std::copy(key, key + 5 + kMaxSize, e.key);
  e.found = found;
  e.plan = best;
  return found;
}

// The resident instance takes a call whose clusters hold at least a quarter
// of the SMs. Below that (one or two large planes) the staged instance is
// faster, its launch spreading each plane's 32 x 32 tiles over every SM:
// 0.078 against 0.151 ms at (1, 512, 512), size 8, and at parity at (2,
// 512, 512), size 4, 32 blocks on an H100's 132 SMs (PERF.md).
constexpr int kResMinShare = 4;

bool res_take(int device, int n_planes, int H, int W, int size,
              const int* widths, ResPlan& pl, int& err) {
  return res_plan(device, n_planes, H, W, size, widths, pl, err) &&
         (long long)n_planes * pl.C * kResMinShare >= g_sms[device];
}

// the device's shared memory limit and SM count, read once
int res_device(int& device) {
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (device < 0 || device >= 64)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (g_smem_optin[device] == 0) {
    e = cudaDeviceGetAttribute(&g_sms[device], cudaDevAttrMultiProcessorCount,
                               device);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaDeviceGetAttribute(&g_smem_optin[device],
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// The last launch's resident shape, for reports (0 for other instances).
ResPlan g_res = {};

}  // namespace

// Bytes of scratch xp_nms and xp_nms_banded need: none where the resident
// instance takes the call (res_take), else the second keep plane and two
// tile flags.
extern "C" long long xp_nms_scratch(int n_planes, int H, int W, int size,
                                    const int* widths) {
  if (size >= 1 && size <= kMaxSize && n_planes > 0 && H > 0 && W > 0) {
    std::lock_guard<std::mutex> lock(g_res_mutex);
    int device, err = 0;
    ResPlan pl;
    if (res_device(device) == 0 &&
        res_take(device, n_planes, H, W, size, widths, pl, err))
      return 0;
    cudaGetLastError();
  }
  const long long tiles = (long long)((H + kTileH - 1) / kTileH) *
                          ((W + kTileW - 1) / kTileW) * n_planes;
  return (long long)n_planes * H * W + 2 * tiles;
}

// The largest H of an (H, W) plane that one cluster holds at this box (the
// fit rule), 0 if none; -1 on a CUDA error. A block of R rows takes 4 (R
// (pitch + 3 bpitch) + 2 hy (pitch + 2 bpitch)) bytes (res_layout), so the
// largest R within the limit, times the largest cluster the device runs at
// that shared memory.
extern "C" int xp_nms_fit_rows(int W, int size, const int* widths) {
  if (size < 1 || size > kMaxSize || W <= 0) return 0;
  std::lock_guard<std::mutex> lock(g_res_mutex);
  int device, err = res_device(device);
  if (err) return -1;
  const ResInstance& in = *res_instance(size, widths);
  int hy, hx;
  strip_halos(size, widths, hy, hx);
  const size_t max_dyn = res_max_dyn(device, in, err);
  if (err) return -1;
  ResPlan pl;
  res_layout(in, 1, W, hy, 1, pl);          // the pitches of this width
  if (pl.nch > kMaxTiles) return 0;
  const long long rows =
      ((long long)max_dyn / 4 - 2LL * hy * (pl.ppitch + 2LL * pl.bpitch)) /
      (pl.ppitch + 3LL * pl.bpitch);
  if (rows < 1) return 0;
  for (int C = kMaxCluster; C >= 1; --C) {
    if (C * rows > INT_MAX) continue;
    res_layout(in, static_cast<int>(C * rows), W, hy, C, pl);
    const int n = res_clusters(device, in, pl.C, pl.smem, pl.per_sm, err);
    if (err) return -1;
    if (n > 0) return static_cast<int>(C * rows);
  }
  return 0;
}

// The staged instance (one cooperative launch over 32 x 32 tiles staged
// from device memory) for boxes up to 16 where res_take refuses the
// resident one.
static int xp_nms_staged(const float* p, const uint8_t* valid, uint8_t* keep,
                         uint8_t* scratch, int* state, int n_planes, int H,
                         int W, int size, const int* widths,
                         unsigned long long* plane_sweeps, void* stream) {
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
  a.plane_sweeps = plane_sweeps;
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

// The resident instance: one cudaMemsetAsync of state and one cluster
// launch (a cluster a plane) on `stream`.
int launch_resident(const ResPlan& pl, const float* p, const uint8_t* valid,
                    uint8_t* keep, int* state,
                    unsigned long long* plane_sweeps, int n_planes, int H,
                    int W, int size, const int* widths, void* stream) {
  ResArgs a = {};
  a.p = p;
  a.valid = valid;
  a.keep = keep;
  a.state = state;
  a.plane_sweeps = plane_sweeps;
  a.H = H;
  a.W = W;
  a.C = pl.C;
  a.rows = pl.rows;
  a.seg = pl.seg;
  a.nseg = pl.nseg;
  a.nch = pl.nch;
  strip_halos(size, widths, a.hy, a.hx);
  for (int d = 0; d < kMaxSize; ++d) a.wd[d] = d < size ? widths[d] : -1;
  a.ppitch = pl.ppitch;
  a.bpitch = pl.bpitch;
  a.max_sweeps = H * W;
  const uintptr_t pa = reinterpret_cast<uintptr_t>(p);
  const uintptr_t va = reinterpret_cast<uintptr_t>(valid);
  const uintptr_t ka = reinterpret_cast<uintptr_t>(keep);
  a.vec_p = pa % 16 == 0 && W % 4 == 0;
  a.vec_v = va % 16 == 0 && W % 16 == 0;
  a.vec_k = ka % 4 == 0 && W % 4 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(state, 0, 4 * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(n_planes * pl.C);
  cfg.blockDim = dim3(pl.inst->threads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {&a};
  err = cudaLaunchKernelExC(&cfg, pl.inst->fn, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// p: (n_planes, H, W) fp32 scores; valid: (n_planes, H, W) uint8 0/1;
// keep: (n_planes, H, W) uint8, the answer; scratch: xp_nms_scratch bytes;
// state: 4 device ints, zeroed here, the sweep count in state[3] after the
// launch. widths: size host ints (ops/nms.py::overlap_widths), 1 <= size
// <= 16. plane_sweeps: one device 64-bit word (or null) that the launch
// adds the sweeps of every plane to; it is not zeroed. Calls that res_take gives the resident instance (planes that fit
// a cluster, clusters for at least a quarter of the SMs): one
// cudaMemsetAsync and one cluster launch; the others the staged one (one
// cooperative launch). Returns the first CUDA error, a refused launch
// included.
extern "C" int xp_nms(const float* p, const uint8_t* valid, uint8_t* keep,
                      uint8_t* scratch, int* state, int n_planes, int H, int W,
                      int size, const int* widths, long long* plane_sweeps,
                      void* stream) {
  unsigned long long* counter =
      reinterpret_cast<unsigned long long*>(plane_sweeps);
  if (size < 1 || size > kMaxSize || n_planes <= 0 || H <= 0 || W <= 0 ||
      (long long)H * W >= (1LL << 31) ||
      (long long)n_planes * kMaxCluster >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  {
    std::lock_guard<std::mutex> lock(g_res_mutex);
    int device, err = res_device(device);
    if (err) return err;
    ResPlan pl;
    const bool take = res_take(device, n_planes, H, W, size, widths, pl, err);
    if (err) return err;
    if (take) {
      err = launch_resident(pl, p, valid, keep, state, counter, n_planes, H,
                            W, size, widths, stream);
      g_res = pl;
      g_smem = pl.smem;
      g_per_sm = pl.per_sm;
      g_blocks = n_planes * pl.C;
      g_plan = BandPlan{};
      g_kernel = nullptr;     // launch() reads its occupancy again
      return err;
    }
    g_res = ResPlan{};
  }
  if (scratch == nullptr)     // xp_nms_scratch planned the resident instance
    return static_cast<int>(cudaErrorInvalidValue);
  return xp_nms_staged(p, valid, keep, scratch, state, n_planes, H, W, size,
                       widths, counter, stream);
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
                             long long* plane_sweeps, void* stream) {
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
  a.plane_sweeps = reinterpret_cast<unsigned long long*>(plane_sweeps);
  g_plan = bp;
  g_res = ResPlan{};
  const size_t smem = 4 * (size_t)bp.table + (size_t)offsets;
  return launch(a, reinterpret_cast<const void*>(nms_kernel<kBanded>), smem,
                stream);
}

// The last launch's shape, for reports: dynamic shared memory bytes a
// block, resident blocks an SM, blocks launched; the banded instance's band
// rows, table levels and staged columns; the resident instance's blocks a
// cluster, rows a block, clusters resident at once, waves and rows a tile
// (0 where the instance has none).
extern "C" void xp_nms_last_launch(long long* out) {
  const long long v[11] = {(long long)g_smem, g_per_sm,     g_blocks,
                           g_plan.rows,       g_plan.levels, g_plan.span,
                           g_res.C,           g_res.rows,    g_res.clusters,
                           g_res.waves,       g_res.seg};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
}

extern "C" const char* xp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
