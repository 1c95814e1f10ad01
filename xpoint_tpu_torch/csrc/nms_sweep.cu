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
// 6 B a pixel a sweep: 0.083 ms at the memory rate for the same call.
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
// second instance of the same launch, nms_kernel<kDirect>: the same
// cooperative loop, grid barrier, change flags and quiet-tile skipping, but
// each pixel reads its (2 size - 1)-row overlap set straight from device
// memory (keep_in with __ldcg, p through the read-only path), one column a
// lane so that a warp's loads are contiguous, with the widths table in device
// memory. It makes ~(2 size - 1)(2 max_w + 1) loads a pixel a sweep where the
// staged instance makes one, and is kept simple: no config uses such boxes.
// A tile's halo may then reach past its eight neighbours (size > 33), so the
// skipping looks at every tile within ceil(halo / 32) tiles.
//
// Where blocks share memory within the launch, and how each case is handled:
//  - the keep planes are written by one block and read by others after a
//    barrier, so they are read with __ldcg (L2, never the non-coherent
//    read-only path or a stale L1 line); p and valid are read-only for the
//    whole launch and keep __restrict__;
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
constexpr int kDirect = 0;                 // nms_kernel<kDirect>: no staging

struct StripSet {
  int size;                  // box side; vertical halo is size - 1
  int max_w;                 // horizontal halo
  unsigned int slot_mask;    // bit w: w is one of the widths (a slot of R)
  int dy_slot[kMaxSize];     // |dy| -> slot of widths[|dy|], -1 if none
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
  const int* widths;         // the direct instance's: size ints, on device
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

// One sweep of the 32 x 32 tile at (y0, x0) for any box size, nothing
// staged: each pixel takes the maximum of p over the kept pixels of its
// overlap set {|dy| < size, |dx| <= widths[|dy|]} from device memory. Lane
// x of warp y takes column x of rows y, y + 8, y + 16, y + 24. Returns
// whether any pixel changed (the same value in every thread of the block).
__device__ int sweep_tile_direct(const float* __restrict__ pp,
                                 const uint8_t* __restrict__ vv,
                                 const uint8_t* kin, uint8_t* kout, int H,
                                 int W, int y0, int x0, int size,
                                 const int* __restrict__ widths) {
  const int gx = x0 + threadIdx.x;
  const int hy = size - 1;
  int flipped = 0;
#pragma unroll 1
  for (int k = 0; k < kTileH / kWarps; ++k) {
    const int gy = y0 + threadIdx.y + kWarps * k;
    if (gy >= H || gx >= W) continue;
    float nm = -INFINITY;
    const int dy_hi = min(hy, H - 1 - gy);
#pragma unroll 1
    for (int dy = max(-hy, -gy); dy <= dy_hi; ++dy) {
      const int w = widths[dy < 0 ? -dy : dy];
      if (w < 0) continue;
      const int row = (gy + dy) * W;
      const int x_hi = min(gx + w, W - 1);
#pragma unroll 4
      for (int x = max(gx - w, 0); x <= x_hi; ++x)
        if (__ldcg(kin + row + x)) nm = fmaxf(nm, pp[row + x]);
    }
    const int o = gy * W + gx;
    const int nk = vv[o] != 0 && !(nm > pp[o]);
    flipped |= nk != (__ldcg(kin + o) != 0);
    kout[o] = static_cast<uint8_t>(nk);
  }
  return __syncthreads_or(flipped);
}

// Four blocks an SM (64 registers, a few spilled) cover more of the tiles'
// load latency than two without spills. kMaxHalo: the staged instance's
// halo bound, or kDirect for the instance that stages nothing.
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
  if (kMaxHalo != kDirect && tid < 2 * a.ss.size - 1) {  // read after the
    const int hy = a.ss.size - 1;                         // first barrier
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
          if constexpr (kMaxHalo == kDirect)
            flipped = sweep_tile_direct(a.p + off, a.valid + off, kin + off,
                                        kout + off, a.H, a.W, y0, x0,
                                        a.ss.size, a.widths);
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

// The fields of NmsArgs both instances share; cudaErrorInvalidValue for a
// shape the launch cannot index.
int init_args(NmsArgs& a, const float* p, const uint8_t* valid, uint8_t* keep,
              uint8_t* scratch, int* state, int n_planes, int H, int W,
              int size, int max_w) {
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
  const int hy = size > 1 ? size - 1 : 0;
  a.reach_y = hy > kTileH ? (hy + kTileH - 1) / kTileH : 1;
  a.reach_x = max_w > kTileW ? (max_w + kTileW - 1) / kTileW : 1;
  a.ss.size = size;
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
    g_resident = per_sm * sms;
  }
  // no resident block (too much shared memory): the launch below is refused
  const int blocks = a.n_tiles < g_resident
                         ? a.n_tiles
                         : (g_resident > 0 ? g_resident : 1);
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

// Bytes of scratch xp_nms and xp_nms_direct need: the second keep plane and
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
                            size, ss.max_w);
  if (err) return err;

  // boxes up to 8 (every config) take the narrower staged rows
  const int max_halo = size <= 8 ? 7 : 15;
  const void* kernel = size <= 8
                           ? reinterpret_cast<const void*>(nms_kernel<7>)
                           : reinterpret_cast<const void*>(nms_kernel<15>);
  const int SH = kTileH + 2 * (size - 1);
  const size_t smem = sizeof(float) * (size_t)SH *
                      (stage_pitch(max_halo) + (size_t)n_slots * kTileW);
  return launch(a, kernel, smem, stream);
}

// As xp_nms for any box size, with nothing staged in shared memory (the
// kDirect instance): widths are `size` ints in device memory, max_w their
// largest (0 if none is >= 0). A size below 1 has an empty overlap set.
extern "C" int xp_nms_direct(const float* p, const uint8_t* valid,
                             uint8_t* keep, uint8_t* scratch, int* state,
                             int n_planes, int H, int W, int size, int max_w,
                             const int* widths, void* stream) {
  NmsArgs a;
  const int err = init_args(a, p, valid, keep, scratch, state, n_planes, H, W,
                            size, max_w);
  if (err) return err;
  a.widths = widths;
  return launch(a, reinterpret_cast<const void*>(nms_kernel<kDirect>), 0,
                stream);
}

extern "C" const char* xp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
