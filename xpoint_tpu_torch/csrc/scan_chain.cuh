// The chained carry shared by the span kernels of the bidirectional scan
// (selective_scan_bidir.cu) and of its backward (selective_scan_bidir_bwd.cu):
// tagged 64-bit chain words, the fixed-distance look-back that folds a chain
// position's entry, block barriers, cp.async staging, and the per-device
// count of resident blocks.
//
// A published value and its flag are one 64-bit word: the call's tag (high
// 32 bits, never 0) and the fp32 value (low 32 bits), stored with
// st.relaxed.gpu.b64 and polled with ld.relaxed.gpu.b64, both single-copy
// atomic at device scope: a reader that sees the tag sees the value of the
// same store, and nothing else is read through the chain, so no fence or
// release / acquire pair is needed. A word left by an earlier call carries
// an older tag and is never taken, so nothing is cleared between calls.
#pragma once
#include <cuda_runtime.h>

#include <mutex>

namespace xp {

__device__ __forceinline__ void publish(unsigned long long* p, unsigned tag,
                                        float v) {
  const unsigned long long w =
      (static_cast<unsigned long long>(tag) << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.b64 [%0], %1;" ::"l"(p), "l"(w) : "memory");
}

__device__ __forceinline__ unsigned long long peek(
    const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.b64 %0, [%1];" : "=l"(w) : "l"(p) : "memory");
  return w;
}

__device__ __forceinline__ bool tagged(unsigned long long w, unsigned tag) {
  return static_cast<unsigned>(w >> 32) == tag;
}

__device__ __forceinline__ float value_of(unsigned long long w) {
  return __uint_as_float(static_cast<unsigned>(w));
}

// One arrival at a counter kept as a tagged word: a word with another tag
// counts 0. Returns the count before this arrival; nothing needs clearing
// between calls.
__device__ __forceinline__ unsigned arrive(unsigned long long* p,
                                           unsigned tag) {
  unsigned long long old = peek(p), seen;
  do {
    seen = old;
    const unsigned n = tagged(seen, tag) ? static_cast<unsigned>(seen) : 0u;
    old = atomicCAS(p, seen,
                    (static_cast<unsigned long long>(tag) << 32) | (n + 1));
  } while (old != seen);
  return tagged(seen, tag) ? static_cast<unsigned>(seen) : 0u;
}

// A barrier of kCount threads of the block on hardware barrier kId (0 is
// __syncthreads'), which may sit in code that warps reach by different
// paths.
template <int kId, int kCount>
__device__ __forceinline__ void barrier() {
  asm volatile("bar.sync %0, %1;" ::"n"(kId), "n"(kCount) : "memory");
}

// kChunk bytes from global to shared memory, zero-filled where !valid (src
// must still be a valid address).
template <int kChunk>
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? kChunk : 0;
  if constexpr (kChunk == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(kChunk), "r"(n));
}

__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// The chain for one lane: entry(k) from exit(k - K) and the summaries (A, V)
// of positions k - K + 1 .. k - 1, once all carry this call's tag, folded in
// position order: exactly the fmafs of the strict chain entry(k) =
// A(k-1) entry(k-1) + V(k-1) from exit(k - K), so every entry has the bits
// of the strict chain whatever the timing. Word (position j, this lane) is
// at lane_at + j * plane.
template <int kLookback>
__device__ __forceinline__ float chain_entry(const unsigned long long* agg_a,
                                             const unsigned long long* agg_v,
                                             const unsigned long long* exit,
                                             unsigned tag, size_t lane_at,
                                             size_t plane, int k) {
  if (k == 0) return 0.f;
  const int first = max(k - kLookback + 1, 0);
  unsigned long long wa[kLookback - 1], wv[kLookback - 1], we = 0;
  for (;;) {
    bool ready = true;
#pragma unroll
    for (int i = 0; i < kLookback - 1; ++i)
      if (first + i < k) {
        const size_t at = lane_at + static_cast<size_t>(first + i) * plane;
        wa[i] = peek(agg_a + at);
        wv[i] = peek(agg_v + at);
      }
    if (k >= kLookback)
      we = peek(exit + lane_at + static_cast<size_t>(k - kLookback) * plane);
#pragma unroll
    for (int i = 0; i < kLookback - 1; ++i)
      if (first + i < k)
        ready = ready && tagged(wa[i], tag) && tagged(wv[i], tag);
    if (k >= kLookback) ready = ready && tagged(we, tag);
    if (ready) break;
    __nanosleep(32);
  }
  float x = k >= kLookback ? value_of(we) : 0.f;
#pragma unroll
  for (int i = 0; i < kLookback - 1; ++i)
    if (first + i < k) x = fmaf(value_of(wa[i]), x, value_of(wv[i]));
  return x;
}

namespace {

// Resident blocks an SM of one kernel instance at one dynamic shared memory
// size, counted once a device. The instance's shared memory attribute is
// set, the first time, to the most any call of it takes (max_smem), so that
// a later call with more than an earlier one still launches.
struct Resident {
  int device;
  const void* fn;
  size_t smem;
  int per_sm;
};
std::mutex g_resident_lock;
Resident g_resident[64];
int g_n_resident = 0;

template <typename F>
int prepare(F fn, int threads, size_t smem, size_t max_smem, int* per_sm) {
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* key = reinterpret_cast<const void*>(fn);
  std::lock_guard<std::mutex> guard(g_resident_lock);
  bool seen = false;
  for (int i = 0; i < g_n_resident; ++i) {
    const Resident& r = g_resident[i];
    if (r.device == device && r.fn == key) {
      seen = true;
      if (r.smem == smem) {
        *per_sm = r.per_sm;
        return 0;
      }
    }
  }
  if (!seen) {
    err = cudaFuncSetAttribute(fn,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(max_smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, threads,
                                                      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (g_n_resident < 64)
    g_resident[g_n_resident++] = {device, key, smem, *per_sm};
  return 0;
}

}  // namespace

}  // namespace xp
