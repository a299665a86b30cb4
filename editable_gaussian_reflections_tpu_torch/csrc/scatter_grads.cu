// scatter_grads.cu - the training step's gradient scatter: every valid hit
// adds its row of per-hit gradient columns into the row of its Gaussian.
//
// Replaces pallas_scatter_grads_t (editable_gaussian_reflections_tpu/ops/
// pallas/scatter_kernel.py), and serves as the step's scatter in place of
// the XLA segment-sum render_grads.scatter_grads computes.  The Pallas kernel
// restated atomicAdd as one-hot matrix products against per-tile candidate
// lists, because a TPU has no scattered atomic add; Hopper has one.  One
// launch takes the hits of every bounce of a step (their rows are
// concatenated), as the Pallas kernel's multi-bounce form did.
//
// Design.  A block takes one chunk of CHUNK consecutive rows (4096: 128 rays
// of K 32 slots, half a 256-ray cull tile of the fused step, whose rays come
// in 16x16 pixel tiles over Morton-ordered Gaussians, so that a chunk's hits
// repeat few Gaussians many times).  It reads the chunk's ids coalesced,
// compacts the valid rows (0 <= id < n_gauss) into keys (id << ROW_BITS |
// row) in shared memory, and sorts them with a bitonic network: stages of
// distance below PER_THREAD in registers, below 32 * PER_THREAD by warp
// shuffles, the rest through shared memory.  Each half-warp then walks one
// contiguous span of the sorted rows, a lane summing two columns (a row is
// 88 contiguous bytes, two rows a warp instruction) in float64 until the id
// changes, where every lane whose sum is nonzero adds it with one atomicAdd.
// So a (Gaussian, column) costs one atomic per span it appears in, not one
// per hit; a run across two spans costs two.  Rows are indexed in 32 bits
// within a chunk (the entry point refuses widths above 2^31 / CHUNK).  The
// key keeps the id's low 32 - ROW_BITS bits: above 2^20 Gaussians two ids
// may share a key's high bits and interleave, which splits their runs (more
// atomics, the same sums); runs end where the full id, kept per row,
// changes.
//
// Numerics: the accumulator is float64 and the caller rounds it to float32
// once, after the step's last launch.  Sums of float32 addends in float64 are
// nearly always exact, so the result does not depend on whether two values
// meet in a register or in L2, nor on the order the atomics land in;
// cancellations give exact zeros.  The plain version (ops/cuda/scatter.py,
// index_add_ in float64) gives the same sums.  Rows with an id outside
// [0, n_gauss) (-1: empty slots) are skipped unread, and a zero run sum is
// not added: adding +0.0 or -0.0 to a float64 sum that starts at +0.0 never
// changes it.
//
// What bounds it: the bytes of the ids and of the valid rows' payload (22
// float32 columns each) and the accumulator's read-modify-write traffic in
// L2.  Each valid row is read once and the atomics are one per distinct
// (Gaussian, column) of a span; the sort and the sums' instructions cost
// issue slots besides (PERF.md, the scatter's ladder in tools/scatter_ab.py).
//
// EGR_SCATTER_COUNT (defined only by the measurement tool
// tools/scatter_ab.py) adds egr_scatter_add_counted, which also counts the
// atomics issued.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PER_THREAD = 16;               // keys a thread holds in the sort
constexpr int CHUNK = THREADS * PER_THREAD;  // rows a block takes
constexpr int ROW_BITS = 12;                 // log2(CHUNK)
constexpr int LOADS = 8;                     // rows a half-warp reads ahead
constexpr unsigned FULL = 0xffffffffu;
static_assert((1 << ROW_BITS) == CHUNK, "ROW_BITS must be log2(CHUNK)");

// Shared-memory index of key i: one word of padding every 32, so that the
// sort's blocked layout (thread t holds keys t * PER_THREAD + e) is free of
// bank conflicts.
__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

struct Smem {
  uint32_t keys[CHUNK + CHUNK / 32];
  int ids[CHUNK];  // the chunk's ids by row
  int warp_count[WARPS];
};
// in dynamic shared memory, which chunks of 8192 rows (above 48 KB) need
constexpr int SMEM_BYTES = (int)sizeof(Smem);

// One compare-exchange stage of the bitonic network at distance j < PER_THREAD
// (both keys in this thread); k is the size of the sequences being merged.
__device__ __forceinline__ void register_stage(uint32_t (&v)[PER_THREAD],
                                               int first, int j, int k) {
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) {
    if (e & j) continue;
    const bool up = ((first + e) & k) == 0;
    const uint32_t a = v[e], b = v[e | j];
    v[e] = up ? min(a, b) : max(a, b);
    v[e | j] = up ? max(a, b) : min(a, b);
  }
}

// Every stage of the merge of size k below distance PER_THREAD.
__device__ __forceinline__ void register_stages(uint32_t (&v)[PER_THREAD],
                                                int first, int k) {
#pragma unroll
  for (int j = PER_THREAD / 2; j > 0; j >>= 1) register_stage(v, first, j, k);
}

// A stage at distance PER_THREAD <= j < 32 * PER_THREAD: the partner key is
// the same register of lane (lane ^ j / PER_THREAD).  k >= 2 * PER_THREAD.
__device__ __forceinline__ void shuffle_stage(uint32_t (&v)[PER_THREAD],
                                              int first, int j, int k) {
  const int m = j / PER_THREAD;
  const bool keep_min = ((first & j) == 0) == ((first & k) == 0);
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) {
    const uint32_t p = __shfl_xor_sync(FULL, v[e], m);
    v[e] = keep_min ? min(v[e], p) : max(v[e], p);
  }
}

// A stage at distance j >= 32 * PER_THREAD, through shared memory.  Every
// thread of the block calls it; `on` marks the threads holding keys.
__device__ __forceinline__ void shared_stage(uint32_t (&v)[PER_THREAD],
                                             uint32_t* keys, int first,
                                             bool on, int j, int k) {
  __syncthreads();  // the last reads of keys are done
  if (on) {
#pragma unroll
    for (int e = 0; e < PER_THREAD; ++e) keys[padded(first + e)] = v[e];
  }
  __syncthreads();
  if (on) {
    const bool keep_min = ((first & j) == 0) == ((first & k) == 0);
#pragma unroll
    for (int e = 0; e < PER_THREAD; ++e) {
      const uint32_t p = keys[padded((first ^ j) + e)];
      v[e] = keep_min ? min(v[e], p) : max(v[e], p);
    }
  }
}

// Sort keys[0, n_valid) ascending (padded layout) in place.  n, the network's
// size, is a power of two >= max(n_valid, 32 * PER_THREAD); keys past n_valid
// enter as 0xffffffff and sort last.
__device__ void block_sort(uint32_t* keys, int n_valid, int n) {
  const int first = threadIdx.x * PER_THREAD;
  const bool on = first < n;  // whole warps: n is a multiple of a warp's keys
  uint32_t v[PER_THREAD];
  if (on) {
#pragma unroll
    for (int e = 0; e < PER_THREAD; ++e)
      v[e] = first + e < n_valid ? keys[padded(first + e)] : 0xffffffffu;
#pragma unroll
    for (int k = 2; k <= PER_THREAD; k <<= 1) {
#pragma unroll
      for (int j = k >> 1; j > 0; j >>= 1) register_stage(v, first, j, k);
    }
  }
  for (int k = 2 * PER_THREAD; k <= n; k <<= 1) {
    int j = k >> 1;
    for (; j >= 32 * PER_THREAD; j >>= 1)
      shared_stage(v, keys, first, on, j, k);
    if (on) {
      for (; j >= PER_THREAD; j >>= 1) shuffle_stage(v, first, j, k);
      register_stages(v, first, k);
    }
  }
  __syncthreads();
  if (on) {
#pragma unroll
    for (int e = 0; e < PER_THREAD; ++e) keys[padded(first + e)] = v[e];
  }
  __syncthreads();
}

// On the lanes whose run `ends`, add its sums of columns col (s0) and
// col + 1 (s1) of Gaussian id into the accumulator.  Every lane of the warp
// calls it.
template <bool COUNT>
__device__ __forceinline__ void flush(double* acc, bool ends, int id,
                                      double s0, double s1, int width,
                                      int col, unsigned long long* n_atomics) {
  const bool add0 = ends && id >= 0 && col < width && s0 != 0.0;
  const bool add1 = ends && id >= 0 && col + 1 < width && s1 != 0.0;
  if (add0) atomicAdd(acc + (size_t)id * width + col, s0);
  if (add1) atomicAdd(acc + (size_t)id * width + col + 1, s1);
  if (COUNT) {
    const int adds = __popc(__ballot_sync(FULL, add0)) +
                     __popc(__ballot_sync(FULL, add1));
    if ((threadIdx.x & 31) == 0 && adds)
      atomicAdd(n_atomics, (unsigned long long)adds);
  }
}

template <bool COUNT>
__global__ void __launch_bounds__(THREADS)
    scatter_add_kernel(const float* __restrict__ payload,
                       const int* __restrict__ ids, double* __restrict__ acc,
                       long long n_hits, int width, int n_gauss,
                       unsigned long long* n_atomics) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem& s = *reinterpret_cast<Smem*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long base = (long long)blockIdx.x * CHUNK;
  const int rows = (int)min((long long)CHUNK, n_hits - base);

  // the chunk's ids, coalesced, and this thread's count of valid rows
  int id[PER_THREAD];
  int count = 0;
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    const int row = q * THREADS + threadIdx.x;
    id[q] = row < rows ? ids[base + row] : -1;
    if ((unsigned)id[q] >= (unsigned)n_gauss) id[q] = -1;
    s.ids[row] = id[q];
    count += id[q] >= 0;
  }
  // compaction: an exclusive scan of the counts over the block
  int incl = count;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) s.warp_count[warp] = incl;
  __syncthreads();
  int at = incl - count, n_valid = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int c = s.warp_count[w];
    at += w < warp ? c : 0;
    n_valid += c;
  }
  if (n_valid == 0) return;  // block-uniform
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    if (id[q] >= 0)
      s.keys[padded(at++)] = ((uint32_t)id[q] << ROW_BITS) |
                             (uint32_t)(q * THREADS + threadIdx.x);
  }
  __syncthreads();
  int n = 32 * PER_THREAD;
  while (n < n_valid) n <<= 1;
  block_sort(s.keys, n_valid, n);

  // segmented sums: warp `warp` takes sorted rows [wbegin, wend), each of
  // its half-warps one half of them; lane c of a half-warp sums columns
  // c0 + 2c and c0 + 2c + 1
  const int span = (n_valid + WARPS - 1) / WARPS;
  const int wbegin = min(warp * span, n_valid);
  const int wend = min(wbegin + span, n_valid);
  const int mid = wbegin + (wend - wbegin + 1) / 2;
  const int begin = lane < 16 ? wbegin : mid;
  const int end = lane < 16 ? mid : wend;
  const float* chunk_rows = payload + base * width;
  for (int c0 = 0; c0 < width; c0 += 32) {
    const int col = c0 + 2 * (lane & 15);
    const bool has0 = col < width, has1 = col + 1 < width;
    int cur = -1;
    double s0 = 0.0, s1 = 0.0;
    for (int i = 0; i < mid - wbegin; i += LOADS) {
      int gid[LOADS];
      float v0[LOADS], v1[LOADS];
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int pos = begin + i + u;
        gid[u] = -1;
        v0[u] = v1[u] = 0.0f;
        if (pos < end) {
          const int row = (int)(s.keys[padded(pos)] & (CHUNK - 1));
          gid[u] = s.ids[row];
          const float* p = chunk_rows + row * width + col;
          if (has0) v0[u] = p[0];
          if (has1) v1[u] = p[1];
        }
      }
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const bool ends = gid[u] >= 0 && gid[u] != cur;
        if (__any_sync(FULL, ends)) {
          flush<COUNT>(acc, ends, cur, s0, s1, width, col, n_atomics);
          if (ends) {
            cur = gid[u];
            s0 = s1 = 0.0;
          }
        }
        s0 += (double)v0[u];
        s1 += (double)v1[u];
      }
    }
    flush<COUNT>(acc, true, cur, s0, s1, width, col, n_atomics);
  }
}

template <bool COUNT>
int launch(const float* payload, const int* ids, double* acc,
           long long n_hits, int width, int n_gauss,
           unsigned long long* n_atomics, void* stream) {
  // a chunk's rows are indexed in 32 bits
  if (width <= 0 || width > 0x7fffffff / CHUNK || n_hits < 0 || n_gauss <= 0)
    return (int)cudaErrorInvalidValue;
  if (n_hits == 0) return 0;
  const long long blocks = (n_hits + CHUNK - 1) / CHUNK;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      scatter_add_kernel<COUNT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  scatter_add_kernel<COUNT><<<(unsigned)blocks, THREADS, SMEM_BYTES,
                              static_cast<cudaStream_t>(stream)>>>(
      payload, ids, acc, n_hits, width, n_gauss, n_atomics);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  acc [n_gauss, width] f64 +=
// payload [n_hits, width] f32 by ids [n_hits] i32.  Launches on `stream`,
// allocates nothing, returns the launch's cudaError_t (0 = success).
extern "C" int egr_scatter_add(const float* payload, const int* ids,
                               double* acc, long long n_hits, int width,
                               int n_gauss, void* stream) {
  return launch<false>(payload, ids, acc, n_hits, width, n_gauss, nullptr,
                       stream);
}

// What the runtime reports of the kernel: registers and spilled (local)
// bytes per thread, shared memory per block, resident blocks per SM.
extern "C" int egr_scatter_add_info(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncSetAttribute(
      scatter_add_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&a, scatter_add_kernel<false>);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, scatter_add_kernel<false>, THREADS, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = SMEM_BYTES;
  out[3] = blocks;
  return 0;
}

#ifdef EGR_SCATTER_COUNT
// egr_scatter_add that also adds the number of atomics it issues to
// *n_atomics (device memory).
extern "C" int egr_scatter_add_counted(const float* payload, const int* ids,
                                       double* acc, long long n_hits,
                                       int width, int n_gauss,
                                       unsigned long long* n_atomics,
                                       void* stream) {
  return launch<true>(payload, ids, acc, n_hits, width, n_gauss, n_atomics,
                      stream);
}
#endif
