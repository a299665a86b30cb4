// scatter_hash.cu - a measurement kernel beside csrc/scatter_grads.cu: the
// same scatter (acc [n_gauss, width] f64 += payload [n_hits, width] f32 rows
// by ids, -1 skipped) in the same 4096-row chunks, with scatter_grads.cu's
// first segmented sums (a warp a span, a lane a column), but the chunk's
// rows grouped by a counting sort on a hash of the id in place of the
// bitonic sort on the id.
//
// Each valid row inserts its id into an open-addressing table of CHUNK
// slots in shared memory (atomicCAS, linear probing: a chunk holds at most
// CHUNK distinct ids, so a free slot or the id's own is always found) and
// takes its rank within the slot from an atomicAdd on the slot's count.  An
// exclusive scan of the counts gives each slot's first position, and each
// row's key (slot << ROW_BITS | row) goes to first + rank: every id's rows
// are contiguous.  Two shared-memory atomics a row instead of the network's
// log2(n) (log2(n) + 1) / 2 compare-exchanges; the order of rows within an
// id's run follows the atomics and changes from run to run (float64 sums of
// float32 values are nearly always exact, as in scatter_grads.cu).
//
// tools/scatter_ab.py builds it (build.load with this directory) and times
// it against scatter_grads.cu in turns; the port does not run it.
// EGR_SCATTER_COUNT adds egr_scatter_add_counted, as in scatter_grads.cu.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PER_THREAD = 16;               // rows a thread reads
constexpr int CHUNK = THREADS * PER_THREAD;  // rows a block takes
constexpr int ROW_BITS = 12;                 // log2(CHUNK)
constexpr int LOADS = 8;                     // rows a warp reads ahead
constexpr unsigned FULL = 0xffffffffu;
static_assert((1 << ROW_BITS) == CHUNK, "ROW_BITS must be log2(CHUNK)");

struct Smem {
  uint32_t keys[CHUNK];  // (slot << ROW_BITS | row), grouped by slot
  int table[CHUNK];      // the id a slot holds, or -1
  int count[CHUNK];      // rows per slot, then the slot's first position
  int warp_sum[WARPS];
};

__device__ __forceinline__ int hash_slot(int id) {
  return (int)(((uint32_t)id * 2654435761u) >> (32 - ROW_BITS));
}

template <bool COUNT>
__device__ __forceinline__ void flush(double* acc, int id, double sum,
                                      int width, int col, bool has_col,
                                      unsigned long long* n_atomics) {
  const bool add = id >= 0 && has_col && sum != 0.0;
  if (add) atomicAdd(acc + (size_t)id * width + col, sum);
  if (COUNT) {
    const unsigned adds = __ballot_sync(FULL, add);
    if ((threadIdx.x & 31) == 0 && adds) atomicAdd(n_atomics, __popc(adds));
  }
}

template <bool COUNT>
__global__ void __launch_bounds__(THREADS)
    scatter_hash_kernel(const float* __restrict__ payload,
                        const int* __restrict__ ids, double* __restrict__ acc,
                        long long n_hits, int width, int n_gauss,
                        unsigned long long* n_atomics) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem& s = *reinterpret_cast<Smem*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long base = (long long)blockIdx.x * CHUNK;
  const int rows = (int)min((long long)CHUNK, n_hits - base);

  for (int i = threadIdx.x; i < CHUNK; i += THREADS) {
    s.table[i] = -1;
    s.count[i] = 0;
  }
  __syncthreads();
  // insert each valid row's id; slot and rank packed (slot << 13 | rank)
  int placed[PER_THREAD];
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    const int row = q * THREADS + threadIdx.x;
    const int id = row < rows ? ids[base + row] : -1;
    placed[q] = -1;
    if ((unsigned)id < (unsigned)n_gauss) {
      int h = hash_slot(id);
      while (true) {
        const int prev = atomicCAS(&s.table[h], -1, id);
        if (prev == -1 || prev == id) break;
        h = (h + 1) & (CHUNK - 1);
      }
      placed[q] = (h << 13) | atomicAdd(&s.count[h], 1);
    }
  }
  __syncthreads();
  // exclusive scan of the counts: thread t takes slots j * THREADS + t
  int local = 0;
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j)
    local += s.count[j * THREADS + threadIdx.x];
  int incl = local;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) s.warp_sum[warp] = incl;
  __syncthreads();
  int at = incl - local, n_valid = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const int c = s.warp_sum[w];
    at += w < warp ? c : 0;
    n_valid += c;
  }
  if (n_valid == 0) return;  // block-uniform
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int i = j * THREADS + threadIdx.x;
    const int c = s.count[i];
    s.count[i] = at;
    at += c;
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < PER_THREAD; ++q) {
    if (placed[q] < 0) continue;
    const int h = placed[q] >> 13;
    s.keys[s.count[h] + (placed[q] & 0x1fff)] =
        ((uint32_t)h << ROW_BITS) | (uint32_t)(q * THREADS + threadIdx.x);
  }
  __syncthreads();

  // segmented sums: warp `warp` walks grouped rows [begin, end), a lane a
  // column
  const int span = (n_valid + WARPS - 1) / WARPS;
  const int begin = min(warp * span, n_valid);
  const int end = min(begin + span, n_valid);
  for (int c0 = 0; c0 < width; c0 += 32) {
    const int col = c0 + lane;
    const bool has_col = col < width;
    int cur = -1;
    double sum = 0.0;
    for (int pos = begin; pos < end; pos += LOADS) {
      int gid[LOADS];
      float val[LOADS];
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        gid[u] = -1;
        val[u] = 0.0f;
        if (pos + u < end) {
          const uint32_t key = s.keys[pos + u];
          const int row = (int)(key & (CHUNK - 1));
          gid[u] = s.table[key >> ROW_BITS];
          if (has_col) val[u] = payload[(base + row) * width + col];
        }
      }
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        if (gid[u] < 0) break;  // past the span's end
        if (gid[u] != cur) {
          flush<COUNT>(acc, cur, sum, width, col, has_col, n_atomics);
          cur = gid[u];
          sum = 0.0;
        }
        sum += (double)val[u];
      }
    }
    flush<COUNT>(acc, cur, sum, width, col, has_col, n_atomics);
  }
}

template <bool COUNT>
int launch(const float* payload, const int* ids, double* acc,
           long long n_hits, int width, int n_gauss,
           unsigned long long* n_atomics, void* stream) {
  if (width <= 0 || n_hits < 0 || n_gauss <= 0)
    return (int)cudaErrorInvalidValue;
  if (n_hits == 0) return 0;
  const long long blocks = (n_hits + CHUNK - 1) / CHUNK;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      scatter_hash_kernel<COUNT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(Smem));
  if (err != cudaSuccess) return (int)err;
  scatter_hash_kernel<COUNT><<<(unsigned)blocks, THREADS, sizeof(Smem),
                               static_cast<cudaStream_t>(stream)>>>(
      payload, ids, acc, n_hits, width, n_gauss, n_atomics);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int egr_scatter_add(const float* payload, const int* ids,
                               double* acc, long long n_hits, int width,
                               int n_gauss, void* stream) {
  return launch<false>(payload, ids, acc, n_hits, width, n_gauss, nullptr,
                       stream);
}

#ifdef EGR_SCATTER_COUNT
extern "C" int egr_scatter_add_counted(const float* payload, const int* ids,
                                       double* acc, long long n_hits,
                                       int width, int n_gauss,
                                       unsigned long long* n_atomics,
                                       void* stream) {
  return launch<true>(payload, ids, acc, n_hits, width, n_gauss, n_atomics,
                      stream);
}
#endif
