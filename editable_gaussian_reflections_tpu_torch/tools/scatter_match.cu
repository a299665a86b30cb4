// scatter_match.cu - a measurement kernel beside csrc/scatter_grads.cu: the
// same scatter (acc [n_gauss, width] f64 += payload [n_hits, width] f32 rows
// by ids, -1 skipped), with equal ids pre-aggregated only within a warp by
// __match_any_sync instead of a block sort.
//
// A warp takes 32 neighbouring rays of K slots: for each slot s, lane l
// reads the id of row (ray0 + l) * K + s, and __match_any_sync groups the
// lanes holding one Gaussian.  The warp then sums each group's rows with a
// lane per column (a row is one coalesced load) and adds each nonzero sum
// with one atomicAdd, as scatter_grads.cu's segmented sums do.  It needs no
// shared memory and no sort, but only meets the repeats that fall on the same
// slot of neighbouring rays.
//
// tools/scatter_ab.py builds it (build.load with this directory) and times
// it against scatter_grads.cu in turns; the port does not run it.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

template <bool COUNT>
__global__ void __launch_bounds__(THREADS)
    scatter_match_kernel(const float* __restrict__ payload,
                         const int* __restrict__ ids,
                         double* __restrict__ acc, long long n_hits,
                         int width, int n_gauss, int k,
                         unsigned long long* n_atomics) {
  const int lane = threadIdx.x & 31;
  const long long ray0 =
      ((long long)blockIdx.x * THREADS + threadIdx.x - lane);  // 32 per warp
  for (int s = 0; s < k; ++s) {
    const long long row = (ray0 + lane) * k + s;
    int id = row < n_hits ? ids[row] : -1;
    if ((unsigned)id >= (unsigned)n_gauss) id = -1;
    const unsigned peers = __match_any_sync(FULL, id);
    unsigned pending = __ballot_sync(FULL, id >= 0);
    while (pending) {
      const int leader = __ffs(pending) - 1;
      const int gid = __shfl_sync(FULL, id, leader);
      unsigned members = __shfl_sync(FULL, peers, leader);
      pending &= ~members;
      for (int c0 = 0; c0 < width; c0 += 32) {
        const int col = c0 + lane;
        const bool has_col = col < width;
        double sum = 0.0;
        for (unsigned m = members; m; m &= m - 1) {
          const long long r = (ray0 + __ffs(m) - 1) * k + s;
          if (has_col) sum += (double)payload[r * width + col];
        }
        const bool add = has_col && sum != 0.0;
        if (add) atomicAdd(acc + (size_t)gid * width + col, sum);
        if (COUNT) {
          const unsigned adds = __ballot_sync(FULL, add);
          if (lane == 0 && adds) atomicAdd(n_atomics, __popc(adds));
        }
      }
    }
  }
}

}  // namespace

// acc [n_gauss, width] f64 += payload [n_hits, width] f32 by ids [n_hits]
// i32, the rows read as rays of k slots; n_atomics (device memory, or null)
// counts the atomics issued.  Launches on `stream`, returns the launch's
// cudaError_t (0 = success).
extern "C" int egr_scatter_match(const float* payload, const int* ids,
                                 double* acc, long long n_hits, int width,
                                 int n_gauss, int k,
                                 unsigned long long* n_atomics,
                                 void* stream) {
  if (width <= 0 || n_hits < 0 || n_gauss <= 0 || k <= 0)
    return (int)cudaErrorInvalidValue;
  if (n_hits == 0) return 0;
  const long long rays = (n_hits + k - 1) / k;
  const long long blocks = (rays + THREADS - 1) / THREADS;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_atomics)
    scatter_match_kernel<true><<<(unsigned)blocks, THREADS, 0, st>>>(
        payload, ids, acc, n_hits, width, n_gauss, k, n_atomics);
  else
    scatter_match_kernel<false><<<(unsigned)blocks, THREADS, 0, st>>>(
        payload, ids, acc, n_hits, width, n_gauss, k, n_atomics);
  return (int)cudaGetLastError();
}
