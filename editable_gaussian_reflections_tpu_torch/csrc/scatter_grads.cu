// scatter_grads.cu - the training step's gradient scatter: every valid hit
// adds its row of per-hit gradient columns into the row of its Gaussian.
//
// Replaces pallas_scatter_grads_t (editable_gaussian_reflections_tpu/ops/
// pallas/scatter_kernel.py), and serves as the step's scatter in place of
// the XLA segment-sum render_grads.scatter_grads computes.  The Pallas kernel
// restated atomicAdd as one-hot matrix products against per-tile candidate
// lists, because a TPU has no scattered atomic add; Hopper has one, so the
// kernel needs no candidate lists: a thread per (hit, column) adds its value
// into the accumulator with atomicAdd.  One launch takes the hits of every
// bounce of a step (their rows are concatenated), as the Pallas kernel's
// multi-bounce form did.
//
// Numerics: the accumulator is float64 and the caller rounds it to float32
// once, after the step's last launch.  Sums of float32 addends in float64 are
// nearly always exact, so the result does not depend on the order the
// atomics land in; cancellations give exact zeros.  The plain version
// (ops/cuda/scatter.py, index_add_ in float64) gives the same sums.  Hits
// with id < 0 (empty slots) and zero values are skipped: adding +0.0 or -0.0
// to a float64 sum that starts at +0.0 never changes it.
//
// What bounds it: the bytes of the payload (22 float32 columns and one id
// per hit) and the accumulator's read-modify-write traffic in L2; atomics on
// the same Gaussian serialise.  This first version does nothing about
// contention (no warp-level pre-aggregation of equal ids).

#include <cuda_runtime.h>

namespace {

__global__ void scatter_add_kernel(const float* __restrict__ payload,
                                   const int* __restrict__ ids,
                                   double* __restrict__ acc, long long n_vals,
                                   int width, int n_gauss) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < n_vals; e += stride) {
    const long long hit = e / width;
    const int id = ids[hit];
    if (id < 0 || id >= n_gauss) continue;
    const float v = payload[e];
    if (v == 0.0f) continue;
    atomicAdd(acc + (size_t)id * width + (e - hit * width), (double)v);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  acc [n_gauss, width] f64 +=
// payload [n_hits, width] f32 by ids [n_hits] i32.  Launches on `stream`,
// allocates nothing, returns the launch's cudaError_t (0 = success).
extern "C" int egr_scatter_add(const float* payload, const int* ids,
                               double* acc, long long n_hits, int width,
                               int n_gauss, void* stream) {
  if (width <= 0 || n_hits < 0 || n_gauss <= 0)
    return (int)cudaErrorInvalidValue;
  if (n_hits == 0) return 0;
  const long long n_vals = n_hits * width;
  const int threads = 256;
  long long blocks = (n_vals + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond this
  scatter_add_kernel<<<(int)blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      payload, ids, acc, n_vals, width, n_gauss);
  return (int)cudaGetLastError();
}
