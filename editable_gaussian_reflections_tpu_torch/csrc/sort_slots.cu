// sort_slots.cu - the k-buffer walks' in-register slot sort as a kernel of
// its own: per ray, K slots (t, id) and A auxiliary blocks of K values are
// ordered by (t, id), the auxiliary values moving with their slots.
//
// Replaces the inline Pallas kernel of tests/test_pallas_kernel.py
// (test_sort_slots_orders_by_depth_with_aux), which runs _sort_slots of
// editable_gaussian_reflections_tpu/ops/pallas/trace_kernel.py.  The plain
// PyTorch version is sort_slots_reference in ops/cuda/sort_slots.py.
//
// Design.  One thread per ray runs the port's device sort,
// egr::sort_slots<K> of trace_tile.cuh (odd-even transposition over
// registers), with each slot's own index riding in the sort's alpha
// channel; the auxiliary blocks are then gathered through that permutation.
// _sort_slots orders by (t, slot index), this by (t, id): the two differ
// only in the order of slots with equal t.
//
// What bounds it: bytes (every value is read once and written once; the
// sort is K^2/2 compare-exchanges in registers per ray).  Loads are strided
// by K between neighbouring threads and served through L1; nothing is
// staged.

#include <cuda_runtime.h>

#include "trace_tile.cuh"

namespace {

template <int K>
__global__ void sort_slots_kernel(const float* t, const int* ids,
                                  const float* aux, float* t_out,
                                  int* ids_out, float* aux_out, int n_rays,
                                  int n_aux) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  float st[K], slot[K];
  int sid[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    st[s] = t[(size_t)r * K + s];
    sid[s] = ids[(size_t)r * K + s];
    slot[s] = (float)s;
  }
  egr::sort_slots<K>(st, slot, sid);
#pragma unroll
  for (int s = 0; s < K; ++s) {
    t_out[(size_t)r * K + s] = st[s];
    ids_out[(size_t)r * K + s] = sid[s];
  }
  const float* src = aux + (size_t)r * n_aux * K;
  float* dst = aux_out + (size_t)r * n_aux * K;
  for (int a = 0; a < n_aux; ++a) {
#pragma unroll
    for (int s = 0; s < K; ++s) dst[a * K + s] = src[a * K + (int)slot[s]];
  }
}

template <int K>
cudaError_t launch(const float* t, const int* ids, const float* aux,
                   float* t_out, int* ids_out, float* aux_out, int n_rays,
                   int n_aux, cudaStream_t s) {
  constexpr int threads = 128;
  const int blocks = (n_rays + threads - 1) / threads;
  sort_slots_kernel<K><<<blocks, threads, 0, s>>>(t, ids, aux, t_out, ids_out,
                                                  aux_out, n_rays, n_aux);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream`, allocates
// nothing, and returns the launch's cudaError_t (0 = success).
extern "C" int egr_sort_slots(const float* t, const int* ids,
                              const float* aux, float* t_out, int* ids_out,
                              float* aux_out, int n_rays, int k, int n_aux,
                              void* stream) {
  if (n_rays < 0 || n_aux < 0) return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 16)
    return (int)launch<16>(t, ids, aux, t_out, ids_out, aux_out, n_rays,
                           n_aux, s);
  if (k == 32)
    return (int)launch<32>(t, ids, aux, t_out, ids_out, aux_out, n_rays,
                           n_aux, s);
  return (int)cudaErrorInvalidValue;
}
