// sort_slots.cu - the k-buffer walks' slot sort as a kernel of its own: per
// ray, K slots (t, id) and A auxiliary blocks of K values are ordered by
// (t, id), the auxiliary values moving with their slots; slots with equal
// (t, id) keep their input order.
//
// Replaces the inline Pallas kernel of tests/test_pallas_kernel.py
// (test_sort_slots_orders_by_depth_with_aux), which runs _sort_slots of
// editable_gaussian_reflections_tpu/ops/pallas/trace_kernel.py.  The plain
// PyTorch version is sort_slots_aux_reference in ops/cuda/sort_slots.py (two
// stable torch.sorts: by id, then by t).  _sort_slots orders by (t, slot
// index), this by (t, id, slot index): the two differ only in the order of
// slots with equal t and different ids.
//
// Design.  K lanes take one ray (a warp at K 32, a half-warp at K 16), lane s
// holding slot s, so that every load and store of t, ids and each auxiliary
// block is one coalesced row of K x 4 bytes.  A bitonic network sorts across
// the lanes with __shfl_xor_sync on the key (t, id, slot): the slot index is
// the last key, which makes the keys distinct and the order the stable one.
// t is compared as an ordered integer with -0 equal to +0 and every NaN
// after every number, as torch.sort compares.  Each auxiliary value then
// moves with one __shfl_sync from the lane that held its slot.
//
// What bounds it: bytes (every value is read once and written once).  The
// network is log2(K) (log2(K) + 1) / 2 stages of three shuffles per lane.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

// t as an unsigned integer in the order torch.sort gives floats: -0 = +0,
// NaN after +inf.
__device__ __forceinline__ uint32_t depth_key(float t) {
  if (t != t) return 0xffffffffu;
  const uint32_t b = __float_as_uint(t == 0.0f ? 0.0f : t);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

template <int K>
__global__ void __launch_bounds__(THREADS)
    sort_slots_kernel(const float* __restrict__ t, const int* __restrict__ ids,
                      const float* __restrict__ aux, float* __restrict__ t_out,
                      int* __restrict__ ids_out, float* __restrict__ aux_out,
                      int n_rays, int n_aux) {
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long ray = e / K;
  const int slot = threadIdx.x & (K - 1);
  // lanes past the last ray take part in the shuffles and store nothing
  const bool on = ray < n_rays;
  float st = on ? t[e] : 0.0f;
  int sid = on ? ids[e] : 0;
  int src = slot;  // the input slot this lane holds
  uint32_t key = depth_key(st);
#pragma unroll
  for (int k = 2; k <= K; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const float pt = __shfl_xor_sync(FULL, st, j);
      const int pid = __shfl_xor_sync(FULL, sid, j);
      const int psrc = __shfl_xor_sync(FULL, src, j);
      const uint32_t pkey = depth_key(pt);
      const bool partner_less =
          pkey < key ||
          (pkey == key && (pid < sid || (pid == sid && psrc < src)));
      // the lower lane of a pair keeps the smaller key in an ascending
      // sequence of the merge, the larger in a descending one
      const bool keep_min = ((slot & j) == 0) == ((slot & k) == 0);
      if (partner_less == keep_min) {
        st = pt;
        sid = pid;
        src = psrc;
        key = pkey;
      }
    }
  }
  if (on) {
    t_out[e] = st;
    ids_out[e] = sid;
  }
  const long long row = ray * n_aux * K;
  for (int a = 0; a < n_aux; ++a) {
    const float v = on ? aux[row + a * K + slot] : 0.0f;
    const float moved = __shfl_sync(FULL, v, src, K);
    if (on) aux_out[row + a * K + slot] = moved;
  }
}

template <int K>
cudaError_t launch(const float* t, const int* ids, const float* aux,
                   float* t_out, int* ids_out, float* aux_out, int n_rays,
                   int n_aux, cudaStream_t s) {
  const long long blocks = ((long long)n_rays * K + THREADS - 1) / THREADS;
  sort_slots_kernel<K><<<(unsigned)blocks, THREADS, 0, s>>>(
      t, ids, aux, t_out, ids_out, aux_out, n_rays, n_aux);
  return cudaGetLastError();
}

template <int K>
cudaError_t info(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, sort_slots_kernel<K>);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, sort_slots_kernel<K>, THREADS, 0);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = blocks;
  return cudaSuccess;
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

// What the runtime reports of the kernel at K: registers and spilled (local)
// bytes per thread, static shared memory per block, resident blocks per SM.
extern "C" int egr_sort_slots_info(int k, int* out) {
  if (k == 16) return (int)info<16>(out);
  if (k == 32) return (int)info<32>(out);
  return (int)cudaErrorInvalidValue;
}
