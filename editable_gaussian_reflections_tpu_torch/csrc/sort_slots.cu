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
// Design.  L = min(K, 32) lanes take one ray (a half-warp at K 16, a
// quarter at K 8, a warp at K 32 and 64), each lane holding R = K / L slots
// in registers: register r of lane l holds slot l + r * L, so that every
// load and store of t, ids and each auxiliary block is R coalesced rows of
// L x 4 bytes.  A bitonic network sorts the K slots on the key (t, id,
// slot): the slot index is the last key, which makes the keys distinct and
// the order the stable one.  A stage whose partner is L or more slots away
// (K 64's first stage of its last merge) compares the lane's own registers;
// every other stage exchanges each register with __shfl_xor_sync.  t is
// compared as an ordered integer with -0 equal to +0 and every NaN after
// every number, as torch.sort compares.  Each auxiliary value then moves
// with one __shfl_sync per register from the lane that held its slot.
//
// What bounds it: bytes (every value is read once and written once).  The
// network is log2(K) (log2(K) + 1) / 2 stages of three shuffles per lane and
// register.

#include <cuda_runtime.h>

#include <cstdint>

#include "kbuffer_k.cuh"

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

// One slot as the network moves it: t, id, the input slot and t's key.
struct Slot {
  float t;
  int id, src;
  uint32_t key;
};

// Whether a comes before b in (t, id, slot) order.
__device__ __forceinline__ bool slot_less(const Slot& a, const Slot& b) {
  return a.key < b.key ||
         (a.key == b.key && (a.id < b.id || (a.id == b.id && a.src < b.src)));
}

template <int K>
__global__ void __launch_bounds__(THREADS)
    sort_slots_kernel(const float* __restrict__ t, const int* __restrict__ ids,
                      const float* __restrict__ aux, float* __restrict__ t_out,
                      int* __restrict__ ids_out, float* __restrict__ aux_out,
                      int n_rays, int n_aux) {
  constexpr int L = K < 32 ? K : 32;  // lanes a ray
  constexpr int R = K / L;            // slots a lane
  const long long g = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long ray = g / L;
  const int lane = threadIdx.x & (L - 1);
  // lanes past the last ray take part in the shuffles and store nothing
  const bool on = ray < n_rays;
  const long long base = ray * K + lane;  // slot `lane` of the ray
  Slot v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    v[r].t = on ? t[base + r * L] : 0.0f;
    v[r].id = on ? ids[base + r * L] : 0;
    v[r].src = lane + r * L;
    v[r].key = depth_key(v[r].t);
  }
#pragma unroll
  for (int k = 2; k <= K; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= L) {
        // partners in this lane: register r and r + j / L, the lower slot
        // keeping the smaller key in an ascending sequence of the merge
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int rp = r + j / L;
          if ((r & (j / L)) != 0 || rp >= R) continue;
          const bool up = ((lane + r * L) & k) == 0;
          if (slot_less(v[rp], v[r]) == up) {
            const Slot x = v[r];
            v[r] = v[rp];
            v[rp] = x;
          }
        }
        continue;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        Slot q;
        q.t = __shfl_xor_sync(FULL, v[r].t, j);
        q.id = __shfl_xor_sync(FULL, v[r].id, j);
        q.src = __shfl_xor_sync(FULL, v[r].src, j);
        q.key = depth_key(q.t);
        // the lower lane of a pair keeps the smaller key in an ascending
        // sequence of the merge, the larger in a descending one
        const int slot = lane + r * L;
        const bool keep_min = ((slot & j) == 0) == ((slot & k) == 0);
        if (slot_less(q, v[r]) == keep_min) v[r] = q;
      }
    }
  }
  if (on) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      t_out[base + r * L] = v[r].t;
      ids_out[base + r * L] = v[r].id;
    }
  }
  const long long row = ray * n_aux * K + lane;
  for (int a = 0; a < n_aux; ++a) {
    float x[R];
#pragma unroll
    for (int r = 0; r < R; ++r) x[r] = on ? aux[row + a * K + r * L] : 0.0f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      // slot src is register src / L of lane src % L
      float moved = 0.0f;
#pragma unroll
      for (int rs = 0; rs < R; ++rs) {
        const float m = __shfl_sync(FULL, x[rs], v[r].src & (L - 1), L);
        if (v[r].src / L == rs) moved = m;
      }
      if (on) aux_out[row + a * K + r * L] = moved;
    }
  }
}

template <int K>
cudaError_t launch(const float* t, const int* ids, const float* aux,
                   float* t_out, int* ids_out, float* aux_out, int n_rays,
                   int n_aux, cudaStream_t s) {
  constexpr int L = K < 32 ? K : 32;
  const long long blocks = ((long long)n_rays * L + THREADS - 1) / THREADS;
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
// nothing, and returns the launch's cudaError_t (0 = success), or
// SHAPES_REFUSED for a K it is not built for (kbuffer_k.cuh).
extern "C" int egr_sort_slots(const float* t, const int* ids,
                              const float* aux, float* t_out, int* ids_out,
                              float* aux_out, int n_rays, int k, int n_aux,
                              void* stream) {
  if (n_rays < 0 || n_aux < 0) return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return egr_k::with_k(k, [&](auto kk) {
    return launch<decltype(kk)::value>(t, ids, aux, t_out, ids_out, aux_out,
                                       n_rays, n_aux, s);
  });
}

// What the runtime reports of the kernel at K: registers and spilled (local)
// bytes per thread, static shared memory per block, resident blocks per SM;
// SHAPES_REFUSED for a K it is not built for.
extern "C" int egr_sort_slots_info(int k, int* out) {
  return egr_k::with_k(
      k, [&](auto kk) { return info<decltype(kk)::value>(out); });
}
