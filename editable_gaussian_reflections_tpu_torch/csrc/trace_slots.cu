// trace_slots.cu - one bounce of the training trace: culled ray x Gaussian
// walk, exact per-ray top-K, and the K kept hits written out depth-sorted
// with the full per-hit payload the training step's composite and backward
// read (t, alpha, id, 10 shading attributes, 24 frame-table fields).
//
// Replaces the Pallas kernels pallas_trace_slots_v4 (editable_gaussian_
// reflections_tpu/ops/pallas/render_kernel_v3.py, scene resident in VMEM)
// and pallas_trace_slots (ops/pallas/render_kernel.py, scene streamed).  The
// two differ in where the scene lives on a TPU, and in their early exit,
// which is part of the result: the caller picks exit_mode 0 (v4: group of 8,
// dead_all) or 1 (v1: pairs, per-ray dead), as the JAX dispatch picks the
// kernel (slots_resident_fits).  The plain PyTorch version of the same
// contract is trace_slots_reference in ops/cuda/trace_slots.py.
//
// Design.  The walk is csrc/trace_tile.cuh, shared with the render kernel:
// each thread keeps only (t, alpha, id) of its K nearest hits in registers.
// The Pallas kernels carried the whole 37-column payload through their
// drain (one-hot MXU extraction, striped spread matrices), because a TPU
// core cannot gather a row by id; here the epilogue sorts the K hits by
// (t, id) and gathers each kept hit's attributes and frame fields by id from
// the row-major attribute and frame tables (pack_attr_table,
// pack_frame_table), the inputs of pallas_trace_slots.  Output rows follow
// unpack_slots' block order; empty slots are t = INF with every other
// column 0.
//
// What bounds it: the pair math, about 60 flops per ray x Gaussian pair on
// the FP32 units, as in render_culled.cu; the output is 37*K floats per ray
// (4.7 KB at K=32), written once.  Known costs left for later: one block per
// SM at K=32 (register-bound), and strided row writes in the epilogue (each
// thread writes its own row).

#include <cuda_runtime.h>

#include "trace_tile.cuh"

namespace {

using namespace egr;

// slot blocks (ops/cuda/layout.py)
constexpr int SLOT_T = 0;
constexpr int SLOT_ALPHA = 1;
constexpr int SLOT_ID = 2;
constexpr int SLOT_ATTR = 3;
constexpr int NUM_FRAME = 24;
constexpr int SLOT_FRAME = SLOT_ATTR + NUM_ATTR;
constexpr int SLOT_BLOCKS = SLOT_FRAME + NUM_FRAME;
constexpr int TABLE_A = 16;
constexpr int FTABLE_A = 32;
constexpr int ACC_LANES = 16;

template <int K, bool CUBE>
__global__ void trace_slots_kernel(TraceParams p, const float* table,
                                   const float* ftable, float* slots,
                                   float* acc) {
  extern __shared__ float sg[];  // [N_GEOM_ROWS, cluster]
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  float st[K], sa[K];
  int sid[K];
  double log_t;
  float trav, chunks;
  trace_tile<K, CUBE>(p, sg, st, sa, sid, log_t, trav, chunks);
  sort_slots<K>(st, sa, sid);

  float* o = slots + (size_t)r * (SLOT_BLOCKS * K);
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const bool v = st[s] < INF;
    const int id = sid[s];
    o[SLOT_T * K + s] = st[s];
    o[SLOT_ALPHA * K + s] = v ? sa[s] : 0.0f;
    o[SLOT_ID * K + s] = v ? (float)id : 0.0f;
    const float* at = table + (size_t)id * TABLE_A;
#pragma unroll
    for (int a = 0; a < NUM_ATTR; ++a)
      o[(SLOT_ATTR + a) * K + s] = v ? at[a] : 0.0f;
    const float* f = ftable + (size_t)id * FTABLE_A;
#pragma unroll
    for (int c = 0; c < NUM_FRAME; ++c)
      o[(SLOT_FRAME + c) * K + s] = v ? f[c] : 0.0f;
  }
  float* a = acc + (size_t)r * ACC_LANES;
  a[0] = (float)log_t;
  a[1] = trav;
  a[2] = chunks;
  for (int i = 3; i < ACC_LANES; ++i) a[i] = 0.0f;
}

template <int K>
cudaError_t launch(const TraceParams& p, const float* table,
                   const float* ftable, float* slots, float* acc, int n_tiles,
                   int tile, cudaStream_t s) {
  const size_t smem = sizeof(float) * N_GEOM_ROWS * p.cluster;
  if (p.int_power == 3)
    trace_slots_kernel<K, true><<<n_tiles, tile, smem, s>>>(p, table, ftable,
                                                            slots, acc);
  else
    trace_slots_kernel<K, false><<<n_tiles, tile, smem, s>>>(p, table, ftable,
                                                             slots, acc);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  slots [n_rays, 37*max_hits] and
// acc [n_rays, 16] f32 are written in full.  Launches on `stream`, allocates
// nothing, and returns the launch's cudaError_t (0 = success).
extern "C" int egr_trace_slots(
    const float* rays_o, const float* rays_d, const float* alive,
    const float* gpack, const float* table, const float* ftable,
    const int* cand,
    const float* cand_near, float* slots, float* acc, int n_rays, int n_gauss,
    int mc, int tile, int cluster, int max_hits, int check_every,
    int exit_mode, int secondary_static, float near, float far,
    float secondary, float bf_max_dist, float bf_thr, float log_thr,
    float exp_power, void* stream) {
  TraceParams p;
  // no split-far window (window_mode 0), so no t_split
  if (!init_trace_params(p, rays_o, rays_d, alive, /*t_split=*/nullptr, gpack,
                         cand, cand_near, n_rays, n_gauss, mc, tile, cluster,
                         check_every, exit_mode, /*window_mode=*/0,
                         secondary_static, near, far, secondary, bf_max_dist,
                         bf_thr, log_thr, exp_power))
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = n_rays / tile;
  if (max_hits == 16)
    return (int)launch<16>(p, table, ftable, slots, acc, n_tiles, tile, s);
  if (max_hits == 32)
    return (int)launch<32>(p, table, ftable, slots, acc, n_tiles, tile, s);
  return (int)cudaErrorInvalidValue;
}
