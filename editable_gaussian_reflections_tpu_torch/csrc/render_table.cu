// render_table.cu - the round-2 fused render: culled ray x Gaussian trace,
// exact per-ray top-K k-buffer, front-to-back composite with the
// truncated-tail correction, the shading attributes read by id from an
// [N, TABLE_A] attribute table.
//
// Replaces the Pallas kernel pallas_render_culled in
// editable_gaussian_reflections_tpu/ops/pallas/render_kernel.py.  Its plain
// PyTorch version is render_culled_table_reference in
// ops/cuda/render_table.py.
//
// Design.  The walk is csrc/trace_tile.cuh in exit mode 1 with groups of 2,
// which is what the Pallas kernel's grid does: one grid step per pair of
// candidate clusters, the step skipped when every ray of the tile is
// saturated, behind the pair's first near distance, or dead; an empty (-1)
// candidate is skipped and not counted; OUT_CHUNKS counts every computed
// cluster.  The TPU kernel extracted each inserted hit's attribute row with
// a one-hot [R, C] x [C, 16] MXU product during its drain; here the
// epilogue (kbuffer_composite.cuh) reads the K kept hits' rows of the table
// by id, once, after the walk.
//
// The Pallas epilogue composites its K slots order-free: each hit's
// transmittance is the product over the slots strictly nearer, ties broken
// by slot index.  That equals compositing the slots sorted, which is what
// the epilogue here does, with ties broken by Gaussian id instead of slot
// index: the two differ only on exact depth ties.
//
// Numerics are render_culled.cu's (float32 pair math without FMA
// contraction, float64 exp/log1p and sums), so the kernel and its plain
// version agree bit for bit.

#include <cuda_runtime.h>

#include "kbuffer_composite.cuh"
#include "trace_tile.cuh"

namespace {

using namespace egr;

constexpr int TABLE_A = 16;  // attribute-table row width (ops/cuda/layout.py)

template <int K, bool CUBE>
__global__ void render_table_kernel(TraceParams p, const float* table,
                                    float thr, float eps_norm, float* out) {
  extern __shared__ float sg[];  // [N_GEOM_ROWS, cluster]
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  float st[K], sa[K];
  int sid[K];
  double log_t;
  float trav, chunks;
  trace_tile<K, CUBE>(p, sg, st, sa, sid, log_t, trav, chunks);
  sort_slots<K>(st, sa, sid);
  // table columns 0-9 are rgb, normal, f0, roughness: the lane order
  composite_slots<K>(
      [&](int i, float& t, int& id) {
        t = st[i];
        id = sid[i];
      },
      [&](int i, int) { return sa[i]; }, log_t, trav, chunks, thr, eps_norm,
      [&](int a, int id) { return table[(size_t)id * TABLE_A + a]; },
      out + (size_t)r * OUT_LANES);
}

template <int K>
cudaError_t launch(const TraceParams& p, const float* table, float thr,
                   float eps_norm, float* out, int n_tiles, int tile,
                   cudaStream_t s) {
  const size_t smem = sizeof(float) * N_GEOM_ROWS * p.cluster;
  if (p.int_power == 3)
    render_table_kernel<K, true><<<n_tiles, tile, smem, s>>>(p, table, thr,
                                                             eps_norm, out);
  else
    render_table_kernel<K, false><<<n_tiles, tile, smem, s>>>(p, table, thr,
                                                              eps_norm, out);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream`, allocates
// nothing, and returns the launch's cudaError_t (0 = success).
extern "C" int egr_render_table(
    const float* rays_o, const float* rays_d, const float* alive,
    const float* gpack, const float* table, const int* cand,
    const float* cand_near, float* out, int n_rays, int n_gauss, int mc,
    int tile, int cluster, int max_hits, int secondary_static, float near,
    float far, float secondary, float bf_max_dist, float bf_thr, float thr,
    float eps_norm, float log_thr, float exp_power, void* stream) {
  TraceParams p;
  if (!init_trace_params(p, rays_o, rays_d, alive, /*t_split=*/nullptr,
                         gpack, cand, cand_near, n_rays, n_gauss, mc, tile,
                         cluster, /*check_every=*/2, /*exit_mode=*/1,
                         /*window_mode=*/0, secondary_static, near, far,
                         secondary, bf_max_dist, bf_thr, log_thr, exp_power))
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = n_rays / tile;
  if (max_hits == 16)
    return (int)launch<16>(p, table, thr, eps_norm, out, n_tiles, tile, s);
  if (max_hits == 32)
    return (int)launch<32>(p, table, thr, eps_norm, out, n_tiles, tile, s);
  return (int)cudaErrorInvalidValue;
}
