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
// Design.  The walk is the k-buffer walk of render_culled.cu
// (csrc/trace_hits_walk.cuh) in exit mode 1 with groups of 2, which is what
// the Pallas kernel's grid does: one grid step per pair of candidate
// clusters, the step skipped when every ray of the tile is saturated,
// behind the pair's first near distance, or dead; an empty (-1) candidate
// is skipped and not counted; OUT_CHUNKS counts every computed cluster.
// The TPU kernel extracted each inserted hit's attribute row with a one-hot
// [R, C] x [C, 16] MXU product during its drain; here the epilogue
// (kbuffer_composite.cuh) reads the K kept hits' rows of the table by id,
// once, after the walk, with alpha recomputed per kept hit.
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
#include "trace_hits_walk.cuh"

namespace {

using namespace egr_hits;

constexpr int TABLE_A = 16;  // attribute-table row width (ops/cuda/layout.py)

template <int K, bool CUBE, bool BACKFACING>
__global__ void __launch_bounds__(MAX_TILE)
    render_table_kernel(HitsParams p, const float* table, float thr,
                        float eps_norm, float* out) {
  extern __shared__ __align__(16) float smem[];
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const Ray ray = load_ray<false>(p, r);
  float* col_t;
  int* col_id;
  double log_t;
  float trav, chunks;
  walk_hits<K, CUBE, BACKFACING, /*EXIT=*/1, /*CHUNKS=*/true>(
      p, smem, ray, col_t, col_id, log_t, trav, chunks);
  sort_column<K>(col_t, col_id, blockDim.x);
  const int stride = blockDim.x;
  // table columns 0-9 are rgb, normal, f0, roughness: the lane order
  egr::composite_slots<K>(
      [&](int i, float& t, int& id) {
        t = col_t[i * stride];
        id = col_id[i * stride];
      },
      [&](int, int id) { return kept_hit<CUBE>(p, ray, id).alpha; }, log_t,
      trav, chunks, thr, eps_norm,
      [&](int a, int id) { return table[(size_t)id * TABLE_A + a]; },
      out + (size_t)r * egr::OUT_LANES);
}

template <int K, bool CUBE, bool BACKFACING>
cudaError_t launch(const HitsParams& p, const float* table, float thr,
                   float eps_norm, float* out, int n_tiles, int tile,
                   cudaStream_t s) {
  const int smem = (int)walk_smem_bytes(K, tile, p.cluster);
  const auto kernel = render_table_kernel<K, CUBE, BACKFACING>;
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_tiles, tile, smem, s>>>(p, table, thr, eps_norm, out);
  return cudaGetLastError();
}

// The instantiation for the launch's exponent and backfacing test.
template <int K>
cudaError_t launch_k(const HitsParams& p, bool backfacing, const float* table,
                     float thr, float eps_norm, float* out, int n_tiles,
                     int tile, cudaStream_t s) {
  const bool cube = p.int_power == 3;
  const auto go = cube ? (backfacing ? launch<K, true, true>
                                     : launch<K, true, false>)
                       : (backfacing ? launch<K, false, true>
                                     : launch<K, false, false>);
  return go(p, table, thr, eps_norm, out, n_tiles, tile, s);
}

}  // namespace

// Plain C entry point (bound with ctypes).  The shapes it takes are
// init_hits_params' (trace_hits_walk.cuh); it returns SHAPES_REFUSED for any
// other.  Launches on `stream`, allocates nothing, and returns the launch's
// cudaError_t (0 = success).
extern "C" int egr_render_table(
    const float* rays_o, const float* rays_d, const float* alive,
    const float* gpack, const float* table, const int* cand,
    const float* cand_near, float* out, int n_rays, int n_gauss, int mc,
    int tile, int cluster, int max_hits, int secondary_static, float near,
    float far, float secondary, float bf_max_dist, float bf_thr, float thr,
    float eps_norm, float log_thr, float exp_power, void* stream) {
  HitsParams p;
  if (!init_hits_params(p, rays_o, rays_d, alive, gpack, cand, cand_near,
                        n_rays, n_gauss, mc, tile, cluster, max_hits,
                        /*check_every=*/2, near, far, secondary, bf_max_dist,
                        bf_thr, log_thr, exp_power) ||
      secondary_static < -1 || secondary_static > 1)
    return SHAPES_REFUSED;
  if (n_rays == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = n_rays / tile;
  const bool backfacing = backfacing_for(secondary_static, secondary);
  return with_k(max_hits, [&](auto k) {
    return launch_k<decltype(k)::value>(p, backfacing, table, thr, eps_norm,
                                        out, n_tiles, tile, s);
  });
}
