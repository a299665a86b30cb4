// render_culled.cu - one bounce of the eval render: culled ray x Gaussian
// trace, exact per-ray top-K k-buffer, front-to-back composite with the
// truncated-tail correction, and the tile early exit.
//
// Replaces the Pallas kernels pallas_render_culled_v4 (whole scene resident
// in VMEM) and pallas_render_culled_v3 (scene streamed by manual DMA), both
// in editable_gaussian_reflections_tpu/ops/pallas/render_kernel_v3.py, and
// pallas_render_culled_v5 (render_kernel_v5.py) on v5's prepared lists.
// The three differ in where the scene lives on a TPU and in how their lists
// are prepared; here one kernel serves them all, and the caller picks the
// early-exit group size each of them used (8 for v4, 4 for v3).  The plain
// PyTorch version of the same contract is render_culled_reference in
// ops/cuda/render_kernel.py.
//
// Design.  The walk over the tile's candidates is csrc/trace_hits_walk.cuh,
// the walk of all three k-buffer kernels (exit mode 0, with the processed
// cluster counter): one block per ray tile of at most 512 rays, one thread
// per ray, clusters streamed through a two-stage cp.async ring and traced
// four Gaussians a step, the kept hits (t, id) in a per-thread column of
// shared memory (two 256-ray blocks per SM at K 32, where the registers of
// the first version's walk allowed one), the pair math's reciprocal without
// a branch per pair, and the ray-independent terms once per Gaussian where
// a block's rays share an origin (a primary pass).  The split-far window
// (window modes 1/2) becomes a per-ray bound on t, so the walk's loop is
// the same for every window mode.  Kernels are instantiated per K (8, 16,
// 32, 64), exponent (3 spelled out, or general) and the backfacing test.
// The TPU kernels' one-hot MXU attribute extraction and striped spread were
// workarounds for a machine without per-lane scatter, so here the epilogue
// sorts the kept hits by (t, id), recomputes each one's alpha from its
// gpack column with the walk's float operations (so it equals what the walk
// saw), reads its attributes by id and composites them
// (kbuffer_composite.cuh).
//
// Numerics (the port's rules, ops/precision.py): the pair math is float32,
// built without FMA contraction (-fmad=false) and without fast math, so it
// rounds like the plain version's separate multiplies and adds.  exp and pow
// are evaluated in float64 and rounded once; the log1p(-alpha) terms and
// every sum stay in float64.  The kernel and its plain version then agree
// bit for bit on any device, and the discrete decisions of the render (hit
// validity, K-th hit, saturation, the T >= threshold cutoff) come out the
// same.  Measured on an H100 80GB HBM3 at 700 W, at the eval render's
// shapes, with the first version's walk: a float32 variant (expf/log1pf,
// float accumulators) was 3% slower, and FMA contraction 5% faster but
// changed the counters of 0.32% of the primary rays and a lane by up to
// 0.70 (|u|^2 = <lo,lo> - <lo,ld>^2/<ld,ld> cancels, so the hit test moves).
//
// What bounds it: the f32 pair math on the FP32 pipe, about 60 flops per
// ray x Gaussian pair, 34 per pair and 26 per Gaussian on a shared origin
// (no tensor-core form is used); the float64 work is per valid hit only.
// Known costs left for later: the float64 exp/log1p per valid hit in the
// walk, and the epilogue's scattered gpack reads (about 27 a kept hit).

#include <cuda_runtime.h>

#include "kbuffer_composite.cuh"
#include "trace_hits_walk.cuh"

namespace {

using namespace egr_hits;

template <int K, bool CUBE, bool BACKFACING>
__global__ void __launch_bounds__(MAX_TILE)
    render_culled_kernel(HitsParams p, float thr, float eps_norm,
                         float* out) {
  extern __shared__ __align__(16) float smem[];
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const Ray ray = load_ray<true>(p, r);
  float* col_t;
  int* col_id;
  double log_t;
  float trav, chunks;
  walk_hits<K, CUBE, BACKFACING, /*EXIT=*/0, /*CHUNKS=*/true>(
      p, smem, ray, col_t, col_id, log_t, trav, chunks);
  sort_column<K>(col_t, col_id, blockDim.x);

  const int attr_rows[egr::NUM_ATTR] = {
      egr::ROW_RGB,     egr::ROW_RGB + 1, egr::ROW_RGB + 2, egr::ROW_NRM,
      egr::ROW_NRM + 1, egr::ROW_NRM + 2, egr::ROW_F0,      egr::ROW_F0 + 1,
      egr::ROW_F0 + 2,  egr::ROW_ROUGH};
  const int stride = blockDim.x;
  egr::composite_slots<K>(
      [&](int i, float& t, int& id) {
        t = col_t[i * stride];
        id = col_id[i * stride];
      },
      [&](int, int id) { return kept_hit<CUBE>(p, ray, id).alpha; }, log_t,
      trav, chunks, thr, eps_norm,
      [&](int a, int id) {
        return p.gpack[(size_t)attr_rows[a] * p.n_gauss + id];
      },
      out + (size_t)r * egr::OUT_LANES);
}

template <int K, bool CUBE, bool BACKFACING>
cudaError_t launch(const HitsParams& p, float thr, float eps_norm, float* out,
                   int n_tiles, int tile, cudaStream_t s) {
  const int smem = (int)walk_smem_bytes(K, tile, p.cluster);
  const auto kernel = render_culled_kernel<K, CUBE, BACKFACING>;
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_tiles, tile, smem, s>>>(p, thr, eps_norm, out);
  return cudaGetLastError();
}

// The instantiation for the launch's exponent and backfacing test.
template <int K>
cudaError_t launch_k(const HitsParams& p, bool backfacing, float thr,
                     float eps_norm, float* out, int n_tiles, int tile,
                     cudaStream_t s) {
  const bool cube = p.int_power == 3;
  const auto go = cube ? (backfacing ? launch<K, true, true>
                                     : launch<K, true, false>)
                       : (backfacing ? launch<K, false, true>
                                     : launch<K, false, false>);
  return go(p, thr, eps_norm, out, n_tiles, tile, s);
}

template <int K, bool CUBE, bool BACKFACING>
cudaError_t info(int tile, int cluster, int* out) {
  return kernel_info(render_culled_kernel<K, CUBE, BACKFACING>, tile,
                     (int)walk_smem_bytes(K, tile, cluster), out);
}

template <int K>
cudaError_t info_k(bool cube, bool backfacing, int tile, int cluster,
                   int* out) {
  const auto go = cube ? (backfacing ? info<K, true, true>
                                     : info<K, true, false>)
                       : (backfacing ? info<K, false, true>
                                     : info<K, false, false>);
  return go(tile, cluster, out);
}

}  // namespace

// Plain C entry point (bound with ctypes).  out [n_rays, 16] f32 is written
// in full (lanes in ops/cuda/layout.py).  window_mode 0 (none), 1 (keep t <
// t_split) or 2 (keep t > t_split); secondary_static 1 (the backfacing test),
// 0 (none) or -1 (where `secondary` > 0).  The shapes it takes are
// init_hits_params' (trace_hits_walk.cuh); it returns SHAPES_REFUSED for any
// other.  Launches on `stream`, allocates nothing, and returns the launch's
// cudaError_t (0 = success).
extern "C" int egr_render_culled(
    const float* rays_o, const float* rays_d, const float* alive,
    const float* t_split, const float* gpack, const int* cand,
    const float* cand_near, float* out, int n_rays, int n_gauss, int mc,
    int tile, int cluster, int max_hits, int check_every, int window_mode,
    int secondary_static, float near, float far, float secondary,
    float bf_max_dist, float bf_thr, float thr, float eps_norm, float log_thr,
    float exp_power, void* stream) {
  HitsParams p;
  if (!init_hits_params(p, rays_o, rays_d, alive, gpack, cand, cand_near,
                        n_rays, n_gauss, mc, tile, cluster, max_hits,
                        check_every, near, far, secondary, bf_max_dist,
                        bf_thr, log_thr, exp_power) ||
      window_mode < 0 || window_mode > 2 || secondary_static < -1 ||
      secondary_static > 1)
    return SHAPES_REFUSED;
  p.t_split = t_split;
  p.window_mode = window_mode;
  if (n_rays == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = n_rays / tile;
  const bool backfacing = backfacing_for(secondary_static, secondary);
  return with_k(max_hits, [&](auto k) {
    return launch_k<decltype(k)::value>(p, backfacing, thr, eps_norm, out,
                                        n_tiles, tile, s);
  });
}

// The compiled kernel of (max_hits, cube, backfacing) at (tile, cluster):
// what kernel_info (trace_hits_walk.cuh) reports in out[0..3].  exit_mode
// must be 0, the only one this kernel has.  Returns a cudaError_t, or
// SHAPES_REFUSED.
extern "C" int egr_render_culled_info(int max_hits, int cube, int backfacing,
                                      int exit_mode, int tile, int cluster,
                                      int* out) {
  if (!hits_shape_ok(max_hits, tile, cluster) || exit_mode != 0)
    return SHAPES_REFUSED;
  return with_k(max_hits, [&](auto k) {
    return info_k<decltype(k)::value>(cube, backfacing, tile, cluster,
                                      out);
  });
}
