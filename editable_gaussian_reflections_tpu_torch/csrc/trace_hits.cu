// trace_hits.cu - one bounce of the non-fused trace: ray x Gaussian walk,
// exact per-ray top-K, the K kept hits depth-sorted with their per-hit
// payload (alpha, gaussval, local hit), and the log-transmittance over every
// processed hit.
//
// Replaces the Pallas kernels pallas_trace_fused (brute: every Gaussian
// chunk, no exit) and pallas_trace_culled_fused (culled: the tile's
// candidate clusters, nearest first, with an exit before each candidate), in
// editable_gaussian_reflections_tpu/ops/pallas/trace_kernel.py.  The plain
// PyTorch version of the same contract is trace_hits_reference in
// ops/cuda/trace_hits.py.
//
// Design.  The walk is csrc/trace_hits_walk.cuh, written for this kernel
// and shared since with the render and slots kernels: one block per ray
// tile, one thread per ray, clusters streamed through a two-stage cp.async
// ring and traced four Gaussians a step (one float4 shared-memory load per
// row for all four), the kept hits (t, id) in a per-thread column of shared
// memory, so that two 256-ray blocks share an SM at K 32 (one did with
// trace_tile.cuh's walk, at 158-164 registers), the reciprocal of the pair
// math without a branch per pair, and on blocks whose rays share an origin
// the ray-independent terms computed once per Gaussian.  Kernels are
// instantiated per K (8, 16, 32, 64), exponent (3 spelled out, or general)
// and pass (backfacing test on reflected passes).  The two Pallas kernels
// map onto it:
//   culled  an exit vote before every candidate: the tile stops once each
//           ray is saturated or has its K-th hit before the candidate's near
//           distance.  pallas_trace_culled_fused skips the rest instead of
//           stopping; on near-ascending lists (what select_candidates
//           returns) that is the same.  The prefetch of the next candidate
//           is issued after the vote; one lost to an exit costs nothing.
//   brute   the caller lists every cluster for every tile, with near
//           distance -INF and log threshold -INF, in one group
//           (check_every = mc): one vote, before the first cluster, which
//           never passes, then every cluster streamed.
// The Pallas kernels take no alive mask (the non-fused renderer masks dead
// rays afterwards), so the caller passes all ones and dead rays are traced
// like live ones; a tile's exit waits for them exactly as on the TPU.
// The TPU drain carried each hit's payload through its one-hot insertion;
// here the epilogue sorts the kept hits by (t, id) (the Pallas kernels sort
// by (t, slot index): the two differ only on exact depth ties) and recomputes
// gaussval, alpha (MAX_ALPHA * gaussval * opacity) and the local hit of each
// kept hit from its gpack column, with the walk's float operations, so they
// equal what the walk saw.
//
// Numerics (ops/precision.py): float32 pair math without FMA contraction,
// exp and pow in float64 rounded once, sqrt of sf^2 in float64 rounded once,
// the log1p(-alpha) terms and their sum in float64, rounded to float32 once.
//
// What bounds it: the pair math on the FP32 pipe.  About 60 flops per ray x
// Gaussian pair; where a block's rays share one origin (a primary pass), 34
// per pair and 26 per Gaussian (rel, lo and |lo|^2 do not depend on the
// ray).  At 67 TFLOP/s (an FMA counted as two) that is the flop bound.
// Built without contraction, each FMUL and FADD issues alone, so the issue
// floor is those flops one per lane and clock, 132 SMs x 128 lanes x 1.98
// GHz = 33.5e12 a second: twice the flop bound.  The compiled loop issues
// ~73 per pair (the reciprocal's three, the compares, the four float4 loads
// per pair), ~47 on a shared origin; the float64 exp/log1p of each valid
// hit come on top.  The brute mode tests every pair.  The epilogue's row
// writes stay strided (per thread); they move well under 1 GB per launch.

#include <cuda_runtime.h>

#include "trace_hits_walk.cuh"

namespace {

using namespace egr_hits;

template <int K, bool CUBE, bool BACKFACING>
__global__ void __launch_bounds__(MAX_TILE)
    trace_hits_kernel(HitsParams p, float* t_out, int* id_out,
                      float* alpha_out, float* gaussval_out,
                      float* local_hit_out, float* log_t_out, int* trav_out) {
  extern __shared__ __align__(16) float smem[];
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const Ray ray = load_ray<false>(p, r);
  float* col_t;
  int* col_id;
  double log_t;
  float trav, chunks;
  walk_hits<K, CUBE, BACKFACING, /*EXIT=*/0, /*CHUNKS=*/false>(
      p, smem, ray, col_t, col_id, log_t, trav, chunks);

  // the kept hits in (t, id) order, sorted in the slot column
  sort_column<K>(col_t, col_id, blockDim.x);
  const size_t row = (size_t)r * K;
  for (int s = 0; s < K; ++s) {
    const float t = col_t[s * blockDim.x];
    const int id = col_id[s * blockDim.x];
    float gaussval = 0.0f, alpha = 0.0f, lh[3] = {0.0f, 0.0f, 0.0f};
    const bool v = t < INF;
    if (v) {
      const KeptHit h = kept_hit<CUBE>(p, ray, id);
      gaussval = h.gaussval;
      alpha = h.alpha;
      const float sf = (float)sqrt((double)fmaxf(h.sf2, 0.0f));
#pragma unroll
      for (int i = 0; i < 3; ++i) lh[i] = sf * (h.lo[i] + t * h.ld[i]);
    }
    t_out[row + s] = t;
    id_out[row + s] = v ? id : 0;
    alpha_out[row + s] = alpha;
    gaussval_out[row + s] = gaussval;
#pragma unroll
    for (int i = 0; i < 3; ++i) local_hit_out[3 * (row + s) + i] = lh[i];
  }
  log_t_out[r] = (float)log_t;
  trav_out[r] = (int)trav;
}

template <int K, bool CUBE, bool BACKFACING>
cudaError_t launch(const HitsParams& p, float* t_out, int* id_out,
                   float* alpha_out, float* gaussval_out, float* local_hit_out,
                   float* log_t_out, int* trav_out, int n_tiles, int tile,
                   cudaStream_t s) {
  const int smem = (int)walk_smem_bytes(K, tile, p.cluster);
  const auto kernel = trace_hits_kernel<K, CUBE, BACKFACING>;
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_tiles, tile, smem, s>>>(p, t_out, id_out, alpha_out,
                                     gaussval_out, local_hit_out, log_t_out,
                                     trav_out);
  return cudaGetLastError();
}

// The instantiation for the launch's exponent and pass: exp_power 3 with
// the cube spelled out, and the backfacing test on reflected passes.
template <int K>
cudaError_t launch_k(const HitsParams& p, float* t_out, int* id_out,
                     float* alpha_out, float* gaussval_out,
                     float* local_hit_out, float* log_t_out, int* trav_out,
                     int n_tiles, int tile, cudaStream_t s) {
  // the backfacing test gated on `secondary`, as the Pallas kernels gate it
  const bool cube = p.int_power == 3,
             backfacing = backfacing_for(-1, p.secondary);
  const auto go = cube ? (backfacing ? launch<K, true, true>
                                     : launch<K, true, false>)
                       : (backfacing ? launch<K, false, true>
                                     : launch<K, false, false>);
  return go(p, t_out, id_out, alpha_out, gaussval_out, local_hit_out,
            log_t_out, trav_out, n_tiles, tile, s);
}

template <int K, bool CUBE, bool BACKFACING>
cudaError_t info(int tile, int cluster, int* out) {
  return kernel_info(trace_hits_kernel<K, CUBE, BACKFACING>, tile,
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

// Plain C entry point (bound with ctypes).  t, alpha, gaussval [n_rays,
// max_hits] f32, ids [n_rays, max_hits] i32, local_hit [n_rays, max_hits, 3]
// f32, log_t [n_rays] f32 and traversed [n_rays] i32 are written in full.
// alive: [n_rays] f32 (the non-fused path passes ones).  The shapes it takes
// are init_hits_params' (trace_hits_walk.cuh); it returns SHAPES_REFUSED for
// any other.  Launches on `stream`, allocates nothing, and returns the
// launch's cudaError_t (0 = success).
extern "C" int egr_trace_hits(
    const float* rays_o, const float* rays_d, const float* alive,
    const float* gpack, const int* cand, const float* cand_near, float* t_out,
    int* id_out, float* alpha_out, float* gaussval_out, float* local_hit_out,
    float* log_t_out, int* trav_out, int n_rays, int n_gauss, int mc,
    int tile, int cluster, int max_hits, int check_every, float near,
    float far, float secondary, float bf_max_dist, float bf_thr,
    float log_thr, float exp_power, void* stream) {
  HitsParams p;
  if (!init_hits_params(p, rays_o, rays_d, alive, gpack, cand, cand_near,
                        n_rays, n_gauss, mc, tile, cluster, max_hits,
                        check_every, near, far, secondary, bf_max_dist,
                        bf_thr, log_thr, exp_power))
    return SHAPES_REFUSED;
  if (n_rays == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = n_rays / tile;
  return with_k(max_hits, [&](auto k) {
    return launch_k<decltype(k)::value>(p, t_out, id_out, alpha_out,
                                        gaussval_out, local_hit_out,
                                        log_t_out, trav_out, n_tiles, tile,
                                        s);
  });
}

// The compiled kernel of (max_hits, cube, backfacing) at (tile, cluster):
// what kernel_info (trace_hits_walk.cuh) reports in out[0..3].  exit_mode
// must be 0, the only one this kernel has.  Returns a cudaError_t, or
// SHAPES_REFUSED.
extern "C" int egr_trace_hits_info(int max_hits, int cube, int backfacing,
                                   int exit_mode, int tile, int cluster,
                                   int* out) {
  if (!hits_shape_ok(max_hits, tile, cluster) || exit_mode != 0)
    return SHAPES_REFUSED;
  return with_k(max_hits, [&](auto k) {
    return info_k<decltype(k)::value>(cube, backfacing, tile, cluster,
                                      out);
  });
}
