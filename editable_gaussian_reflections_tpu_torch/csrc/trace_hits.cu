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
// Design.  The walk is csrc/trace_tile.cuh, unchanged and shared with the
// render and slots kernels: one block per ray tile, one thread per ray, a
// cluster's geometry staged in shared memory, each thread keeping its K
// nearest hits (t, alpha, id) in registers.  The two Pallas kernels map onto
// it as follows:
//   culled  exit mode 0 with check_every 1: before every candidate the tile
//           stops once each ray is saturated or has its K-th hit before the
//           candidate's near distance.  pallas_trace_culled_fused skips the
//           rest instead of stopping; on near-ascending lists (what
//           select_candidates returns) that is the same.
//   brute   the caller lists every cluster for every tile, with near
//           distance -INF and log threshold -INF, in one group
//           (check_every = mc): nothing ever exits.
// The Pallas kernels take no alive mask (the non-fused renderer masks dead
// rays afterwards), so the caller passes all ones and dead rays are traced
// like live ones; a tile's exit waits for them exactly as on the TPU.
// The TPU drain carried each hit's payload through its one-hot insertion;
// here the epilogue sorts the kept hits by (t, id) (the Pallas kernels sort
// by (t, slot index): the two differ only on exact depth ties) and recomputes
// gaussval and the local hit of each kept hit from its gpack column, with
// the walk's float operations, so they equal what the walk saw.
//
// Numerics (ops/precision.py): float32 pair math without FMA contraction,
// exp and pow in float64 rounded once, sqrt of sf^2 in float64 rounded once,
// the log1p(-alpha) terms and their sum in float64, rounded to float32 once.
//
// What bounds it: the pair math, about 60 flops per ray x Gaussian pair on
// the FP32 units, as in render_culled.cu; the brute mode tests every pair.
// Known costs left for later: one block per SM at K=32 (register-bound),
// strided row writes in the epilogue.

#include <cuda_runtime.h>

#include "trace_tile.cuh"

namespace {

using namespace egr;

template <int K, bool CUBE>
__global__ void trace_hits_kernel(TraceParams p, float* t_out, int* id_out,
                                  float* alpha_out, float* gaussval_out,
                                  float* local_hit_out, float* log_t_out,
                                  int* trav_out) {
  extern __shared__ float sg[];  // [N_GEOM_ROWS, cluster]
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  float st[K], sa[K];
  int sid[K];
  double log_t;
  float trav, chunks;
  trace_tile<K, CUBE>(p, sg, st, sa, sid, log_t, trav, chunks);
  sort_slots<K>(st, sa, sid);

  const float ox = p.rays_o[3 * r], oy = p.rays_o[3 * r + 1],
              oz = p.rays_o[3 * r + 2];
  const float dx = p.rays_d[3 * r], dy = p.rays_d[3 * r + 1],
              dz = p.rays_d[3 * r + 2];
  const float k2 = 2.0f * p.exp_power;
  const size_t row = (size_t)r * K;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    float gaussval = 0.0f, lh[3] = {0.0f, 0.0f, 0.0f};
    const bool v = st[s] < INF;
    if (v) {
      const int id = sid[s];
#define G(row) p.gpack[(size_t)(row) * p.n_gauss + id]
      const float rx = ox - G(ROW_MEAN);
      const float ry = oy - G(ROW_MEAN + 1);
      const float rz = oz - G(ROW_MEAN + 2);
      float lo[3], ld[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float r0 = G(ROW_ROT + i), r1 = G(ROW_ROT + 3 + i),
                    r2 = G(ROW_ROT + 6 + i);
        const float inv = G(ROW_INV + i);
        lo[i] = inv * (r0 * rx + r1 * ry + r2 * rz);
        ld[i] = inv * (r0 * dx + r1 * dy + r2 * dz);
      }
      const float dot_ol = lo[0] * ld[0] + lo[1] * ld[1] + lo[2] * ld[2];
      const float dot_ll = ld[0] * ld[0] + ld[1] * ld[1] + ld[2] * ld[2];
      const float dot_oo = lo[0] * lo[0] + lo[1] * lo[1] + lo[2] * lo[2];
      const float inv_ll = 1.0f / fmaxf(dot_ll, 1e-30f);
      const float sq = dot_oo - dot_ol * dot_ol * inv_ll;
      const float sf2 = G(ROW_SF2);
#undef G
      const float sqs = fmaxf(sq * sf2, 0.0f);
      float powered;
      if (CUBE) {
        powered = sqs * sqs * sqs;
      } else if (p.int_power > 0) {
        powered = sqs;
        for (int e = 1; e < p.int_power; ++e) powered = powered * sqs;
      } else {
        powered = (float)pow((double)sqs, (double)p.exp_power);
      }
      gaussval = (float)exp((double)(-powered / k2));
      const float sf = (float)sqrt((double)fmaxf(sf2, 0.0f));
#pragma unroll
      for (int i = 0; i < 3; ++i) lh[i] = sf * (lo[i] + st[s] * ld[i]);
    }
    t_out[row + s] = st[s];
    id_out[row + s] = v ? sid[s] : 0;
    alpha_out[row + s] = v ? sa[s] : 0.0f;
    gaussval_out[row + s] = gaussval;
#pragma unroll
    for (int i = 0; i < 3; ++i) local_hit_out[3 * (row + s) + i] = lh[i];
  }
  log_t_out[r] = (float)log_t;
  trav_out[r] = (int)trav;
}

template <int K>
cudaError_t launch(const TraceParams& p, float* t_out, int* id_out,
                   float* alpha_out, float* gaussval_out, float* local_hit_out,
                   float* log_t_out, int* trav_out, int n_tiles, int tile,
                   cudaStream_t s) {
  const size_t smem = sizeof(float) * N_GEOM_ROWS * p.cluster;
  if (p.int_power == 3)
    trace_hits_kernel<K, true><<<n_tiles, tile, smem, s>>>(
        p, t_out, id_out, alpha_out, gaussval_out, local_hit_out, log_t_out,
        trav_out);
  else
    trace_hits_kernel<K, false><<<n_tiles, tile, smem, s>>>(
        p, t_out, id_out, alpha_out, gaussval_out, local_hit_out, log_t_out,
        trav_out);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  t, alpha, gaussval [n_rays,
// max_hits] f32, ids [n_rays, max_hits] i32, local_hit [n_rays, max_hits, 3]
// f32, log_t [n_rays] f32 and traversed [n_rays] i32 are written in full.
// alive: [n_rays] f32 (the non-fused path passes ones).  Launches on
// `stream`, allocates nothing, and returns the launch's cudaError_t (0 =
// success).
extern "C" int egr_trace_hits(
    const float* rays_o, const float* rays_d, const float* alive,
    const float* gpack, const int* cand, const float* cand_near, float* t_out,
    int* id_out, float* alpha_out, float* gaussval_out, float* local_hit_out,
    float* log_t_out, int* trav_out, int n_rays, int n_gauss, int mc,
    int tile, int cluster, int max_hits, int check_every, float near,
    float far, float secondary, float bf_max_dist, float bf_thr,
    float log_thr, float exp_power, void* stream) {
  TraceParams p;
  // no split-far window; the backfacing test is gated on `secondary`, as
  // the Pallas kernels gate it
  if (!init_trace_params(p, rays_o, rays_d, alive, /*t_split=*/nullptr,
                         gpack, cand, cand_near, n_rays, n_gauss, mc, tile,
                         cluster, check_every, /*exit_mode=*/0,
                         /*window_mode=*/0, /*secondary_static=*/-1, near,
                         far, secondary, bf_max_dist, bf_thr, log_thr,
                         exp_power))
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = n_rays / tile;
  if (max_hits == 16)
    return (int)launch<16>(p, t_out, id_out, alpha_out, gaussval_out,
                           local_hit_out, log_t_out, trav_out, n_tiles, tile,
                           s);
  if (max_hits == 32)
    return (int)launch<32>(p, t_out, id_out, alpha_out, gaussval_out,
                           local_hit_out, log_t_out, trav_out, n_tiles, tile,
                           s);
  return (int)cudaErrorInvalidValue;
}
