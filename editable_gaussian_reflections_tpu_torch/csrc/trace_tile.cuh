// trace_tile.cuh - the first version's culled ray x Gaussian walk, and what
// the other kernels take from it.  Its walk (trace_tile) is the round-2
// render's (render_table.cu) and the measurement kernel's
// (tools/grouped_walk.cu); its pair-math functions are the streaming scan
// kernel's (render_scan.cu); its sort_slots is the slot-sort kernel's
// (sort_slots.cu); its gpack row constants and INF / MAX_ALPHA are the
// k-buffer walk's (trace_hits_walk.cuh), which the eval render
// (render_culled.cu), the training slots trace (trace_slots.cu) and the
// non-fused trace (trace_hits.cu) run instead of trace_tile.
//
// One block per ray tile, one thread per ray.  The block walks the tile's
// candidate clusters (nearest first); for each cluster it stages the 22
// geometry rows of the gpack block ([22, cluster] f32, at most 22.5 KB) in
// shared memory, and every thread tests its ray against each Gaussian of the
// cluster (the pair math of the JAX render_kernel.py:_pair_math).  Each
// thread keeps its K nearest hits (t, alpha, id) in registers with a
// replace-max insertion, and accumulates the log-transmittance of every
// valid hit in the processed clusters.  Every `check_every` clusters the
// block decides, with __syncthreads_and, whether every ray is done and stops
// if so.  That exit is part of the result (full_T and the counters count
// only the processed clusters), so it follows the Pallas kernel being
// reproduced, selected by `exit_mode`:
//
//   0  pallas_render_culled_v4/_v3 (tools/grouped_walk.cu): a ray is done
//      when saturated (log T <= log thr) or when its K-th hit lies before
//      the group's first candidate; the walk also stops at once when every
//      ray of the tile is dead.  chunks counts processed clusters holding
//      any valid Gaussian.
//   1  pallas_render_culled (render_table.cu, check_every 2): a dead ray
//      also counts as done; chunks counts every processed cluster.
//
// Numerics (ops/precision.py): float32 pair math built without FMA
// contraction (-fmad=false), exp and pow in float64 rounded once, the
// log1p(-alpha) terms and every sum in float64.  The plain PyTorch versions
// (ops/cuda/render_kernel.py) compute the same and agree bit for bit.

#pragma once

#include <cuda_runtime.h>

namespace egr {

// gpack rows (ops/cuda/layout.py)
constexpr int ROW_MEAN = 0;
constexpr int ROW_ROT = 3;
constexpr int ROW_INV = 12;
constexpr int ROW_OPACITY = 15;
constexpr int ROW_SF2 = 16;
constexpr int ROW_NRM = 17;
constexpr int ROW_NLEN = 20;
constexpr int ROW_VALID = 21;
constexpr int ROW_RGB = 22;
constexpr int ROW_F0 = 25;
constexpr int ROW_ROUGH = 28;
constexpr int N_GEOM_ROWS = 22;
constexpr int NUM_ATTR = 10;  // rgb, normal, f0, roughness (ATTR_ROWS in
                              // ops/cuda/layout.py: the kernels' attr_rows)

constexpr float INF = 3.0e38f;
constexpr float MAX_ALPHA = 0.9999f;

struct TraceParams {
  const float* rays_o;     // [R, 3]
  const float* rays_d;     // [R, 3]
  const float* alive;      // [R]  > 0 for live rays
  const float* t_split;    // [R]  window bound, read in window_mode 1/2
  const float* gpack;      // [32, n_gauss]
  const int* cand;         // [R / tile, mc]  cluster ids, -1 = none
  const float* cand_near;  // [R / tile, mc]  near distance, ascending
  int n_gauss;
  int mc;
  int cluster;
  int check_every;
  int exit_mode;           // 0 / 1, see above
  int window_mode;         // 0 none, 1 keep t < t_split, 2 keep t > t_split
  int secondary_static;    // 0 no backfacing test, 1 always, -1 gate on secondary
  int int_power;           // exp_power when it is an integer in [1, 8], else 0
  float near, far, secondary, bf_max_dist, bf_thr;
  float log_thr, exp_power;
};

// Fill the fields shared by every launch; false if the shapes are refused.
inline bool init_trace_params(TraceParams& p, const float* rays_o,
                              const float* rays_d, const float* alive,
                              const float* t_split, const float* gpack,
                              const int* cand, const float* cand_near,
                              int n_rays, int n_gauss, int mc, int tile,
                              int cluster, int check_every, int exit_mode,
                              int window_mode, int secondary_static,
                              float near, float far, float secondary,
                              float bf_max_dist, float bf_thr, float log_thr,
                              float exp_power) {
  if (tile <= 0 || tile > 1024 || n_rays % tile != 0 || cluster <= 0 ||
      check_every <= 0 || mc <= 0 || n_gauss % cluster != 0 ||
      sizeof(float) * N_GEOM_ROWS * cluster > 48 * 1024 ||
      (exit_mode != 0 && exit_mode != 1))
    return false;
  p.rays_o = rays_o;
  p.rays_d = rays_d;
  p.alive = alive;
  p.t_split = t_split;
  p.gpack = gpack;
  p.cand = cand;
  p.cand_near = cand_near;
  p.n_gauss = n_gauss;
  p.mc = mc;
  p.cluster = cluster;
  p.check_every = check_every;
  p.exit_mode = exit_mode;
  p.window_mode = window_mode;
  p.secondary_static = secondary_static;
  const bool integer = exp_power >= 1.0f && exp_power <= 8.0f &&
                       exp_power == (float)(int)exp_power;
  p.int_power = integer ? (int)exp_power : 0;
  p.near = near;
  p.far = far;
  p.secondary = secondary;
  p.bf_max_dist = bf_max_dist;
  p.bf_thr = bf_thr;
  p.log_thr = log_thr;
  p.exp_power = exp_power;
  return true;
}

// The pair math as functions, for the streaming scan kernel
// (render_scan.cu): the same float operations as trace_tile's inline copy
// below and trace_hits_walk.cuh's.  trace_tile keeps that copy because
// routing it through these functions made nvcc schedule the k-buffer walks
// ~9% slower on an H100 (render_culled primary pass 60.3 -> 65.6 ms,
// trace_slots 68.9 -> 75.0 ms at the 800x800 / 100k-room shapes, when both
// walked trace_tile; tools/walk_ab.py).  Keep the three in step.

// One ray, as every thread of a walk holds it.
struct RayState {
  float ox, oy, oz, dx, dy, dz;
  float t_split;  // read in window_mode 1/2 only
  bool live;
};

__device__ __forceinline__ RayState load_ray(const TraceParams& p, int r) {
  RayState ray;
  ray.ox = p.rays_o[3 * r];
  ray.oy = p.rays_o[3 * r + 1];
  ray.oz = p.rays_o[3 * r + 2];
  ray.dx = p.rays_d[3 * r];
  ray.dy = p.rays_d[3 * r + 1];
  ray.dz = p.rays_d[3 * r + 2];
  ray.live = p.alive[r] > 0.0f;
  ray.t_split = p.window_mode != 0 ? p.t_split[r] : 0.0f;
  return ray;
}

// Whether a ray x Gaussian pair is a hit, from the pair's ray-frame
// quantities (the JAX _pair_math's validity): in front of the Gaussian's
// centre, inside its unit sphere, inside [near, far] and the window, on a
// live ray, and on reflected passes not a backfacing near hit.
// backfacing() - the Gaussian's normal is long enough and faces along the
// ray - is evaluated only when that test runs: its loads stay off the
// common path.
template <class Backfacing>
__device__ __forceinline__ bool pair_valid(const TraceParams& p,
                                           const RayState& ray, float gvalid,
                                           float dot_ol, float sq, float t,
                                           const Backfacing& backfacing) {
  bool valid = (gvalid > 0.0f) && (dot_ol <= 0.0f) && (sq <= 1.0f) &&
               (t > p.near) && (t < p.far) && ray.live;
  if (p.window_mode == 1) valid = valid && (t < ray.t_split);
  if (p.window_mode == 2) valid = valid && (t > ray.t_split);
  if (valid && p.secondary_static != 0) {
    const bool reject = (t < p.bf_max_dist) && backfacing();
    valid = p.secondary_static == 1 ? !reject
                                    : (p.secondary <= 0.0f || !reject);
  }
  return valid;
}

// The generalized-Gaussian opacity of a hit at squared unit-sphere distance
// sq: exp and pow in float64, rounded once.
template <bool CUBE>
__device__ __forceinline__ float pair_alpha(const TraceParams& p, float sq,
                                            float sf2, float opacity) {
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
  const float gaussval =
      (float)exp((double)(-powered / (2.0f * p.exp_power)));
  return MAX_ALPHA * gaussval * opacity;
}

// The direct pair math (the JAX render_kernel.py:_pair_math): the ray in
// the Gaussian's unit-sphere frame, its closest approach t and squared
// distance sq.  G(row) reads the Gaussian's gpack row; gvalid is its
// ROW_VALID, which the caller has read.  Returns whether the pair is a hit;
// t and alpha are set for hits.
template <bool CUBE, class Row>
__device__ __forceinline__ bool pair_direct(const TraceParams& p,
                                            const RayState& ray, const Row& G,
                                            float gvalid, float& t,
                                            float& alpha) {
  const float rx = ray.ox - G(ROW_MEAN);
  const float ry = ray.oy - G(ROW_MEAN + 1);
  const float rz = ray.oz - G(ROW_MEAN + 2);
  float lo[3], ld[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float r0 = G(ROW_ROT + i), r1 = G(ROW_ROT + 3 + i),
                r2 = G(ROW_ROT + 6 + i);
    const float inv = G(ROW_INV + i);
    lo[i] = inv * (r0 * rx + r1 * ry + r2 * rz);
    ld[i] = inv * (r0 * ray.dx + r1 * ray.dy + r2 * ray.dz);
  }
  const float dot_ol = lo[0] * ld[0] + lo[1] * ld[1] + lo[2] * ld[2];
  const float dot_ll = ld[0] * ld[0] + ld[1] * ld[1] + ld[2] * ld[2];
  const float dot_oo = lo[0] * lo[0] + lo[1] * lo[1] + lo[2] * lo[2];
  const float inv_ll = 1.0f / fmaxf(dot_ll, 1e-30f);
  t = -dot_ol * inv_ll;
  const float sq = dot_oo - dot_ol * dot_ol * inv_ll;
  const bool valid = pair_valid(p, ray, gvalid, dot_ol, sq, t, [&] {
    return G(ROW_NLEN) > p.bf_thr &&
           G(ROW_NRM) * ld[0] + G(ROW_NRM + 1) * ld[1] +
                   G(ROW_NRM + 2) * ld[2] >
               0.0f;
  });
  if (valid) alpha = pair_alpha<CUBE>(p, sq, G(ROW_SF2), G(ROW_OPACITY));
  return valid;
}

// The walk of this thread's ray (blockIdx.x = tile, threadIdx.x = ray in
// the tile) over the tile's candidates.  sg: dynamic shared memory of
// N_GEOM_ROWS * cluster floats.  Every thread of the block must call it.
template <int K, bool CUBE>
__device__ __forceinline__ void trace_tile(const TraceParams& p, float* sg,
                                           float (&st)[K], float (&sa)[K],
                                           int (&sid)[K], double& log_t,
                                           float& trav, float& chunks) {
  const int tile = blockDim.x;
  const int ti = blockIdx.x;
  const int r = ti * tile + threadIdx.x;
  const int C = p.cluster;

  const float ox = p.rays_o[3 * r], oy = p.rays_o[3 * r + 1],
              oz = p.rays_o[3 * r + 2];
  const float dx = p.rays_d[3 * r], dy = p.rays_d[3 * r + 1],
              dz = p.rays_d[3 * r + 2];
  const bool live = p.alive[r] > 0.0f;
  const float t_split = p.window_mode != 0 ? p.t_split[r] : 0.0f;
  const float k2 = 2.0f * p.exp_power;

#pragma unroll
  for (int s = 0; s < K; ++s) {
    st[s] = INF;
    sa[s] = 0.0f;
    sid[s] = 0;
  }
  float kth = INF;
  log_t = 0.0;  // log-transmittance over every processed hit
  trav = 0.0f;
  chunks = 0.0f;

  const int* cand = p.cand + (size_t)ti * p.mc;
  const float* cand_near = p.cand_near + (size_t)ti * p.mc;
  const bool dead_all = __syncthreads_and(!live);
  const int n_groups = (p.mc + p.check_every - 1) / p.check_every;

  for (int g = 0; g < n_groups && !dead_all; ++g) {
    const int base = g * p.check_every;
    const bool finished = (log_t <= (double)p.log_thr) ||
                          (kth < cand_near[base]) ||
                          (p.exit_mode == 1 && !live);
    if (__syncthreads_and(finished)) break;

    for (int j = 0; j < p.check_every; ++j) {
      const int ci = base + j;
      const int c = ci < p.mc ? cand[ci] : -1;
      if (c < 0) continue;  // the same for the whole block

      __syncthreads();  // the previous cluster's readers are done
      const float* src = p.gpack + (size_t)c * C;
      for (int i = threadIdx.x; i < N_GEOM_ROWS * C; i += tile) {
        const int row = i / C;
        sg[i] = src[(size_t)row * p.n_gauss + (i - row * C)];
      }
      __syncthreads();

      double chunk_log_t = 0.0;
      float chunk_trav = 0.0f, chunk_any = 0.0f;
      for (int k = 0; k < C; ++k) {
#define G(row) sg[(row) * C + k]
        const float gvalid = G(ROW_VALID);
        chunk_trav += gvalid;
        chunk_any = fmaxf(chunk_any, gvalid);

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
        const float t = -dot_ol * inv_ll;
        const float sq = dot_oo - dot_ol * dot_ol * inv_ll;

        bool valid = (gvalid > 0.0f) && (dot_ol <= 0.0f) && (sq <= 1.0f) &&
                     (t > p.near) && (t < p.far) && live;
        if (p.window_mode == 1) valid = valid && (t < t_split);
        if (p.window_mode == 2) valid = valid && (t > t_split);
        if (valid && p.secondary_static != 0) {
          const float ndotd = G(ROW_NRM) * ld[0] + G(ROW_NRM + 1) * ld[1] +
                              G(ROW_NRM + 2) * ld[2];
          const bool reject = (t < p.bf_max_dist) &&
                              (G(ROW_NLEN) > p.bf_thr) && (ndotd > 0.0f);
          valid = p.secondary_static == 1 ? !reject
                                          : (p.secondary <= 0.0f || !reject);
        }
        if (!valid) continue;

        const float sqs = fmaxf(sq * G(ROW_SF2), 0.0f);
        float powered;
        if (CUBE) {
          powered = sqs * sqs * sqs;
        } else if (p.int_power > 0) {
          powered = sqs;
          for (int e = 1; e < p.int_power; ++e) powered = powered * sqs;
        } else {
          powered = (float)pow((double)sqs, (double)p.exp_power);
        }
        const float gaussval = (float)exp((double)(-powered / k2));
        const float alpha = MAX_ALPHA * gaussval * G(ROW_OPACITY);
#undef G
        chunk_log_t += log1p((double)(-alpha));

        if (t < kth) {  // replace the first slot holding the K-th depth
          int win = -1;
#pragma unroll
          for (int s = 0; s < K; ++s)
            if (win < 0 && st[s] >= kth) win = s;
#pragma unroll
          for (int s = 0; s < K; ++s) {
            if (s == win) {
              st[s] = t;
              sa[s] = alpha;
              sid[s] = c * C + k;
            }
          }
          kth = st[0];
#pragma unroll
          for (int s = 1; s < K; ++s) kth = fmaxf(kth, st[s]);
        }
      }
      log_t += chunk_log_t;
      trav += chunk_trav;
      chunks += p.exit_mode == 1 ? 1.0f : chunk_any;
    }
  }
}

// Sort the kept hits by (t, id): odd-even transposition over registers.  The
// Pallas kernels order by (t, slot index); the two differ only on exact depth
// ties, and (t, id) makes the result independent of insertion order.
template <int K>
__device__ __forceinline__ void sort_slots(float (&st)[K], float (&sa)[K],
                                           int (&sid)[K]) {
#pragma unroll
  for (int pass = 0; pass < K; ++pass) {
#pragma unroll
    for (int i = pass & 1; i + 1 < K; i += 2) {
      if (st[i] > st[i + 1] || (st[i] == st[i + 1] && sid[i] > sid[i + 1])) {
        const float t = st[i], a = sa[i];
        const int id = sid[i];
        st[i] = st[i + 1];
        sa[i] = sa[i + 1];
        sid[i] = sid[i + 1];
        st[i + 1] = t;
        sa[i + 1] = a;
        sid[i + 1] = id;
      }
    }
  }
}

}  // namespace egr
