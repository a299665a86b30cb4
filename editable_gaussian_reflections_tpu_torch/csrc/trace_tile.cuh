// trace_tile.cuh - what the kernels share beside the k-buffer walk: the
// gpack row constants and INF / MAX_ALPHA (every walk, trace_hits_walk.cuh
// included), and the first version's walk pieces that the measurement
// kernel tools/grouped_walk.cu runs: its params (TraceParams), its pair math
// as functions, its insertion into register slots, the drain-order walk
// that decides exact depth ties for it, and its slot sort.
//
// The walk they served (one block per ray tile, a cluster's 22 geometry
// rows staged in shared memory, the K nearest hits (t, alpha, id) per thread
// in registers with a replace-max insertion, a vote every `check_every`
// clusters, exit_mode 0 for pallas_render_culled_v4/_v3 and 1 for
// pallas_render_culled) is grouped_walk.cu's own copy now: the round-2
// render (render_table.cu) runs the k-buffer walk.
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

// The pair math as functions, for tools/grouped_walk.cu and its
// drain-order pass (drain_walk): the same float operations as
// trace_hits_walk.cuh's group_pairs.  The walks do not call them: routing a
// walk through these functions made nvcc schedule it ~9% slower on an H100
// (tools/walk_ab.py).  Keep the two in step.

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

// Insert a hit at depth t < kth into the register slots: it replaces the
// first slot holding the K-th depth, and kth becomes the new largest kept
// depth.  Returns whether another slot held the same finite K-th depth: an
// exact tie, which the insertion order decides.
template <int K>
__device__ __forceinline__ bool insert_slot(float (&st)[K], float (&sa)[K],
                                            int (&sid)[K], float t,
                                            float alpha, int id, float& kth) {
  int win = -1;
#pragma unroll
  for (int s = 0; s < K; ++s)
    if (win < 0 && st[s] >= kth) win = s;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (s == win) {
      st[s] = t;
      sa[s] = alpha;
      sid[s] = id;
    }
  }
  float m = st[0];
#pragma unroll
  for (int s = 1; s < K; ++s) m = fmaxf(m, st[s]);
  const bool tie = m == kth && kth < INF;
  kth = m;
  return tie;
}

// This thread's ray walks the first n_done clusters of its tile's list
// (`cand`) again, reading gpack itself, into emptied slots, inserting each
// cluster's hits as the plain version's drain (and the Pallas kernels') do:
// in ascending (t, lane) order, each replacing the first slot that holds the
// K-th depth.  A pass over the cluster finds each next hit, so it costs a
// pass per insertion; a walk takes it only for a ray whose Gaussian-order
// insertion met an exact tie (insert_slot).
template <int K, bool CUBE>
__device__ __forceinline__ void drain_walk(const TraceParams& p,
                                           const RayState& ray,
                                           const int* cand, int n_done,
                                           float (&st)[K], float (&sa)[K],
                                           int (&sid)[K]) {
  const int C = p.cluster;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    st[s] = INF;
    sa[s] = 0.0f;
    sid[s] = 0;
  }
  float kth = INF;
  for (int ci = 0; ci < n_done; ++ci) {
    const int c = cand[ci];
    if (c < 0) continue;
    float last_t = -INF;  // the last inserted hit, (t, lane)
    int last = -1;
    for (;;) {
      float next_t = kth, next_alpha = 0.0f;
      int next = -1;
      for (int k = 0; k < C; ++k) {
        const auto G = [&](int row) {
          return p.gpack[(size_t)row * p.n_gauss + (size_t)c * C + k];
        };
        float t, alpha;
        if (!pair_direct<CUBE>(p, ray, G, G(ROW_VALID), t, alpha)) continue;
        if (t < next_t && (t > last_t || (t == last_t && k > last))) {
          next_t = t;
          next_alpha = alpha;
          next = k;
        }
      }
      if (next < 0) break;
      insert_slot<K>(st, sa, sid, next_t, next_alpha, c * C + next, kth);
      last_t = next_t;
      last = next;
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
