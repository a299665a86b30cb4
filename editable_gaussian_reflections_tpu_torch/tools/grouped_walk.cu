// grouped_walk.cu - a measurement kernel, not a path of the port: the
// k-buffer render of csrc/render_culled.cu, as it was on the walk of
// csrc/trace_tile.cuh, with that walk rewritten to stage a whole early-exit
// group of candidate clusters in shared memory at once.
// tools/refill_ladder.py builds and times it; nothing else loads it.
//
// The question it answered: what trace_tile.cuh's walk's per-cluster fixed
// cost - one shared-memory refill and its two barriers per cluster - costs
// on this card (render_culled now walks csrc/trace_hits_walk.cuh).  This walk pays them once per group
// instead: the group's `check_every` candidate clusters ([check_every, 22,
// cluster] f32, 45 KB at 8 x 64, 180 KB at 8 x 256) are staged in one
// refill between one pair of barriers (the group's exit vote and the end of
// the refill), then every thread tests its ray against them cluster by
// cluster.  Exits are decided per group only, so the result equals
// render_culled's (exit mode 0) at the same cluster, tile, check_every and
// near distances, bit for bit: the processed clusters, the kept hits (exact
// ties at the K-th depth decided in the drain's order, trace_tile.cuh's
// drain_walk) and every sum are the same.  So the two kernels' times on the same inputs
// differ by the refills and barriers (and by this walk's call of the pair
// math, below), not by the work.
//
// The exit: a ray is done when saturated or when its K-th hit lies before
// the group's first candidate (dead rays are not done); a tile whose rays
// are all dead stops at once; chunks counts processed clusters holding any
// valid Gaussian.  A -1 candidate is skipped.
//
// The pair math is trace_tile.cuh's pair_direct, called, not copied (the
// shared walk keeps an inline copy; calling the functions cost it ~9% on an
// H100, PERF.md).  The epilogue is kbuffer_composite.cuh.  Numerics are
// render_culled.cu's.  Built by ops/cuda/build.py with csrc/ on the include
// path.

#include <cuda_runtime.h>

#include "kbuffer_composite.cuh"
#include "trace_tile.cuh"

namespace {

using namespace egr;

constexpr int MAX_SMEM = 227 * 1024;  // dynamic shared memory per block, sm_90

template <int K, bool CUBE>
__global__ void grouped_walk_kernel(TraceParams p, float thr, float eps_norm,
                                    float* out) {
  extern __shared__ float sg[];  // [check_every, N_GEOM_ROWS, cluster]
  const int tile = blockDim.x;
  const int ti = blockIdx.x;
  const int r = ti * tile + threadIdx.x;
  const int C = p.cluster;
  const int CE = p.check_every;
  const int block_floats = N_GEOM_ROWS * C;
  const RayState ray = load_ray(p, r);

  float st[K], sa[K];
  int sid[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    st[s] = INF;
    sa[s] = 0.0f;
    sid[s] = 0;
  }
  float kth = INF;
  double log_t = 0.0;  // log-transmittance over every processed hit
  float trav = 0.0f, chunks = 0.0f;

  const int* cand = p.cand + (size_t)ti * p.mc;
  const float* cand_near = p.cand_near + (size_t)ti * p.mc;
  const bool dead_all = __syncthreads_and(!ray.live);
  const int n_groups = (p.mc + CE - 1) / CE;
  bool tie = false;   // an insertion met an exact tie at the K-th depth
  int n_done = p.mc;  // the clusters processed

  for (int g = 0; g < n_groups && !dead_all; ++g) {
    const int base = g * CE;
    const bool finished =
        (log_t <= (double)p.log_thr) || (kth < cand_near[base]);
    // the vote is also the barrier after the previous group's readers
    if (__syncthreads_and(finished)) {
      n_done = base;
      break;
    }

    for (int j = 0; j < CE; ++j) {  // one refill for the whole group
      const int ci = base + j;
      const int c = ci < p.mc ? cand[ci] : -1;
      if (c < 0) continue;  // the same for the whole block
      const float* src = p.gpack + (size_t)c * C;
      float* dst = sg + j * block_floats;
      for (int i = threadIdx.x; i < block_floats; i += tile) {
        const int row = i / C;
        dst[i] = src[(size_t)row * p.n_gauss + (i - row * C)];
      }
    }
    __syncthreads();

    for (int j = 0; j < CE; ++j) {
      const int ci = base + j;
      const int c = ci < p.mc ? cand[ci] : -1;
      if (c < 0) continue;
      const float* sj = sg + j * block_floats;
      double chunk_log_t = 0.0;
      float chunk_trav = 0.0f, chunk_any = 0.0f;
      for (int k = 0; k < C; ++k) {
        const auto G = [&](int row) { return sj[row * C + k]; };
        const float gvalid = G(ROW_VALID);
        chunk_trav += gvalid;
        chunk_any = fmaxf(chunk_any, gvalid);
        float t, alpha;
        if (!pair_direct<CUBE>(p, ray, G, gvalid, t, alpha)) continue;
        chunk_log_t += log1p((double)(-alpha));

        if (t < kth)
          tie |= insert_slot<K>(st, sa, sid, t, alpha, c * C + k, kth);
      }
      log_t += chunk_log_t;
      trav += chunk_trav;
      chunks += chunk_any;
    }
  }
  // an exact tie at the K-th depth: insert in the drain's order instead
  if (tie) drain_walk<K, CUBE>(p, ray, cand, n_done, st, sa, sid);

  sort_slots<K>(st, sa, sid);
  composite_slots<K>(
      [&](int i, float& t, int& id) {
        t = st[i];
        id = sid[i];
      },
      [&](int i, int) { return sa[i]; }, log_t, trav, chunks, thr, eps_norm,
      [&](int a, int id) {
        const int rows[NUM_ATTR] = {ROW_RGB,     ROW_RGB + 1, ROW_RGB + 2,
                                    ROW_NRM,     ROW_NRM + 1, ROW_NRM + 2,
                                    ROW_F0,      ROW_F0 + 1,  ROW_F0 + 2,
                                    ROW_ROUGH};
        return p.gpack[(size_t)rows[a] * p.n_gauss + id];
      },
      out + (size_t)r * OUT_LANES);
}

template <int K, bool CUBE>
cudaError_t launch_one(const TraceParams& p, float thr, float eps_norm,
                       float* out, int n_tiles, int tile, size_t smem,
                       cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        grouped_walk_kernel<K, CUBE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  grouped_walk_kernel<K, CUBE><<<n_tiles, tile, smem, s>>>(p, thr, eps_norm,
                                                           out);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch(const TraceParams& p, float thr, float eps_norm, float* out,
                   int n_tiles, int tile, size_t smem, cudaStream_t s) {
  if (p.int_power == 3)
    return launch_one<K, true>(p, thr, eps_norm, out, n_tiles, tile, smem, s);
  return launch_one<K, false>(p, thr, eps_norm, out, n_tiles, tile, smem, s);
}

}  // namespace

// Plain C entry point (bound with ctypes), with render_culled.cu's
// arguments.  Launches on `stream`, allocates nothing, and returns the
// launch's cudaError_t (0 = success).
extern "C" int egr_grouped_walk(
    const float* rays_o, const float* rays_d, const float* alive,
    const float* t_split, const float* gpack, const int* cand,
    const float* cand_near, float* out, int n_rays, int n_gauss, int mc,
    int tile, int cluster, int max_hits, int check_every, int window_mode,
    int secondary_static, float near, float far, float secondary,
    float bf_max_dist, float bf_thr, float thr, float eps_norm, float log_thr,
    float exp_power, void* stream) {
  TraceParams p;
  if (!init_trace_params(p, rays_o, rays_d, alive, t_split, gpack, cand,
                         cand_near, n_rays, n_gauss, mc, tile, cluster,
                         check_every, /*exit_mode=*/0, window_mode,
                         secondary_static, near, far, secondary, bf_max_dist,
                         bf_thr, log_thr, exp_power))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * N_GEOM_ROWS * cluster * check_every;
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = n_rays / tile;
  if (max_hits == 16)
    return (int)launch<16>(p, thr, eps_norm, out, n_tiles, tile, smem, s);
  if (max_hits == 32)
    return (int)launch<32>(p, thr, eps_norm, out, n_tiles, tile, smem, s);
  return (int)cudaErrorInvalidValue;
}
