// render_scan.cu - one bounce of the inference fast path: culled ray x
// Gaussian trace with a streaming front-to-back composite (no K cap) and the
// truncated-tail correction.
//
// Replaces the Pallas kernels pallas_render_culled_v6 (direct pair math,
// composite_mode "scan"; editable_gaussian_reflections_tpu/ops/pallas/
// render_kernel_v6.py) and pallas_render_culled_v7 (quadric-form pair math,
// optional bf16 attribute dot, composite_mode "scanq"; render_kernel_v7.py).
// The two share their composite; here one kernel serves both, templated on
// the pair math.  The plain PyTorch version of the same contract is
// render_scan_reference in ops/cuda/scan_kernel.py.
//
// What it computes, per ray (one thread), per candidate cluster in list
// order (the list re-sorted by cluster-centre depth), per Gaussian in table
// order (within-cluster depth sorted):
//   T_before = T_comp(chunk start) * ex, ex the exclusive in-chunk product of
//   (1 - alpha) over the chunk's hits; a hit composites while T_before >= thr
//   with weight w = T_before * alpha; T_comp becomes the least T_before *
//   (1 - alpha) over the chunk's composited hits; full_T takes the whole
//   chunk's product.  Every `check_every` candidates the block stops when
//   every ray of the tile is saturated (T_comp <= thr; a dead ray never is),
//   when every ray is dead, or when the group's first candidate is empty.
//   full_T counts only processed chunks, so the exit is part of the result.
//   The epilogue scales the 10 attributes and the depth by the tail factor
//   1 + (T_final - full_T) / max(1 - T_final, eps).
//
// Layout and walk.  One block per ray tile, one thread per ray.  The scan
// table is row-major, [N, SCAN_COLS] f32 (ops/cuda/layout.py): a candidate
// cluster's C rows are one contiguous block, staged into shared memory with
// 16-byte loads; every thread then walks them in table order (all threads
// read the same row: a broadcast).  The Pallas kernels' Hillis-Steele prefix
// product over sublanes and the MXU attribute dot were a TPU's way to keep
// the chunk in vector registers; a thread here runs the product and the sums
// sequentially.  The pair math is csrc/trace_tile.cuh's (direct), or the
// quadric form: per ray, the monomials of o' = o - centre and d once; per
// pair, dot_ll, dot_ol, dot_oo and ndotd as dots of the table's weights with
// them (the expanded form keeps its own rounding, as in JAX).
//
// Numerics (ops/precision.py): float32 pair math built without FMA
// contraction; exp and pow in float64, rounded once; the in-chunk product in
// float64, rounded once where it is used; the chunk's attribute and depth
// sums in float64 in table order, rounded once and added to float32
// accumulators, as JAX adds a chunk's dot.  attr_bf16 rounds w and the
// attribute to bf16 (nearest even) before the product, as a TPU's one-pass
// bf16 dot does.  The kernel and its plain version then agree bit for bit.
//
// What bounds it: the float32 pair math, 61 flops per ray x Gaussian pair
// (direct) or 59 (quadric), counted from the source, on the FP32 units, for
// every Gaussian of every processed chunk; the float64 work is per
// composited hit only.  What this
// first version does about it: nothing yet - it is written to be right and
// simple (no double-buffered staging, one shared-memory refill and two
// barriers per chunk).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "trace_tile.cuh"

namespace {

using namespace egr;

// scan table columns (ops/cuda/layout.py).  The direct table holds the
// gpack's 22 geometry rows as columns 0-21; the quadric table the columns
// below.  Both hold the 10 attributes, in output-lane order, at SCAN_ATTR.
constexpr int SCAN_COLS = 32;
constexpr int SCAN_ATTR = 22;
constexpr int Q_S = 0;        // 6: S00, S11, S22, S01, S02, S12 (S = M^T M)
constexpr int Q_NQ = 6;       // 3: -S mu'
constexpr int Q_C = 9;        // mu'^T S mu'
constexpr int Q_ND = 10;      // 3: M^T nrm
constexpr int Q_OPACITY = 13;
constexpr int Q_SF2 = 14;
constexpr int Q_NLEN = 15;
constexpr int Q_VALID = 16;

// output lanes (ops/cuda/layout.py)
constexpr int OUT_DEPTH = 10;
constexpr int OUT_TFINAL = 11;
constexpr int OUT_FULLT = 12;
constexpr int OUT_NUMACC = 13;
constexpr int OUT_TRAV = 14;
constexpr int OUT_CHUNKS = 15;
constexpr int OUT_LANES = 16;

constexpr int DIRECT = 0;
constexpr int QUADRIC = 1;

// the ray's quadric features (the JAX _ray_features), o' = o - centre
struct RayFeatures {
  float dd[6], od[6], oo[6], o[3];
};

__device__ __forceinline__ RayFeatures ray_features(const RayState& ray,
                                                    const float* center) {
  const float ox = ray.ox - center[0], oy = ray.oy - center[1],
              oz = ray.oz - center[2];
  const float dx = ray.dx, dy = ray.dy, dz = ray.dz;
  RayFeatures f;
  f.dd[0] = dx * dx;
  f.dd[1] = dy * dy;
  f.dd[2] = dz * dz;
  f.dd[3] = dx * dy;
  f.dd[4] = dx * dz;
  f.dd[5] = dy * dz;
  f.od[0] = ox * dx;
  f.od[1] = oy * dy;
  f.od[2] = oz * dz;
  f.od[3] = ox * dy + oy * dx;
  f.od[4] = ox * dz + oz * dx;
  f.od[5] = oy * dz + oz * dy;
  f.oo[0] = ox * ox;
  f.oo[1] = oy * oy;
  f.oo[2] = oz * oz;
  f.oo[3] = ox * oy;
  f.oo[4] = ox * oz;
  f.oo[5] = oy * oz;
  f.o[0] = ox;
  f.o[1] = oy;
  f.o[2] = oz;
  return f;
}

// The quadric pair math (the JAX render_kernel_v7.py:_pair_math_q), the
// weights' dots summed left to right.  w_dd carries 2 S_ij off the diagonal
// and the o' weights are -2 S mu': doubling is exact, so these equal the
// JAX table's weights.
template <bool CUBE>
__device__ __forceinline__ bool pair_quadric(const TraceParams& p,
                                             const RayState& ray,
                                             const RayFeatures& f,
                                             const float* g, float& t,
                                             float& alpha) {
  const float s00 = g[Q_S], s11 = g[Q_S + 1], s22 = g[Q_S + 2];
  const float s01 = g[Q_S + 3], s02 = g[Q_S + 4], s12 = g[Q_S + 5];
  const float t01 = 2.0f * s01, t02 = 2.0f * s02, t12 = 2.0f * s12;
  const float q0 = g[Q_NQ], q1 = g[Q_NQ + 1], q2 = g[Q_NQ + 2];
  const float dot_ll = s00 * f.dd[0] + s11 * f.dd[1] + s22 * f.dd[2] +
                       t01 * f.dd[3] + t02 * f.dd[4] + t12 * f.dd[5];
  const float dot_ol = s00 * f.od[0] + s11 * f.od[1] + s22 * f.od[2] +
                       s01 * f.od[3] + s02 * f.od[4] + s12 * f.od[5] +
                       q0 * ray.dx + q1 * ray.dy + q2 * ray.dz;
  const float dot_oo = s00 * f.oo[0] + s11 * f.oo[1] + s22 * f.oo[2] +
                       t01 * f.oo[3] + t02 * f.oo[4] + t12 * f.oo[5] +
                       (2.0f * q0) * f.o[0] + (2.0f * q1) * f.o[1] +
                       (2.0f * q2) * f.o[2] + g[Q_C];
  const float inv_ll = 1.0f / fmaxf(dot_ll, 1e-30f);
  t = -dot_ol * inv_ll;
  const float sq = dot_oo - dot_ol * dot_ol * inv_ll;
  const bool valid = pair_valid(p, ray, g[Q_VALID], dot_ol, sq, t, [&] {
    return g[Q_NLEN] > p.bf_thr &&
           g[Q_ND] * ray.dx + g[Q_ND + 1] * ray.dy + g[Q_ND + 2] * ray.dz >
               0.0f;
  });
  if (valid) alpha = pair_alpha<CUBE>(p, sq, g[Q_SF2], g[Q_OPACITY]);
  return valid;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int PM, bool STATS, bool BF16, bool CUBE>
__global__ void render_scan_kernel(TraceParams p, float thr, float eps_norm,
                                   const float* center, float* out) {
  extern __shared__ float4 sg4[];  // [cluster, SCAN_COLS] f32
  const float* sg = reinterpret_cast<const float*>(sg4);
  const int tile = blockDim.x;
  const int ti = blockIdx.x;
  const int r = ti * tile + threadIdx.x;
  const int C = p.cluster;
  const RayState ray = load_ray(p, r);
  RayFeatures f;
  if (PM == QUADRIC) f = ray_features(ray, center);

  float t_comp = 1.0f, full_t = 1.0f, depth = 0.0f;
  float attr[NUM_ATTR];
#pragma unroll
  for (int a = 0; a < NUM_ATTR; ++a) attr[a] = 0.0f;
  float num_acc = 0.0f, trav = 0.0f, chunks = 0.0f;

  const int* cand = p.cand + (size_t)ti * p.mc;
  const bool dead_all = __syncthreads_and(!ray.live);
  const int n_groups = (p.mc + p.check_every - 1) / p.check_every;
  const int n_vec = C * SCAN_COLS / 4;

  for (int g = 0; g < n_groups && !dead_all; ++g) {
    const int base = g * p.check_every;
    const bool saturated = __syncthreads_and(t_comp <= thr);
    if (saturated || cand[base] < 0) break;  // the same for the whole block

    for (int j = 0; j < p.check_every; ++j) {
      const int ci = base + j;
      const int c = ci < p.mc ? cand[ci] : -1;
      if (c < 0) continue;  // an empty candidate composites nothing

      __syncthreads();  // the previous cluster's readers are done
      const float4* src =
          reinterpret_cast<const float4*>(p.gpack) + (size_t)c * n_vec;
      for (int i = threadIdx.x; i < n_vec; i += tile) sg4[i] = src[i];
      __syncthreads();

      double ex = 1.0;  // exclusive product of (1 - alpha) over the chunk
      double wsum[NUM_ATTR];
#pragma unroll
      for (int a = 0; a < NUM_ATTR; ++a) wsum[a] = 0.0;
      double dsum = 0.0;
      float t_next = t_comp;
      float c_num = 0.0f, c_trav = 0.0f, c_any = 0.0f;
      for (int k = 0; k < C; ++k) {
        const float* gk = sg + k * SCAN_COLS;
        float t, alpha;
        bool valid;
        if (PM == DIRECT) {
          valid = pair_direct<CUBE>(
              p, ray, [&](int col) { return gk[col]; }, gk[ROW_VALID], t,
              alpha);
        } else {
          valid = pair_quadric<CUBE>(p, ray, f, gk, t, alpha);
        }
        if (STATS) {
          const float gvalid = gk[PM == DIRECT ? ROW_VALID : Q_VALID];
          c_trav += gvalid;
          c_any = fmaxf(c_any, gvalid);
        }
        if (!valid) continue;
        const float oma = 1.0f - alpha;
        const float t_before = t_comp * (float)ex;
        if (t_before >= thr) {
          const float w = t_before * alpha;
          t_next = fminf(t_next, t_before * oma);
          dsum += (double)w * (double)t;
          const float wa = BF16 ? bf16_round(w) : w;
#pragma unroll
          for (int a = 0; a < NUM_ATTR; ++a) {
            const float v = gk[SCAN_ATTR + a];
            wsum[a] += (double)wa * (double)(BF16 ? bf16_round(v) : v);
          }
          if (STATS) c_num += 1.0f;
        }
        ex *= (double)oma;
      }
      t_comp = t_next;
      full_t = full_t * (float)ex;
      depth += (float)dsum;
#pragma unroll
      for (int a = 0; a < NUM_ATTR; ++a) attr[a] += (float)wsum[a];
      if (STATS) {
        num_acc += c_num;
        trav += c_trav;
        chunks += c_any;
      }
    }
  }

  // truncated-tail correction: spread the transmittance the processed
  // chunks left over the composited hits
  const float factor =
      1.0f + (t_comp - full_t) / fmaxf(1.0f - t_comp, eps_norm);
  float o[OUT_LANES];
#pragma unroll
  for (int a = 0; a < NUM_ATTR; ++a) o[a] = attr[a] * factor;
  o[OUT_DEPTH] = depth * factor;
  o[OUT_TFINAL] = t_comp;
  o[OUT_FULLT] = full_t;
  o[OUT_NUMACC] = num_acc;
  o[OUT_TRAV] = trav;
  o[OUT_CHUNKS] = chunks;
  float4* dst = reinterpret_cast<float4*>(out + (size_t)r * OUT_LANES);
#pragma unroll
  for (int i = 0; i < OUT_LANES / 4; ++i)
    dst[i] = make_float4(o[4 * i], o[4 * i + 1], o[4 * i + 2], o[4 * i + 3]);
}

template <int PM, bool STATS, bool BF16, bool CUBE>
cudaError_t launch_one(const TraceParams& p, float thr, float eps_norm,
                       const float* center, float* out, int n_tiles,
                       int tile, cudaStream_t s) {
  const auto kernel = render_scan_kernel<PM, STATS, BF16, CUBE>;
  const size_t smem = sizeof(float) * SCAN_COLS * p.cluster;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<n_tiles, tile, smem, s>>>(p, thr, eps_norm, center, out);
  return cudaGetLastError();
}

template <int PM, bool STATS, bool BF16>
cudaError_t launch_cube(const TraceParams& p, float thr, float eps_norm,
                        const float* center, float* out, int n_tiles,
                        int tile, cudaStream_t s) {
  if (p.int_power == 3)
    return launch_one<PM, STATS, BF16, true>(p, thr, eps_norm, center,
                                             out, n_tiles, tile, s);
  return launch_one<PM, STATS, BF16, false>(p, thr, eps_norm, center, out,
                                            n_tiles, tile, s);
}

template <bool STATS>
cudaError_t launch_math(int pair_math, int attr_bf16, const TraceParams& p,
                        float thr, float eps_norm, const float* center,
                        float* out, int n_tiles, int tile, cudaStream_t s) {
  if (pair_math == DIRECT && !attr_bf16)
    return launch_cube<DIRECT, STATS, false>(p, thr, eps_norm, center, out,
                                             n_tiles, tile, s);
  if (pair_math == QUADRIC && !attr_bf16)
    return launch_cube<QUADRIC, STATS, false>(p, thr, eps_norm, center, out,
                                              n_tiles, tile, s);
  if (pair_math == QUADRIC)
    return launch_cube<QUADRIC, STATS, true>(p, thr, eps_norm, center, out,
                                             n_tiles, tile, s);
  return cudaErrorInvalidValue;  // bf16 attributes come with scanq only
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream`, allocates
// nothing, and returns the launch's cudaError_t (0 = success).  table:
// [n_gauss, SCAN_COLS] f32, row-major; cand: [n_rays / tile, mc] i32;
// center: [3] f32 on the device, the quadric form's origin.
extern "C" int egr_render_scan(
    const float* rays_o, const float* rays_d, const float* alive,
    const float* t_split, const float* table, const float* center,
    const int* cand, float* out, int n_rays, int n_gauss, int mc, int tile,
    int cluster, int check_every, int window_mode, int secondary_static,
    int pair_math, int stats, int attr_bf16, float near, float far,
    float secondary, float bf_max_dist, float bf_thr, float thr,
    float eps_norm, float exp_power, void* stream) {
  TraceParams p;
  if (cluster > 512 ||
      !init_trace_params(p, rays_o, rays_d, alive, t_split, table, cand,
                         /*cand_near=*/nullptr, n_rays, n_gauss, mc, tile,
                         cluster, check_every, /*exit_mode=*/0, window_mode,
                         secondary_static, near, far, secondary, bf_max_dist,
                         bf_thr, /*log_thr=*/0.0f, exp_power))
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = n_rays / tile;
  if (stats)
    return (int)launch_math<true>(pair_math, attr_bf16, p, thr, eps_norm,
                                  center, out, n_tiles, tile, s);
  return (int)launch_math<false>(pair_math, attr_bf16, p, thr, eps_norm,
                                 center, out, n_tiles, tile, s);
}
