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
// Layout and walk: the k-buffer walks' design (trace_hits_walk.cuh), whose
// helpers this kernel calls.  One block per ray tile (at most MAX_TILE
// rays), one thread per ray.  The scan table is row-major, [N, SCAN_COLS]
// f32 (ops/cuda/layout.py); a cluster is staged in groups of 4 Gaussians
// ([cpad / 4][NR] float4: the table's 32 columns of Gaussians 4g..4g+3 and
// a row of the stage's own, cpad the cluster rounded up to 4 with invalid
// zero columns), so that one float4 shared load gives a column for four
// Gaussians at an immediate offset.  The stages form a ring of two, filled
// with 4-byte cp.async copies (a table row is one Gaussian's columns, so
// 16 contiguous bytes never make one stage float4): cluster c + 1 is copied
// while cluster c is composited, one wait and one barrier a cluster.  Each
// step computes the pair math of four Gaussians (independent of each other;
// the direct form is the walks' group_pairs, the quadric form
// quadric_group), then composites the four in table order.  1 / dot_ll is
// rcp_normal, the division only for a group that needs it (same bits).  A
// block whose rays share one origin bit for bit (every primary pass) has
// the ray-independent terms of each staged Gaussian computed once, into the
// stage (prepare_cluster): direct, lo and |lo|^2 (origin_terms); quadric,
// dot_oo.  With bf16 attributes each staged attribute is rounded once there
// too, not per ray and hit.  The Pallas kernels' Hillis-Steele prefix
// product over sublanes and the MXU attribute dot were a TPU's way to keep
// the chunk in vector registers; a thread here runs the product and the
// sums sequentially.
//
// Numerics (ops/precision.py): float32 pair math built without FMA
// contraction (the expanded quadric form keeps its own rounding, as in
// JAX); exp and pow in float64, rounded once; the in-chunk product in
// float64, rounded once where it is used; the chunk's attribute and depth
// sums in float64 in table order, rounded once and added to float32
// accumulators, as JAX adds a chunk's dot.  attr_bf16 rounds w and the
// attribute to bf16 (nearest even) before the product, as a TPU's one-pass
// bf16 dot does.  The kernel and its plain version then agree bit for bit.
//
// What bounds it: the float32 pair math on the FP32 units for every
// Gaussian of every processed chunk - counted from this source in
// chip_smoke.py (scan_flops): per pair, and on a shared origin per pair
// less the origin terms plus those once per staged Gaussian - and the
// float64 exp, product and sums per composited hit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "trace_hits_walk.cuh"

namespace {

using namespace egr_hits;
using egr::NUM_ATTR;

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

// A stage's rows per Gaussian: the table's columns, then its own row, dot_oo
// of a shared origin (origin_terms' |lo|^2, or the quadric form's dot_oo).
constexpr int NR = SCAN_COLS + 1;
constexpr int ROW_OO = SCAN_COLS;

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

// Dynamic shared memory of one block: the stage ring.
inline size_t scan_smem_bytes(int cluster) {
  return sizeof(float) * NSTAGE * NR * padded_cluster(cluster);
}

inline bool scan_shape_ok(int tile, int cluster) {
  return tile > 0 && tile <= MAX_TILE && cluster > 0 &&
         cluster <= MAX_CLUSTER && scan_smem_bytes(cluster) <= MAX_SMEM;
}

// The quadric form's per-ray terms (the JAX _ray_features of o' = o -
// centre and d): the direction's monomials dd and the mixed ones od, and o'.
// oo, the origin's monomials, is formed where it is needed (oo_terms).
struct QuadRay {
  float dd[6], od[6], o[3];
};

__device__ __forceinline__ QuadRay quad_ray(const Ray& ray,
                                            const float* center) {
  QuadRay f;
  const float ox = ray.ox - center[0], oy = ray.oy - center[1],
              oz = ray.oz - center[2];
  const float dx = ray.dx, dy = ray.dy, dz = ray.dz;
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
  f.o[0] = ox;
  f.o[1] = oy;
  f.o[2] = oz;
  return f;
}

// The origin's monomials of o'.
__device__ __forceinline__ void oo_terms(const float (&o)[3], float (&oo)[6]) {
  oo[0] = o[0] * o[0];
  oo[1] = o[1] * o[1];
  oo[2] = o[2] * o[2];
  oo[3] = o[0] * o[1];
  oo[4] = o[0] * o[2];
  oo[5] = o[1] * o[2];
}

// The quadric form's dot_oo of one Gaussian (columns g(col)), summed left to
// right: w_oo carries 2 S_ij off the diagonal and the o' weights are 2 q, as
// in the JAX table's weights (doubling is exact).
template <class Col>
__device__ __forceinline__ float quad_dot_oo(const Col& g,
                                             const float (&oo)[6],
                                             const float (&o)[3]) {
  return g(Q_S) * oo[0] + g(Q_S + 1) * oo[1] + g(Q_S + 2) * oo[2] +
         (2.0f * g(Q_S + 3)) * oo[3] + (2.0f * g(Q_S + 4)) * oo[4] +
         (2.0f * g(Q_S + 5)) * oo[5] + (2.0f * g(Q_NQ)) * o[0] +
         (2.0f * g(Q_NQ + 1)) * o[1] + (2.0f * g(Q_NQ + 2)) * o[2] + g(Q_C);
}

// The quadric pair math (the JAX render_kernel_v7.py:_pair_math_q) of this
// thread's ray against the staged group of 4 at `grp`, as group_pairs does
// the direct form: t, sq and validity of each, the group's Q_VALID
// returned.  SHARED: row ROW_OO holds each Gaussian's dot_oo
// (prepare_cluster); else oo holds the ray's origin monomials.
template <bool BACKFACING, bool SHARED>
__device__ __forceinline__ float4 quadric_group(
    const HitsParams& p, const Ray& ray, const QuadRay& f,
    const float (&oo)[6], const float* grp, float (&t)[4], float (&sq)[4],
    bool (&valid)[4]) {
#define G4(col) (*reinterpret_cast<const float4*>(grp + (col) * 4))
#define LANE(v, j) \
  ((j) == 0 ? (v).x : (j) == 1 ? (v).y : (j) == 2 ? (v).z : (v).w)
  float dot_ol[4], ll[4], inv_ll[4], dot_oo[4];
  bool huge = false;
  {
    const float4 s00 = G4(Q_S), s11 = G4(Q_S + 1), s22 = G4(Q_S + 2),
                 s01 = G4(Q_S + 3), s02 = G4(Q_S + 4), s12 = G4(Q_S + 5);
    const float4 q0 = G4(Q_NQ), q1 = G4(Q_NQ + 1), q2 = G4(Q_NQ + 2);
    // the shared origin's dot_oo, or the constant term of the ray's
    const float4 c4 = G4(SHARED ? ROW_OO : Q_C);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float t01 = 2.0f * LANE(s01, j), t02 = 2.0f * LANE(s02, j),
                  t12 = 2.0f * LANE(s12, j);
      const float dot_ll = LANE(s00, j) * f.dd[0] + LANE(s11, j) * f.dd[1] +
                           LANE(s22, j) * f.dd[2] + t01 * f.dd[3] +
                           t02 * f.dd[4] + t12 * f.dd[5];
      dot_ol[j] = LANE(s00, j) * f.od[0] + LANE(s11, j) * f.od[1] +
                  LANE(s22, j) * f.od[2] + LANE(s01, j) * f.od[3] +
                  LANE(s02, j) * f.od[4] + LANE(s12, j) * f.od[5] +
                  LANE(q0, j) * ray.dx + LANE(q1, j) * ray.dy +
                  LANE(q2, j) * ray.dz;
      if (SHARED) {
        dot_oo[j] = LANE(c4, j);
      } else {
        dot_oo[j] = LANE(s00, j) * oo[0] + LANE(s11, j) * oo[1] +
                    LANE(s22, j) * oo[2] + t01 * oo[3] + t02 * oo[4] +
                    t12 * oo[5] + (2.0f * LANE(q0, j)) * f.o[0] +
                    (2.0f * LANE(q1, j)) * f.o[1] +
                    (2.0f * LANE(q2, j)) * f.o[2] + LANE(c4, j);
      }
      ll[j] = fmaxf(dot_ll, 1e-30f);
      inv_ll[j] = rcp_normal(ll[j]);
      huge = huge || !(ll[j] < 8.507059173023462e37f);  // 2^126
    }
  }
  if (huge) {  // out of rcp_normal's range (rare): divide
#pragma unroll
    for (int j = 0; j < 4; ++j) inv_ll[j] = 1.0f / ll[j];
  }
  const float4 gv4 = G4(Q_VALID);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    t[j] = -dot_ol[j] * inv_ll[j];
    sq[j] = dot_oo[j] - dot_ol[j] * dot_ol[j] * inv_ll[j];
    valid[j] = (LANE(gv4, j) > 0.0f) && (dot_ol[j] <= 0.0f) &&
               (sq[j] <= 1.0f) && (t[j] > ray.near) && (t[j] < ray.far);
    // the backfacing test of reflected passes, on the world direction
    if (BACKFACING && valid[j] && t[j] < p.bf_max_dist) {
      const float* col = grp + j;
      const float ndotd = col[Q_ND * 4] * ray.dx +
                          col[(Q_ND + 1) * 4] * ray.dy +
                          col[(Q_ND + 2) * 4] * ray.dz;
      if (col[Q_NLEN * 4] > p.bf_thr && ndotd > 0.0f) valid[j] = false;
    }
  }
#undef G4
#undef LANE
  return gv4;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Start copying cluster c's table rows into stage `dst`, one 4-byte copy a
// column of a Gaussian, in the stage's order (a warp writes 32 consecutive
// words and reads 8 columns of 4 rows).  The pad columns of the last group
// are not written: they hold the zeros set once.
__device__ __forceinline__ void stage_table(const HitsParams& p, float* dst,
                                            int c) {
  const int C = p.cluster;
  const float* src = p.gpack + (size_t)c * C * SCAN_COLS;
  for (int i = threadIdx.x; i < p.cpad * SCAN_COLS; i += blockDim.x) {
    const int g = i >> 7, col = (i >> 2) & (SCAN_COLS - 1), j = i & 3;
    const int k = 4 * g + j;
    if (k < C) cp_async4(dst + g * (4 * NR) + col * 4 + j,
                         src + (size_t)k * SCAN_COLS + col);
  }
}

// The ray-independent work on the staged cluster `sg`, once per Gaussian:
// on a block whose rays share one origin, the origin terms into the stage
// (direct: origin_terms; quadric: dot_oo into row ROW_OO, with
// quadric_group's operations); with bf16 attributes, each attribute rounded
// to bf16.  The caller publishes it with a barrier.
template <int PM, bool BF16>
__device__ __forceinline__ void prepare_cluster(const HitsParams& p,
                                                const Ray& ray,
                                                const QuadRay& f, float* sg,
                                                bool shared) {
  if (PM == DIRECT && shared) origin_terms<NR, ROW_OO>(ray, sg, p.cluster);
  if (PM == DIRECT) return;
  float oo[6];
  oo_terms(f.o, oo);
  for (int k = threadIdx.x; k < p.cluster; k += blockDim.x) {
    float* g = sg + stage_index<NR>(0, k);  // column col at g[4 * col]
    if (shared)
      g[4 * ROW_OO] = quad_dot_oo([&](int col) { return g[4 * col]; }, oo,
                                  f.o);
    if (BF16) {
#pragma unroll
      for (int a = 0; a < NUM_ATTR; ++a)
        g[4 * (SCAN_ATTR + a)] = bf16_round(g[4 * (SCAN_ATTR + a)]);
    }
  }
}

// The type of a chunk's product and sums (ops/precision.py: float64).
using Sum = double;

// The composite state of one ray.
struct ScanState {
  float t_comp, full_t, depth, attr[NUM_ATTR];
  float num_acc, trav, chunks;
};

// Composite one staged cluster `sg` (a chunk) into this thread's ray, four
// Gaussians a step, each step's pair math first and its hits in table
// order.  SHARED: the stage holds the origin terms (prepare_cluster).
template <int PM, bool STATS, bool BF16, bool CUBE, bool BACKFACING,
          bool SHARED>
__device__ __forceinline__ void composite_cluster(const HitsParams& p,
                                                  const Ray& ray,
                                                  const QuadRay& f,
                                                  const float* sg, float thr,
                                                  ScanState& s) {
  constexpr int SF2 = PM == DIRECT ? ROW_SF2 : Q_SF2;
  constexpr int OPACITY = PM == DIRECT ? ROW_OPACITY : Q_OPACITY;
  float oo[6];  // the origin's monomials, for the quadric form's dot_oo
  if (PM == QUADRIC && !SHARED) oo_terms(f.o, oo);
  Sum ex = 1.0;  // exclusive product of (1 - alpha) over the chunk
  Sum wsum[NUM_ATTR];
#pragma unroll
  for (int a = 0; a < NUM_ATTR; ++a) wsum[a] = 0.0;
  Sum dsum = 0.0;
  float t_next = s.t_comp;
  float c_num = 0.0f, c_trav = 0.0f, c_any = 0.0f;
  for (int k = 0; k < p.cpad; k += 4) {
    const float* grp = sg + k * NR;  // this group of 4
    float t[4], sq[4];
    bool valid[4];
    float4 gv4;
    if (PM == DIRECT)
      gv4 = group_pairs<BACKFACING, SHARED, ROW_OO>(p, ray, grp, t, sq,
                                                    valid);
    else
      gv4 = quadric_group<BACKFACING, SHARED>(p, ray, f, oo, grp, t, sq,
                                              valid);
    if (STATS) {
      const float gv[4] = {gv4.x, gv4.y, gv4.z, gv4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c_trav += gv[j];
        c_any = fmaxf(c_any, gv[j]);
      }
    }
    // the four hits in table order
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!valid[j]) continue;
      const float* col = grp + j;
      const float alpha = MAX_ALPHA *
                          hit_gaussval<CUBE>(p, sq[j], col[SF2 * 4]) *
                          col[OPACITY * 4];
      const float oma = 1.0f - alpha;
      const float t_before = s.t_comp * (float)ex;
      if (t_before >= thr) {
        const float w = t_before * alpha;
        t_next = fminf(t_next, t_before * oma);
        dsum += (Sum)w * (Sum)t[j];
        const float wa = BF16 ? bf16_round(w) : w;
#pragma unroll
        for (int a = 0; a < NUM_ATTR; ++a)
          wsum[a] += (Sum)wa * (Sum)col[(SCAN_ATTR + a) * 4];
        if (STATS) c_num += 1.0f;
      }
      ex *= (Sum)oma;
    }
  }
  s.t_comp = t_next;
  s.full_t = s.full_t * (float)ex;
  s.depth += (float)dsum;
#pragma unroll
  for (int a = 0; a < NUM_ATTR; ++a) s.attr[a] += (float)wsum[a];
  if (STATS) {
    s.num_acc += c_num;
    s.trav += c_trav;
    s.chunks += c_any;
  }
}

template <int PM, bool STATS, bool BF16, bool CUBE, bool BACKFACING>
__global__ void __launch_bounds__(MAX_TILE)
    render_scan_kernel(HitsParams p, float thr, float eps_norm,
                       const float* center, float* out) {
  extern __shared__ __align__(16) float smem[];
  const int tile = blockDim.x;
  const int ti = blockIdx.x;
  const int r = ti * tile + threadIdx.x;
  const int C = p.cluster, CP = p.cpad;
  const int stage_size = NR * CP;
  float* const stages = smem;
  const Ray ray = load_ray<true>(p, r);
  QuadRay f;
  if (PM == QUADRIC) f = quad_ray(ray, center);

  ScanState s;
  s.t_comp = 1.0f;
  s.full_t = 1.0f;
  s.depth = 0.0f;
#pragma unroll
  for (int a = 0; a < NUM_ATTR; ++a) s.attr[a] = 0.0f;
  s.num_acc = s.trav = s.chunks = 0.0f;

  // the pad columns of every stage: invalid Gaussians, written once
  if (CP != C) {
    const int w = CP - C;
    for (int i = threadIdx.x; i < NSTAGE * NR * w; i += tile) {
      const int row = i / w, stage = row / NR;
      stages[stage * stage_size +
             stage_index<NR>(row - stage * NR, C + i - row * w)] = 0.0f;
    }
  }
  const int* cand = p.cand + (size_t)ti * p.mc;
  // also publishes the zeroed pad columns
  if (!__syncthreads_and(!ray.live)) {
    const bool shared = block_shares_origin(p.rays_o, ray, ti);
    int c_next = cand[0];
    if (c_next >= 0) stage_table(p, stages, c_next);
    cp_async_commit();
    for (int ci = 0, vote = 0; ci < p.mc; ++ci) {
      const int c = c_next;
      if (vote == 0) {
        // the exit group's vote; also the barrier after the last readers
        // of the stage refilled below
        if (__syncthreads_and(s.t_comp <= thr) || c < 0) break;
      } else {
        __syncthreads();  // every reader of the stage refilled below is done
      }
      vote = vote + 1 == p.check_every ? 0 : vote + 1;
      // prefetch the next candidate into the other stage
      if (ci + 1 < p.mc) {
        c_next = cand[ci + 1];
        if (c_next >= 0)
          stage_table(p, stages + ((ci + 1) % NSTAGE) * stage_size, c_next);
      }
      cp_async_commit();
      cp_async_wait<1>();  // this thread's part of cluster ci has landed
      __syncthreads();     // and everyone else's
      if (c < 0) continue;  // an empty candidate composites nothing
      float* sg = stages + (ci % NSTAGE) * stage_size;
      if (shared || BF16) {
        prepare_cluster<PM, BF16>(p, ray, f, sg, shared);
        __syncthreads();
      }
      if (shared)
        composite_cluster<PM, STATS, BF16, CUBE, BACKFACING, true>(
            p, ray, f, sg, thr, s);
      else
        composite_cluster<PM, STATS, BF16, CUBE, BACKFACING, false>(
            p, ray, f, sg, thr, s);
    }
    cp_async_wait<0>();
  }

  // truncated-tail correction: spread the transmittance the processed
  // chunks left over the composited hits
  const float factor =
      1.0f + (s.t_comp - s.full_t) / fmaxf(1.0f - s.t_comp, eps_norm);
  float o[OUT_LANES];
#pragma unroll
  for (int a = 0; a < NUM_ATTR; ++a) o[a] = s.attr[a] * factor;
  o[OUT_DEPTH] = s.depth * factor;
  o[OUT_TFINAL] = s.t_comp;
  o[OUT_FULLT] = s.full_t;
  o[OUT_NUMACC] = s.num_acc;
  o[OUT_TRAV] = s.trav;
  o[OUT_CHUNKS] = s.chunks;
  float4* dst = reinterpret_cast<float4*>(out + (size_t)r * OUT_LANES);
#pragma unroll
  for (int i = 0; i < OUT_LANES / 4; ++i)
    dst[i] = make_float4(o[4 * i], o[4 * i + 1], o[4 * i + 2], o[4 * i + 3]);
}

// One launch's arguments, and what visit() calls for the instantiation of
// its options: launch it, or report what the runtime says of it.
struct Launch {
  HitsParams p;
  float thr, eps_norm;
  const float* center;
  float* out;
  int n_tiles, tile;
  cudaStream_t stream;

  template <int PM, bool STATS, bool BF16, bool CUBE, bool BACKFACING>
  cudaError_t run() const {
    const auto kernel = render_scan_kernel<PM, STATS, BF16, CUBE, BACKFACING>;
    const int smem = (int)scan_smem_bytes(p.cluster);
    const cudaError_t err = set_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<n_tiles, tile, smem, stream>>>(p, thr, eps_norm, center, out);
    return cudaGetLastError();
  }
};

struct Info {
  int tile, cluster;
  int* out;

  template <int PM, bool STATS, bool BF16, bool CUBE, bool BACKFACING>
  cudaError_t run() const {
    return kernel_info(render_scan_kernel<PM, STATS, BF16, CUBE, BACKFACING>,
                       tile, (int)scan_smem_bytes(cluster), out);
  }
};

// f.run<PM, STATS, BF16, CUBE, BACKFACING>() for the options; bf16
// attributes come with the quadric math only.
template <int PM, bool STATS, bool BF16, bool CUBE, class F>
cudaError_t visit_backfacing(bool backfacing, const F& f) {
  return backfacing ? f.template run<PM, STATS, BF16, CUBE, true>()
                    : f.template run<PM, STATS, BF16, CUBE, false>();
}

template <int PM, bool STATS, bool BF16, class F>
cudaError_t visit_cube(bool cube, bool backfacing, const F& f) {
  return cube ? visit_backfacing<PM, STATS, BF16, true>(backfacing, f)
              : visit_backfacing<PM, STATS, BF16, false>(backfacing, f);
}

template <bool STATS, class F>
cudaError_t visit_math(int pair_math, bool bf16, bool cube, bool backfacing,
                       const F& f) {
  if (pair_math == DIRECT && !bf16)
    return visit_cube<DIRECT, STATS, false>(cube, backfacing, f);
  if (pair_math == QUADRIC && !bf16)
    return visit_cube<QUADRIC, STATS, false>(cube, backfacing, f);
  if (pair_math == QUADRIC)
    return visit_cube<QUADRIC, STATS, true>(cube, backfacing, f);
  return cudaErrorInvalidValue;  // bf16 attributes come with scanq only
}

template <class F>
cudaError_t visit(int pair_math, bool stats, bool bf16, bool cube,
                  bool backfacing, const F& f) {
  return stats ? visit_math<true>(pair_math, bf16, cube, backfacing, f)
               : visit_math<false>(pair_math, bf16, cube, backfacing, f);
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream`, allocates
// nothing, and returns the launch's cudaError_t (0 = success), or
// SHAPES_REFUSED for shapes it does not take (blocks of at most MAX_TILE
// rays, clusters of at most MAX_CLUSTER).  table: [n_gauss, SCAN_COLS]
// f32, row-major; cand: [n_rays / tile, mc] i32; center: [3] f32 on the
// device, the quadric form's origin.
extern "C" int egr_render_scan(
    const float* rays_o, const float* rays_d, const float* alive,
    const float* t_split, const float* table, const float* center,
    const int* cand, float* out, int n_rays, int n_gauss, int mc, int tile,
    int cluster, int check_every, int window_mode, int secondary_static,
    int pair_math, int stats, int attr_bf16, float near, float far,
    float secondary, float bf_max_dist, float bf_thr, float thr,
    float eps_norm, float exp_power, void* stream) {
  if (!scan_shape_ok(tile, cluster) || n_rays % tile != 0 ||
      check_every <= 0 || mc <= 0 || n_gauss % cluster != 0 ||
      window_mode < 0 || window_mode > 2 || secondary_static < -1 ||
      secondary_static > 1)
    return SHAPES_REFUSED;
  Launch l;
  HitsParams& p = l.p;
  p.rays_o = rays_o;
  p.rays_d = rays_d;
  p.alive = alive;
  p.t_split = t_split;
  p.gpack = table;
  p.cand = cand;
  p.cand_near = nullptr;
  p.n_gauss = n_gauss;
  p.mc = mc;
  p.cluster = cluster;
  p.cpad = padded_cluster(cluster);
  p.check_every = check_every;
  p.window_mode = window_mode;
  const bool integer = exp_power >= 1.0f && exp_power <= 8.0f &&
                       exp_power == (float)(int)exp_power;
  p.int_power = integer ? (int)exp_power : 0;
  p.vec16 = 0;
  p.near = near;
  p.far = far;
  p.secondary = secondary;
  p.bf_max_dist = bf_max_dist;
  p.bf_thr = bf_thr;
  p.log_thr = 0.0f;
  p.exp_power = exp_power;
  l.thr = thr;
  l.eps_norm = eps_norm;
  l.center = center;
  l.out = out;
  l.n_tiles = n_rays / tile;
  l.tile = tile;
  l.stream = static_cast<cudaStream_t>(stream);
  if (n_rays == 0) return 0;
  return (int)visit(pair_math, stats != 0, attr_bf16 != 0,
                    p.int_power == 3,
                    backfacing_for(secondary_static, secondary), l);
}

// The compiled kernel of (pair_math, stats, attr_bf16, exponent 3 or not,
// backfacing test or not: reflected passes) launched with `tile`-ray blocks
// at `cluster`: what kernel_info (trace_hits_walk.cuh) reports in
// out[0..3] - registers and spilled bytes per thread, dynamic shared memory
// per block, resident blocks per SM.  Returns a cudaError_t, or
// SHAPES_REFUSED.
extern "C" int egr_render_scan_info(int pair_math, int stats, int attr_bf16,
                                    int cube, int backfacing, int tile,
                                    int cluster, int* out) {
  if (!scan_shape_ok(tile, cluster)) return SHAPES_REFUSED;
  Info info;
  info.tile = tile;
  info.cluster = cluster;
  info.out = out;
  return (int)visit(pair_math, stats != 0, attr_bf16 != 0, cube != 0,
                    backfacing != 0, info);
}
