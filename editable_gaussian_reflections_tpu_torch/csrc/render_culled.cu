// render_culled.cu - one bounce of the eval render: culled ray x Gaussian
// trace, exact per-ray top-K k-buffer, front-to-back composite with the
// truncated-tail correction, and the tile early exit.
//
// Replaces the Pallas kernels pallas_render_culled_v4 (whole scene resident
// in VMEM) and pallas_render_culled_v3 (scene streamed by manual DMA), both
// in editable_gaussian_reflections_tpu/ops/pallas/render_kernel_v3.py.  The
// two differ only in where the scene lives on a TPU; here one kernel serves
// both, and the caller picks the early-exit group size each of them used
// (8 for v4, 4 for v3).  The plain PyTorch version of the same contract is
// render_culled_reference in ops/cuda/render_kernel.py.
//
// Design.  The walk over the tile's candidates is csrc/trace_tile.cuh,
// shared with the training slots kernel: one block per ray tile, one thread
// per ray, a cluster's geometry staged in shared memory, each thread keeping
// its K nearest hits (t, alpha, id) in registers, and the v4 group exit
// (exit_mode 0).  The TPU kernels' one-hot MXU attribute extraction and
// striped spread were workarounds for a machine without per-lane scatter, so
// here the epilogue sorts the kept hits, reads their attributes by id from
// device memory and composites them.
//
// Numerics (the port's rules, ops/precision.py): the pair math is float32,
// built without FMA contraction (-fmad=false) and without fast math, so it
// rounds like the plain version's separate multiplies and adds.  exp and pow
// are evaluated in float64 and rounded once; the log1p(-alpha) terms and
// every sum stay in float64.  The kernel and its plain version then agree
// bit for bit on any device, and the discrete decisions of the render (hit
// validity, K-th hit, saturation, the T >= threshold cutoff) come out the
// same.  Measured on an H100 80GB HBM3 at 700 W, at the eval render's
// shapes: a float32 variant (expf/log1pf, float accumulators) was 3% slower,
// and FMA contraction 5% faster but changed the counters of 0.32% of the
// primary rays and a lane by up to 0.70 (|u|^2 = <lo,lo> - <lo,ld>^2/<ld,ld>
// cancels, so the hit test moves).
//
// What bounds it: the f32 pair math, about 60 flops per ray x Gaussian pair
// on the FP32 units (no tensor-core form is used); the float64 work is per
// valid hit only.  What this first version does about it: nothing yet - it
// is written to be right and simple.  Known costs left for later: one block
// per SM at K=32 (register-bound), and a shared-memory refill plus two
// barriers per cluster.

#include <cuda_runtime.h>

#include "trace_tile.cuh"

namespace {

using namespace egr;

// output lanes (ops/cuda/layout.py); lanes 0-9 hold rgb, normal, f0 and
// roughness, in the order of attr_rows below
constexpr int OUT_ATTR = 0;
constexpr int OUT_DEPTH = 10;
constexpr int OUT_TFINAL = 11;
constexpr int OUT_FULLT = 12;
constexpr int OUT_NUMACC = 13;
constexpr int OUT_TRAV = 14;
constexpr int OUT_CHUNKS = 15;
constexpr int OUT_LANES = 16;

template <int K, bool CUBE>
__global__ void render_culled_kernel(TraceParams p, float thr, float eps_norm,
                                     float* out) {
  extern __shared__ float sg[];  // [N_GEOM_ROWS, cluster]
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  float st[K], sa[K];
  int sid[K];
  double log_t;
  float trav, chunks;
  trace_tile<K, CUBE>(p, sg, st, sa, sid, log_t, trav, chunks);

  // composite the hits front to back in (t, id) order
  sort_slots<K>(st, sa, sid);

  const int attr_rows[10] = {ROW_RGB,     ROW_RGB + 1, ROW_RGB + 2, ROW_NRM,
                             ROW_NRM + 1, ROW_NRM + 2, ROW_F0,      ROW_F0 + 1,
                             ROW_F0 + 2,  ROW_ROUGH};
  double front = 0.0, sum_la = 0.0, depth = 0.0;
  double attr[10];
#pragma unroll
  for (int a = 0; a < 10; ++a) attr[a] = 0.0;
  float num_acc = 0.0f;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if (st[i] < INF) {
      const double la = log1p((double)(-sa[i]));
      const float t_before = (float)exp(front);
      if (t_before >= thr) {  // prefix-closed: T only falls
        const double w = (double)t_before * (double)sa[i];
        sum_la += la;
        depth += w * (double)st[i];
        num_acc += 1.0f;
#pragma unroll
        for (int a = 0; a < 10; ++a)
          attr[a] += w * (double)p.gpack[(size_t)attr_rows[a] * p.n_gauss +
                                         sid[i]];
      }
      front += la;
    }
  }
  // truncated-tail correction: spread the transmittance the K hits left
  // over the hits composited
  const float t_final = (float)exp(sum_la);
  const float full_t = (float)exp(log_t);
  const double factor =
      1.0 + ((double)t_final - (double)full_t) /
                fmax(1.0 - (double)t_final, (double)eps_norm);

  float* o = out + (size_t)r * OUT_LANES;
#pragma unroll
  for (int a = 0; a < 10; ++a) o[OUT_ATTR + a] = (float)(attr[a] * factor);
  o[OUT_DEPTH] = (float)(depth * factor);
  o[OUT_TFINAL] = t_final;
  o[OUT_FULLT] = full_t;
  o[OUT_NUMACC] = num_acc;
  o[OUT_TRAV] = trav;
  o[OUT_CHUNKS] = chunks;
}

template <int K>
cudaError_t launch(const TraceParams& p, float thr, float eps_norm, float* out,
                   int n_tiles, int tile, cudaStream_t s) {
  const size_t smem = sizeof(float) * N_GEOM_ROWS * p.cluster;
  if (p.int_power == 3)
    render_culled_kernel<K, true><<<n_tiles, tile, smem, s>>>(p, thr, eps_norm,
                                                              out);
  else
    render_culled_kernel<K, false><<<n_tiles, tile, smem, s>>>(p, thr,
                                                               eps_norm, out);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream`, allocates
// nothing, and returns the launch's cudaError_t (0 = success).
extern "C" int egr_render_culled(
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
  if (n_rays == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = n_rays / tile;
  if (max_hits == 16) return (int)launch<16>(p, thr, eps_norm, out, n_tiles,
                                             tile, s);
  if (max_hits == 32) return (int)launch<32>(p, thr, eps_norm, out, n_tiles,
                                             tile, s);
  return (int)cudaErrorInvalidValue;
}
