// trace_slots.cu - one bounce of the training trace: culled ray x Gaussian
// walk, exact per-ray top-K, and the K kept hits written out depth-sorted
// with the full per-hit payload the training step's composite and backward
// read (t, alpha, id, 10 shading attributes, 24 frame-table fields).
//
// Replaces the Pallas kernels pallas_trace_slots_v4 (editable_gaussian_
// reflections_tpu/ops/pallas/render_kernel_v3.py, scene resident in VMEM)
// and pallas_trace_slots (ops/pallas/render_kernel.py, scene streamed).  The
// two differ in where the scene lives on a TPU, and in their early exit,
// which is part of the result: the caller picks exit_mode 0 (v4: group of 8,
// dead_all) or 1 (v1: pairs, per-ray dead), as the JAX dispatch picks the
// kernel (slots_resident_fits).  The plain PyTorch version of the same
// contract is trace_slots_reference in ops/cuda/trace_slots.py.
//
// Design.  The walk is csrc/trace_hits_walk.cuh, the walk of all three
// k-buffer kernels (exit mode 0 or 1, a compile-time option, with the
// processed-cluster counter): one block per ray tile of at most 512 rays,
// one thread per ray, clusters streamed through a two-stage cp.async ring
// and traced four Gaussians a step, the kept hits (t, id) in a per-thread
// column of shared memory (two 256-ray blocks per SM at K 32, where the
// registers of the first version's walk allowed one), the pair math's
// reciprocal without a branch per pair, and the ray-independent terms once
// per Gaussian where a block's rays share an origin (a primary pass).
// Kernels are instantiated per K (8, 16, 32, 64), exponent (3 spelled out,
// or general), the backfacing test, the exit mode and, in exit mode 0, the
// split-far window (window_mode 1 keeps hits with t < t_split, 2 those with
// t > t_split: pallas_trace_slots_v4's t-window, render_kernel_v3.py:787).
// The window is a compile-time option, as the walk's load_ray makes it: the
// kernels of window_mode 0 are the same code as without it, and the
// windowed ones fold the bound into the ray's near or far once per thread.
// pallas_trace_slots (exit mode 1) takes no window, and JAX never splits
// where it runs, so the entry point refuses that pair.  The Pallas kernels
// carried the whole 37-column payload through their drain (one-hot MXU
// extraction, striped spread matrices), because a TPU core cannot gather a
// row by id; here the epilogue sorts the K hits by (t, id), recomputes each
// kept hit's alpha from its gpack column with the walk's float operations
// (so it equals what the walk saw), and gathers its attributes and frame
// fields by id from the row-major attribute and frame tables
// (pack_attr_table, pack_frame_table), the inputs of pallas_trace_slots.
// Output rows follow unpack_slots' block order; empty slots are t = INF
// with every other column 0.
//
// What bounds it: the pair math, about 60 flops per ray x Gaussian pair on
// the FP32 pipe, 34 per pair and 26 per Gaussian on a shared origin, as in
// render_culled.cu; the output is 37*K floats per ray (4.7 KB at K=32,
// 2.8 GB a launch at the training step's 589,824 rays), written once.  A
// thread writing its own row stored one word per ray and instruction, 4.7
// KB apart, which cost more than the walk itself (PERF.md), so the
// epilogue stages each slot block in shared memory and writes whole
// segments.  Known costs left for later: the float64 exp/log1p per valid
// hit in the walk, and the epilogue's scattered table gathers (34 words a
// kept hit) and its two barriers per slot block.

#include <cuda_runtime.h>

#include "trace_hits_walk.cuh"

namespace {

using namespace egr_hits;

// slot blocks (ops/cuda/layout.py)
constexpr int SLOT_T = 0;
constexpr int SLOT_ALPHA = 1;
constexpr int SLOT_ID = 2;
constexpr int SLOT_ATTR = 3;
constexpr int NUM_ATTR = egr::NUM_ATTR;
constexpr int NUM_FRAME = 24;
constexpr int SLOT_FRAME = SLOT_ATTR + NUM_ATTR;
constexpr int SLOT_BLOCKS = SLOT_FRAME + NUM_FRAME;
constexpr int TABLE_A = 16;
constexpr int FTABLE_A = 32;
constexpr int ACC_LANES = 16;

// The epilogue stages each slot block of the block's rows, a part of
// part_of(K) slots at a time, in a [tile][part + 1] float buffer of shared
// memory: in the stage ring, which the walk is done with, where it fits
// (tile 256, cluster 256, K 32: 33 of 47 KB), else after the slot columns.
// A part is the whole block up to K 32; at K 64 it is half of it, so that
// the Config's tile 256 and cluster 256 fit (a [256][65] buffer fits
// neither the ring nor, at 66,560 bytes after 178,176 of ring and columns,
// the card's 232,448).  Floats of dynamic shared memory before the
// buffer, and the bytes of a block's dynamic shared memory.
__host__ __device__ constexpr int part_of(int max_hits) {
  return max_hits > 32 ? 32 : max_hits;
}

inline int buffer_offset(int max_hits, int tile, int cluster) {
  const int ring = NSTAGE * N_STAGE_ROWS * padded_cluster(cluster);
  return tile * (part_of(max_hits) + 1) <= ring
             ? 0
             : ring + 2 * max_hits * tile;
}

inline size_t slots_smem_bytes(int max_hits, int tile, int cluster) {
  const size_t walk = walk_smem_bytes(max_hits, tile, cluster);
  return buffer_offset(max_hits, tile, cluster) == 0
             ? walk
             : walk + sizeof(float) * tile * (part_of(max_hits) + 1);
}

template <int K, bool CUBE, bool BACKFACING, int EXIT, bool WINDOW>
__global__ void __launch_bounds__(MAX_TILE)
    trace_slots_kernel(HitsParams p, int buffer, const float* table,
                       const float* ftable, float* slots, float* acc) {
  extern __shared__ __align__(16) float smem[];
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const Ray ray = load_ray<WINDOW>(p, r);
  float* col_t;
  int* col_id;
  double log_t;
  float trav, chunks;
  walk_hits<K, CUBE, BACKFACING, EXIT, /*CHUNKS=*/true>(
      p, smem, ray, col_t, col_id, log_t, trav, chunks);
  sort_column<K>(col_t, col_id, blockDim.x);

  // The rows, one slot block at a time, in parts of P slots (part_of): each
  // thread puts its ray's P values of the part in its row of the buffer,
  // then the block writes every ray's P values, which are contiguous in its
  // output row, a warp to a ray (or more at K 8 and 16): whole segments of
  // up to 128 bytes instead of one word per ray and store.
  constexpr int P = part_of(K);
  const int tile = blockDim.x;
  float* const buf = smem + buffer;
  float* const mine = buf + threadIdx.x * (P + 1);
  float* const rows = slots + (size_t)blockIdx.x * tile * (SLOT_BLOCKS * K);
  __syncthreads();  // the walk is done with the stage ring
  for (int b = 0; b < SLOT_BLOCKS; ++b) {
    for (int s0 = 0; s0 < K; s0 += P) {
      if (b == SLOT_ALPHA) {
#pragma unroll 1
        for (int q = 0; q < P; ++q) {
          const float t = col_t[(s0 + q) * tile];
          mine[q] = t < INF
                        ? kept_hit<CUBE>(p, ray, col_id[(s0 + q) * tile]).alpha
                        : 0.0f;
        }
      } else {
        // an attribute or frame field: column b of the table row of the id
        const bool frame = b >= SLOT_FRAME;
        const float* src = frame
                               ? ftable + (b - SLOT_FRAME)
                               : table + (b >= SLOT_ATTR ? b - SLOT_ATTR : 0);
        const int width = frame ? FTABLE_A : TABLE_A;
#pragma unroll 8
        for (int q = 0; q < P; ++q) {
          const float t = col_t[(s0 + q) * tile];
          const int id = col_id[(s0 + q) * tile];  // 0 where it is empty
          mine[q] = b == SLOT_T       ? t
                    : !(t < INF)      ? 0.0f
                    : b == SLOT_ID    ? (float)id
                                      : src[(size_t)id * width];
        }
      }
      __syncthreads();
      for (int i = threadIdx.x; i < tile * P; i += tile) {
        const int ray_i = i / P, q = i - ray_i * P;
        rows[(size_t)ray_i * (SLOT_BLOCKS * K) + b * K + s0 + q] =
            buf[ray_i * (P + 1) + q];
      }
      __syncthreads();  // the buffer is free for the next part
    }
  }
  float* a = acc + (size_t)r * ACC_LANES;
  a[0] = (float)log_t;
  a[1] = trav;
  a[2] = chunks;
  for (int i = 3; i < ACC_LANES; ++i) a[i] = 0.0f;
}

template <int K, bool CUBE, bool BACKFACING, int EXIT, bool WINDOW>
cudaError_t launch(const HitsParams& p, const float* table,
                   const float* ftable, float* slots, float* acc, int n_tiles,
                   int tile, cudaStream_t s) {
  const int smem = (int)slots_smem_bytes(K, tile, p.cluster);
  const auto kernel = trace_slots_kernel<K, CUBE, BACKFACING, EXIT, WINDOW>;
  const cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<n_tiles, tile, smem, s>>>(p, buffer_offset(K, tile, p.cluster),
                                     table, ftable, slots, acc);
  return cudaGetLastError();
}

// The instantiation for the launch's exponent, backfacing test, exit mode
// and window.
template <int K, int EXIT, bool WINDOW>
cudaError_t launch_e(const HitsParams& p, bool backfacing, const float* table,
                     const float* ftable, float* slots, float* acc,
                     int n_tiles, int tile, cudaStream_t s) {
  const bool cube = p.int_power == 3;
  const auto go = cube ? (backfacing ? launch<K, true, true, EXIT, WINDOW>
                                     : launch<K, true, false, EXIT, WINDOW>)
                       : (backfacing ? launch<K, false, true, EXIT, WINDOW>
                                     : launch<K, false, false, EXIT, WINDOW>);
  return go(p, table, ftable, slots, acc, n_tiles, tile, s);
}

// Exit mode 1 has no windowed kernel (the entry point refuses the pair).
template <int K>
cudaError_t launch_k(const HitsParams& p, bool backfacing, int exit_mode,
                     const float* table, const float* ftable, float* slots,
                     float* acc, int n_tiles, int tile, cudaStream_t s) {
  const auto go = exit_mode == 1      ? launch_e<K, 1, false>
                  : p.window_mode != 0 ? launch_e<K, 0, true>
                                       : launch_e<K, 0, false>;
  return go(p, backfacing, table, ftable, slots, acc, n_tiles, tile, s);
}

template <int K, bool CUBE, bool BACKFACING, int EXIT, bool WINDOW>
cudaError_t info(int tile, int cluster, int* out) {
  return kernel_info(trace_slots_kernel<K, CUBE, BACKFACING, EXIT, WINDOW>,
                     tile, (int)slots_smem_bytes(K, tile, cluster), out);
}

template <int K, int EXIT, bool WINDOW>
cudaError_t info_e(bool cube, bool backfacing, int tile, int cluster,
                   int* out) {
  const auto go = cube ? (backfacing ? info<K, true, true, EXIT, WINDOW>
                                     : info<K, true, false, EXIT, WINDOW>)
                       : (backfacing ? info<K, false, true, EXIT, WINDOW>
                                     : info<K, false, false, EXIT, WINDOW>);
  return go(tile, cluster, out);
}

// kind 0 and 1: exit modes 0 and 1 without the window; 2: exit mode 0 with
// it (window_mode 1 and 2 run the same kernel).
template <int K>
cudaError_t info_k(bool cube, bool backfacing, int kind, int tile,
                   int cluster, int* out) {
  return kind == 1   ? info_e<K, 1, false>(cube, backfacing, tile, cluster,
                                           out)
         : kind == 2 ? info_e<K, 0, true>(cube, backfacing, tile, cluster, out)
                     : info_e<K, 0, false>(cube, backfacing, tile, cluster,
                                           out);
}

}  // namespace

// Plain C entry point (bound with ctypes).  slots [n_rays, 37*max_hits] and
// acc [n_rays, 16] f32 are written in full.  exit_mode 0 or 1 (the header);
// window_mode 0 (none, t_split unread), 1 (keep t < t_split) or 2 (keep t >
// t_split), in exit mode 0 only; secondary_static 1 (the backfacing test),
// 0 (none) or -1 (where `secondary` > 0).  The shapes it takes are init_hits_params'
// (trace_hits_walk.cuh) whose staging buffer fits too (slots_smem_bytes);
// it returns SHAPES_REFUSED for any other.  Launches on `stream`, allocates
// nothing, and returns the launch's cudaError_t (0 = success).
extern "C" int egr_trace_slots(
    const float* rays_o, const float* rays_d, const float* alive,
    const float* t_split, const float* gpack, const float* table,
    const float* ftable, const int* cand, const float* cand_near,
    float* slots, float* acc, int n_rays, int n_gauss, int mc, int tile,
    int cluster, int max_hits, int check_every, int exit_mode,
    int window_mode, int secondary_static, float near, float far,
    float secondary, float bf_max_dist, float bf_thr, float log_thr,
    float exp_power, void* stream) {
  HitsParams p;
  if (!init_hits_params(p, rays_o, rays_d, alive, gpack, cand, cand_near,
                        n_rays, n_gauss, mc, tile, cluster, max_hits,
                        check_every, near, far, secondary, bf_max_dist,
                        bf_thr, log_thr, exp_power) ||
      slots_smem_bytes(max_hits, tile, cluster) > MAX_SMEM ||
      (exit_mode != 0 && exit_mode != 1) || window_mode < 0 ||
      window_mode > 2 || (exit_mode == 1 && window_mode != 0) ||
      secondary_static < -1 || secondary_static > 1)
    return SHAPES_REFUSED;
  p.t_split = t_split;
  p.window_mode = window_mode;
  if (n_rays == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = n_rays / tile;
  const bool backfacing = backfacing_for(secondary_static, secondary);
  return with_k(max_hits, [&](auto k) {
    return launch_k<decltype(k)::value>(p, backfacing, exit_mode, table,
                                        ftable, slots, acc, n_tiles, tile, s);
  });
}

// The compiled kernel of (max_hits, cube, backfacing, exit_mode) at (tile,
// cluster): what kernel_info (trace_hits_walk.cuh) reports in out[0..3].
// exit_mode 2 asks for exit mode 0's windowed kernel (window_mode 1/2).
// Returns a cudaError_t, or SHAPES_REFUSED.
extern "C" int egr_trace_slots_info(int max_hits, int cube, int backfacing,
                                    int exit_mode, int tile, int cluster,
                                    int* out) {
  if (!hits_shape_ok(max_hits, tile, cluster) ||
      slots_smem_bytes(max_hits, tile, cluster) > MAX_SMEM ||
      exit_mode < 0 || exit_mode > 2)
    return SHAPES_REFUSED;
  return with_k(max_hits, [&](auto k) {
    return info_k<decltype(k)::value>(cube, backfacing, exit_mode, tile,
                                      cluster, out);
  });
}
