// kbuffer_composite.cuh - the epilogue of a k-buffer render: composite the
// K kept hits, in (t, id) order, front to back with the truncated-tail
// correction, and write the [OUT_LANES] row of the ray.  Used by
// render_culled.cu and render_table.cu (kept hits in the walk's
// shared-memory slot columns, alpha recomputed per hit, attributes from the
// gpack rows or an [N, TABLE_A] table) and the measurement kernel
// tools/grouped_walk.cu (kept hits in registers, gpack rows).
//
// Numerics (ops/precision.py): log1p and exp in float64, the transmittance
// prefix, the weights and every sum in float64, each lane rounded once.
// The plain version is ops/cuda/render_kernel.py::_composite.

#pragma once

#include <cuda_runtime.h>

#include "trace_tile.cuh"

namespace egr {

// output lanes (ops/cuda/layout.py): lanes 0-9 hold rgb, normal, f0 and
// roughness in the order of the attribute reader's index a
constexpr int OUT_ATTR = 0;
constexpr int OUT_DEPTH = 10;
constexpr int OUT_TFINAL = 11;
constexpr int OUT_FULLT = 12;
constexpr int OUT_NUMACC = 13;
constexpr int OUT_TRAV = 14;
constexpr int OUT_CHUNKS = 15;
constexpr int OUT_LANES = 16;

// The kept hits through accessors, so that they may live in registers or in
// shared memory: hit(i, t, id) sets the i-th kept hit in (t, id) order (the
// caller sorts; t = INF where the slot is empty), alpha(i, id) gives its
// opacity (asked for kept hits only), attr(a, id) attribute a (0-9) of
// Gaussian id, as a float.
template <int K, class Hit, class Alpha, class Attr>
__device__ __forceinline__ void composite_slots(const Hit& hit,
                                                const Alpha& alpha,
                                                double log_t, float trav,
                                                float chunks, float thr,
                                                float eps_norm,
                                                const Attr& attr, float* o) {
  double front = 0.0, sum_la = 0.0, depth = 0.0;
  double acc[NUM_ATTR];
#pragma unroll
  for (int a = 0; a < NUM_ATTR; ++a) acc[a] = 0.0;
  float num_acc = 0.0f;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    float t;
    int id;
    hit(i, t, id);
    if (t < INF) {
      const float a_i = alpha(i, id);
      const double la = log1p((double)(-a_i));
      const float t_before = (float)exp(front);
      if (t_before >= thr) {  // prefix-closed: T only falls
        const double w = (double)t_before * (double)a_i;
        sum_la += la;
        depth += w * (double)t;
        num_acc += 1.0f;
#pragma unroll
        for (int a = 0; a < NUM_ATTR; ++a) acc[a] += w * (double)attr(a, id);
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
#pragma unroll
  for (int a = 0; a < NUM_ATTR; ++a)
    o[OUT_ATTR + a] = (float)(acc[a] * factor);
  o[OUT_DEPTH] = (float)(depth * factor);
  o[OUT_TFINAL] = t_final;
  o[OUT_FULLT] = full_t;
  o[OUT_NUMACC] = num_acc;
  o[OUT_TRAV] = trav;
  o[OUT_CHUNKS] = chunks;
}

}  // namespace egr
