// kbuffer_composite.cuh - the epilogue of a k-buffer render: sort the K
// kept hits, composite them front to back with the truncated-tail
// correction, and write the [OUT_LANES] row of the ray.  Used by
// render_table.cu (attributes from an [N, TABLE_A] table) and by the
// measurement kernel tools/grouped_walk.cu (attributes from the gpack
// rows).
//
// render_culled.cu holds the same code inline; it keeps its own copy so
// that its compiled walk stays as measured (moving it here is an edit of
// that kernel and owes a tools/walk_ab.py A/B).  Keep the two in step.
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

// attr(a, id): attribute a (0-9) of Gaussian id, as a float.
template <int K, class Attr>
__device__ __forceinline__ void composite_slots(float (&st)[K], float (&sa)[K],
                                                int (&sid)[K], double log_t,
                                                float trav, float chunks,
                                                float thr, float eps_norm,
                                                const Attr& attr, float* o) {
  sort_slots<K>(st, sa, sid);
  double front = 0.0, sum_la = 0.0, depth = 0.0;
  double acc[NUM_ATTR];
#pragma unroll
  for (int a = 0; a < NUM_ATTR; ++a) acc[a] = 0.0;
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
        for (int a = 0; a < NUM_ATTR; ++a)
          acc[a] += w * (double)attr(a, sid[i]);
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
