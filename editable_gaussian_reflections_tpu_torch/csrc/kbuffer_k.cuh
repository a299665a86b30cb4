// kbuffer_k.cuh - the k-buffer depths K (max_hits) the kernels are built
// for, and how an entry point dispatches on K: the one place in csrc/ that
// knows the set, as SUPPORTED_K of ops/cuda/render_kernel.py is on the
// Python side.  Included by trace_hits_walk.cuh (the k-buffer walks) and
// sort_slots.cu.

#pragma once

#include <type_traits>

namespace egr_k {

// What the entry points return when they refuse the shapes (a cudaError_t
// is never negative).
constexpr int SHAPES_REFUSED = -1;

inline bool k_built(int max_hits) {
  return max_hits == 8 || max_hits == 16 || max_hits == 32 || max_hits == 64;
}

// f(std::integral_constant<int, K>{}) for the built K == max_hits, as an
// int; SHAPES_REFUSED for any other (never another K's kernel).
template <class F>
int with_k(int max_hits, F&& f) {
  switch (max_hits) {
    case 8:
      return (int)f(std::integral_constant<int, 8>{});
    case 16:
      return (int)f(std::integral_constant<int, 16>{});
    case 32:
      return (int)f(std::integral_constant<int, 32>{});
    case 64:
      return (int)f(std::integral_constant<int, 64>{});
    default:
      return SHAPES_REFUSED;
  }
}

}  // namespace egr_k
