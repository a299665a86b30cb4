"""The fine-cluster k-buffer render for one bounce: `render_culled_v5` and
its plain PyTorch version `render_culled_v5_reference`.

Counterpart of the JAX ops/pallas/render_kernel_v5.py
pallas_render_culled_v5, which only tools/bench_v5.py and the JAX tests
run: render_culled's contract (ops/cuda/render_kernel.py) at fine clusters
(32 or 64 Gaussians) and 128-ray tiles, with v5's candidate preparation -
the early-exit group rounded to whole 128-Gaussian spans (v5_check_every),
the lists padded to whole groups, and the near distances truncated toward
zero to bf16 (truncate_near).  The exit is render_culled's (exit mode 0):
a ray is done when saturated or behind the group's first candidate, a
wholly dead tile stops at once.

So the kernel is render_culled's (csrc/render_culled.cu) on the prepared
lists, as pallas_render_culled_v3 and v4 share it: the TPU kernel's
transposed table, span staging and striped drain were a TPU layout, and a
walk that staged a whole exit group per refill computed the same bits more
slowly on an H100 (tools/refill_ladder.py, PERF.md).  Against the Pallas
kernel (float32 sums, an order-free composite with ties by slot index), to
a tolerance.

`debug_mode` 1 and 2 of the JAX kernel were TPU attribution probes (the
drain skipped, or cut to one insertion): they change the result and raise
here.
"""

from __future__ import annotations

import torch

from .render_kernel import (
    V5_SPAN,
    pad_candidates,
    render_culled,
    render_culled_reference,
    truncate_near,
    v5_check_every,
)


def prepare_v5(candidates, cand_near, cluster: int, check_every: int,
               span: int = V5_SPAN):
    """(candidates, truncated near, check_every) as v5 walks them."""
    ce = v5_check_every(check_every, cluster, span)
    cands, near = pad_candidates(candidates, cand_near, ce)
    return cands.contiguous(), truncate_near(cands, near), ce


def _v5_call(fn, rays_o, rays_d, gpack, candidates, cand_near, num, near,
             far, exp_power, secondary, backfacing_max_dist,
             backfacing_invalid_normal_threshold, transmittance_threshold,
             eps_forward_normalization, max_hits, cluster, tile, alive,
             check_every, span, debug_mode, t_split, window_mode,
             secondary_static):
    """fn (render_culled or its plain version) on v5's prepared lists."""
    del num                             # unused, as in the JAX kernel
    if debug_mode != 0:
        raise ValueError(f"debug_mode={debug_mode}: the TPU kernel's "
                         f"attribution probes are not ported")
    cands, near_t, ce = prepare_v5(candidates, cand_near, cluster,
                                   check_every, span)
    return fn(rays_o, rays_d, gpack, cands, near_t, near, far, exp_power,
              secondary, backfacing_max_dist,
              backfacing_invalid_normal_threshold,
              transmittance_threshold=transmittance_threshold,
              eps_forward_normalization=eps_forward_normalization,
              max_hits=max_hits, cluster=cluster, tile=tile, alive=alive,
              check_every=ce, t_split=t_split, window_mode=window_mode,
              secondary_static=secondary_static)


def render_culled_v5_reference(
    rays_o, rays_d, gpack, candidates, cand_near, num, near, far, exp_power,
    secondary, backfacing_max_dist, backfacing_invalid_normal_threshold,
    transmittance_threshold=0.01, eps_forward_normalization=1e-12,
    max_hits: int = 16, cluster: int = 64, tile: int = 128, alive=None,
    check_every: int = 8, span: int = V5_SPAN, debug_mode: int = 0,
    t_split=None, window_mode: int = 0, secondary_static: int = -1,
) -> torch.Tensor:
    """Plain PyTorch version (module docstring): render_culled_reference on
    v5's prepared candidates."""
    return _v5_call(render_culled_reference, rays_o, rays_d, gpack,
                    candidates, cand_near, num, near, far, exp_power,
                    secondary, backfacing_max_dist,
                    backfacing_invalid_normal_threshold,
                    transmittance_threshold, eps_forward_normalization,
                    max_hits, cluster, tile, alive, check_every, span,
                    debug_mode, t_split, window_mode, secondary_static)


def render_culled_v5(
    rays_o, rays_d, gpack, candidates, cand_near, num, near, far, exp_power,
    secondary, backfacing_max_dist, backfacing_invalid_normal_threshold,
    transmittance_threshold=0.01, eps_forward_normalization=1e-12,
    max_hits: int = 16, cluster: int = 64, tile: int = 128, alive=None,
    check_every: int = 8, span: int = V5_SPAN, debug_mode: int = 0,
    t_split=None, window_mode: int = 0, secondary_static: int = -1,
) -> torch.Tensor:
    """Fine-cluster culled trace + composite for one bounce; [R,
    OUT_LANES] f32.  The arguments are pallas_render_culled_v5's (without
    `interpret`; `num` unused, as there).

    render_culled on v5's prepared candidates: CUDA tensors launch its
    kernel (counted in `render_culled.launches`), CPU tensors take its
    plain version.  Anything else raises."""
    return _v5_call(render_culled, rays_o, rays_d, gpack, candidates,
                    cand_near, num, near, far, exp_power, secondary,
                    backfacing_max_dist, backfacing_invalid_normal_threshold,
                    transmittance_threshold, eps_forward_normalization,
                    max_hits, cluster, tile, alive, check_every, span,
                    debug_mode, t_split, window_mode, secondary_static)
