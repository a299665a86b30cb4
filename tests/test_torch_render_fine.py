"""PyTorch port vs JAX package: the fine-cluster (v5) render kernel.

render_culled_v5_reference (the plain version of render_culled's kernel on
v5's prepared candidate lists) is held against pallas_render_culled_v5 in interpret mode on the cases of
tests/test_render_kernel_v5.py, through the same _run: the full traversal
(every cluster listed, near 0, threshold 1e-8, so no exit fires) at
cluster/span 64/128, 32/128 and 32/64 on primary and scattered rays, real
culling with the exits active, the alive mask, and the split windows; on
_room(1024) at 32x32 rays, K 8, tile 128.  Float lanes to rtol 1e-4 /
atol 5e-5 (float32 sums and an order-free composite in JAX, float64 sums
and a sorted composite here), the counters exactly: the exit decisions,
taken on v5's truncated near distances and rounded groups, agree.  One
difference is by design: hits at equal depth are kept and composited in
insertion and slot order in JAX, in lane and id order here, and XLA on the
CPU contracts the pair math's multiply-adds into FMAs, which moves a depth
by an ulp.  So a ray whose K + 1 nearest hits hold two within TIE_REL of
each other may keep or weight the tied Gaussians the other way round (1
ray of 1024 in the far-window case: two hits 1 ulp apart at t = 15.149,
its rgb by up to 1.5e-3).  On those rays the
order-free lanes (depth, transmittances, counters) still match.

The kernel itself runs only on a CUDA card: test_torch_render_fine_cuda.py
compares it with this plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editable_gaussian_reflections_tpu.ops.culling import (
    cluster_bounds,
    select_candidates,
)
from editable_gaussian_reflections_tpu.ops.pallas.render_kernel_v5 import (
    pallas_render_culled_v5,
)
from editable_gaussian_reflections_tpu.ops.pallas.trace_kernel import (
    pack_frames,
)
from editable_gaussian_reflections_tpu_torch.ops.cuda import layout
from editable_gaussian_reflections_tpu_torch.ops.cuda.render_fine import (
    render_culled_v5,
    render_culled_v5_reference,
)
from editable_gaussian_reflections_tpu_torch.ops.cuda.render_kernel import (
    _f32,
    _pair_math,
    render_culled,
    truncate_near,
    v5_check_every,
)
from tests.test_render_kernel import SETTINGS, _rays, _room

torch.set_num_threads(1)

# depths this close (relative; 8 ulps) count as a tie
TIE_REL = 2.0 ** -20


def _run(frames, attrs, rays_o, rays_d, *, cluster, tile, exhaustive=False,
         thr=None, secondary=0.0, alive=None, t_split=None, window_mode=0,
         max_hits=8, **kw):
    """tests/test_render_kernel_v5.py's _run for v5, on both packages:
    the port's and JAX's outputs as [R, OUT_LANES] numpy arrays, and
    tie_rays (below) for the comparison."""
    gpack = pack_frames(frames, attrs)
    n_c = gpack.shape[1] // cluster
    znear, zfar = jnp.float32(0.05), jnp.float32(50.0)
    if exhaustive:
        n_t = rays_o.shape[0] // tile
        cands = jnp.broadcast_to(jnp.arange(n_c, dtype=jnp.int32),
                                 (n_t, n_c))
        cnear = jnp.zeros((n_t, n_c), jnp.float32)
        num = None
    else:
        cands, cnear, num, _o, _td = select_candidates(
            rays_o, rays_d, cluster_bounds(frames, cluster), znear, zfar,
            tile=tile, max_clusters=n_c)
    thr = thr if thr is not None else SETTINGS.transmittance_threshold
    tail = (3.0, secondary, SETTINGS.backfacing_max_dist,
            SETTINGS.backfacing_invalid_normal_threshold)
    kw = dict(kw, transmittance_threshold=thr, max_hits=max_hits,
              cluster=cluster, tile=tile, t_split=t_split,
              window_mode=window_mode)
    ref = pallas_render_culled_v5(
        rays_o, rays_d, gpack, cands, cnear, num, znear, zfar, *tail,
        interpret=True, alive=alive, **kw)

    def t(x):
        return None if x is None else torch.tensor(np.asarray(x))

    kw["t_split"] = t(t_split)
    args = (t(rays_o), t(rays_d), t(gpack), t(cands), t(cnear))
    out = render_culled_v5_reference(*args, None, 0.05, 50.0, *tail,
                                     alive=t(alive), **kw)

    def tie_rays(rows):
        """Whether each ray of `rows` has two valid hits within TIE_REL of
        each other's depth among its K + 1 nearest (the hits that compete
        for the slots), over every Gaussian."""
        o, d = args[0][rows][None], args[1][rows][None]
        R = args[0].shape[0]
        per_ray = [torch.ones(R) if x is None else t(x).float()
                   for x in (alive, t_split)]
        tt, _a, valid, _g = _pair_math(
            o, d, per_ray[0][rows][None], per_ray[1][rows][None],
            args[2][None], near=_f32(0.05), far=_f32(50.0),
            secondary=_f32(secondary),
            bf_max_dist=_f32(SETTINGS.backfacing_max_dist),
            bf_thr=_f32(SETTINGS.backfacing_invalid_normal_threshold),
            exp_power=3.0, window_mode=window_mode,
            secondary_static=kw.get("secondary_static", -1))
        ties = []
        for ti, vi in zip(tt[0], valid[0]):
            hits = ti[vi].sort().values[:max_hits + 1]
            ties.append(bool(((hits[1:] - hits[:-1])
                              <= TIE_REL * hits[1:]).any()))
        return np.array(ties)

    return out.numpy(), np.asarray(ref), tie_rays


def assert_lanes_match(out, ref, tie_rays):
    """Every lane, except the attribute lanes of rays with a depth tie
    among their nearest hits (module docstring)."""
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(out[:, layout.OUT_NUMACC:],
                                  ref[:, layout.OUT_NUMACC:])
    f = slice(0, layout.OUT_NUMACC)
    close = np.isclose(out[:, f], ref[:, f], rtol=1e-4, atol=5e-5)
    if close.all():
        return
    bad = np.nonzero(~close.all(axis=1))[0]
    assert tie_rays(torch.tensor(bad)).all(), "a mismatch without a tie"
    ties = np.zeros(len(out), bool)
    ties[bad] = True
    attr = slice(layout.OUT_RGB, layout.OUT_ROUGH + 1)
    rest = slice(layout.OUT_DEPTH, layout.OUT_NUMACC)
    np.testing.assert_allclose(out[ties, rest], ref[ties, rest], rtol=1e-4,
                               atol=5e-5)
    assert np.abs(out[ties, attr] - ref[ties, attr]).max() < 2e-3


@pytest.mark.parametrize("cluster,span", [(64, 128), (32, 128), (32, 64)])
@pytest.mark.parametrize("secondary", [0.0, 1.0])
def test_full_traversal_matches_pallas(cluster, span, secondary):
    _scene, frames, attrs = _room(1024)
    rays_o, rays_d = _rays()
    if secondary:
        rays_d = jax.random.normal(jax.random.PRNGKey(3), rays_d.shape)
        rays_d = rays_d / jnp.linalg.norm(rays_d, axis=-1, keepdims=True)
    out, ref, ties = _run(frames, attrs, rays_o, rays_d, cluster=cluster,
                          tile=128, exhaustive=True, thr=1e-8,
                          secondary=secondary, span=span,
                          secondary_static=int(secondary))
    assert_lanes_match(out, ref, ties)


def test_culled_with_exits_matches_pallas():
    _scene, frames, attrs = _room(1024)
    rays_o, rays_d = _rays()
    out, ref, ties = _run(frames, attrs, rays_o, rays_d, cluster=32,
                          tile=128, span=128, secondary_static=0)
    assert_lanes_match(out, ref, ties)
    # the exit fired: some tile computed fewer clusters than it lists
    _c, _n, num, _o, _t = select_candidates(
        rays_o, rays_d, cluster_bounds(frames, 32), jnp.float32(0.05),
        jnp.float32(50.0), tile=128, max_clusters=32)
    assert (out[::128, layout.OUT_CHUNKS] < np.asarray(num)).any()


def test_dead_rays_and_alive_mask_match_pallas():
    _scene, frames, attrs = _room(1024)
    rays_o, rays_d = _rays()
    alive = jnp.arange(rays_o.shape[0]) % 3 != 0
    out, ref, ties = _run(frames, attrs, rays_o, rays_d, cluster=64,
                          tile=128, exhaustive=True, thr=1e-8, alive=alive)
    assert_lanes_match(out, ref, ties)
    dead = ~np.asarray(alive)
    assert np.all(out[dead, layout.OUT_TFINAL] == 1.0)


@pytest.mark.parametrize("window_mode", [1, 2])
def test_split_window_matches_pallas(window_mode):
    _scene, frames, attrs = _room(1024)
    rays_o, rays_d = _rays()
    t_split = jnp.full((rays_o.shape[0],), 6.0, jnp.float32)
    out, ref, ties = _run(frames, attrs, rays_o, rays_d, cluster=32,
                          tile=128, exhaustive=True, thr=1e-8,
                          t_split=t_split, window_mode=window_mode)
    assert_lanes_match(out, ref, ties)


def test_candidate_preparation_follows_v5():
    # check_every rounded to whole 128-Gaussian spans (render_kernel_v5.py
    # :405-409)
    assert v5_check_every(8, 64) == 8 and v5_check_every(3, 64) == 2
    assert v5_check_every(6, 32) == 4 and v5_check_every(1, 32) == 4
    assert v5_check_every(8, 32, span=64) == 8
    # near truncated toward zero to bf16; empty -> 3e38; negative -> 0
    cands = torch.tensor([[0, 1, -1, 2]], dtype=torch.int32)
    near = torch.tensor([[1.2345678, -0.5, 7.0, 3.0e38]])
    got = truncate_near(cands, near)
    bits = np.asarray(jax.lax.bitcast_convert_type(
        jnp.where(jnp.asarray(cands) < 0, jnp.float32(3e38),
                  jnp.maximum(jnp.asarray(near), 0.0)), jnp.int32)
        & jnp.int32(-65536))
    np.testing.assert_array_equal(got.view(torch.int32).numpy(), bits)
    assert (got <= torch.where(cands < 0, 3e38, near.clamp(min=0))).all()


def test_debug_modes_raise_and_cpu_takes_plain_version():
    _scene, frames, attrs = _room(1024)
    rays_o, rays_d = (torch.tensor(np.asarray(x)) for x in _rays())
    gpack = torch.tensor(np.asarray(pack_frames(frames, attrs)))
    n_c = gpack.shape[1] // 64
    cands = torch.arange(n_c, dtype=torch.int32).expand(8, n_c).contiguous()
    cnear = torch.zeros((8, n_c))
    args = (rays_o, rays_d, gpack, cands, cnear, None, 0.05, 50.0, 3.0, 0.0,
            0.1, 0.9)
    for mode in (1, 2):
        with pytest.raises(ValueError, match="debug_mode"):
            render_culled_v5(*args, max_hits=8, debug_mode=mode)
    before = render_culled.launches
    a = render_culled_v5(*args, max_hits=8)
    b = render_culled_v5_reference(*args, max_hits=8)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert render_culled.launches == before
