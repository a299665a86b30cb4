"""PyTorch port vs JAX package: the round-2 fused render kernel.

render_culled_table_reference (the plain version of csrc/render_table.cu)
is held against pallas_render_culled in interpret mode on the cases of
tests/test_render_kernel.py: primary and secondary passes, the dead-ray
mask, and the static backfacing gate against the dynamic one, on
_room(2048) at 32x32 rays (K 16, cluster 256, tile 256, 8 candidates).
Float lanes to rtol 1e-4 / atol 5e-5, the JAX package's own tolerance for
this kernel (float32 sums and an order-free composite there, float64 sums
and a sorted one here); the counters exactly.  The static gate equals the
dynamic one bit for bit, as in the JAX test.

The kernel itself runs only on a CUDA card: test_torch_render_table_cuda.py
compares it with this plain version there.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editable_gaussian_reflections_tpu.ops.culling import (
    cluster_bounds,
    morton_order,
    select_candidates,
)
from editable_gaussian_reflections_tpu.ops.pallas import render_kernel as rk
from editable_gaussian_reflections_tpu.ops.pallas.trace_kernel import (
    pack_frames,
)
from editable_gaussian_reflections_tpu.scene import gaussian_scene as jgs
from editable_gaussian_reflections_tpu.utils.synth import room_scene
from editable_gaussian_reflections_tpu_torch.ops.cuda import layout
from editable_gaussian_reflections_tpu_torch.ops.cuda.render_table import (
    render_culled_table,
    render_culled_table_reference,
)
from tests.test_render_kernel import SETTINGS, _rays, _room

torch.set_num_threads(1)

ZNEAR, ZFAR = 0.05, 50.0


@functools.cache
def _inputs():
    _scene, frames, attrs = _room()
    rays_o, rays_d = _rays()
    cands, cnear, _n, _o, _td = select_candidates(
        rays_o, rays_d, cluster_bounds(frames, 256), jnp.float32(ZNEAR),
        jnp.float32(ZFAR), tile=256, max_clusters=8)
    return dict(rays_o=rays_o, rays_d=rays_d, gpack=pack_frames(frames, attrs),
                table=rk.pack_attr_table(attrs), candidates=cands,
                cand_near=cnear)


KW = dict(transmittance_threshold=SETTINGS.transmittance_threshold,
          eps_forward_normalization=SETTINGS.eps_forward_normalization,
          max_hits=16, cluster=256, tile=256)


@functools.cache
def _jax_out(secondary, with_alive):
    a = _inputs()
    alive = ((jnp.arange(a["rays_o"].shape[0]) % 2) == 0 if with_alive
             else None)
    return np.asarray(rk.pallas_render_culled(
        a["rays_o"], a["rays_d"], a["gpack"], a["table"], a["candidates"],
        a["cand_near"], jnp.float32(ZNEAR), jnp.float32(ZFAR), 3.0,
        secondary, SETTINGS.backfacing_max_dist,
        SETTINGS.backfacing_invalid_normal_threshold, interpret=True,
        alive=alive, **KW))


def _port_out(secondary, with_alive, fn=render_culled_table_reference,
              secondary_static=-1):
    a = {k: torch.tensor(np.asarray(v)) for k, v in _inputs().items()}
    R = a["rays_o"].shape[0]
    alive = (torch.arange(R) % 2) == 0 if with_alive else None
    return fn(a["rays_o"], a["rays_d"], a["gpack"], a["table"],
              a["candidates"], a["cand_near"], ZNEAR, ZFAR, 3.0, secondary,
              SETTINGS.backfacing_max_dist,
              SETTINGS.backfacing_invalid_normal_threshold, alive=alive,
              secondary_static=secondary_static, **KW).numpy()


def assert_lanes_match(out, ref):
    f = slice(0, layout.OUT_NUMACC)
    np.testing.assert_allclose(out[:, f], ref[:, f], rtol=1e-4, atol=5e-5)
    np.testing.assert_array_equal(out[:, layout.OUT_NUMACC:],
                                  ref[:, layout.OUT_NUMACC:])


@pytest.mark.parametrize("secondary", [0.0, 1.0])
def test_reference_matches_pallas(secondary):
    out = _port_out(secondary, False)
    assert out.shape == (1024, layout.OUT_LANES) and np.isfinite(out).all()
    assert_lanes_match(out, _jax_out(secondary, False))


def test_dead_rays_composite_nothing():
    out = _port_out(0.0, True)
    assert_lanes_match(out, _jax_out(0.0, True))
    dead = (np.arange(out.shape[0]) % 2) != 0
    # no hits: zero composite, T_final = full_T = 1
    assert np.all(out[dead, :layout.OUT_TFINAL] == 0.0)
    assert np.all(out[dead, layout.OUT_TFINAL] == 1.0)
    assert np.all(out[dead, layout.OUT_FULLT] == 1.0)
    assert out[~dead, layout.OUT_RGB:layout.OUT_RGB + 3].sum() > 0.0


@pytest.mark.parametrize("secondary", [0, 1])
def test_secondary_static_matches_dynamic_gate(secondary):
    dyn = _port_out(float(secondary), False)
    stat = _port_out(float(secondary), False, secondary_static=secondary)
    np.testing.assert_array_equal(stat, dyn)
    assert_lanes_match(stat, _jax_out(float(secondary), False))


def test_early_exit_matches_pallas():
    """Gaussians 3x larger close the room's gaps: whole tiles saturate and
    the pair-granular exit fires (cluster 128, 16 candidates)."""
    params = room_scene(2048)
    params["scaling"] = params["scaling"] + np.float32(np.log(3.0))
    scene = jgs.from_arrays(**params, pad_multiple=512)
    frames, attrs = jgs.build_frames(scene, SETTINGS.alpha_threshold,
                                     SETTINGS.exp_power, 1.0)
    perm = morton_order(frames)
    frames = jax.tree_util.tree_map(lambda a: a[perm], frames)
    attrs = jax.tree_util.tree_map(lambda a: a[perm], attrs)
    rays_o, rays_d = _rays()
    cands, cnear, _n, _o, _td = select_candidates(
        rays_o, rays_d, cluster_bounds(frames, 128), jnp.float32(ZNEAR),
        jnp.float32(ZFAR), tile=256, max_clusters=16)
    args = [rays_o, rays_d, pack_frames(frames, attrs),
            rk.pack_attr_table(attrs), cands, cnear]
    kw = dict(KW, cluster=128, secondary_static=0)
    tail = (ZNEAR, ZFAR, 3.0, 0.0, SETTINGS.backfacing_max_dist,
            SETTINGS.backfacing_invalid_normal_threshold)
    ref = np.asarray(rk.pallas_render_culled(*args, *tail, interpret=True,
                                             **kw))
    out = render_culled_table_reference(
        *(torch.tensor(np.asarray(a)) for a in args), *tail, **kw).numpy()
    assert_lanes_match(out, ref)
    listed = (np.asarray(cands) >= 0).sum(axis=1)
    assert (out[::256, layout.OUT_CHUNKS] < listed).any()


def test_wrapper_takes_plain_version_for_cpu_tensors():
    before = render_culled_table.launches
    a = _port_out(1.0, True, fn=render_culled_table)
    np.testing.assert_array_equal(a, _port_out(1.0, True))
    assert render_culled_table.launches == before
