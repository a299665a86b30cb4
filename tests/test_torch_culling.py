"""PyTorch port vs JAX package: Morton clustering and per-tile culling.

Candidate lists must be EQUAL (the kernel's early exit and every hit follow
from them), so the port sorts stably where JAX does; the near distances are
held to 1e-5 relative.  One scene duplicates means to exercise tie order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editable_gaussian_reflections_tpu.ops import culling as jc
from editable_gaussian_reflections_tpu.ops.camera_rays import (
    primary_ray_directions as j_rays,
)
from editable_gaussian_reflections_tpu.scene import gaussian_scene as jgs
from editable_gaussian_reflections_tpu.utils.synth import (
    room_camera,
    room_scene,
)
from editable_gaussian_reflections_tpu_torch.ops import culling as tc
from editable_gaussian_reflections_tpu_torch.scene import gaussian_scene as tgs

# the suite runs in several worker processes on shared cores: one torch
# thread per process keeps them from oversubscribing the CPU
torch.set_num_threads(1)

ALPHA_THRESHOLD, EXP_POWER = 0.005, 3.0


def _frames(params, pad_multiple=512):
    jscene = jgs.from_arrays(**params, pad_multiple=pad_multiple)
    jf, _ = jgs.build_frames(jscene, ALPHA_THRESHOLD, EXP_POWER, 1.0)
    tscene = tgs.from_numpy({f: np.asarray(getattr(jscene, f))
                             for f in jgs.GaussianScene._fields},
                            device="cpu")
    tf, _ = tgs.build_frames(tscene, ALPHA_THRESHOLD, EXP_POWER, 1.0)
    return jf, tf


def _duplicated_room():
    """Room whose means repeat in runs of 4 (equal Morton codes, equal
    cluster-center distances): only a stable sort keeps JAX's order."""
    params = room_scene(2048, seed=1)
    params["xyz"] = np.repeat(params["xyz"][::4], 4, axis=0)
    return params


SCENES = {"room": lambda: room_scene(2048), "duplicated": _duplicated_room}


@pytest.fixture(scope="module", params=sorted(SCENES))
def sorted_frames(request):
    jf, tf = _frames(SCENES[request.param]())
    jperm = np.asarray(jc.morton_order(jf))
    tperm = tc.morton_order(tf)
    jf = jax.tree_util.tree_map(lambda a: a[jperm], jf)
    return jperm, tperm, jf, tf.take(tperm)


def test_morton_order_matches(sorted_frames):
    jperm, tperm, _, _ = sorted_frames
    np.testing.assert_array_equal(tperm.numpy(), jperm)


@pytest.mark.parametrize("bits", [5, 10])
def test_morton_codes_match(bits):
    pts = np.random.default_rng(4).normal(size=(4096, 3)).astype(np.float32)
    lo, hi = pts.min(0), pts.max(0)
    ref = jc.morton_codes(jnp.asarray(pts), jnp.asarray(lo), jnp.asarray(hi),
                          bits=bits)
    port = tc.morton_codes(torch.from_numpy(pts), torch.from_numpy(lo),
                           torch.from_numpy(hi), bits=bits)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref).astype(np.int64))


@pytest.mark.parametrize("cluster", [128, 256])
def test_cluster_bounds_match(sorted_frames, cluster):
    _, _, jf, tf = sorted_frames
    jb = jc.cluster_bounds(jf, cluster)
    tb = tc.cluster_bounds(tf, cluster)
    np.testing.assert_array_equal(tb.any_valid.numpy(),
                                  np.asarray(jb.any_valid))
    np.testing.assert_allclose(tb.center.numpy(), np.asarray(jb.center),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tb.radius.numpy(), np.asarray(jb.radius),
                               rtol=1e-5)


def _rays(kind, H=32, W=32):
    eye, c2w = room_camera()
    perm, _ = jc.tile_pixel_order(H, W, 16, 16)
    d = np.asarray(j_rays(W, H, jnp.asarray(0.9), jnp.asarray(c2w))
                   ).reshape(-1, 3)[perm]
    o = np.broadcast_to(eye, d.shape).astype(np.float32)
    if kind == "secondary":
        # scattered origins and directions, like reflected rays
        rng = np.random.default_rng(6)
        o = (o + rng.normal(scale=0.5, size=o.shape)).astype(np.float32)
        d = rng.normal(size=d.shape)
        d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return np.ascontiguousarray(o), np.ascontiguousarray(d)


@pytest.mark.parametrize("kind,cluster,tile,mc,near", [
    ("primary", 256, 256, 8, 0.05),
    ("primary", 128, 64, 6, 0.05),     # overflow: farthest clusters drop
    ("secondary", 128, 256, 16, 0.0),
    ("secondary", 256, 128, 3, 0.0),   # overflow with t_drop
])
def test_select_candidates_match(sorted_frames, kind, cluster, tile, mc,
                                 near):
    _, _, jf, tf = sorted_frames
    o, d = _rays(kind)
    far = 50.0
    ref = jc.select_candidates(jnp.asarray(o), jnp.asarray(d),
                               jc.cluster_bounds(jf, cluster),
                               jnp.float32(near), jnp.float32(far),
                               tile=tile, max_clusters=mc)
    port = tc.select_candidates(torch.from_numpy(o), torch.from_numpy(d),
                                tc.cluster_bounds(tf, cluster), near, far,
                                tile=tile, max_clusters=mc)
    cands, cnear, num, overflow, t_drop = (np.asarray(a) for a in ref)
    np.testing.assert_array_equal(port[0].numpy(), cands)
    np.testing.assert_allclose(port[1].numpy(), cnear, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(port[2].numpy(), num)
    np.testing.assert_array_equal(port[3].numpy(), overflow)
    np.testing.assert_allclose(port[4].numpy(), t_drop, rtol=1e-5, atol=1e-6)
    if mc < 8:  # the overflow cases do drop clusters
        assert overflow.any() and np.isfinite(t_drop).any()


def test_tile_cones_and_visibility_match(sorted_frames):
    _, _, jf, tf = sorted_frames
    o, d = _rays("secondary")
    jcones = jc.tile_cones(jnp.asarray(o), jnp.asarray(d), 64)
    tcones = tc.tile_cones(torch.from_numpy(o), torch.from_numpy(d), 64)
    for a, b in zip(tcones, jcones):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    # per-tile depth windows, as the split-far passes use them
    near = np.linspace(0.0, 2.0, len(o) // 64).astype(np.float32)
    vis = tc.cone_sphere_visible(tcones, tc.cluster_bounds(tf, 128),
                                 torch.from_numpy(near), 50.0)
    ref = jc.cone_sphere_visible(jcones, jc.cluster_bounds(jf, 128),
                                 jnp.asarray(near), jnp.float32(50.0))
    np.testing.assert_array_equal(vis.numpy(), np.asarray(ref))


@pytest.mark.parametrize("shape", [(32, 32, 16), (48, 64, 8)])
def test_tile_pixel_order_matches(shape):
    H, W, t = shape
    for a, b in zip(tc.tile_pixel_order(H, W, t, t),
                    jc.tile_pixel_order(H, W, t, t)):
        np.testing.assert_array_equal(a, b)
