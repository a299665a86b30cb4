"""PyTorch port vs JAX package: Morton clustering and per-tile culling.

Candidate lists must be EQUAL where JAX's cull is conservative (the narrow
cones of primary passes: the kernel's early exit and every hit follow from
the lists), so the port sorts stably where JAX does; the near distances are
held to 1e-5 relative.  One scene duplicates means to exercise tie order.

The port's cone test is conservative for every cone (ops/culling.py
cone_sphere_visible), where JAX's drops clusters of wide cones and of depth
windows that start beyond 0: there its visible sets are a superset of
JAX's, and a witness holds them against an exact per-ray ray-sphere test
over (near, far)."""

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


def _visible(o, d, bounds, near, far, tile):
    """The port's visibility as select_candidates computes it (WIDE)."""
    cones = tc.tile_cones(torch.from_numpy(o).to(torch.float64),
                          torch.from_numpy(d).to(torch.float64), tile)
    b = tc.ClusterBounds(bounds.center.to(torch.float64),
                         bounds.radius.to(torch.float64), bounds.any_valid)
    return tc.cone_sphere_visible(cones, b, near, far).numpy()


def _ray_sphere_hits(o, d, center, radius, near, far):
    """[R, NC] exact: does ray r meet sphere c at some t in (near, far)?
    float64; near / far scalars or per-ray [R]."""
    o, d = o.astype(np.float64), d.astype(np.float64)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    rel = center.astype(np.float64)[None] - o[:, None]
    tc_ = np.sum(rel * d[:, None], axis=-1)
    h2 = radius.astype(np.float64)[None] ** 2 - np.sum(rel * rel, -1) \
        + tc_ ** 2
    h = np.sqrt(np.maximum(h2, 0.0))
    near = np.broadcast_to(np.asarray(near, np.float64), (len(o),))[:, None]
    far = np.broadcast_to(np.asarray(far, np.float64), (len(o),))[:, None]
    return (h2 >= 0) & (np.maximum(tc_ - h, near) < np.minimum(tc_ + h, far))


def _witness(vis, o, d, center, radius, valid, near, far, tile):
    """No ray misses, in its tile's visible set, a valid sphere it hits."""
    hits = _ray_sphere_hits(o, d, center, radius, near, far) & valid[None]
    missing = hits & ~np.repeat(vis, tile, axis=0)
    assert not missing.any(), (
        f"{int(missing.any(axis=1).sum())} of {len(o)} rays miss a sphere "
        "they hit")


SELECT_CASES = [
    ("primary", 256, 256, 8, 0.05),
    ("primary", 128, 64, 6, 0.05),     # overflow: farthest clusters drop
    ("secondary", 128, 256, 16, 0.0),
    ("secondary", 256, 128, 3, 0.0),   # overflow with t_drop
]


@pytest.mark.parametrize("kind,cluster,tile,mc,near", SELECT_CASES)
def test_select_candidates_match(sorted_frames, kind, cluster, tile, mc,
                                 near):
    """Primary (narrow cones): the lists equal JAX's.  Secondary (random
    directions: cones near 180 degrees, where JAX's angle test wraps): the
    visible sets are a superset of JAX's and pass the witness, and the
    lists are the port's own visible set nearest first, cut at mc."""
    _, _, jf, tf = sorted_frames
    o, d = _rays(kind)
    far = 50.0
    ref = jc.select_candidates(jnp.asarray(o), jnp.asarray(d),
                               jc.cluster_bounds(jf, cluster),
                               jnp.float32(near), jnp.float32(far),
                               tile=tile, max_clusters=mc)
    tb = tc.cluster_bounds(tf, cluster)
    port = tc.select_candidates(torch.from_numpy(o), torch.from_numpy(d),
                                tb, near, far, tile=tile, max_clusters=mc)
    cands, cnear, num, overflow, t_drop = (np.asarray(a) for a in ref)
    if kind == "primary":
        np.testing.assert_array_equal(port[0].numpy(), cands)
        np.testing.assert_allclose(port[1].numpy(), cnear, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(port[2].numpy(), num)
        np.testing.assert_array_equal(port[3].numpy(), overflow)
        np.testing.assert_allclose(port[4].numpy(), t_drop, rtol=1e-5,
                                   atol=1e-6)
        if mc < 8:  # the overflow cases do drop clusters
            assert overflow.any() and np.isfinite(t_drop).any()
        return
    vis = _visible(o, d, tb, near, far, tile)
    jvis = np.zeros_like(vis)
    for t, row in enumerate(cands):
        jvis[t, row[row >= 0]] = True
    assert vis[jvis].all(), "a JAX candidate is not visible in the port"
    _witness(vis, o, d, tb.center.numpy(), tb.radius.numpy(),
             tb.any_valid.numpy(), near, far, tile)
    n_vis = vis.sum(axis=1)
    np.testing.assert_array_equal(port[2].numpy(), np.minimum(n_vis, mc))
    np.testing.assert_array_equal(port[3].numpy(), n_vis > mc)
    assert (port[2].numpy() >= num).all()
    got = port[0].numpy()
    for t in range(len(got)):
        listed = got[t][got[t] >= 0]
        assert vis[t, listed].all() and len(set(listed)) == len(listed)
        near_d = port[1].numpy()[t][:len(listed)]
        assert (np.diff(near_d) >= 0).all()      # nearest first
        # nothing unlisted is nearer than the list's last entry
        if n_vis[t] > mc:
            assert port[4].numpy()[t] >= near_d[-1]
    if mc < 8:
        assert port[3].numpy().any() and np.isfinite(port[4].numpy()).any()


@pytest.mark.parametrize("kind,cluster,tile,mc,near", SELECT_CASES)
def test_lists_superset_of_jax(sorted_frames, kind, cluster, tile, mc, near):
    """On select_candidates' inputs: every cluster JAX's cone test keeps,
    the port's keeps (equal sets on the primary cases), and the port's
    sets pass the exact per-ray witness."""
    _, _, jf, tf = sorted_frames
    o, d = _rays(kind)
    jcones = jc.tile_cones(jnp.asarray(o), jnp.asarray(d), tile)
    jvis = np.asarray(jc.cone_sphere_visible(
        jcones, jc.cluster_bounds(jf, cluster), jnp.float32(near),
        jnp.float32(50.0)))
    tb = tc.cluster_bounds(tf, cluster)
    vis = _visible(o, d, tb, near, 50.0, tile)
    assert vis[jvis].all()
    if kind == "primary":
        np.testing.assert_array_equal(vis, jvis)
    _witness(vis, o, d, tb.center.numpy(), tb.radius.numpy(),
             tb.any_valid.numpy(), near, 50.0, tile)


def test_tile_cones_and_visibility_match(sorted_frames):
    """The cones equal JAX's; with per-tile depth windows starting beyond 0
    (the split-far far pass) on wide cones, the visible sets are a superset
    of JAX's and pass the witness."""
    _, _, jf, tf = sorted_frames
    o, d = _rays("secondary")
    jcones = jc.tile_cones(jnp.asarray(o), jnp.asarray(d), 64)
    tcones = tc.tile_cones(torch.from_numpy(o), torch.from_numpy(d), 64)
    for a, b in zip(tcones, jcones):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    # per-tile depth windows, as the split-far passes use them
    near = np.linspace(0.0, 2.0, len(o) // 64).astype(np.float32)
    tb = tc.cluster_bounds(tf, 128)
    vis = tc.cone_sphere_visible(tcones, tb, torch.from_numpy(near),
                                 50.0).numpy()
    ref = np.asarray(jc.cone_sphere_visible(
        jcones, jc.cluster_bounds(jf, 128), jnp.asarray(near),
        jnp.float32(50.0)))
    assert vis[ref].all()
    _witness(vis, o, d, tb.center.numpy(), tb.radius.numpy(),
             tb.any_valid.numpy(), np.repeat(near, 64), 50.0, 64)


def _cone_rays(seed, half_deg, origin_spread, T=64, tile=64):
    """T tiles of `tile` rays: directions uniform within half_deg of a
    random axis, origins at a random point plus a spread."""
    rng = np.random.default_rng(seed)
    d = []
    for a in rng.normal(size=(T, 3)):
        a = a / np.linalg.norm(a)
        u = np.cross(a, [1.0, 0, 0] if abs(a[0]) < 0.9 else [0, 1.0, 0])
        u /= np.linalg.norm(u)
        w = np.cross(a, u)
        ct = rng.uniform(np.cos(np.radians(half_deg)), 1.0, tile)
        st = np.sqrt(1.0 - ct * ct)
        ph = rng.uniform(0.0, 2 * np.pi, tile)
        d.append(ct[:, None] * a + st[:, None] * (
            np.cos(ph)[:, None] * u + np.sin(ph)[:, None] * w))
    d = np.concatenate(d)
    o = (np.repeat(rng.normal(size=(T, 3)), tile, axis=0)
         + rng.normal(scale=origin_spread, size=d.shape))
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("half_deg,near,spread", [
    (170.0, 0.0, 0.0),     # wide cones at near 0 (reflected passes)
    (170.0, 0.0, 0.3),     # ... with origins spread
    (50.0, 3.0, 0.0),      # cones to 50 degrees, a window beyond 0
    (170.0, 3.0, 0.0),     # wide cones, a window beyond 0
    (20.0, 3.0, 0.1),      # narrow cones (primary-like), beyond 0
    (20.0, 0.0, 0.0),
])
def test_cone_cull_witness(half_deg, near, spread):
    """No ray misses, in its tile's list, a sphere it hits within (near,
    far): 400 random spheres, tiles of 64 rays, any cone width."""
    o, d = _cone_rays(int(half_deg + 10 * near + 100 * spread), half_deg,
                      spread)
    rng = np.random.default_rng(7)
    center = rng.uniform(-8.0, 8.0, (400, 3)).astype(np.float32)
    radius = rng.uniform(0.1, 1.5, 400).astype(np.float32)
    bounds = tc.ClusterBounds(torch.from_numpy(center),
                              torch.from_numpy(radius),
                              torch.ones(400, dtype=torch.bool))
    vis = _visible(o, d, bounds, near, 50.0, 64)
    _witness(vis, o, d, center, radius, np.ones(400, bool), near, 50.0, 64)
    # and a superset of JAX's cull on the same cones
    jcones = jc.tile_cones(jnp.asarray(o), jnp.asarray(d), 64)
    jvis = np.asarray(jc.cone_sphere_visible(
        jcones, jc.ClusterBounds(jnp.asarray(center), jnp.asarray(radius),
                                 jnp.ones(400, bool)),
        jnp.float32(near), jnp.float32(50.0)))
    assert vis[jvis].all()
    # through select_candidates (WIDE cones, no cap): the same sets
    cands = tc.select_candidates(torch.from_numpy(o), torch.from_numpy(d),
                                 bounds, near, 50.0, tile=64,
                                 max_clusters=400)[0].numpy()
    listed = np.zeros_like(vis)
    for t, row in enumerate(cands):
        listed[t, row[row >= 0]] = True
    np.testing.assert_array_equal(listed, vis)


@pytest.mark.parametrize("shape", [(32, 32, 16), (48, 64, 8)])
def test_tile_pixel_order_matches(shape):
    H, W, t = shape
    for a, b in zip(tc.tile_pixel_order(H, W, t, t),
                    jc.tile_pixel_order(H, W, t, t)):
        np.testing.assert_array_equal(a, b)
