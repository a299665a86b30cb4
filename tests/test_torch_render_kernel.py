"""PyTorch port vs JAX package: the culled k-buffer render kernel.

render_culled_reference (the plain version of csrc/render_culled.cu) is
held against pallas_render_culled_v4 and pallas_render_culled_v3 in
interpret mode, on the 2048-Gaussian room at 32x32 rays, and on an exact
depth tie at the K-th slot that a later hit breaks.  Float lanes to
rtol 1e-4 / atol 5e-5 (the JAX package's own kernel tolerance); the counter
lanes (accumulated hits, traversed Gaussians, processed chunks) exactly,
since they record where the early exit happened.

The kernel itself runs only on a CUDA card: test_torch_render_kernel_cuda.py
compares it with this plain version there.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editable_gaussian_reflections_tpu.ops import culling as jc
from editable_gaussian_reflections_tpu.ops.camera_rays import (
    primary_ray_directions as j_rays,
)
from editable_gaussian_reflections_tpu.ops.pallas.render_kernel_v3 import (
    pallas_render_culled_v3,
    pallas_render_culled_v4,
)
from editable_gaussian_reflections_tpu.ops.pallas.trace_kernel import (
    pack_frames as j_pack,
)
from editable_gaussian_reflections_tpu.scene import gaussian_scene as jgs
from editable_gaussian_reflections_tpu.utils.synth import (
    room_camera,
    room_scene,
)
from editable_gaussian_reflections_tpu_torch.ops.cuda import layout
from editable_gaussian_reflections_tpu_torch.ops.cuda.render_kernel import (
    check_every_for,
    render_culled,
    render_culled_reference,
)

# the suite runs in several worker processes on shared cores: one torch
# thread per process keeps them from oversubscribing the CPU
torch.set_num_threads(1)

NEAR, FAR, BF_MAX_DIST, BF_THR = 0.05, 50.0, 0.1, 0.9
JAX_KERNELS = {"v4": (pallas_render_culled_v4, 8),
               "v3": (pallas_render_culled_v3, 4)}


@functools.cache
def _room(scale):
    """The 2048-Gaussian room, its Gaussians `scale` times larger (3x closes
    the gaps between them, so whole tiles saturate and exit early)."""
    params = room_scene(2048)
    params["scaling"] = params["scaling"] + np.float32(np.log(scale))
    scene = jgs.from_arrays(**params, pad_multiple=512)
    frames, attrs = jgs.build_frames(scene, 0.005, 3.0, 1.0)
    perm = jc.morton_order(frames)
    frames = jax.tree_util.tree_map(lambda a: a[perm], frames)
    attrs = jax.tree_util.tree_map(lambda a: a[perm], attrs)
    return frames, j_pack(frames, attrs)


def _rays(kind, H=32, W=32):
    eye, c2w = room_camera()
    perm, _ = jc.tile_pixel_order(H, W, 16, 16)
    d = np.asarray(j_rays(W, H, jnp.asarray(0.9), jnp.asarray(c2w))
                   ).reshape(-1, 3)[perm]
    o = np.broadcast_to(eye, d.shape).astype(np.float32)
    if kind == "secondary":
        # reflected-ray-like: origins spread over the room, scattered
        # directions (ray order = tile order, as after the re-sort)
        rng = np.random.default_rng(6)
        o = (o + rng.normal(scale=0.5, size=o.shape)).astype(np.float32)
        d = rng.normal(size=d.shape)
        d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return np.ascontiguousarray(o), np.ascontiguousarray(d)


def _alive(R, tile):
    alive = (np.arange(R) % 3) != 0
    alive[-tile:] = False          # one wholly dead tile: the dead-tile exit
    return alive


# (K, cluster, tile, rays, secondary_static, window_mode, alive, mc,
#  transmittance_threshold, JAX kernel, Gaussian scale)
CASES = {
    "k16_c256_primary_v4": (16, 256, 256, "primary", 0, 0, False, 8, 0.01,
                            "v4", 1.0),
    "k32_c128_primary_v3": (32, 128, 256, "primary", 0, 0, False, 16, 0.01,
                            "v3", 1.0),
    "k16_c128_secondary_alive_v4": (16, 128, 256, "secondary", 1, 0, True,
                                    16, 0.01, "v4", 1.0),
    "k32_c256_dynamic_gate_near_window_v3": (32, 256, 128, "secondary", -1,
                                             1, False, 8, 0.01, "v3", 1.0),
    "k16_c128_far_window_tile64_v4": (16, 128, 64, "secondary", 1, 2, True,
                                      12, 0.01, "v4", 1.0),
    "k16_c128_early_exit_v4": (16, 128, 256, "primary", 0, 0, False, 16,
                               0.01, "v4", 3.0),
    "k32_c128_early_exit_v3": (32, 128, 256, "primary", 0, 0, False, 16,
                               0.01, "v3", 3.0),
    "k16_c256_short_list_v4": (16, 256, 256, "primary", 0, 0, True, 3, 0.01,
                               "v4", 1.0),
}


def _keywords(case):
    """The kernel's keywords of a case (its K, cluster, tile, pass, window
    and threshold)."""
    K, cluster, tile, kind, ss, wmode, _alive, _mc, thr, _kern, _s = case
    return dict(near=NEAR if kind == "primary" else 0.0, far=FAR,
                exp_power=3.0, secondary=1.0 if ss else 0.0,
                backfacing_max_dist=BF_MAX_DIST,
                backfacing_invalid_normal_threshold=BF_THR,
                transmittance_threshold=thr, eps_forward_normalization=1e-12,
                max_hits=K, cluster=cluster, tile=tile, window_mode=wmode,
                secondary_static=ss)


def _inputs(case):
    K, cluster, tile, kind, ss, wmode, with_alive, mc, thr, kern, scale = case
    frames, gpack = _room(scale)
    o, d = _rays(kind)
    R = o.shape[0]
    near = NEAR if kind == "primary" else 0.0
    cands, cnear, _n, _o, _t = jc.select_candidates(
        jnp.asarray(o), jnp.asarray(d), jc.cluster_bounds(frames, cluster),
        jnp.float32(near), jnp.float32(FAR), tile=tile, max_clusters=mc)
    alive = _alive(R, tile) if with_alive else None
    t_split = (np.random.default_rng(7).uniform(1.0, 4.0, R).astype(np.float32)
               if wmode else None)
    args = dict(rays_o=o, rays_d=d, gpack=np.asarray(gpack),
                candidates=np.asarray(cands), cand_near=np.asarray(cnear),
                alive=alive, t_split=t_split)
    return args, _keywords(case), kern


def _jax_out(args, kw, kern):
    fn, _ = JAX_KERNELS[kern]
    a = {k: (None if v is None else jnp.asarray(v)) for k, v in args.items()}
    return np.asarray(fn(
        a["rays_o"], a["rays_d"], a["gpack"], a["candidates"],
        a["cand_near"], None, kw["near"], kw["far"], kw["exp_power"],
        kw["secondary"], kw["backfacing_max_dist"],
        kw["backfacing_invalid_normal_threshold"],
        transmittance_threshold=kw["transmittance_threshold"],
        eps_forward_normalization=kw["eps_forward_normalization"],
        max_hits=kw["max_hits"], cluster=kw["cluster"], tile=kw["tile"],
        interpret=True, alive=a["alive"], t_split=a["t_split"],
        window_mode=kw["window_mode"],
        secondary_static=kw["secondary_static"]))


def _port_out(args, kw, kern, fn=render_culled, device="cpu"):
    t = {k: (None if v is None else torch.tensor(v, device=device))
         for k, v in args.items()}
    kw = dict(kw)
    near, far, ep, sec, bfd, bft = (kw.pop(k) for k in (
        "near", "far", "exp_power", "secondary", "backfacing_max_dist",
        "backfacing_invalid_normal_threshold"))
    return fn(t["rays_o"], t["rays_d"], t["gpack"], t["candidates"],
              t["cand_near"], near, far, ep, sec, bfd, bft, alive=t["alive"],
              t_split=t["t_split"], check_every=JAX_KERNELS[kern][1], **kw)


def assert_lanes_match(out, ref):
    f = slice(0, layout.OUT_NUMACC)
    np.testing.assert_allclose(out[:, f], ref[:, f], rtol=1e-4, atol=5e-5)
    np.testing.assert_array_equal(out[:, layout.OUT_NUMACC:],
                                  ref[:, layout.OUT_NUMACC:])


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_pallas(case):
    args, kw, kern = _inputs(CASES[case])
    ref = _jax_out(args, kw, kern)
    out = _port_out(args, kw, kern).numpy()
    assert out.shape == (len(args["rays_o"]), layout.OUT_LANES)
    assert_lanes_match(out, ref)
    assert np.isfinite(out).all()
    if "early_exit" in case:
        # the group-granular exit fired: some tile processed fewer chunks
        # than its candidate list holds
        tile = kw["tile"]
        listed = (args["candidates"] >= 0).sum(axis=1)
        processed = ref[::tile, layout.OUT_CHUNKS]
        assert (processed < listed).any(), (processed, listed)
    if args["alive"] is not None:
        dead = ~args["alive"]
        assert np.all(out[dead, :layout.OUT_TFINAL] == 0.0)
        assert np.all(out[dead, layout.OUT_TFINAL] == 1.0)


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "apart"])
def test_boundary_tie_matches_pallas(shared):
    """An exact depth tie at the K-th slot that a later, nearer hit breaks
    (test_torch_trace_hits_cuda.boundary_tie_case: A red, B blue): the
    plain walk keeps the Gaussian pallas_render_culled_v4's drain keeps (A,
    not B: its ids), and the composite equals the Pallas kernel's."""
    from editable_gaussian_reflections_tpu_torch.ops.cuda.render_kernel import (
        walk_tiles)
    from test_torch_trace_hits_cuda import boundary_tie_case

    tie = boundary_tie_case(K=16, cluster=128, shared=shared)
    args = dict(rays_o=tie["rays_o"], rays_d=tie["rays_d"],
                gpack=tie["gpack"], candidates=tie["candidates"],
                cand_near=tie["cand_near"], alive=None, t_split=None)
    kw = dict(near=NEAR, far=FAR, exp_power=3.0, secondary=0.0,
              backfacing_max_dist=BF_MAX_DIST,
              backfacing_invalid_normal_threshold=BF_THR,
              transmittance_threshold=0.01, eps_forward_normalization=1e-12,
              max_hits=16, cluster=128, tile=256, window_mode=0,
              secondary_static=0)
    ref = _jax_out(args, kw, "v4")
    out = _port_out(args, kw, "v4").numpy()
    assert_lanes_match(out, ref)
    t = {k: torch.tensor(args[k]) for k in
         ("rays_o", "rays_d", "gpack", "candidates", "cand_near")}
    walk = list(walk_tiles(
        t["rays_o"], t["rays_d"], t["gpack"], t["candidates"],
        t["cand_near"], NEAR, FAR, 3.0, 0.0, BF_MAX_DIST, BF_THR,
        max_hits=16, cluster=128, tile=256, secondary_static=0))
    ids = walk[0][3]
    assert (ids == tie["a"]).any(dim=1).all()
    assert not (ids == tie["b"]).any()


def test_wrapper_takes_plain_version_for_cpu_tensors():
    args, kw, kern = _inputs(CASES["k16_c256_primary_v4"])
    before = render_culled.launches
    a = _port_out(args, kw, kern)
    b = _port_out(args, kw, kern, fn=render_culled_reference)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert render_culled.launches == before  # no kernel launched


def test_check_every_follows_the_jax_kernel_choice():
    # v4 (groups of 8) while the packed scene fits its resident budget
    assert check_every_for(100_352) == 8
    assert check_every_for(2_000_000) == 4
