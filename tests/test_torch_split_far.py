"""PyTorch port vs JAX package: split-far, the two-pass near/far bounce.

The four tests of tests/test_split_far.py on the port (its plain versions):
the render kernel's t-window partition combines exactly for an arbitrary
per-ray t_split; render_frame_fused(split_far=True) equals the single pass
at 0 and 2 bounces; the training step's merged near + far slots give the
single pass's forward and gradients at 0 and 2 bounces; a ray the near
pass saturates composites nothing from the far pass.  Tolerances are that
file's.

Then the port's split frame and split step against JAX's on the same
inputs (JAX's Pallas kernels in interpret mode, in a child process capped
at the AVX instruction set, as tests/test_torch_render_frame.py explains),
on scenes of several clusters, so that the cull decides something.  The
step traces JAX's own scene tables (hits at the clip radius flip with the
tables' last ulp, tests/test_torch_train_step.py): its outputs within 1e-5
and its gradients within tests/test_split_far.py's rule.  The frame builds
its own: within 1e-5 on every ray where neither starved at 0 bounces, and
at 2 bounces on all but 0.5% of them (near-mirror bounces grow an ulp
~10x a bounce, tests/test_torch_render_frame.py).  The port's cull is
conservative where JAX's is not (ops/culling.py cone_sphere_visible): a
ray where the two frames part is held against JAX's frame with every
cluster listed for every tile (its cull switched off), and the rays so
explained are named in the test's output.
"""

import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from editable_gaussian_reflections_tpu_torch.ops.culling import (
    ClusterBounds,
    cluster_bounds,
    morton_order,
    select_candidates,
)
from editable_gaussian_reflections_tpu_torch.ops.cuda.layout import (
    pack_attr_table,
    pack_frame_table,
    pack_frames,
    unpack_composite,
)
from editable_gaussian_reflections_tpu_torch.ops.cuda.render_kernel import (
    render_culled,
)
from editable_gaussian_reflections_tpu_torch.renderer import raytracer as trt
from editable_gaussian_reflections_tpu_torch.scene import gaussian_scene as tgs

torch.set_num_threads(1)

CAMERA = trt.CameraParams(
    origin=torch.zeros(3),
    c2w=torch.tensor(np.diag([1.0, 1.0, -1.0]).astype(np.float32)),
    fov_y=0.9, znear=0.1, zfar=100.0)
SIDE = 32
# the JAX comparisons: the frame on 13 clusters of 128 Gaussians (the blob
# and the shell; candidate budgets above 13, so that no list overflows and
# the cull alone decides), the step on 3
FRAME_SCENE, STEP_SCENE = (600, 1000), (200, 120)
FRAME_KW = dict(max_hits=16, jitter=False, cull_cluster=128, max_clusters=8,
                rays_per_call=1024, split_far=True, mc_far=8,
                max_hits_far=8)
STEP_R = 512
STEP_KW = dict(cull_tile=256, cull_cluster=128, max_clusters=8)
STEP_SPLIT = dict(split_far=True, mc_far=8, max_hits_far=16)
JAX_FRAME_KW = dict(FRAME_KW, max_clusters=16, mc_far=16)
# the lanes the frame's composite keeps over its kept hits (full_T also
# counts hits behind the K-th, up to where a tile's exit stops its rays)
KEPT = ("rgb", "depth", "transmittance", "normal", "roughness", "f0")


def scene_arrays(rng, n_near=48, n_far=24):
    """tests/test_split_far.py's scene: a near blob at z~5 plus a far cloud
    at radius ~40."""
    shell = rng.normal(size=(n_far, 3))
    shell = shell / np.linalg.norm(shell, axis=1, keepdims=True) * 40.0
    xyz = np.concatenate([rng.normal(0, 1.5, (n_near, 3)) + [0, 0, 5],
                          shell]).astype(np.float32)
    n = n_near + n_far
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return dict(
        xyz=xyz,
        scaling=rng.uniform(np.log(0.3), np.log(1.2), (n, 3)).astype(
            np.float32),
        rotation=np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)),
        opacity=rng.uniform(-1.5, 0.5, n).astype(np.float32),
        diffuse=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        normal=nrm.astype(np.float32),
        f0=np.full((n, 3), 0.04, np.float32),
        roughness=rng.uniform(0.1, 0.9, n).astype(np.float32))


def _scene(params):
    return tgs.from_arrays(**params, pad_multiple=128, device="cpu")


def _random_rays(rng, R):
    o = rng.normal(0, 0.5, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _step_targets(rng, R):
    return dict(
        diffuse=rng.uniform(0, 1, (R, 3)).astype(np.float32),
        specular=rng.uniform(0, 0.3, (R, 3)).astype(np.float32),
        depth=rng.uniform(1, 5, (R,)).astype(np.float32),
        normal=rng.normal(size=(R, 3)).astype(np.float32),
        roughness=rng.uniform(0, 1, (R,)).astype(np.float32),
        f0=rng.uniform(0, 1, (R, 3)).astype(np.float32))


def _frame_samples(num_bounces, seed=0):
    us = np.random.default_rng(seed).uniform(
        0, 1, (num_bounces + 1, SIDE * SIDE, 2)).astype(np.float32)
    return us


def _sorted_tables(scene, settings):
    frames, attrs = tgs.build_frames(scene, settings.alpha_threshold,
                                     settings.exp_power,
                                     settings.global_scale_factor)
    perm = morton_order(frames)
    frames, attrs = frames.take(perm), attrs.take(perm)
    scene_s = tgs.GaussianScene(*(a[perm] for a in scene))
    return dict(gpack=pack_frames(frames, attrs).contiguous(),
                table=pack_attr_table(attrs).contiguous(),
                ftable=pack_frame_table(frames, scene_s).contiguous(),
                bounds=cluster_bounds(frames, 128))


def _step(params, rays, targets, us, num_bounces, tables=None, **kw):
    settings = trt.RenderSettings(transmittance_threshold=1e-8)
    scene = _scene(params)
    tables = tables or _sorted_tables(scene, settings)
    return trt.render_tile_with_grads_fused(
        torch.tensor(rays[0]), torch.tensor(rays[1]),
        trt.RayTargets(**{k: torch.tensor(v) for k, v in targets.items()}),
        settings, 0.1, 100.0, torch.tensor(us[:num_bounces + 1]),
        num_bounces, 16, n_capacity=scene.capacity, **STEP_KW, **tables,
        **kw)


def _frame(params, num_bounces, settings, us=None, **kw):
    us = torch.tensor(_frame_samples(num_bounces) if us is None else us)
    return trt.render_frame_fused(
        _scene(params), CAMERA, settings, None, SIDE, SIDE,
        num_bounces=num_bounces,
        samples=trt.FrameSamples(jitter=None, us=us), **kw)


# -- the four tests of tests/test_split_far.py, on the port ---------------


def test_kernel_t_window_partition_combines_exactly():
    """near (t < ts) + far (t > ts) == the single pass, ray by ray, for an
    arbitrary positive per-ray t_split (not even a sphere's)."""
    rng = np.random.default_rng(1)
    settings = trt.RenderSettings(transmittance_threshold=1e-8)
    tables = _sorted_tables(_scene(scene_arrays(rng)), settings)
    R, tile = 512, 256
    o, d = (torch.tensor(a) for a in _random_rays(rng, R))
    t_split = torch.tensor(rng.uniform(2.0, 60.0, R).astype(np.float32))

    def pass_(wmode, cull_near, cull_far):
        cands, cnear, _n, _o, _t = select_candidates(
            o, d, tables["bounds"], cull_near, cull_far, tile=tile,
            max_clusters=8)
        out = render_culled(
            o, d, tables["gpack"], cands, cnear, 0.1, 100.0, 3.0, 0.0,
            settings.backfacing_max_dist,
            settings.backfacing_invalid_normal_threshold,
            transmittance_threshold=1e-8, max_hits=32, cluster=128,
            tile=tile, t_split=t_split, window_mode=wmode)
        return unpack_composite(out)

    single = pass_(0, 0.1, 100.0)
    near = pass_(1, *trt.window_bounds(0.1, 100.0, t_split, 1, tile))
    far = pass_(2, *trt.window_bounds(0.1, 100.0, t_split, 2, tile))
    fTn = near["full_T"]

    def close(a, b, atol):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=atol)

    close(near["rgb"] + fTn[:, None] * far["rgb"], single["rgb"], 1e-6)
    close(near["depth"] + fTn * far["depth"], single["depth"], 1e-5)
    close(fTn * far["full_T"], single["full_T"], 1e-7)
    close(near["T_final"] * far["T_final"], single["T_final"], 1e-7)
    assert (near["num_accumulated"] > 0).any()
    assert (far["num_accumulated"] > 0).any()


@pytest.mark.parametrize("bounces", [0, 2])
def test_frame_split_far_matches_single_pass(bounces):
    """render_frame_fused(split_far=True) == split_far=False with ample K
    and candidates (the split sphere from the live means, the whole bounce
    loop with the GGX epilogue and the starved flags); max_hits_far 8
    differs from the near K."""
    params = scene_arrays(np.random.default_rng(2))
    settings = trt.RenderSettings(transmittance_threshold=1e-8)
    kw = dict(FRAME_KW, split_far=False)
    s0, f0 = _frame(params, bounces, settings, **kw)
    s1, f1 = _frame(params, bounces, settings, **FRAME_KW)
    torch.testing.assert_close(f1, f0, rtol=1e-5, atol=1e-5)
    for name in ("rgb", "depth", "transmittance", "total_transmittance",
                 "normal", "roughness", "alive"):
        torch.testing.assert_close(getattr(s1, name), getattr(s0, name),
                                   rtol=1e-5, atol=1e-5, msg=name)


@pytest.mark.parametrize("bounces", [0, 2])
def test_training_split_far_matches_single_pass_grads(bounces):
    """render_tile_with_grads_fused(split_far=True): the merged near + far
    slots give the single pass's forward and loss-fused gradients when both
    passes have room (the threshold tiny, so the aliveness gate never
    parts them)."""
    rng = np.random.default_rng(4)
    params = scene_arrays(rng)
    rays = _random_rays(rng, STEP_R)
    targets = _step_targets(rng, STEP_R)
    us = rng.uniform(0, 1, (3, STEP_R, 2)).astype(np.float32)
    s0, f0, g0 = _step(params, rays, targets, us, bounces)
    s1, f1, g1 = _step(params, rays, targets, us, bounces, **STEP_SPLIT)
    torch.testing.assert_close(f1, f0, rtol=1e-5, atol=1e-5)
    for name in ("rgb", "depth", "transmittance", "total_transmittance",
                 "normal", "roughness"):
        torch.testing.assert_close(getattr(s1, name), getattr(s0, name),
                                   rtol=1e-5, atol=1e-5, msg=name)
    for f in g0._fields:
        a, b = getattr(g1, f), getattr(g0, f)
        scale = max(1e-6, float(b.abs().max()))
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5 * scale,
                                   msg=f"grads.{f}")


def test_split_far_saturated_rays_skip_far_pass():
    """A ray the near pass saturates composites nothing from the far pass:
    an opaque black wall in front of a bright far shell stays black."""
    rng = np.random.default_rng(3)
    n_wall = 64
    shell = rng.normal(size=(64, 3))
    xyz = np.concatenate([
        rng.uniform(-4, 4, (n_wall, 3)) * [1, 1, 0] + [0, 0, 6],
        shell / np.linalg.norm(shell, axis=1, keepdims=True) * 40.0,
    ]).astype(np.float32)
    n = xyz.shape[0]
    params = dict(
        xyz=xyz, scaling=np.full((n, 3), np.log(1.0), np.float32),
        rotation=np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)),
        opacity=np.full(n, 8.0, np.float32),
        diffuse=np.concatenate([np.zeros((n_wall, 3), np.float32),
                                np.ones((n - n_wall, 3), np.float32)]),
        normal=np.tile(np.array([0, 0, -1], np.float32), (n, 1)),
        f0=np.full((n, 3), 0.04, np.float32),
        roughness=np.full(n, 0.5, np.float32))
    steps, final = _frame(params, 0, trt.RenderSettings(),
                          **dict(FRAME_KW, max_hits_far=0))
    final = final.reshape(SIDE, SIDE, 3)
    tt = steps.total_transmittance[0].reshape(SIDE, SIDE)
    assert tt[16, 16] < 0.01
    assert (final[12:20, 12:20] < 1e-3).all()


def test_split_passes_report_their_starved_flags():
    """Each split bounce reports its two passes' starved flags beside the
    bounce's: fused_forward's SplitCalls (the near and far slots calls,
    windows 1 and 2) and split_bounce's per-pass composites, whose larger
    flag is the bounce's overflow."""
    rng = np.random.default_rng(4)
    params = scene_arrays(rng)
    o, d = _random_rays(rng, STEP_R)
    us = rng.uniform(0, 1, (3, STEP_R, 2)).astype(np.float32)
    settings = trt.RenderSettings(transmittance_threshold=1e-8)
    scene = _scene(params)
    steps, _final, _res, calls = trt.fused_forward(
        torch.tensor(o), torch.tensor(d), settings, 0.1, 100.0,
        torch.tensor(us), 2, 16, n_capacity=scene.capacity, **STEP_KW,
        **_sorted_tables(scene, settings), **STEP_SPLIT)
    assert len(calls) == 3
    for step, c in enumerate(calls):
        assert isinstance(c, trt.SplitCalls)
        assert (c.near.kwargs["window_mode"], c.far.kwargs["window_mode"]) \
            == (1, 2)
        assert c.starved_near.shape == c.starved_far.shape == (STEP_R,)
        torch.testing.assert_close(
            torch.maximum(c.starved_near, c.starved_far).to(
                steps.overflow.dtype), steps.overflow[step])
    seen, real = [], trt.split_bounce

    def split_bounce(*args, **kwargs):
        seen.append(real(*args, **kwargs))
        return seen[-1]

    with mock.patch.object(trt, "split_bounce", split_bounce):
        _frame(params, 2, settings, **FRAME_KW)
    assert len(seen) == 3
    for _comp, starved, (near, far) in seen:
        torch.testing.assert_close(
            torch.maximum(near["starved"], far["starved"]), starved)


# -- against JAX ------------------------------------------------------------


def jax_reference(path):
    """JAX's split frames (0 and 2 bounces; culled, and with every cluster
    listed) and split steps (0 and 2 bounces) on the three-cluster scene,
    in interpret mode, saved to `path`.  Run by jax_ref in a child."""
    import jax
    import jax.numpy as jnp

    from editable_gaussian_reflections_tpu.ops import culling as jc
    from editable_gaussian_reflections_tpu.ops.pallas.render_kernel import (
        pack_attr_table as j_attr_table,
        pack_frame_table as j_frame_table,
    )
    from editable_gaussian_reflections_tpu.ops.pallas.trace_kernel import (
        pack_frames as j_pack,
    )
    from editable_gaussian_reflections_tpu.renderer import raytracer as jrt
    from editable_gaussian_reflections_tpu.scene import gaussian_scene as jgs

    out = {}
    rng = np.random.default_rng(11)
    params = scene_arrays(rng, *FRAME_SCENE)
    out.update({f"frame_params/{k}": v for k, v in params.items()})
    scene = jgs.from_arrays(**params, pad_multiple=128)
    settings = jrt.RenderSettings(transmittance_threshold=1e-8)
    cam = jrt.CameraParams(
        origin=jnp.zeros(3), c2w=jnp.asarray(np.diag([1.0, 1.0, -1.0]),
                                             jnp.float32),
        fov_y=jnp.asarray(0.9), znear=jnp.asarray(0.1),
        zfar=jnp.asarray(100.0))

    # the GGX uniforms render_frame_fused draws from the key
    # (raytracer.py:906-911), in linear pixel order, for the port
    key = jax.random.PRNGKey(0)
    key_t = jax.random.fold_in(jax.random.split(key)[1], 0)
    us = []
    for _ in range(3):
        key_t, kstep = jax.random.split(key_t)
        us.append(np.asarray(jax.random.uniform(kstep, (SIDE * SIDE, 2),
                                                jnp.float32)))
    out["frame_us"] = np.stack(us)

    def frames(tag):
        for nb in (0, 2):
            steps, final = jrt.render_frame_fused(
                scene, cam, settings, key, SIDE, SIDE, num_bounces=nb,
                interpret=True, **JAX_FRAME_KW)
            out[f"{tag}{nb}/final"] = np.asarray(final)
            for f in steps._fields:
                out[f"{tag}{nb}/{f}"] = np.asarray(getattr(steps, f))

    frames("frame")
    # every cluster listed for every tile (a new trace reads the module's
    # name; the caches hold the culled traces)
    real_vis = jc.cone_sphere_visible
    jax.clear_caches()
    jc.cone_sphere_visible = (
        lambda cones, bounds, near, far: jnp.broadcast_to(
            bounds.any_valid[None, :],
            (cones.origin.shape[0], bounds.any_valid.shape[0])))
    try:
        frames("unculled")
    finally:
        jc.cone_sphere_visible = real_vis
        jax.clear_caches()

    # the split step on random rays
    params = scene_arrays(rng, *STEP_SCENE)
    out.update({f"step_params/{k}": v for k, v in params.items()})
    scene = jgs.from_arrays(**params, pad_multiple=128)
    rays = _random_rays(rng, STEP_R)
    targets = _step_targets(rng, STEP_R)
    out.update(rays_o=rays[0], rays_d=rays[1])
    out.update({f"targets/{k}": v for k, v in targets.items()})

    @jax.jit
    def prepared(scene):
        # one compile for the whole preparation (op by op, XLA would
        # compile every eager operation on its own)
        frames, attrs = jgs.build_frames(scene, settings.alpha_threshold,
                                         settings.exp_power,
                                         settings.global_scale_factor)
        perm = jc.morton_order(frames)
        frames, attrs, scene_s = jax.tree_util.tree_map(
            lambda a: a[perm], (frames, attrs, scene))
        return dict(gpack=j_pack(frames, attrs), table=j_attr_table(attrs),
                    ftable=j_frame_table(frames, scene_s),
                    bounds=jc.cluster_bounds(frames, 128))

    tables = prepared(scene)
    for k in ("gpack", "table", "ftable"):
        out[f"tables/{k}"] = np.asarray(tables[k])
    for f in tables["bounds"]._fields:
        out[f"tables/bounds/{f}"] = np.asarray(getattr(tables["bounds"], f))
    key = jax.random.PRNGKey(7)
    us, k = [], key
    for _ in range(3):
        k, kstep = jax.random.split(k)
        us.append(np.asarray(jax.random.uniform(kstep, (STEP_R, 2),
                                                jnp.float32)))
    out["step_us"] = np.stack(us)
    tg = jrt.RayTargets(**{f: jnp.asarray(v) for f, v in targets.items()})
    for nb in (0, 2):
        # under jit, as the JAX package's training loop runs it: one
        # compile instead of one per eager operation
        step = jax.jit(lambda ro, rd, tg, key, arrays, nb=nb: (
            jrt.render_tile_with_grads_fused(
                ro, rd, tg, settings, jnp.float32(0.1), jnp.float32(100.0),
                key, nb, 16, n_capacity=scene.capacity, interpret=True,
                **STEP_KW, **arrays, **STEP_SPLIT)))
        steps, final, g = step(jnp.asarray(rays[0]), jnp.asarray(rays[1]),
                               tg, key, tables)
        out[f"step{nb}/final"] = np.asarray(final)
        for f in steps._fields:
            out[f"step{nb}/{f}"] = np.asarray(getattr(steps, f))
        for f in g._fields:
            out[f"step{nb}/grads/{f}"] = np.asarray(getattr(g, f))
    np.savez(path, **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_split_far") / "ref.npz"
    root = str(Path(__file__).resolve().parents[1])
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_cpu_max_isa=AVX").strip(),
               PYTHONPATH=os.pathsep.join(
                   p for p in (root, os.environ.get("PYTHONPATH")) if p))
    subprocess.run([sys.executable, __file__, str(path)], env=env, check=True,
                   timeout=600)
    with np.load(path) as data:
        return dict(data)


def _ref_params(ref, which):
    return {k.split("/", 1)[1]: v for k, v in ref.items()
            if k.startswith(f"{which}_params/")}


@pytest.mark.parametrize("bounces", [0, 2])
def test_split_frame_matches_jax(bounces, jax_ref):
    """The port's split frame against JAX's on the same samples: every
    ray where neither starved within 1e-5; a ray where they part must be
    one where JAX's cull dropped a hit, so the port equals JAX's frame with
    every cluster listed there (its kept lanes)."""
    settings = trt.RenderSettings(transmittance_threshold=1e-8)
    steps, final = _frame(_ref_params(jax_ref, "frame"), bounces, settings,
                          us=jax_ref["frame_us"][:bounces + 1],
                          **JAX_FRAME_KW)
    assert float(steps.overflow.mean()) < 0.05
    ok = ((steps.overflow.numpy() == 0)
          & (jax_ref[f"frame{bounces}/overflow"] == 0)).all(axis=0)
    assert ok.mean() > 0.95, ok.mean()

    def parts(tag, names):
        bad = np.zeros(ok.shape, bool)
        for f in names:
            a = getattr(steps, f).numpy()
            b = jax_ref[f"{tag}{bounces}/{f}"]
            far = np.abs(a - b) > 1e-5 + 1e-5 * np.abs(b)
            bad |= far.reshape(far.shape[0], far.shape[1], -1).any(
                axis=(0, 2))
        return bad & ok

    culled = parts("frame", KEPT + ("total_transmittance",))
    explained = culled & ~parts("unculled", KEPT)
    print(f"bounces {bounces}: rays where JAX's cull dropped a hit the "
          f"port keeps: {np.flatnonzero(explained).tolist()}")
    unexplained = culled & ~explained
    assert unexplained.sum() <= (0 if bounces == 0 else 0.005 * ok.sum()), \
        np.flatnonzero(unexplained)
    same = ok & ~culled
    np.testing.assert_allclose(final.numpy()[same],
                               jax_ref[f"frame{bounces}/final"][same],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bounces", [0, 2])
def test_split_step_matches_jax(bounces, jax_ref):
    """The port's split step (near K 16, far K 16) against JAX's on the
    same rays, targets, uniforms and scene tables: the outputs within 1e-5,
    the gradients within tests/test_split_far.py's rule."""
    rays = (jax_ref["rays_o"], jax_ref["rays_d"])
    targets = {k.split("/", 1)[1]: v for k, v in jax_ref.items()
               if k.startswith("targets/")}
    tables = {k: torch.tensor(jax_ref[f"tables/{k}"])
              for k in ("gpack", "table", "ftable")}
    tables["bounds"] = ClusterBounds(*(
        torch.tensor(jax_ref[f"tables/bounds/{f}"])
        for f in ClusterBounds._fields))
    steps, final, grads = _step(_ref_params(jax_ref, "step"), rays, targets,
                                jax_ref["step_us"], bounces, tables=tables,
                                **STEP_SPLIT)
    np.testing.assert_allclose(final.numpy(),
                               jax_ref[f"step{bounces}/final"], rtol=1e-5,
                               atol=1e-5)
    for name in ("rgb", "depth", "transmittance", "total_transmittance",
                 "normal", "roughness", "overflow"):
        np.testing.assert_allclose(getattr(steps, name).numpy(),
                                   jax_ref[f"step{bounces}/{name}"],
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    for f in grads._fields:
        a, b = getattr(grads, f).numpy(), jax_ref[f"step{bounces}/grads/{f}"]
        scale = max(1e-6, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5 * scale,
                                   err_msg=f"grads.{f}")


if __name__ == "__main__":
    jax_reference(sys.argv[1])
