"""PyTorch port vs JAX package: the training step's forward composite and
loss-fused backward.

  * composite, backward_step, scatter_grads and loss_gradients_per_step on
    seeded [R, K] inputs: every output within 1e-5 relative
    (|a - b| <= 1e-5 * |b| + 1e-5 * scale, scale = max(1, max |b|));
  * render_tile_with_grads_fused on the 2048-Gaussian room, 32x32 primary
    rays, K=16, JAX's own tables and GGX uniforms: at 0 bounces every
    gradient field within rtol 2e-4, atol 2e-5 * scale (scale = max |b|),
    the JAX package's own rule (tests/test_render_kernel.py:291-293); at 2
    bounces at least 99.5% of each field's elements within that rule
    (:295-296), since reflected rays amplify ulp differences.

The JAX side runs in a child process whose XLA is capped at the AVX
instruction set (see test_torch_render_frame.py): XLA on the CPU otherwise
contracts multiply-adds into FMAs, which the port, like the kernels, does
not.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from editable_gaussian_reflections_tpu_torch.ops.composite import composite
from editable_gaussian_reflections_tpu_torch.ops.culling import ClusterBounds
from editable_gaussian_reflections_tpu_torch.ops.render_grads import (
    ParamGrads,
    backward_step,
    param_grads_to_numpy,
    scatter_grads,
    zero_grads,
)
from editable_gaussian_reflections_tpu_torch.ops.tonemap import tonemap
from editable_gaussian_reflections_tpu_torch.ops.trace import RayHits
from editable_gaussian_reflections_tpu_torch.renderer import raytracer as trt

# the suite runs in several worker processes on shared cores: one torch
# thread per process keeps them from oversubscribing the CPU
torch.set_num_threads(1)

R, K, N = 64, 8, 40           # seeded [R, K] inputs scattered into N rows
SETTINGS = dict(loss_weight_diffuse=5.0, loss_weight_specular=3.0,
                loss_weight_depth=2.5, loss_weight_normal=2.5,
                loss_weight_f0=1.0, loss_weight_roughness=1.0)
FUSED_K, FUSED_MC, KEY = 16, 8, 11
REL = 1e-5


def _seeded_inputs():
    """Hit records, gathered attributes/frames and upstream gradients."""
    rng = np.random.default_rng(0)
    f32 = np.float32
    n_valid = rng.integers(0, K + 1, R)
    valid = np.arange(K)[None, :] < n_valid[:, None]
    t = np.sort(rng.uniform(0.5, 5.0, (R, K)), axis=1)
    alpha = rng.uniform(0.01, 0.9, (R, K))
    # a few very opaque hits, so the T >= threshold cutoff bites
    alpha[rng.uniform(size=(R, K)) < 0.1] = 0.9999
    tail = rng.uniform(0.3, 1.0, R)
    full_T = np.prod(np.where(valid, 1.0 - alpha, 1.0), axis=1) * tail
    q = rng.normal(size=(R, K, 4))
    qn = q / np.linalg.norm(q, axis=-1, keepdims=True)
    r, x, y, z = (qn[..., i] for i in range(4))
    rot = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z),
                  2 * (x * z + r * y)], -1),
        np.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - r * x)], -1),
        np.stack([2 * (x * z - r * y), 2 * (y * z + r * x),
                  1 - 2 * (x * x + y * y)], -1)], -2)
    scaling = np.exp(rng.normal(scale=0.3, size=(R, K, 3)) - 3.0)
    sf = rng.uniform(1.0, 2.0, (R, K))
    x = dict(
        ids=np.where(valid, rng.integers(0, N, (R, K)), 0).astype(np.int32),
        t=np.where(valid, t, 0.0), alpha=np.where(valid, alpha, 0.0),
        gaussval=np.where(valid, rng.uniform(0.05, 1.0, (R, K)), 0.0),
        local_hit=np.where(valid[..., None],
                           rng.normal(scale=0.5, size=(R, K, 3)), 0.0),
        valid=valid, full_T=full_T,
        num_traversed=rng.integers(0, 100, R).astype(np.int32),
        g_rgb=rng.uniform(0, 1, (R, K, 3)),
        g_normal=rng.normal(size=(R, K, 3)),
        g_f0=rng.uniform(0, 1, (R, K, 3)),
        g_roughness=rng.uniform(0, 1, (R, K)),
        g_opacity=rng.uniform(0.05, 0.95, (R, K)), g_scaling=scaling,
        g_rotation_raw=q, g_rot=rot,
        g_inv_sizes=1.0 / (scaling * sf[..., None]), g_sf=sf,
        dL_drgb=rng.normal(size=(R, 3)), dL_dnormal=rng.normal(size=(R, 3)),
        dL_df0=rng.normal(size=(R, 3)), dL_droughness=rng.normal(size=R),
        dL_ddepth=rng.normal(size=R),
        # loss_gradients_per_step: 2 bounces
        s_rgb=rng.uniform(0, 1, (3, R, 3)),
        s_normal=rng.normal(size=(3, R, 3)),
        s_f0=rng.uniform(0, 1, (3, R, 3)),
        s_roughness=rng.uniform(0, 1, (3, R)),
        s_depth=rng.uniform(0, 5, (3, R)),
        s_throughput=rng.uniform(0, 1, (3, R, 3)),
        tg_diffuse=rng.uniform(0, 1, (R, 3)),
        tg_specular=rng.uniform(0, 1, (R, 3)),
        tg_depth=rng.uniform(0, 5, R), tg_normal=rng.normal(size=(R, 3)),
        tg_roughness=rng.uniform(0, 1, R), tg_f0=rng.uniform(0, 1, (R, 3)))
    # exact ties with the targets: sign(0) = 0
    x["s_depth"][0, :4] = x["tg_depth"][:4]
    return {k: (v.astype(f32) if v.dtype == np.float64 else v)
            for k, v in x.items()}


HIT_FIELDS = ("ids", "t", "alpha", "gaussval", "local_hit", "valid",
              "full_T", "num_traversed")
GATHERED = ("g_rgb", "g_normal", "g_f0", "g_roughness", "g_opacity",
            "g_scaling", "g_rotation_raw", "g_rot", "g_inv_sizes", "g_sf")
UPSTREAM = ("dL_drgb", "dL_dnormal", "dL_df0", "dL_droughness", "dL_ddepth")


def jax_reference(path):
    """JAX outputs of every test here, saved to `path` as npz.  Run by the
    jax_ref fixture in a child process."""
    import jax
    import jax.numpy as jnp

    from editable_gaussian_reflections_tpu.ops import composite as jcomp
    from editable_gaussian_reflections_tpu.ops import culling as jc
    from editable_gaussian_reflections_tpu.ops import render_grads as jrg
    from editable_gaussian_reflections_tpu.ops.camera_rays import (
        primary_ray_directions as j_rays,
    )
    from editable_gaussian_reflections_tpu.ops.pallas import (
        render_kernel as jrk,
    )
    from editable_gaussian_reflections_tpu.ops.pallas.trace_kernel import (
        pack_frames as j_pack,
    )
    from editable_gaussian_reflections_tpu.ops.trace import RayHits as JHits
    from editable_gaussian_reflections_tpu.renderer import raytracer as jrt
    from editable_gaussian_reflections_tpu.scene import gaussian_scene as jgs
    from editable_gaussian_reflections_tpu.utils.synth import (
        room_camera,
        room_scene,
    )

    out = {}
    x = {k: jnp.asarray(v) for k, v in _seeded_inputs().items()}
    settings = jrt.RenderSettings(**SETTINGS)
    hits = JHits(**{k: x[k] for k in HIT_FIELDS})
    comp = jcomp.composite(hits, x["g_rgb"], x["g_normal"], x["g_f0"],
                           x["g_roughness"], settings.transmittance_threshold,
                           settings.eps_forward_normalization)
    for f in comp._fields:
        out[f"comp/{f}"] = np.asarray(getattr(comp, f))
    per_hit = jrg.backward_step(
        hits, comp, *(x[k] for k in GATHERED), *(x[k] for k in UPSTREAM),
        settings.exp_power, settings.eps_scale_grad, N,
        settings.global_scale_factor)
    for k, v in per_hit.items():
        out[f"per_hit/{k}"] = np.asarray(v)
    grads = jrg.scatter_grads(per_hit, x["ids"], N)
    for f in grads._fields:
        out[f"scatter/{f}"] = np.asarray(getattr(grads, f))
    steps = jrt.StepOutputs(
        rgb=x["s_rgb"], normal=x["s_normal"], f0=x["s_f0"],
        roughness=x["s_roughness"], depth=x["s_depth"],
        transmittance=x["s_depth"], total_transmittance=x["s_depth"],
        throughput=x["s_throughput"], alive=x["s_depth"],
        overflow=x["s_depth"])
    targets = jrt.RayTargets(**{f: x[f"tg_{f}"]
                                for f in jrt.RayTargets._fields})
    for s, dls in enumerate(jrt.loss_gradients_per_step(steps, targets,
                                                        settings, 2)):
        for i, v in enumerate(dls):
            out[f"loss/{s}/{i}"] = np.asarray(v)

    # render_tile_with_grads_fused on the room
    @jax.jit
    def prepared(scene):
        # one compile for the whole preparation (op by op, XLA would
        # compile every eager operation on its own)
        frames, attrs = jgs.build_frames(scene, settings.alpha_threshold,
                                         settings.exp_power, 1.0)
        perm = jc.morton_order(frames)
        frames, attrs, scene_s = jax.tree_util.tree_map(
            lambda a: a[perm], (frames, attrs, scene))
        return (dict(gpack=j_pack(frames, attrs),
                     table=jrk.pack_attr_table(attrs),
                     ftable=jrk.pack_frame_table(frames, scene_s)),
                jc.cluster_bounds(frames, 256))

    scene = jgs.from_arrays(**room_scene(2048), pad_multiple=512)
    tables, bounds = prepared(scene)
    out.update({k: np.asarray(v) for k, v in tables.items()})
    out.update({f"bounds/{f}": np.asarray(getattr(bounds, f))
                for f in bounds._fields})
    eye, c2w = room_camera()
    pix, _ = jc.tile_pixel_order(32, 32, 16, 16)
    rays_d = j_rays(32, 32, jnp.asarray(0.9), jnp.asarray(c2w)
                    ).reshape(-1, 3)[jnp.asarray(pix)]
    rays_o = jnp.broadcast_to(jnp.asarray(eye), rays_d.shape)
    nr = rays_d.shape[0]
    rng = np.random.default_rng(3)
    tg = jrt.RayTargets(
        diffuse=jnp.asarray(rng.uniform(0, 1, (nr, 3)), jnp.float32),
        specular=jnp.asarray(rng.uniform(0, 0.3, (nr, 3)), jnp.float32),
        depth=jnp.asarray(rng.uniform(1, 5, (nr,)), jnp.float32),
        normal=jnp.asarray(rng.normal(size=(nr, 3)), jnp.float32),
        roughness=jnp.asarray(rng.uniform(0, 1, (nr,)), jnp.float32),
        f0=jnp.asarray(rng.uniform(0, 1, (nr, 3)), jnp.float32))
    out.update(rays_o=np.asarray(rays_o), rays_d=np.asarray(rays_d))
    out.update({f"targets/{f}": np.asarray(getattr(tg, f))
                for f in tg._fields})
    # the uniforms render_tile_with_grads_fused draws per bounce
    key = jax.random.PRNGKey(KEY)
    us = []
    for _ in range(3):
        key, kstep = jax.random.split(key)
        us.append(np.asarray(jax.random.uniform(kstep, (nr, 2), jnp.float32)))
    out["us"] = np.stack(us)
    for nb in (0, 2):
        # under jit, as the JAX package's training loop runs it: one
        # compile instead of one per eager operation (its gradients part
        # from the eager run's by at most 2e-8 relative)
        step = jax.jit(lambda ro, rd, tg, key, arrays, nb=nb: (
            jrt.render_tile_with_grads_fused(
                ro, rd, tg, settings, jnp.float32(0.05), jnp.float32(50.0),
                key, nb, FUSED_K, cull_tile=256, cull_cluster=256,
                max_clusters=FUSED_MC, n_capacity=scene.capacity,
                interpret=True, **arrays)))
        steps, final, g = step(rays_o, rays_d, tg, jax.random.PRNGKey(KEY),
                               dict(tables, bounds=bounds))
        for f in g._fields:
            out[f"fused{nb}/grads/{f}"] = np.asarray(getattr(g, f))
        out[f"fused{nb}/final"] = np.asarray(final)
        out[f"fused{nb}/rgb"] = np.asarray(steps.rgb)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """jax_reference's arrays, computed by XLA without FMA contraction
    (module docstring) in a child process: XLA reads its flags once per
    process."""
    path = tmp_path_factory.mktemp("jax_grads") / "ref.npz"
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


def close(a, b, name, rel=REL):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    if b.dtype == bool or b.dtype.kind in "iu":
        np.testing.assert_array_equal(a, b, err_msg=name)
        return
    scale = max(1.0, float(np.abs(b).max(initial=0.0)))
    np.testing.assert_allclose(a, b, rtol=rel, atol=rel * scale,
                               err_msg=name)


def _port_inputs():
    x = {k: torch.tensor(v) for k, v in _seeded_inputs().items()}
    return x, RayHits(**{k: x[k] for k in HIT_FIELDS})


def _port_comp(x, hits):
    s = trt.RenderSettings(**SETTINGS)
    return composite(hits, x["g_rgb"], x["g_normal"], x["g_f0"],
                     x["g_roughness"], s.transmittance_threshold,
                     s.eps_forward_normalization)


def _port_per_hit(x, hits):
    s = trt.RenderSettings(**SETTINGS)
    return backward_step(hits, _port_comp(x, hits),
                         *(x[k] for k in GATHERED),
                         *(x[k] for k in UPSTREAM), s.exp_power,
                         s.eps_scale_grad, N, s.global_scale_factor)


def test_composite_matches_jax(jax_ref):
    x, hits = _port_inputs()
    comp = _port_comp(x, hits)
    assert comp.comp_mask.any() and not comp.comp_mask.all()
    for f in comp._fields:
        close(getattr(comp, f), jax_ref[f"comp/{f}"], f"comp.{f}")


def test_backward_step_matches_jax(jax_ref):
    x, hits = _port_inputs()
    per_hit = _port_per_hit(x, hits)
    assert set(per_hit) == set(ParamGrads._fields)
    for k, v in per_hit.items():
        assert torch.isfinite(v).all(), k
        close(v, jax_ref[f"per_hit/{k}"], f"per_hit.{k}")


def test_scatter_grads_matches_jax(jax_ref):
    x, hits = _port_inputs()
    per_hit = _port_per_hit(x, hits)
    grads = scatter_grads(per_hit, hits.ids, N, valid=hits.valid)
    got = param_grads_to_numpy(grads)
    for f in ParamGrads._fields:
        close(got[f], jax_ref[f"scatter/{f}"], f"grads.{f}")
    # skipping empty slots equals JAX adding their zero rows at id 0
    every = scatter_grads(per_hit, hits.ids, N)
    # zero_grads is the identity of the sum
    every = param_grads_to_numpy(zero_grads(N) + every)
    for f in ParamGrads._fields:
        np.testing.assert_array_equal(every[f], got[f], err_msg=f)


def test_loss_gradients_per_step_matches_jax(jax_ref):
    x, _ = _port_inputs()
    steps = trt.StepOutputs(
        rgb=x["s_rgb"], normal=x["s_normal"], f0=x["s_f0"],
        roughness=x["s_roughness"], depth=x["s_depth"],
        transmittance=x["s_depth"], total_transmittance=x["s_depth"],
        throughput=x["s_throughput"], alive=x["s_depth"],
        overflow=x["s_depth"])
    targets = trt.RayTargets(**{f: x[f"tg_{f}"]
                                for f in trt.RayTargets._fields})
    dls = trt.loss_gradients_per_step(steps, targets,
                                      trt.RenderSettings(**SETTINGS), 2)
    assert len(dls) == 3
    for s, per_step in enumerate(dls):
        for i, v in enumerate(per_step):
            close(v, jax_ref[f"loss/{s}/{i}"], f"loss step {s} term {i}")


def _port_fused(ref, num_bounces):
    t = {k: torch.tensor(ref[k]) for k in ("gpack", "table", "ftable")}
    bounds = ClusterBounds(*(torch.tensor(ref[f"bounds/{f}"])
                             for f in ClusterBounds._fields))
    targets = trt.RayTargets(**{f: torch.tensor(ref[f"targets/{f}"])
                                for f in trt.RayTargets._fields})
    return trt.render_tile_with_grads_fused(
        torch.tensor(ref["rays_o"]), torch.tensor(ref["rays_d"]), targets,
        trt.RenderSettings(**SETTINGS), 0.05, 50.0,
        torch.tensor(ref["us"][:num_bounces + 1]), num_bounces, FUSED_K,
        bounds=bounds, cull_tile=256, cull_cluster=256,
        max_clusters=FUSED_MC, n_capacity=t["gpack"].shape[1], **t)


@pytest.mark.parametrize("num_bounces", [0, 2])
def test_fused_tile_grads_match_jax(num_bounces, jax_ref):
    steps, final, grads = _port_fused(jax_ref, num_bounces)
    got = param_grads_to_numpy(grads)
    assert final.shape == (1024, 3)
    for f in ParamGrads._fields:
        a, b = got[f], jax_ref[f"fused{num_bounces}/grads/{f}"]
        assert np.isfinite(a).all(), f
        assert np.abs(b).max() > 0.0, f
        scale = max(1e-6, float(np.abs(b).max()))
        if num_bounces == 0:
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5 * scale,
                                       err_msg=f"grads.{f}")
        else:
            ok = np.abs(a - b) <= 2e-4 * np.abs(b) + 2e-5 * scale
            assert ok.mean() >= 0.995, (f, 1 - ok.mean())


def test_fused_tile_batches_equal_single_tiles(jax_ref):
    """Four 256-ray tiles traced as one batch (reflected rays re-sorted
    within their own tile) equal the same tiles traced one by one: the
    per-ray outputs bit for bit, the gradient sums to float64 rounding."""
    t = {k: torch.tensor(jax_ref[k]) for k in ("gpack", "table", "ftable")}
    bounds = ClusterBounds(*(torch.tensor(jax_ref[f"bounds/{f}"])
                             for f in ClusterBounds._fields))
    targets = trt.RayTargets(**{f: torch.tensor(jax_ref[f"targets/{f}"])
                                for f in trt.RayTargets._fields})
    o, d = torch.tensor(jax_ref["rays_o"]), torch.tensor(jax_ref["rays_d"])
    us = torch.tensor(jax_ref["us"])
    kw = dict(bounds=bounds, cull_tile=256, cull_cluster=256,
              max_clusters=FUSED_MC, n_capacity=t["gpack"].shape[1], **t)
    settings = trt.RenderSettings(**SETTINGS)
    steps_b, _, grads_b = trt.render_tile_with_grads_fused(
        o, d, targets, settings, 0.05, 50.0, us, 2, FUSED_K, tile_rays=256,
        **kw)
    tiles, grads_t = [], None
    for i in range(4):
        rows = slice(256 * i, 256 * (i + 1))
        steps_i, _, g = trt.render_tile_with_grads_fused(
            o[rows], d[rows], trt.RayTargets(*(a[rows] for a in targets)),
            settings, 0.05, 50.0, us[:, rows], 2, FUSED_K, **kw)
        tiles.append(steps_i)
        grads_t = g if grads_t is None else grads_t + g
    for f in trt.StepOutputs._fields:
        torch.testing.assert_close(
            getattr(steps_b, f), torch.cat([getattr(s, f) for s in tiles],
                                           dim=1), rtol=0, atol=0, msg=f)
    for f in ParamGrads._fields:
        a, b = getattr(grads_b, f), getattr(grads_t, f)
        scale = max(1e-6, float(b.abs().max()))
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * scale,
                                   msg=f)


def _psnr(a, b):
    """Tonemapped, clamped PSNR of a against b (dB)."""
    mse = float(((tonemap(a).clamp(0, 1) - tonemap(b).clamp(0, 1)) ** 2
                 ).double().mean())
    return 10 * np.log10(1.0 / max(mse, 1e-12))


def test_split_far_raises(jax_ref):
    """split_far, which raised before it was ported, runs the two-pass
    bounce on this file's fused inputs (2 bounces, far K 16).  The split
    step keeps up to K + K_far hits a ray where the single pass keeps K, so
    on this dense room the two differ by the hits the single pass cuts
    (tests/test_torch_split_far.py holds the split step equal to the
    single pass where both have room, and against JAX's split step): the
    primary frames within 55 dB, the final within 35 dB (tonemapped), and
    every gradient field finite and within 25% of the single pass's
    largest entry."""
    t = {k: torch.tensor(jax_ref[k]) for k in ("gpack", "table", "ftable")}
    bounds = ClusterBounds(*(torch.tensor(jax_ref[f"bounds/{f}"])
                             for f in ClusterBounds._fields))
    targets = trt.RayTargets(**{f: torch.tensor(jax_ref[f"targets/{f}"])
                                for f in trt.RayTargets._fields})
    steps, final, grads = trt.render_tile_with_grads_fused(
        torch.tensor(jax_ref["rays_o"]), torch.tensor(jax_ref["rays_d"]),
        targets, trt.RenderSettings(**SETTINGS), 0.05, 50.0,
        torch.tensor(jax_ref["us"]), 2, FUSED_K, bounds=bounds,
        cull_tile=256, cull_cluster=256, max_clusters=FUSED_MC,
        n_capacity=t["gpack"].shape[1], split_far=True, mc_far=FUSED_MC,
        max_hits_far=16, **t)
    single_steps, single, single_grads = _port_fused(jax_ref, 2)
    assert _psnr(steps.rgb[0], single_steps.rgb[0]) > 55.0
    assert _psnr(final, single) > 35.0
    for f in ParamGrads._fields:
        a, b = getattr(grads, f), getattr(single_grads, f)
        assert torch.isfinite(a).all(), f
        assert float((a - b).abs().max()) < 0.25 * float(b.abs().max()), f


if __name__ == "__main__":
    jax_reference(sys.argv[1])
