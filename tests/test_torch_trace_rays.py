"""PyTorch port vs JAX package: the XLA tracer (use_pallas=False).

The port's ops/trace.py trace_rays, ops/intersect.py intersect_block and
ops/trace.py intersect_gathered against JAX's on the same inputs:
  * on the 2048-Gaussian room (tests/test_torch_render_tile.py), traced on
    the frames JAX built, 96 rays from the room camera, K 16, chunks of
    512, primary; and 64 rays from inside the room with the secondary
    back-face test at a 10-unit reach (so that it rejects);
  * a tie case: make_scene(32) of tests/test_sharding.py with five rows
    copied bit for bit, into the same chunk and into later ones, 128 rays,
    K 16 over chunks of 16 (the viewer's duplicate makes such copies);
  * render_frame(use_pallas=False) at 32x32, 1 bounce, K 16, ray tiles of
    512, and train_step(use_pallas=False) on tests/test_torch_train_step.py's
    48-Gaussian scene at 64x32 (tiles of 256, K 8, chunks of 64), both with
    JAX's jitter and per-tile GGX uniforms.
Then the port alone: against tests/oracle.py (numpy, float64; the cases of
tests/test_render_small.py:105-191), and trace_rays against the plain
version of the brute trace_hits kernel.  The JAX side runs in a child
process whose XLA is capped at the AVX instruction set (see
test_torch_render_frame.py).

Tolerances (worst readings, port vs JAX on JAX's frames):
  * valid and ids equal, ties included (measured: equal);
  * t within 1e-6 relative (measured 0: the same float32 operations in the
    same order), local_hit within 1e-6 * scale (measured 0), scale =
    max(1, max |JAX|);
  * alpha and gaussval within 1e-6 * scale (measured 3.0e-8 and 6.0e-8:
    XLA's float32 exp and pow against the port's correctly rounded ones);
  * full_T within 1e-5 relative (measured 9.5e-6 on the primary rays,
    1.8e-6 on the secondary: the port sums log1p(-alpha) per chunk in
    float64, XLA in float32, so the reference carries the larger error).
The frame and the step: test_torch_render_tile.py's rules (bounce 0 within
rtol 1e-4 / atol 5e-5 on JAX's tables, at most 0.5% of elements outside
2e-4*|ref| + 2e-5*scale at every bounce; the step's moments within that
band on JAX's tables, on its own except at most MAX_FLIPPED Gaussians).
Against the oracle: test_render_small.py's tolerances.  Against the brute
plain version: the same valid hits and ids, t within 1e-6 relative.
"""

import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from editable_gaussian_reflections_tpu_torch import training as ttr
from editable_gaussian_reflections_tpu_torch.ops.composite import composite
from editable_gaussian_reflections_tpu_torch.ops.cuda.layout import pack_frames
from editable_gaussian_reflections_tpu_torch.ops.intersect import (
    GaussianFrames,
    intersect_block,
)
from editable_gaussian_reflections_tpu_torch.ops.precision import rounded
from editable_gaussian_reflections_tpu_torch.ops.render_grads import (
    backward_step,
    scatter_grads,
)
from editable_gaussian_reflections_tpu_torch.ops.trace import (
    gather_frames,
    intersect_gathered,
    trace_rays,
    trace_rays_brute,
)
from editable_gaussian_reflections_tpu_torch.renderer import raytracer as trt
from editable_gaussian_reflections_tpu_torch.scene import gaussian_scene as tgs
from editable_gaussian_reflections_tpu_torch.utils.synth import (
    room_camera,
    room_scene,
)
from tests.test_torch_render_tile import (
    HYPER,
    LRS,
    MISMATCH,
    ZFAR,
    ZNEAR,
    _mismatch,
    _room,
    _tight,
    jax_tile_samples,
    make_scene_arrays,
)

torch.set_num_threads(1)

K, CHUNK = 16, 512
BF = dict(backfacing_max_dist=10.0, backfacing_invalid_normal_threshold=0.9)
TIE_CHUNK = 16
# the frame and the step
W, H, NB, TILE, KEY = 32, 32, 1, 512, 4
W_T, H_T, TILE_T, STEP_KEY = 64, 32, 256, 1
STEP_KW = dict(num_bounces=1, max_hits=8, chunk=64, use_pallas=False)
MAX_FLIPPED = 6
FIELDS = ("xyz", "scaling", "rotation", "opacity", "diffuse", "normal", "f0",
          "roughness")
HIT_FIELDS = ("ids", "t", "alpha", "gaussval", "local_hit", "valid",
              "full_T", "num_traversed")


def room_rays(n=96, seed=0, inside=False):
    """Rays from the room camera into the room, or from points inside it
    in every direction; float32, directions normalized."""
    rng = np.random.default_rng(seed)
    eye, c2w = room_camera()
    if inside:
        o = rng.uniform(-1.5, 1.5, (n, 3))
        d = rng.normal(size=(n, 3))
    else:
        o = np.tile(eye, (n, 1))
        d = (np.asarray(c2w) @ np.stack([rng.uniform(-0.4, 0.4, n),
                                          rng.uniform(-0.4, 0.4, n),
                                          -np.ones(n)]))
        d = d.T
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def tie_scene_arrays():
    """make_scene(32) with rows copied bit for bit: 3 to 6 and 1 to 13 (the
    same 16-row chunk), 5 to 20, 2 to 27 and 9 to 30 (the next chunk)."""
    a = make_scene_arrays(n=32, seed=0)
    for src, dst in ((3, 6), (1, 13), (5, 20), (2, 27), (9, 30)):
        for v in a.values():
            v[dst] = v[src]
    return a


def jax_reference(path):
    """JAX outputs of every comparison here, saved to `path` as npz.  Run
    by the jax_ref fixture in a child process."""
    import jax
    import jax.numpy as jnp

    from editable_gaussian_reflections_tpu import training as jtr
    from editable_gaussian_reflections_tpu.ops import intersect as jint
    from editable_gaussian_reflections_tpu.ops import trace as jtrace
    from editable_gaussian_reflections_tpu.renderer import raytracer as jrt
    from editable_gaussian_reflections_tpu.scene import gaussian_scene as jgs

    out = {}
    settings = jrt.RenderSettings()

    def frames_of(scene):
        return jax.jit(lambda s: jgs.build_frames(
            s, settings.alpha_threshold, settings.exp_power))(scene)

    def save_hits(prefix, hits):
        for f in HIT_FIELDS:
            out[f"{prefix}/{f}"] = np.asarray(getattr(hits, f))

    def save_frames(prefix, frames):
        for f in GaussianFrames._fields:
            out[f"{prefix}/{f}"] = np.asarray(getattr(frames, f))

    room = jgs.from_arrays(**room_scene(2048), pad_multiple=512)
    frames, attrs = frames_of(room)
    save_frames("room", frames)
    for f in tgs.SceneAttributes._fields:
        out[f"room_attrs/{f}"] = np.asarray(getattr(attrs, f))
    for case, (o, d) in (("prim", room_rays()),
                         ("sec", room_rays(64, 1, inside=True))):
        sec = case == "sec"
        near = 0.0 if sec else ZNEAR
        hits = jtrace.trace_rays(jnp.asarray(o), jnp.asarray(d), frames, 3.0,
                                 jnp.float32(near), jnp.float32(ZFAR),
                                 max_hits=K, chunk=CHUNK, secondary=sec, **BF)
        save_hits(case, hits)
        blk = jax.tree_util.tree_map(lambda a: a[:CHUNK], frames)
        b = jax.jit(lambda o, d, blk: jint.intersect_block(
            o, d, blk, 3.0, jnp.float32(near), jnp.float32(ZFAR),
            secondary=sec, **BF))(jnp.asarray(o[:16]), jnp.asarray(d[:16]),
                                  blk)
        for f in ("t", "alpha", "gaussval", "local_hit", "valid"):
            out[f"{case}_block/{f}"] = np.asarray(getattr(b, f))
        g = jax.jit(lambda o, d, ids: jtrace.intersect_gathered(
            o, d, jtrace.gather_frames(frames, ids), 3.0))(
                jnp.asarray(o), jnp.asarray(d), hits.ids)
        for f, v in zip(("alpha", "gaussval", "local_hit", "t"), g):
            out[f"{case}_gathered/{f}"] = np.asarray(v)

    ties = jgs.from_arrays(**tie_scene_arrays(), pad_multiple=TIE_CHUNK)
    tframes, _ = frames_of(ties)
    save_frames("ties_frames", tframes)
    o = np.zeros((128, 3), np.float32)
    rng = np.random.default_rng(3)
    d = rng.normal(size=(128, 3))
    d[:, 2] = np.abs(d[:, 2]) + 0.8
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    out["ties_rays_d"] = d
    save_hits("ties", jtrace.trace_rays(
        jnp.asarray(o), jnp.asarray(d), tframes, 3.0, jnp.float32(0.1),
        jnp.float32(60.0), max_hits=K, chunk=TIE_CHUNK))

    eye, c2w = room_camera()
    camera = jrt.CameraParams(
        origin=jnp.asarray(eye), c2w=jnp.asarray(c2w),
        fov_y=jnp.asarray(0.9), znear=jnp.asarray(ZNEAR),
        zfar=jnp.asarray(ZFAR))
    steps, final = jrt.render_frame(
        room, camera, settings, jax.random.PRNGKey(KEY), W, H,
        num_bounces=NB, max_hits=K, chunk=CHUNK, tile=TILE,
        use_pallas=False)
    for f in jrt.StepOutputs._fields:
        out[f"frame/{f}"] = np.asarray(getattr(steps, f))
    out["frame/final"] = np.asarray(final)

    tscene = jgs.from_arrays(**make_scene_arrays(), pad_multiple=256)
    tcam = jrt.CameraParams(
        origin=jnp.zeros(3),
        c2w=jnp.asarray(np.diag([1.0, 1.0, -1.0]).astype(np.float32)),
        fov_y=jnp.asarray(0.8), znear=jnp.asarray(0.1),
        zfar=jnp.asarray(60.0))
    R = W_T * H_T
    rng = np.random.default_rng(2)
    targets = jrt.RayTargets(
        diffuse=jnp.asarray(rng.uniform(0, 1, (R, 3)), jnp.float32),
        specular=jnp.asarray(rng.uniform(0, 0.3, (R, 3)), jnp.float32),
        depth=jnp.asarray(rng.uniform(3, 7, (R,)), jnp.float32),
        normal=jnp.asarray(rng.normal(size=(R, 3)), jnp.float32),
        roughness=jnp.asarray(rng.uniform(0, 1, (R,)), jnp.float32),
        f0=jnp.asarray(rng.uniform(0, 1, (R, 3)), jnp.float32))
    for f in targets._fields:
        out[f"targets/{f}"] = np.asarray(getattr(targets, f))
    new, metrics = jtr.train_step(
        jtr.init_train_state(tscene), tcam, targets, settings, LRS, HYPER,
        jax.random.PRNGKey(STEP_KEY), W_T, H_T, tile=TILE_T, **STEP_KW)
    for tree in ("scene", "mu", "nu"):
        for f in jgs.GaussianScene._fields:
            out[f"step/{tree}/{f}"] = np.asarray(getattr(getattr(new, tree),
                                                         f))
    out["step/total_weight"] = np.asarray(new.total_weight)
    out["step/l1_diffuse"] = np.asarray(metrics["l1_diffuse"])
    t_frames, t_attrs = frames_of(tscene)
    save_frames("step_tables", t_frames)
    for f in tgs.SceneAttributes._fields:
        out[f"step_attrs/{f}"] = np.asarray(getattr(t_attrs, f))
    np.savez(path, **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """jax_reference's arrays, computed by XLA without FMA contraction in a
    child process."""
    path = tmp_path_factory.mktemp("jax_trace_rays") / "ref.npz"
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


def _frames(ref, prefix) -> GaussianFrames:
    return GaussianFrames(**{f: torch.tensor(ref[f"{prefix}/{f}"])
                             for f in GaussianFrames._fields})


def _close(a, b, what, rel=1e-6):
    scale = max(1.0, float(np.abs(b).max(initial=0.0)))
    err = np.abs(np.asarray(a, np.float64) - b).max(initial=0.0)
    assert err <= rel * scale, f"{what}: {err} > {rel} * {scale}"


def _assert_hits(hits, ref, prefix):
    v = ref[f"{prefix}/valid"]
    np.testing.assert_array_equal(hits.valid.numpy(), v, err_msg=prefix)
    np.testing.assert_array_equal(hits.ids.numpy(), ref[f"{prefix}/ids"],
                                  err_msg=prefix)
    np.testing.assert_array_equal(hits.num_traversed.numpy(),
                                  ref[f"{prefix}/num_traversed"])
    np.testing.assert_allclose(hits.t.numpy(), ref[f"{prefix}/t"], rtol=1e-6,
                               atol=0, err_msg=prefix)
    for f in ("alpha", "gaussval", "local_hit"):
        _close(getattr(hits, f).numpy(), ref[f"{prefix}/{f}"],
               f"{prefix} {f}")
    np.testing.assert_allclose(hits.full_T.numpy(), ref[f"{prefix}/full_T"],
                               rtol=1e-5, err_msg=prefix)


@pytest.mark.parametrize("case", ["prim", "sec"])
def test_trace_rays_matches_jax(case, jax_ref):
    frames = _frames(jax_ref, "room")
    sec = case == "sec"
    o, d = room_rays(64, 1, inside=True) if sec else room_rays()
    o, d = torch.tensor(o), torch.tensor(d)
    near = 0.0 if sec else ZNEAR
    hits = trace_rays(o, d, frames, 3.0, near, ZFAR, max_hits=K, chunk=CHUNK,
                      secondary=sec, **BF)
    _assert_hits(hits, jax_ref, case)
    assert hits.valid.sum(1).max() == K          # some rays truncate at K
    b = intersect_block(o[:16], d[:16], GaussianFrames(
        *(a[:CHUNK] for a in frames)), 3.0, near, ZFAR, secondary=sec, **BF)
    np.testing.assert_array_equal(b.valid.numpy(),
                                  jax_ref[f"{case}_block/valid"])
    np.testing.assert_allclose(b.t.numpy(), jax_ref[f"{case}_block/t"],
                               rtol=1e-6, atol=0)
    for f in ("alpha", "gaussval", "local_hit"):
        _close(getattr(b, f).numpy(), jax_ref[f"{case}_block/{f}"],
               f"block {f}")
    g = intersect_gathered(o, d, gather_frames(
        frames, torch.tensor(jax_ref[f"{case}/ids"])), 3.0)
    for f, v in zip(("alpha", "gaussval", "local_hit", "t"), g):
        _close(v.numpy(), jax_ref[f"{case}_gathered/{f}"], f"gathered {f}")
    if sec:
        # the back-face test rejected some hits a primary trace keeps
        prim = trace_rays(o, d, frames, 3.0, near, ZFAR, max_hits=K,
                          chunk=CHUNK, secondary=False, **BF)
        assert prim.valid.sum() > hits.valid.sum()


def test_trace_rays_ties_match_jax(jax_ref):
    """Bit-equal copies in one chunk and across chunks: at equal t both
    sides keep the lower index first."""
    frames = _frames(jax_ref, "ties_frames")
    d = torch.tensor(jax_ref["ties_rays_d"])
    hits = trace_rays(torch.zeros((128, 3)), d, frames, 3.0, 0.1, 60.0,
                      max_hits=K, chunk=TIE_CHUNK)
    _assert_hits(hits, jax_ref, "ties")
    ids, t, v = hits.ids.numpy(), hits.t.numpy(), hits.valid.numpy()
    tied = 0
    for r in range(ids.shape[0]):
        for k in range(1, K):
            if v[r, k] and t[r, k] == t[r, k - 1]:
                assert ids[r, k] > ids[r, k - 1]
                tied += 1
    assert tied >= 3, tied


def test_trace_rays_equals_brute_plain():
    """The XLA tracer's twin and the brute trace_hits' plain version keep
    the same hits on the room."""
    scene, _camera = _room()
    frames, attrs = tgs.build_frames(scene, 0.005, 3.0)
    o, d = (torch.tensor(a) for a in room_rays(128, 5))
    hits = trace_rays(o, d, frames, 3.0, ZNEAR, ZFAR, max_hits=K,
                      chunk=CHUNK)
    brute, _ = trace_rays_brute(o, d, pack_frames(frames, attrs).contiguous(),
                                3.0, ZNEAR, ZFAR, 0.0, max_hits=K)
    np.testing.assert_array_equal(hits.valid.numpy(), brute.valid.numpy())
    np.testing.assert_array_equal(hits.ids.numpy(), brute.ids.numpy())
    np.testing.assert_allclose(hits.t.numpy(), brute.t.numpy(), rtol=1e-6,
                               atol=0)
    np.testing.assert_array_equal(hits.num_traversed.numpy(),
                                  brute.num_traversed.numpy())


# -- against tests/oracle.py (test_render_small.py's cases) ------------------

EXP_POWER, ALPHA_THRESHOLD, TRANS_THRESHOLD = 3.0, 0.005, 0.01
EPS_NORM, EPS_SCALE_GRAD = 1e-12, 1e-12


def _small_trace(sc, o, d, max_hits=16, near=0.2, far=100.0):
    scene = tgs.from_arrays(**sc, pad_multiple=8, device="cpu")
    frames, attrs = tgs.build_frames(scene, ALPHA_THRESHOLD, EXP_POWER)
    hits = trace_rays(torch.tensor(o), torch.tensor(d), frames, EXP_POWER,
                      near, far, max_hits=max_hits, chunk=8)
    g = attrs.take(hits.ids.to(torch.int64))
    comp = composite(hits, g.rgb, g.normal, g.f0, g.roughness,
                     TRANS_THRESHOLD, EPS_NORM)
    return scene, frames, attrs, hits, comp


def test_forward_matches_oracle():
    from oracle import forward_one_ray
    from test_render_small import make_scene, oracle_gaussians, rays

    sc = make_scene()
    o, d = rays()
    _, _, _, _hits, comp = _small_trace(sc, o, d)
    gs = oracle_gaussians(sc)
    for ri in range(o.shape[0]):
        out, composited = forward_one_ray(
            o[ri].astype(np.float64), d[ri].astype(np.float64), gs,
            EXP_POWER, 0.2, 100.0, TRANS_THRESHOLD, EPS_NORM)
        for f, atol in (("rgb", 2e-4), ("depth", 2e-4), ("normal", 2e-4),
                        ("T_final", 1e-5), ("full_T", 1e-5)):
            np.testing.assert_allclose(getattr(comp, f)[ri].numpy(), out[f],
                                       rtol=2e-3, atol=atol, err_msg=f)
        assert int(comp.num_accumulated[ri]) == len(composited)


def test_trace_depth_order_and_truncation():
    from test_render_small import make_scene, rays

    sc = make_scene(n=12, seed=3)
    o, d = rays(seed=4, r=3)
    _, _, _, hits, _ = _small_trace(sc, o, d, max_hits=4)
    _, _, _, full, _ = _small_trace(sc, o, d, max_hits=16)
    t, v = hits.t.numpy(), hits.valid.numpy()
    for ri in range(t.shape[0]):
        assert np.all(np.diff(t[ri][v[ri]]) >= 0), "hits must be depth-sorted"
        # the 4 kept are the 4 nearest of all of the ray's hits
        n = min(4, int(full.valid[ri].sum()))
        np.testing.assert_array_equal(hits.ids[ri, :n].numpy(),
                                      full.ids[ri, :n].numpy())
    assert full.valid.sum(1).max() > 4          # some ray truncates at K 4


def test_backward_matches_oracle():
    from oracle import backward_one_ray, forward_one_ray
    from test_render_small import make_scene, oracle_gaussians, rays

    sc = make_scene(n=6, seed=7)
    o, d = rays(seed=8, r=4)
    scene, frames, attrs, hits, comp = _small_trace(sc, o, d)
    R = o.shape[0]
    rng = np.random.default_rng(9)
    dL = dict(rgb=rng.normal(size=(R, 3)), normal=rng.normal(size=(R, 3)),
              f0=rng.normal(size=(R, 3)), roughness=rng.normal(size=R),
              depth=rng.normal(size=R))
    ids = hits.ids.to(torch.int64)
    fg = gather_frames(frames, ids)
    g = attrs.take(ids)
    per_hit = backward_step(
        hits, comp, g.rgb, g.normal, g.f0, g.roughness, fg.opacity,
        rounded(torch.exp, scene.scaling)[ids], scene.rotation[ids], fg.rot,
        fg.inv_sizes, fg.sf,
        *(torch.tensor(dL[k], dtype=torch.float32)
          for k in ("rgb", "normal", "f0", "roughness", "depth")),
        EXP_POWER, EPS_SCALE_GRAD, scene.capacity)
    grads = scatter_grads(per_hit, hits.ids, scene.capacity, hits.valid)
    gs = oracle_gaussians(sc)
    n = sc["xyz"].shape[0]
    acc = {k: np.zeros((n,) + s) for k, s in
           [("mean", (3,)), ("scale", (3,)), ("rotation", (4,)),
            ("opacity", ()), ("rgb", (3,)), ("normal", (3,)), ("f0", (3,)),
            ("roughness", ()), ("total_weight", ())]}
    for ri in range(R):
        out, composited = forward_one_ray(
            o[ri].astype(np.float64), d[ri].astype(np.float64), gs,
            EXP_POWER, 0.2, 100.0, TRANS_THRESHOLD, EPS_NORM)
        dL_ray = {k: (dL[k][ri] if np.ndim(dL[k]) > 1 else float(dL[k][ri]))
                  for k in dL}
        og = backward_one_ray(out, composited, dL_ray, EXP_POWER,
                              EPS_SCALE_GRAD)
        for gid, gg in og.items():
            for k in acc:
                acc[k][gid] += gg[k]
    for k in acc:
        np.testing.assert_allclose(getattr(grads, k).numpy()[:n], acc[k],
                                   rtol=5e-3, atol=5e-3, err_msg=k)


# -- render_frame and train_step with use_pallas=False ------------------------


def test_render_frame_xla_matches_jax(jax_ref):
    scene, camera = _room()
    jitter, us = jax_tile_samples(__import__("jax").random.PRNGKey(KEY), W,
                                  H, TILE, NB + 1)
    samples = trt.TileSamples(jitter=torch.tensor(jitter),
                              us=torch.tensor(us))
    tables = (_frames(jax_ref, "room"), tgs.SceneAttributes(**{
        f: torch.tensor(jax_ref[f"room_attrs/{f}"])
        for f in tgs.SceneAttributes._fields}))
    no_kernel = mock.patch.object(trt, "trace_rays_brute",
                                  side_effect=AssertionError("kernel"))
    outs = {}
    with no_kernel:
        outs["own"] = trt.render_frame(
            scene, camera, trt.RenderSettings(), None, W, H, num_bounces=NB,
            max_hits=K, chunk=CHUNK, tile=TILE, samples=samples,
            use_pallas=False)
        with mock.patch.object(trt, "build_frames", return_value=tables):
            outs["jax tables"] = trt.render_frame(
                scene, camera, trt.RenderSettings(), None, W, H,
                num_bounces=NB, max_hits=K, chunk=CHUNK, tile=TILE,
                samples=samples, use_pallas=False)
    for name, (steps, final) in outs.items():
        for f in trt.StepOutputs._fields:
            a, b = getattr(steps, f).numpy(), jax_ref[f"frame/{f}"]
            assert a.shape == b.shape and np.isfinite(a).all(), (name, f)
            for bounce in range(a.shape[0]):
                bad = _mismatch(a[bounce], b[bounce])
                assert bad <= MISMATCH, f"{name} bounce {bounce} {f}: {bad}"
        assert _mismatch(final.numpy(), jax_ref["frame/final"]) <= MISMATCH
    steps = outs["jax tables"][0]
    for f in trt.StepOutputs._fields:
        if f != "throughput":
            np.testing.assert_allclose(getattr(steps, f).numpy()[0],
                                       jax_ref[f"frame/{f}"][0], rtol=1e-4,
                                       atol=5e-5, err_msg=f)


def _xla_step(ref, jax_tables=False):
    import jax

    scene = tgs.from_arrays(**make_scene_arrays(), pad_multiple=256,
                            device="cpu")
    camera = trt.CameraParams(
        origin=torch.zeros(3),
        c2w=torch.tensor(np.diag([1.0, 1.0, -1.0]).astype(np.float32)),
        fov_y=0.8, znear=0.1, zfar=60.0)
    targets = trt.targets_from_numpy(
        {f: ref[f"targets/{f}"] for f in trt.RayTargets._fields},
        device="cpu")
    jitter, us = jax_tile_samples(jax.random.PRNGKey(STEP_KEY), W_T, H_T,
                                  TILE_T, STEP_KW["num_bounces"] + 1)
    samples = trt.TileSamples(jitter=torch.tensor(jitter),
                              us=torch.tensor(us))
    real = ttr.prepare_render_inputs

    def with_jax_tables(*args, **kwargs):
        out = real(*args, **kwargs)
        attrs = tgs.SceneAttributes(**{
            f: torch.tensor(ref[f"step_attrs/{f}"])
            for f in tgs.SceneAttributes._fields})
        return (_frames(ref, "step_tables"), attrs) + tuple(out[2:])

    with mock.patch.object(ttr, "prepare_render_inputs",
                           with_jax_tables if jax_tables else real), \
            mock.patch.object(trt, "trace_rays_brute",
                              side_effect=AssertionError("kernel")):
        return ttr.train_step(ttr.init_train_state(scene), camera, targets,
                              trt.RenderSettings(), LRS, HYPER, None, W_T,
                              H_T, tile=TILE_T, samples=samples, **STEP_KW)


def test_train_step_xla_matches_jax(jax_ref):
    own, m_own = _xla_step(jax_ref)
    swapped, m_sw = _xla_step(jax_ref, jax_tables=True)
    for m in (m_own, m_sw):
        np.testing.assert_allclose(m["l1_diffuse"].item(),
                                   float(jax_ref["step/l1_diffuse"]),
                                   rtol=1e-5)
    ref = {f"{tree}.{f}": jax_ref[f"step/{tree}/{f}"]
           for f in FIELDS for tree in ("mu", "nu")}
    ref["total_weight"] = jax_ref["step/total_weight"]
    assert (ref["total_weight"] > 0).any()
    flipped = np.zeros(ref["total_weight"].shape[0], bool)
    for k, b in ref.items():
        tree, _, f = k.partition(".")
        get = ((lambda st: st.total_weight.numpy()) if k == "total_weight"
               else (lambda st: getattr(getattr(st, tree), f).numpy()))
        assert _tight(get(swapped), b).all(), k
        bad = ~_tight(get(own), b)
        flipped |= bad.reshape(bad.shape[0], -1).any(axis=1)
    assert flipped.sum() <= MAX_FLIPPED, np.nonzero(flipped)[0]


if __name__ == "__main__":
    jax_reference(sys.argv[1])
