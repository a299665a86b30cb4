"""PyTorch port vs JAX package: the k-buffer kernels' plain versions at K 8
and K 64, the depths the port builds beside K 16 and K 32.

Held against the JAX Pallas kernels in interpret mode at the JAX tests'
own shapes:
  * pallas_trace_fused (brute) at K 8: tests/test_pallas_kernel.py:33's
    make_scene(96), 16 rays, chunk 32, tile 16, primary and secondary;
  * pallas_trace_culled_fused at K 8 through select_candidates
    (tests/test_pallas_kernel.py:116: cluster 32, tile 16, 8 candidates),
    primary and secondary;
  * pallas_trace_culled_fused at K 64 on the early-termination scene of
    tests/test_pallas_kernel.py:193 (cluster 32, tile 16, the far cluster
    listed at near distance 20), thresholds 0.5 and 1e-30;
  * pallas_render_culled_v4 at K 64, cluster 128, tile 256 (the exact
    reference of tests/test_render_kernel_v6.py:38) on one 256-ray tile
    of tests/test_torch_render_kernel.py's room;
  * _sort_slots at K 8 in the inline kernel of
    tests/test_pallas_kernel.py:279;
  * split-far's far-pass K at K 16 when max_hits_far is 0: the K of every
    slots-kernel call JAX's render_tile_with_grads_fused makes (recorded
    while it is traced, the kernel stubbed) against the port's
    fused_forward's calls.

Tolerances are those of the files that hold the same kernels at K 16 and
K 32: tests/test_torch_trace_hits.py (ids, masks and counts equal; t
within 1e-6 relative; alpha, gaussval and local_hit within 1e-6 * scale;
full_T within 2e-6 and log T within 1e-5 relative),
tests/test_torch_render_kernel.py (float lanes rtol 1e-4 / atol 5e-5,
counter lanes equal) and tests/test_torch_sort_slots.py (t equal; ids and
auxiliary values equal outside groups of equal t, a permutation of JAX's
within them).

The JAX side runs in a child process whose XLA is capped at the AVX
instruction set (tests/test_torch_render_frame.py says why).  Its
interpret-mode compile of the K 64 trace kernel alone takes about a
minute (it grows with K).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from editable_gaussian_reflections_tpu_torch.ops.cuda.render_kernel import (
    SUPPORTED_K,
)
from editable_gaussian_reflections_tpu_torch.ops.cuda.sort_slots import (
    sort_slots_aux_reference,
)
from editable_gaussian_reflections_tpu_torch.ops.cuda.trace_hits import (
    trace_hits,
)
from editable_gaussian_reflections_tpu_torch.ops.trace import (
    trace_rays_brute,
    trace_rays_culled,
)
from editable_gaussian_reflections_tpu_torch.renderer import raytracer as trt
from tests.test_torch_render_kernel import (
    _inputs as render_inputs,
)
from tests.test_torch_render_kernel import (
    _keywords,
    _port_out,
    assert_lanes_match,
)
from tests.test_torch_split_far import (
    STEP_KW,
    STEP_R,
    _random_rays,
    _scene,
    _sorted_tables,
    scene_arrays,
)
from tests.test_torch_trace_hits import (
    FAR,
    LOG_T_REL,
    NEAR,
    T_REL,
    VAL_TOL,
    _assert_hits,
    _close,
    early_termination_inputs,
    make_rays,
    make_scene_arrays,
)

torch.set_num_threads(1)

# (mode, secondary) of the K 8 traces
TRACE8 = {"brute_primary": ("brute", 0.0), "brute_secondary": ("brute", 1.0),
          "culled_primary": ("culled", 0.0),
          "culled_secondary": ("culled", 1.0)}
# the render at K 64: tests/test_torch_render_kernel.py's case layout (K,
# cluster, tile, rays, secondary_static, window_mode, alive, mc, threshold,
# JAX kernel, Gaussian scale), every cluster of the room a candidate and
# the threshold of tests/test_render_kernel_v6.py's exact reference
RENDER64 = (64, 128, 256, "primary", 0, 0, False, 16, 1e-8, "v4", 1.0)
SORT_R, SORT_K = 8, 8


def jax_reference(path):
    """JAX's outputs of every test here, saved to `path` as npz.  Run by
    the jax_ref fixture in a child process."""
    import jax
    import jax.numpy as jnp

    from editable_gaussian_reflections_tpu.ops.pallas.trace_kernel import (
        pallas_trace_culled_fused,
    )
    from tests.test_torch_render_kernel import _jax_out

    out = {}
    _jax_traces_k8(out)
    _jax_sort_k8(out)
    _jax_far_k(out)
    args, kw, kern = _one_tile(*render_inputs(RENDER64))
    out["render64"] = _jax_out(args, kw, kern)
    out.update({f"render64_in/{k}": v for k, v in args.items()
                if v is not None})
    gpack, o, d = early_termination_inputs()
    for thr in (0.5, 1e-30):
        res = pallas_trace_culled_fused(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(gpack),
            jnp.asarray([[0, 1]], jnp.int32),
            jnp.asarray([[0.0, 20.0]], jnp.float32), 0.1, 100.0, 3.0, 0.0,
            0.1, 0.9, transmittance_threshold=thr, max_hits=64, cluster=32,
            tile=16, interpret=True)
        for i, f in enumerate(("t", "ids", "alpha", "gaussval",
                               "local_hit")):
            out[f"early_{thr}/{f}"] = np.asarray(res[i])
        out[f"early_{thr}/log_T"] = np.asarray(res[6])
        out[f"early_{thr}/traversed"] = np.asarray(res[7])
    jax.effects_barrier()
    np.savez(path, **out)


def _jax_traces_k8(out):
    import jax
    import jax.numpy as jnp

    from editable_gaussian_reflections_tpu.ops.culling import (
        cluster_bounds,
        morton_order,
        select_candidates,
    )
    from editable_gaussian_reflections_tpu.ops.pallas.trace_kernel import (
        pack_frames,
    )
    from editable_gaussian_reflections_tpu.ops.trace import (
        trace_rays_culled as j_culled,
    )
    from editable_gaussian_reflections_tpu.ops.trace import (
        trace_rays_pallas,
    )
    from editable_gaussian_reflections_tpu.scene.gaussian_scene import (
        build_frames,
        from_arrays,
    )

    @jax.jit
    def tables(scene):
        frames, attrs = build_frames(scene, 0.005, 3.0)
        perm = morton_order(frames)
        s_frames, s_attrs = jax.tree_util.tree_map(lambda a: a[perm],
                                                   (frames, attrs))
        return (frames, s_frames, pack_frames(frames, attrs),
                pack_frames(s_frames, s_attrs), cluster_bounds(s_frames, 32))

    frames, s_frames, brute_gpack, culled_gpack, bounds = tables(
        from_arrays(**make_scene_arrays(), pad_multiple=32))
    o, d = (jnp.asarray(a) for a in make_rays())
    for name, (mode, secondary) in TRACE8.items():
        if mode == "brute":
            out[f"{name}/gpack"] = np.asarray(brute_gpack)
            hits, attrs = trace_rays_pallas(
                o, d, frames, brute_gpack, 3.0, NEAR, FAR,
                jnp.float32(secondary), max_hits=8, chunk=32, tile=16,
                interpret=True, extract_attrs=True)
        else:
            out[f"{name}/gpack"] = np.asarray(culled_gpack)
            cands, cnear, _n, ovf, _t = select_candidates(
                o, d, bounds, NEAR, FAR, tile=16, max_clusters=8)
            assert not bool(np.asarray(ovf).any())
            out[f"{name}/cands"] = np.asarray(cands)
            out[f"{name}/cnear"] = np.asarray(cnear)
            hits, attrs = j_culled(
                o, d, s_frames, culled_gpack, cands, cnear, 3.0, NEAR, FAR,
                jnp.float32(secondary), transmittance_threshold=1e-9,
                max_hits=8, cluster=32, tile=16, interpret=True)
        for f in ("ids", "t", "alpha", "gaussval", "local_hit", "valid",
                  "full_T", "num_traversed"):
            out[f"{name}/{f}"] = np.asarray(getattr(hits, f))
        for f in ("rgb", "normal", "f0", "roughness") if attrs else ():
            out[f"{name}/attrs/{f}"] = np.asarray(attrs[f])


def sort_inputs():
    """tests/test_pallas_kernel.py:279's inputs at K 8: exact ties, empty
    slots in front and interleaved."""
    from editable_gaussian_reflections_tpu.ops.pallas.trace_kernel import (
        AUX_GEO,
    )

    rng = np.random.default_rng(7)
    t = rng.uniform(0, 10, (SORT_R, SORT_K)).astype(np.float32)
    t[:, 3] = t[:, 5]
    t[0, :4] = 3.0e38
    t[1, ::2] = 3.0e38
    ids = rng.integers(0, 1000, (SORT_R, SORT_K)).astype(np.float32)
    aux = rng.normal(size=(SORT_R, AUX_GEO * SORT_K)).astype(np.float32)
    return t, ids, aux, AUX_GEO


def _jax_sort_k8(out):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from editable_gaussian_reflections_tpu.ops.pallas.trace_kernel import (
        _sort_slots,
    )

    t, ids, aux, A = sort_inputs()

    def kernel(t_ref, id_ref, aux_ref, to_ref, ido_ref, auxo_ref):
        to_ref[:] = t_ref[:]
        ido_ref[:] = id_ref[:]
        auxo_ref[:] = aux_ref[:]
        _sort_slots(to_ref, ido_ref, auxo_ref, SORT_K, A=A)

    res = pl.pallas_call(
        kernel,
        out_shape=(jax.ShapeDtypeStruct(t.shape, jnp.float32),
                   jax.ShapeDtypeStruct(ids.shape, jnp.float32),
                   jax.ShapeDtypeStruct(aux.shape, jnp.float32)),
        interpret=True,
    )(jnp.asarray(t), jnp.asarray(ids), jnp.asarray(aux))
    for name, v in zip(("t", "ids", "aux"), res):
        out[f"sort/{name}"] = np.asarray(v)


def _jax_far_k(out):
    """The (window mode, K) of each slots-kernel call of JAX's split-far
    training step at K 16, max_hits_far 0: the step is traced (not run)
    with the kernel replaced by a recorder returning zeros of its
    shapes."""
    import jax
    import jax.numpy as jnp

    from editable_gaussian_reflections_tpu.ops import culling as jc
    from editable_gaussian_reflections_tpu.ops.pallas import (
        render_kernel as jrk,
    )
    from editable_gaussian_reflections_tpu.ops.pallas import (
        render_kernel_v3 as jv3,
    )
    from editable_gaussian_reflections_tpu.ops.pallas.trace_kernel import (
        pack_frames as j_pack,
    )
    from editable_gaussian_reflections_tpu.renderer import raytracer as jrt
    from editable_gaussian_reflections_tpu.scene import gaussian_scene as jgs

    rng = np.random.default_rng(4)
    scene = jgs.from_arrays(**scene_arrays(rng), pad_multiple=128)
    o, d = (jnp.asarray(a) for a in _random_rays(rng, STEP_R))
    settings = jrt.RenderSettings(transmittance_threshold=1e-8)

    def tables():
        frames, attrs = jgs.build_frames(scene, settings.alpha_threshold,
                                         settings.exp_power,
                                         settings.global_scale_factor)
        return dict(gpack=j_pack(frames, attrs),
                    table=jrk.pack_attr_table(attrs),
                    ftable=jrk.pack_frame_table(frames, scene),
                    bounds=jc.cluster_bounds(frames, 128))

    targets = jrt.RayTargets(
        diffuse=jnp.zeros((STEP_R, 3)), specular=jnp.zeros((STEP_R, 3)),
        depth=jnp.ones((STEP_R,)), normal=jnp.zeros((STEP_R, 3)),
        roughness=jnp.zeros((STEP_R,)), f0=jnp.zeros((STEP_R, 3)))
    calls = []

    def recorder(rays_o, *args, max_hits, window_mode=0, **kw):
        calls.append((window_mode, max_hits))
        R = rays_o.shape[0]
        return (jnp.zeros((R, jrk.SLOT_BLOCKS * max_hits), jnp.float32),
                jnp.zeros((R, 16), jnp.float32))

    real = jv3.pallas_trace_slots_v4
    jv3.pallas_trace_slots_v4 = recorder
    try:
        jax.make_jaxpr(lambda: jrt.render_tile_with_grads_fused(
            o, d, targets, settings, jnp.float32(0.1), jnp.float32(100.0),
            jax.random.PRNGKey(0), 2, 16, n_capacity=scene.capacity,
            split_far=True, mc_far=8, **STEP_KW, **tables()))()
    finally:
        jv3.pallas_trace_slots_v4 = real
    out["far_k/calls"] = np.asarray(calls, np.int64)


def _one_tile(args, kw, kern):
    """A render case cut to its first 256-ray tile."""
    tile = kw["tile"]
    args = dict(args, rays_o=args["rays_o"][:tile],
                rays_d=args["rays_d"][:tile],
                candidates=args["candidates"][:1],
                cand_near=args["cand_near"][:1])
    return args, kw, kern


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """jax_reference's arrays, computed by XLA without FMA contraction
    (module docstring) in a child process."""
    path = tmp_path_factory.mktemp("jax_kbuffer_k") / "ref.npz"
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


def _t(ref, key):
    return torch.tensor(ref[key])


def test_the_port_builds_k_8_and_64():
    assert SUPPORTED_K == (8, 16, 32, 64)


@pytest.mark.parametrize("case", sorted(TRACE8))
def test_trace_k8_matches_jax(case, jax_ref):
    """pallas_trace_fused / pallas_trace_culled_fused at K 8 against
    trace_hits_reference through trace_rays_brute / trace_rays_culled."""
    mode, secondary = TRACE8[case]
    o, d = (torch.tensor(a) for a in make_rays())
    gpack = _t(jax_ref, f"{case}/gpack")
    if mode == "brute":
        hits, attrs = trace_rays_brute(o, d, gpack, 3.0, NEAR, FAR,
                                       secondary, max_hits=8,
                                       extract_attrs=True)
    else:
        hits, attrs = trace_rays_culled(
            o, d, gpack, _t(jax_ref, f"{case}/cands"),
            _t(jax_ref, f"{case}/cnear"), 3.0, NEAR, FAR, secondary,
            transmittance_threshold=1e-9, max_hits=8, cluster=32, tile=16)
    assert hits.t.shape == (16, 8)
    _assert_hits(hits, jax_ref, case, attrs)


def test_culled_trace_k64_early_termination_matches_jax(jax_ref):
    """tests/test_pallas_kernel.py:193 at its K 64: a high threshold skips
    the far cluster (fewer traversals) on both sides, and every output
    agrees at each threshold."""
    gpack, o, d = early_termination_inputs()
    trav = {}
    for thr in (0.5, 1e-30):
        t, ids, alpha, gv, lh, _a, log_T, tr = trace_hits(
            torch.tensor(o), torch.tensor(d), torch.tensor(gpack),
            torch.tensor([[0, 1]], dtype=torch.int32),
            torch.tensor([[0.0, 20.0]]), 0.1, 100.0, 3.0, 0.0, 0.1, 0.9,
            transmittance_threshold=thr, max_hits=64, cluster=32, tile=16)
        ref = {f: jax_ref[f"early_{thr}/{f}"] for f in
               ("t", "ids", "alpha", "gaussval", "local_hit", "log_T",
                "traversed")}
        assert t.shape == (16, 64)
        valid = t.numpy() < 1e37
        np.testing.assert_array_equal(valid, ref["t"] < 1e37)
        np.testing.assert_array_equal(np.where(valid, ids.numpy(), -1),
                                      np.where(valid, ref["ids"], -1))
        np.testing.assert_allclose(np.where(valid, t.numpy(), 0),
                                   np.where(valid, ref["t"], 0), rtol=T_REL)
        for f, a in (("alpha", alpha), ("gaussval", gv), ("local_hit", lh)):
            _close(a.numpy(), ref[f], VAL_TOL, f)
        np.testing.assert_array_equal(tr.numpy(), ref["traversed"])
        np.testing.assert_allclose(log_T.numpy(), ref["log_T"],
                                   rtol=LOG_T_REL)
        trav[thr] = int(tr.sum())
    assert trav[0.5] < trav[1e-30]


def test_render_culled_k64_matches_jax(jax_ref):
    """pallas_render_culled_v4 at K 64 (cluster 128, tile 256: the exact
    reference of the scan kernels' JAX tests) on one 256-ray tile, every
    cluster of the room listed: more than 32 hits composited on some
    rays.  The tile's inputs are the child's (JAX's culling made them)."""
    args = {k: jax_ref.get(f"render64_in/{k}") for k in (
        "rays_o", "rays_d", "gpack", "candidates", "cand_near", "alive",
        "t_split")}
    out = _port_out(args, _keywords(RENDER64), RENDER64[9]).numpy()
    ref = jax_ref["render64"]
    assert out.shape == (256, 16)
    assert_lanes_match(out, ref)
    assert np.isfinite(out).all()
    assert (out[:, 13] > 32).any()        # accumulated hits past K 32


def test_sort_k8_matches_jax_up_to_tie_order(jax_ref):
    """_sort_slots at K 8 against sort_slots_aux_reference:
    tests/test_torch_sort_slots.py's rule."""
    t, ids, aux, A = sort_inputs()
    jt, jids, jaux = (jax_ref[f"sort/{n}"] for n in ("t", "ids", "aux"))
    st, sid, saux = (x.numpy() for x in sort_slots_aux_reference(
        torch.tensor(t), torch.tensor(ids.astype(np.int32)),
        torch.tensor(aux)))
    np.testing.assert_array_equal(st, jt)
    n_tied = 0
    for r in range(SORT_R):
        _vals, start, count = np.unique(st[r], return_index=True,
                                        return_counts=True)
        for s0, n in zip(start, count):
            cols = range(s0, s0 + n)

            def columns(i, a):
                blocks = a[r].reshape(A, SORT_K)
                return sorted((float(i[r, c]), *blocks[:, c].tolist())
                              for c in cols)
            assert columns(sid.astype(np.float32), saux) == columns(jids,
                                                                     jaux)
            n_tied += n > 1
        single = np.repeat(count == 1, count)
        np.testing.assert_array_equal(sid[r][single], jids[r][single])
        np.testing.assert_array_equal(
            saux[r].reshape(A, SORT_K)[:, single],
            jaux[r].reshape(A, SORT_K)[:, single])
    assert n_tied >= SORT_R - 1   # the t[:, 3] = t[:, 5] tie


def test_split_far_default_k_far_matches_jax(jax_ref):
    """At K 16 with max_hits_far 0 the far passes trace K 8 slots, as
    JAX's step does (max(8, K // 2)): the port's fused_forward calls
    against JAX's, bounce by bounce, near (window 1) then far (window
    2)."""
    rng = np.random.default_rng(4)
    params = scene_arrays(rng)
    o, d = _random_rays(rng, STEP_R)
    us = rng.uniform(0, 1, (3, STEP_R, 2)).astype(np.float32)
    settings = trt.RenderSettings(transmittance_threshold=1e-8)
    scene = _scene(params)
    _steps, _final, _res, calls = trt.fused_forward(
        torch.tensor(o), torch.tensor(d), settings, 0.1, 100.0,
        torch.tensor(us), 2, 16, n_capacity=scene.capacity, **STEP_KW,
        **_sorted_tables(scene, settings), split_far=True, mc_far=8)
    port = [(c.kwargs["window_mode"], c.kwargs["max_hits"])
            for split in calls for c in (split.near, split.far)]
    assert trt.far_hits(16) == 8
    assert port == [tuple(x) for x in jax_ref["far_k/calls"]]
    assert port == [(1, 16), (2, 8)] * 3


if __name__ == "__main__":
    jax_reference(sys.argv[1])
