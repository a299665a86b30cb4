"""PyTorch port vs JAX package: the non-fused trace.

trace_hits_reference (the plain version of csrc/trace_hits.cu), through the
port's trace_rays_brute / trace_rays_culled where the JAX test goes through
trace_rays_pallas / trace_rays_culled, is held against the JAX Pallas
kernels pallas_trace_fused (brute) and pallas_trace_culled_fused (culled) in
interpret mode, at the sizes of tests/test_pallas_kernel.py: make_scene(96),
16 rays, K 8.  Cases: brute and culled (through select_candidates), primary
and secondary (backfacing test on, with a 10-unit reach so that it
rejects); the brute cases trace a ragged ray count (24 rays, not a multiple
of the port's 256-ray block) and extract the shading attributes; then the
adversarial cluster order and early-termination cases of
tests/test_pallas_kernel.py:152-250, at K 16 (the interpret-mode compile
grows with K: 41 s at K 64; the early-termination case lists the far
cluster at near distance 0 instead of raising K past the near cluster's 32
hits, so again only saturation can skip it).  Both sides trace the same inputs (the
child builds gpack, rays and candidates), so only the kernels' arithmetic
differs.

The JAX side runs in a child process whose XLA is capped at the AVX
instruction set (as in test_torch_render_frame.py).

Tolerances, from the readings of these cases (worst, port vs JAX):
  * ids, traversed counts and the kept-hit masks: equal;
  * t within 1e-6 relative (measured 0: the same float32 operations);
  * alpha and gaussval within 1e-6 * scale (scale = max(1, max |JAX|);
    measured 1.2e-7: XLA's float32 exp against the port's correctly
    rounded one);
  * local_hit within 1e-6 * scale (measured 0);
  * full_T within 2e-6 relative (measured 1.5e-7), and log T within 1e-5
    relative where it is large (measured 1.4e-6 at log T ~ -70 on the
    opaque early-termination scene): the Pallas kernel sums log1p(-alpha)
    in float32 per chunk, the port in float64;
  * shading attributes: equal (a value copy on both sides).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from editable_gaussian_reflections_tpu_torch.ops.cuda.trace_hits import (
    BRUTE_CLUSTER,
    BRUTE_TILE,
    trace_hits,
    walk_inputs,
)
from editable_gaussian_reflections_tpu_torch.ops.trace import (
    trace_rays_brute,
    trace_rays_culled,
)

# the suite runs in several worker processes on shared cores: one torch
# thread per process keeps them from oversubscribing the CPU
torch.set_num_threads(1)

NEAR, FAR = 0.1, 60.0
T_REL = 1e-6
VAL_TOL = 1e-6
FULL_T_REL = 2e-6
LOG_T_REL = 1e-5

# (mode, secondary, backfacing reach, K, rays, extract_attrs); cases that
# differ only in traced scalars share one interpret-mode compile
CASES = {
    "brute_primary_24_rays": ("brute", 0.0, 0.1, 8, 24, True),
    "brute_secondary_24_rays": ("brute", 1.0, 10.0, 8, 24, True),
    "culled_primary": ("culled", 0.0, 0.1, 8, 16, False),
    "culled_secondary": ("culled", 1.0, 10.0, 8, 16, False),
}
ATTRS = ("rgb", "normal", "f0", "roughness")


def make_scene_arrays(n=96, seed=0):
    """tests/test_pallas_kernel.py:make_scene's arrays."""
    rng = np.random.default_rng(seed)
    return dict(
        xyz=(rng.uniform(-1.5, 1.5, (n, 3))
             + np.array([0, 0, 5])).astype(np.float32),
        scaling=rng.uniform(-2.0, -1.0, (n, 3)).astype(np.float32),
        rotation=rng.normal(size=(n, 4)).astype(np.float32),
        opacity=rng.uniform(-1, 2, n).astype(np.float32),
        diffuse=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        normal=rng.normal(size=(n, 3)).astype(np.float32),
        f0=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        roughness=rng.uniform(0, 1, n).astype(np.float32))


def make_rays(R=16, seed=1):
    """tests/test_pallas_kernel.py:_rays."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.2, 0.2, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3))
    d[:, 2] = np.abs(d[:, 2]) + 0.7
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def jax_reference(path):
    """Inputs and JAX outputs of every test here, saved to `path` as npz.
    Run by the jax_ref fixture in a child process."""
    import jax
    import jax.numpy as jnp

    from editable_gaussian_reflections_tpu.ops.culling import (
        cluster_bounds,
        morton_order,
        select_candidates,
    )
    from editable_gaussian_reflections_tpu.ops.pallas.trace_kernel import (
        pack_frames,
        pallas_trace_culled_fused,
    )
    from editable_gaussian_reflections_tpu.ops.trace import (
        trace_rays_culled,
        trace_rays_pallas,
    )
    from editable_gaussian_reflections_tpu.scene.gaussian_scene import (
        build_frames,
        from_arrays,
    )

    out = {}

    def save_hits(name, hits, attrs=None):
        for f in ("ids", "t", "alpha", "gaussval", "local_hit", "valid",
                  "full_T", "num_traversed"):
            out[f"{name}/{f}"] = np.asarray(getattr(hits, f))
        for f in ATTRS if attrs is not None else ():
            out[f"{name}/attrs/{f}"] = np.asarray(attrs[f])

    @jax.jit
    def tables(scene):
        # one compile for the whole preparation (op by op, XLA would
        # compile every eager operation on its own)
        frames, attrs = build_frames(scene, 0.005, 3.0)
        # the culled cases trace the Morton-sorted scene, as the renderer
        # does
        perm = morton_order(frames)
        s_frames, s_attrs = jax.tree_util.tree_map(lambda a: a[perm],
                                                   (frames, attrs))
        return (frames, s_frames, pack_frames(frames, attrs),
                pack_frames(s_frames, s_attrs), cluster_bounds(s_frames, 32))

    frames, sorted_frames, brute_gpack, culled_gpack, bounds = tables(
        from_arrays(**make_scene_arrays(), pad_multiple=32))
    gpacks = {"brute": brute_gpack, "culled": culled_gpack}
    for name, (mode, secondary, reach, K, R, extract) in CASES.items():
        o, d = (jnp.asarray(a) for a in make_rays(R))
        gpack = gpacks[mode]
        out[f"{name}/gpack"] = np.asarray(gpack)
        out[f"{name}/rays_o"], out[f"{name}/rays_d"] = map(np.asarray, (o, d))
        if mode == "brute":
            hits, slot_attrs = trace_rays_pallas(
                o, d, frames, gpack, 3.0, NEAR, FAR, jnp.float32(secondary),
                max_hits=K, chunk=32, tile=16, backfacing_max_dist=reach,
                interpret=True, extract_attrs=extract)
        else:
            cands, cnear, _n, ovf, _t = select_candidates(
                o, d, bounds, NEAR, FAR, tile=16, max_clusters=8)
            assert not bool(np.asarray(ovf).any())
            out[f"{name}/cands"] = np.asarray(cands)
            out[f"{name}/cnear"] = np.asarray(cnear)
            hits, slot_attrs = trace_rays_culled(
                o, d, sorted_frames, gpack, cands, cnear, 3.0, NEAR, FAR,
                jnp.float32(secondary), transmittance_threshold=1e-9,
                max_hits=K, cluster=32, tile=16, backfacing_max_dist=reach,
                interpret=True)
        save_hits(name, hits, slot_attrs)

    # the adversarial cluster order: a permuted list, no 'behind' exit
    # (near 0) and no saturation (threshold 1e-30)
    gpack3 = tables(from_arrays(**make_scene_arrays(seed=3),
                                pad_multiple=32))[2]
    o, d = (jnp.asarray(a) for a in make_rays(seed=4))
    order = np.random.default_rng(0).permutation(
        gpack3.shape[1] // 32).astype(np.int32)[None]
    res = pallas_trace_culled_fused(
        o, d, gpack3, jnp.asarray(order),
        jnp.zeros(order.shape, jnp.float32), NEAR, FAR, 3.0, 0.0, 0.1, 0.9,
        transmittance_threshold=1e-30, max_hits=16, cluster=32, tile=16,
        interpret=True)
    out.update({"adversarial/gpack": np.asarray(gpack3),
                "adversarial/cands": order,
                "adversarial/rays_o": np.asarray(o),
                "adversarial/rays_d": np.asarray(d)})
    for i, f in enumerate(("t", "ids", "alpha", "gaussval", "local_hit")):
        out[f"adversarial/{f}"] = np.asarray(res[i])
    out["adversarial/log_T"] = np.asarray(res[6])
    out["adversarial/traversed"] = np.asarray(res[7])

    # early termination: an opaque near cluster and a far one, both listed
    # at near distance 0, so only saturation can skip the far cluster
    gpack4, o, d = early_termination_inputs()
    for thr in (0.5, 1e-30):
        res = pallas_trace_culled_fused(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(gpack4),
            jnp.asarray([[0, 1]], jnp.int32),
            jnp.asarray([[0.0, 0.0]], jnp.float32), 0.1, 100.0, 3.0, 0.0,
            0.1, 0.9, transmittance_threshold=thr, max_hits=16, cluster=32,
            tile=16, interpret=True)
        for i, f in enumerate(("t", "ids", "alpha")):
            out[f"early_{thr}/{f}"] = np.asarray(res[i])
        out[f"early_{thr}/log_T"] = np.asarray(res[6])
        out[f"early_{thr}/traversed"] = np.asarray(res[7])
    np.savez(path, **out)


def early_termination_inputs():
    """tests/test_pallas_kernel.py:193-226's scene (packed) and rays."""
    import jax

    from editable_gaussian_reflections_tpu.ops.pallas.trace_kernel import (
        pack_frames,
    )
    from editable_gaussian_reflections_tpu.scene.gaussian_scene import (
        build_frames,
        from_arrays,
    )

    n = 64
    rng = np.random.default_rng(5)
    xyz = np.concatenate([
        rng.uniform(-2, 2, (32, 3)) + np.array([0, 0, 3.0]),
        rng.uniform(-2, 2, (32, 3)) + np.array([0, 0, 30.0]),
    ]).astype(np.float32)
    scene = from_arrays(
        xyz=xyz, scaling=np.full((n, 3), 0.5, np.float32),
        rotation=np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)),
        opacity=np.full((n,), 12.0, np.float32),
        diffuse=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        normal=rng.normal(size=(n, 3)).astype(np.float32),
        f0=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        roughness=rng.uniform(0, 1, n).astype(np.float32), pad_multiple=32)
    o, d = make_rays(seed=6)
    gpack = jax.jit(lambda sc: pack_frames(*build_frames(sc, 0.005, 3.0)))(
        scene)
    return np.asarray(gpack), o, d


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """jax_reference's arrays, computed by XLA without FMA contraction
    (module docstring) in a child process."""
    path = tmp_path_factory.mktemp("jax_trace_hits") / "ref.npz"
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


def _close(a, b, rel, name):
    scale = max(1.0, float(np.abs(b).max(initial=0.0)))
    np.testing.assert_array_less(np.abs(a - b), rel * scale + 1e-30,
                                 err_msg=name)


def _assert_hits(hits, ref, name, attrs=None):
    valid = hits.valid.numpy()
    np.testing.assert_array_equal(valid, ref[f"{name}/valid"])
    assert valid.any(), name
    np.testing.assert_array_equal(hits.ids.numpy(), ref[f"{name}/ids"])
    np.testing.assert_array_equal(hits.num_traversed.numpy(),
                                  ref[f"{name}/num_traversed"])
    np.testing.assert_allclose(hits.t.numpy(), ref[f"{name}/t"], rtol=T_REL,
                               atol=0)
    for f in ("alpha", "gaussval", "local_hit"):
        _close(getattr(hits, f).numpy(), ref[f"{name}/{f}"], VAL_TOL, f)
    np.testing.assert_allclose(hits.full_T.numpy(), ref[f"{name}/full_T"],
                               rtol=FULL_T_REL, atol=0)
    for f in ATTRS if attrs is not None else ():
        np.testing.assert_array_equal(attrs[f].numpy(),
                                      ref[f"{name}/attrs/{f}"], err_msg=f)


@pytest.mark.parametrize("case", sorted(CASES))
def test_trace_matches_jax(case, jax_ref):
    mode, secondary, reach, K, _R, extract = CASES[case]
    o, d = _t(jax_ref, f"{case}/rays_o"), _t(jax_ref, f"{case}/rays_d")
    gpack = _t(jax_ref, f"{case}/gpack")
    kw = dict(max_hits=K, backfacing_max_dist=reach, extract_attrs=extract)
    if mode == "brute":
        hits, attrs = trace_rays_brute(o, d, gpack, 3.0, NEAR, FAR,
                                       secondary, **kw)
    else:
        hits, attrs = trace_rays_culled(
            o, d, gpack, _t(jax_ref, f"{case}/cands"),
            _t(jax_ref, f"{case}/cnear"), 3.0, NEAR, FAR, secondary,
            transmittance_threshold=1e-9, cluster=32, tile=16, **kw)
    assert (attrs is None) != extract
    _assert_hits(hits, jax_ref, case, attrs)


def test_adversarial_cluster_order_matches_jax(jax_ref):
    """The culled trace over a permuted candidate list with no exit equals
    the JAX kernel (and so the XLA trace, tests/test_pallas_kernel.py)."""
    ref = {k.split("/", 1)[1]: v for k, v in jax_ref.items()
           if k.startswith("adversarial/")}
    cands = torch.tensor(ref["cands"])
    t, ids, alpha, gv, lh, _a, log_T, trav = trace_hits(
        torch.tensor(ref["rays_o"]), torch.tensor(ref["rays_d"]),
        torch.tensor(ref["gpack"]), cands,
        torch.zeros(cands.shape, dtype=torch.float32), NEAR, FAR, 3.0, 0.0,
        0.1, 0.9, transmittance_threshold=1e-30, max_hits=16, cluster=32,
        tile=16)
    valid = t.numpy() < 1e37
    np.testing.assert_array_equal(valid, ref["t"] < 1e37)
    np.testing.assert_array_equal(np.where(valid, ids.numpy(), -1),
                                  np.where(valid, ref["ids"], -1))
    np.testing.assert_allclose(np.where(valid, t.numpy(), 0),
                               np.where(valid, ref["t"], 0), rtol=T_REL)
    for f, a in (("alpha", alpha), ("gaussval", gv), ("local_hit", lh)):
        _close(a.numpy(), ref[f], VAL_TOL, f)
    np.testing.assert_allclose(log_T.numpy(), ref["log_T"], rtol=LOG_T_REL)
    np.testing.assert_array_equal(trav.numpy(), ref["traversed"])


def test_early_termination_matches_jax(jax_ref):
    """A high transmittance threshold skips the far cluster (fewer
    traversals) on both sides, and the kept hits agree at each threshold."""
    gpack, o, d = early_termination_inputs()
    trav = {}
    for thr in (0.5, 1e-30):
        t, ids, alpha, _g, _l, _a, log_T, tr = trace_hits(
            torch.tensor(o), torch.tensor(d), torch.tensor(gpack),
            torch.tensor([[0, 1]], dtype=torch.int32),
            torch.tensor([[0.0, 0.0]]), 0.1, 100.0, 3.0, 0.0, 0.1, 0.9,
            transmittance_threshold=thr, max_hits=16, cluster=32, tile=16)
        ref = {f: jax_ref[f"early_{thr}/{f}"] for f in
               ("t", "ids", "alpha", "log_T", "traversed")}
        valid = t.numpy() < 1e37
        np.testing.assert_array_equal(valid, ref["t"] < 1e37)
        np.testing.assert_array_equal(np.where(valid, ids.numpy(), -1),
                                      np.where(valid, ref["ids"], -1))
        np.testing.assert_allclose(np.where(valid, t.numpy(), 0),
                                   np.where(valid, ref["t"], 0), rtol=T_REL)
        _close(alpha.numpy(), ref["alpha"], VAL_TOL, "alpha")
        np.testing.assert_array_equal(tr.numpy(), ref["traversed"])
        np.testing.assert_allclose(log_T.numpy(), ref["log_T"],
                                   rtol=LOG_T_REL)
        trav[thr] = int(tr.sum())
    assert trav[0.5] < trav[1e-30]


def test_brute_walk_inputs_pad_rays_and_gaussians():
    """The brute mode's blocking: rays padded with zero rays, gpack with
    invalid columns, every cluster listed for every block at -INF."""
    o = torch.rand((300, 3))
    gpack = torch.rand((32, 300))
    wo, wd, wg, cands, cnear, thr, cluster, tile, ce = walk_inputs(
        o, o, gpack, None, None, 0.01, 64, 16)
    assert (cluster, tile) == (BRUTE_CLUSTER, BRUTE_TILE)
    assert wo.shape == (512, 3) and not wo[300:].any()
    assert wg.shape == (32, 512) and not wg[:, 300:].any()
    assert cands.tolist() == [[0, 1], [0, 1]] and ce == 2 and thr == 0.0
    assert bool((cnear == float("-inf")).all())
    # the culled mode passes its inputs through, one exit test per cluster
    c = torch.zeros((2, 3), dtype=torch.int32)
    got = walk_inputs(o[:256], o[:256], gpack[:, :256], c, c.float(), 0.01,
                      64, 128)
    assert got[3] is c and got[5:] == (0.01, 64, 128, 1)


if __name__ == "__main__":
    jax_reference(sys.argv[1])
