"""PyTorch port vs JAX package: the training slots trace.

trace_slots_reference (the plain version of csrc/trace_slots.cu) and
unpack_slots are held against pallas_trace_slots_v4 and pallas_trace_slots
in interpret mode, on the 2048-Gaussian room at 32x16 rays (two 256-ray
tiles), K=16 and a few candidate clusters per tile, for primary rays and for
reflected-ray-like rays with a dead-ray mask; and on an exact depth tie at
the K-th slot that a later hit breaks, where the kept ids must equal the
Pallas drain's on every ray; and in split-far's window modes 1 and 2 (the
near and far pass over per-ray split distances, each culled over its
window), whose two outputs merge_slots joins as the JAX merge_slots does.

The JAX side runs in a child process whose XLA is capped at the AVX
instruction set (as in test_torch_render_frame.py): with FMA contraction,
|u|^2 = <lo,lo> - <lo,ld>^2/<ld,ld> cancels differently and alpha moves by
up to 5e-4 relative on this scene, while the port rounds every product as
the kernels do.  The child also builds the inputs (tables, candidates).

Tolerances:
  * the kept ids and the counters (traversed Gaussians, processed
    clusters) equal on >= 99.9% of rays (they record where the early exit
    happened; the port sorts slots by (t, id), the Pallas kernels by
    (t, slot index), which can differ only on exact depth ties);
  * on those rays, t, alpha, every payload column and log-T within
    1e-5 * scale (scale = max(1, max |reference|) of the column).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from editable_gaussian_reflections_tpu_torch.ops.cuda import layout
from editable_gaussian_reflections_tpu_torch.ops.cuda.trace_slots import (
    exit_mode_for,
    slots_resident_fits,
    trace_slots,
    trace_slots_reference,
)
from editable_gaussian_reflections_tpu_torch.ops.intersect import (
    GaussianFrames,
)
from editable_gaussian_reflections_tpu_torch.scene import gaussian_scene as tgs

# the suite runs in several worker processes on shared cores: one torch
# thread per process keeps them from oversubscribing the CPU
torch.set_num_threads(1)

NEAR, FAR, BF_MAX_DIST, BF_THR, THR = 0.05, 50.0, 0.1, 0.9, 0.01
K, CLUSTER, TILE, MC = 16, 256, 256, 8
H, W = 16, 32
IDS_EQUAL = 0.999
REL_TOL = 1e-5

# the boundary-tie case (test_torch_trace_hits_cuda.boundary_tie_case, K
# 16, cluster 128, one tile): rays share the origin or not
TIE_CASES = {"tie_shared": True, "tie_apart": False}
TIE_CLUSTER = 128

# (rays, JAX kernel, port exit mode, check_every, secondary_static)
CASES = {
    "primary_v4": ("primary", "v4", 0, 8, 0),
    "secondary_dead_v4": ("secondary", "v4", 0, 8, 1),
    "primary_v1": ("primary", "v1", 1, 2, 0),
    "secondary_dead_v1": ("secondary", "v1", 1, 2, 1),
}
CAPACITIES = (2048, 176_128, 393_216, 400_000, 1_000_000)
# split-far's passes on the secondary rays (dead mask, backfacing test):
# window mode, K
WINDOW_CASES = {"window_near_v4": (1, K), "window_far_v4": (2, 8)}


def jax_reference(path):
    """Inputs and JAX outputs of every test here, saved to `path` as npz.
    Run by the jax_ref fixture in a child process."""
    import jax
    import jax.numpy as jnp

    from editable_gaussian_reflections_tpu.ops import culling as jc
    from editable_gaussian_reflections_tpu.ops.camera_rays import (
        primary_ray_directions as j_rays,
    )
    from editable_gaussian_reflections_tpu.ops.pallas import (
        render_kernel as jrk,
    )
    from editable_gaussian_reflections_tpu.ops.pallas.render_kernel_v3 import (
        pallas_trace_slots_v4,
        slots_resident_fits as j_resident_fits,
    )
    from editable_gaussian_reflections_tpu.ops.pallas.trace_kernel import (
        pack_frames as j_pack,
    )
    from editable_gaussian_reflections_tpu.scene import gaussian_scene as jgs
    from editable_gaussian_reflections_tpu.utils.synth import (
        room_camera,
        room_scene,
    )

    @jax.jit
    def prepared(scene):
        # one compile for the whole preparation (op by op, XLA would
        # compile every eager operation on its own)
        frames, attrs = jgs.build_frames(scene, 0.005, 3.0, 1.0)
        perm = jc.morton_order(frames)
        frames, attrs, scene_s = jax.tree_util.tree_map(
            lambda a: a[perm], (frames, attrs, scene))
        return (frames, attrs, scene_s, j_pack(frames, attrs),
                jrk.pack_attr_table(attrs),
                jrk.pack_frame_table(frames, scene_s),
                jc.cluster_bounds(frames, CLUSTER))

    out = {}
    frames, attrs, scene_s, gpack, table, ftable, bounds = prepared(
        jgs.from_arrays(**room_scene(2048), pad_multiple=512))
    for f in frames._fields:
        out[f"frames/{f}"] = np.asarray(getattr(frames, f))
    for f in attrs._fields:
        out[f"attrs/{f}"] = np.asarray(getattr(attrs, f))
    for f in jgs.GaussianScene._fields:
        out[f"scene/{f}"] = np.asarray(getattr(scene_s, f))
    out.update(gpack=np.asarray(gpack), table=np.asarray(table),
               ftable=np.asarray(ftable))

    eye, c2w = room_camera()
    pix, _ = jc.tile_pixel_order(H, W, 16, 16)
    d0 = np.asarray(j_rays(W, H, jnp.asarray(0.9), jnp.asarray(c2w))
                    ).reshape(-1, 3)[pix]
    o0 = np.broadcast_to(eye, d0.shape).astype(np.float32)
    rng = np.random.default_rng(6)
    o1 = (o0 + rng.normal(scale=0.5, size=o0.shape)).astype(np.float32)
    d1 = rng.normal(size=d0.shape)
    d1 = (d1 / np.linalg.norm(d1, axis=-1, keepdims=True)).astype(np.float32)
    alive = (np.arange(H * W) % 3) != 0
    alive[-TILE:] = False      # one wholly dead tile
    rays = dict(primary=(o0, np.ascontiguousarray(d0), None, NEAR),
                secondary=(o1, d1, alive, 0.0))
    for kind, (o, d, al, near) in rays.items():
        cands, cnear, _n, _o, _t = jc.select_candidates(
            jnp.asarray(o), jnp.asarray(d), bounds, jnp.float32(near),
            jnp.float32(FAR), tile=TILE, max_clusters=MC)
        out.update({f"{kind}/o": o, f"{kind}/d": d,
                    f"{kind}/cands": np.asarray(cands),
                    f"{kind}/cnear": np.asarray(cnear)})
        if al is not None:
            out[f"{kind}/alive"] = al

    for case, (kind, kernel, _mode, _ce, ss) in CASES.items():
        o, d, al, near = rays[kind]
        common = (jnp.asarray(out[f"{kind}/cands"]),
                  jnp.asarray(out[f"{kind}/cnear"]), near, FAR, 3.0,
                  float(ss), BF_MAX_DIST, BF_THR)
        kw = dict(transmittance_threshold=THR, max_hits=K, cluster=CLUSTER,
                  tile=TILE, interpret=True, secondary_static=ss,
                  alive=None if al is None else jnp.asarray(al))
        if kernel == "v4":
            slots, acc = pallas_trace_slots_v4(
                jnp.asarray(o), jnp.asarray(d), gpack, ftable, *common, **kw)
        else:
            slots, acc = jrk.pallas_trace_slots(
                jnp.asarray(o), jnp.asarray(d), gpack, table, ftable,
                *common, **kw)
        out[f"{case}/slots"] = np.asarray(slots)
        out[f"{case}/acc"] = np.asarray(acc)

    from test_torch_trace_hits_cuda import boundary_tie_case
    for case, shared in TIE_CASES.items():
        tie = boundary_tie_case(K=K, cluster=TIE_CLUSTER, shared=shared)
        slots, acc = pallas_trace_slots_v4(
            jnp.asarray(tie["rays_o"]), jnp.asarray(tie["rays_d"]),
            jnp.asarray(tie["gpack"]), jnp.asarray(tie["ftable"]),
            jnp.asarray(tie["candidates"]), jnp.asarray(tie["cand_near"]),
            NEAR, FAR, 3.0, 0.0, BF_MAX_DIST, BF_THR,
            transmittance_threshold=THR, max_hits=K, cluster=TIE_CLUSTER,
            tile=TILE, interpret=True, secondary_static=0)
        out[f"{case}/slots"] = np.asarray(slots)
        out[f"{case}/acc"] = np.asarray(acc)

    o, d, al, _near = rays["secondary"]
    t_split = np.random.default_rng(9).uniform(1.0, 8.0, H * W).astype(
        np.float32)
    out["window/t_split"] = t_split
    ts_tiles = t_split.reshape(-1, TILE)
    for case, (wmode, k) in WINDOW_CASES.items():
        cull_near, cull_far = ((0.0, ts_tiles.max(axis=1)) if wmode == 1
                               else (ts_tiles.min(axis=1), FAR))
        cands, cnear, _n, _o, _t = jc.select_candidates(
            jnp.asarray(o), jnp.asarray(d), bounds, jnp.asarray(cull_near),
            jnp.asarray(cull_far, jnp.float32), tile=TILE, max_clusters=MC)
        slots, acc = pallas_trace_slots_v4(
            jnp.asarray(o), jnp.asarray(d), gpack, ftable, cands, cnear, 0.0,
            FAR, 3.0, 1.0, BF_MAX_DIST, BF_THR, transmittance_threshold=THR,
            max_hits=k, cluster=CLUSTER, tile=TILE, interpret=True,
            alive=jnp.asarray(al), t_split=jnp.asarray(t_split),
            window_mode=wmode, secondary_static=1)
        out.update({f"{case}/cands": np.asarray(cands),
                    f"{case}/cnear": np.asarray(cnear),
                    f"{case}/slots": np.asarray(slots),
                    f"{case}/acc": np.asarray(acc)})
    merged = jrk.merge_slots(out["window_near_v4/slots"],
                             out["window_near_v4/acc"],
                             out["window_far_v4/slots"],
                             out["window_far_v4/acc"], K, 8)
    out["merged/slots"], out["merged/acc"] = (np.asarray(a) for a in merged)

    unpacked = jrk.unpack_slots(out["secondary_dead_v4/slots"],
                                out["secondary_dead_v4/acc"], K,
                                jnp.asarray(o), jnp.asarray(d))
    for name, group in zip(("hits", "attrs", "frames"), unpacked):
        for k, v in group.items():
            out[f"unpack/{name}/{k}"] = np.asarray(v)
    out["resident_fits"] = np.array([j_resident_fits(n) for n in CAPACITIES])
    np.savez(path, **out)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """jax_reference's arrays, computed by XLA without FMA contraction
    (module docstring) in a child process: XLA reads its flags once per
    process."""
    path = tmp_path_factory.mktemp("jax_trace_slots") / "ref.npz"
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


def _port_slots(ref, kind, exit_mode, check_every, secondary_static,
                fn=trace_slots_reference):
    t = {k: torch.tensor(ref[k]) for k in ("gpack", "table", "ftable")}
    x = {k: torch.tensor(ref[f"{kind}/{k}"])
         for k in ("o", "d", "cands", "cnear")}
    alive = (torch.tensor(ref[f"{kind}/alive"])
             if f"{kind}/alive" in ref else None)
    near = NEAR if kind == "primary" else 0.0
    slots, acc = fn(
        x["o"], x["d"], t["gpack"], t["table"], t["ftable"], x["cands"],
        x["cnear"], near, FAR, 3.0, float(secondary_static),
        BF_MAX_DIST, BF_THR, transmittance_threshold=THR, max_hits=K,
        cluster=CLUSTER, tile=TILE, alive=alive,
        secondary_static=secondary_static, exit_mode=exit_mode,
        check_every=check_every)
    return slots.numpy(), acc.numpy()


def _blocks(slots, k=K):
    return slots.reshape(slots.shape[0], layout.SLOT_BLOCKS, k)


def assert_slots_match(slots, acc, ref_slots, ref_acc, k=K):
    s, r = _blocks(slots, k), _blocks(ref_slots, k)
    same = ((s[:, layout.SLOT_ID] == r[:, layout.SLOT_ID]).all(axis=1)
            & (acc[:, 1:3] == ref_acc[:, 1:3]).all(axis=1))
    assert same.mean() >= IDS_EQUAL, f"ids/counters equal on {same.mean()}"
    for b in range(layout.SLOT_BLOCKS):
        a, e = s[same, b], r[same, b]
        if b == layout.SLOT_T:        # empty slots: INF on both sides
            a, e = np.where(e < 1e37, a, 0.0), np.where(e < 1e37, e, 0.0)
        scale = max(1.0, float(np.abs(e).max(initial=0.0)))
        np.testing.assert_allclose(a, e, rtol=0, atol=REL_TOL * scale,
                                   err_msg=f"slot block {b}")
    scale = max(1.0, float(np.abs(ref_acc[same, 0]).max(initial=0.0)))
    np.testing.assert_allclose(acc[same, 0], ref_acc[same, 0], rtol=0,
                               atol=REL_TOL * scale, err_msg="log-T")
    np.testing.assert_array_equal(acc[:, 3:], 0.0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_pallas(case, jax_ref):
    kind, _kernel, exit_mode, check_every, ss = CASES[case]
    ref_slots, ref_acc = jax_ref[f"{case}/slots"], jax_ref[f"{case}/acc"]
    slots, acc = _port_slots(jax_ref, kind, exit_mode, check_every, ss)
    assert slots.shape == ref_slots.shape == (H * W, layout.SLOT_BLOCKS * K)
    assert np.isfinite(slots).all() and np.isfinite(acc).all()
    assert_slots_match(slots, acc, ref_slots, ref_acc)
    valid = _blocks(slots)[:, layout.SLOT_T] < 1e37
    assert valid.any()
    if f"{kind}/alive" in jax_ref:
        dead = ~jax_ref[f"{kind}/alive"]
        assert not valid[dead].any()
        assert np.all(acc[dead, 0] == 0.0)


@pytest.mark.parametrize("case", sorted(TIE_CASES))
def test_boundary_tie_matches_pallas(case, jax_ref):
    """An exact depth tie at the K-th slot that a later, nearer hit breaks
    (test_torch_trace_hits_cuda.boundary_tie_case): the plain walk keeps
    the Gaussian pallas_trace_slots_v4's drain keeps (A, not B), on every
    ray; ids and counters equal exactly."""
    from test_torch_trace_hits_cuda import boundary_tie_case

    tie = boundary_tie_case(K=K, cluster=TIE_CLUSTER, shared=TIE_CASES[case])
    t = {k: torch.tensor(v) for k, v in tie.items() if k not in ("a", "b")}
    slots, acc = trace_slots_reference(
        t["rays_o"], t["rays_d"], t["gpack"], t["table"], t["ftable"],
        t["candidates"], t["cand_near"], NEAR, FAR, 3.0, 0.0, BF_MAX_DIST,
        BF_THR, transmittance_threshold=THR, max_hits=K, cluster=TIE_CLUSTER,
        tile=TILE, exit_mode=0, check_every=8)
    slots, acc = slots.numpy(), acc.numpy()
    ref_slots, ref_acc = jax_ref[f"{case}/slots"], jax_ref[f"{case}/acc"]
    ids, ref_ids = _blocks(slots)[:, layout.SLOT_ID], _blocks(
        ref_slots)[:, layout.SLOT_ID]
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_array_equal(acc[:, 1:3], ref_acc[:, 1:3])
    assert (ids == tie["a"]).any(axis=1).all()
    assert not (ids == tie["b"]).any()
    assert_slots_match(slots, acc, ref_slots, ref_acc)


def _port_window_slots(ref, case, fn=trace_slots_reference):
    wmode, k = WINDOW_CASES[case]
    t = {n: torch.tensor(ref[n]) for n in ("gpack", "table", "ftable")}
    slots, acc = fn(
        torch.tensor(ref["secondary/o"]), torch.tensor(ref["secondary/d"]),
        t["gpack"], t["table"], t["ftable"],
        torch.tensor(ref[f"{case}/cands"]), torch.tensor(ref[f"{case}/cnear"]),
        0.0, FAR, 3.0, 1.0, BF_MAX_DIST, BF_THR, transmittance_threshold=THR,
        max_hits=k, cluster=CLUSTER, tile=TILE,
        alive=torch.tensor(ref["secondary/alive"]), secondary_static=1,
        exit_mode=0, check_every=8,
        t_split=torch.tensor(ref["window/t_split"]), window_mode=wmode)
    return slots.numpy(), acc.numpy()


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_reference_window_matches_pallas(case, jax_ref):
    """Window mode 1 keeps only hits before each ray's t_split, mode 2
    only those beyond it, as pallas_trace_slots_v4 (interpret mode)
    does."""
    wmode, k = WINDOW_CASES[case]
    slots, acc = _port_window_slots(jax_ref, case)
    assert_slots_match(slots, acc, jax_ref[f"{case}/slots"],
                       jax_ref[f"{case}/acc"], k)
    t = _blocks(slots, k)[:, layout.SLOT_T]
    valid = t < 1e37
    ts = jax_ref["window/t_split"][:, None]
    assert valid.any() and (valid & ~jax_ref["secondary/alive"][:, None]
                            ).sum() == 0
    assert ((t < ts) if wmode == 1 else (t > ts))[valid].all()


def test_merge_slots_matches_jax(jax_ref):
    """merge_slots on the two windowed passes' port slots equals JAX's
    merge_slots on the Pallas kernel's: the near slots then the far ones in
    every block, the first three acc lanes added."""
    n = _port_window_slots(jax_ref, "window_near_v4")
    f = _port_window_slots(jax_ref, "window_far_v4")
    slots, acc = layout.merge_slots(*(torch.tensor(a) for a in (*n, *f)),
                                    K, 8)
    assert slots.shape == (H * W, layout.SLOT_BLOCKS * (K + 8))
    assert_slots_match(slots.numpy(), acc.numpy(), jax_ref["merged/slots"],
                       jax_ref["merged/acc"], K + 8)
    # on JAX's own inputs the two merges are the same arrays
    got = layout.merge_slots(*(torch.tensor(jax_ref[f"{c}/{x}"]) for c in (
        "window_near_v4", "window_far_v4") for x in ("slots", "acc")), K, 8)
    np.testing.assert_array_equal(got[0].numpy(), jax_ref["merged/slots"])
    np.testing.assert_array_equal(got[1].numpy(), jax_ref["merged/acc"])


def test_window_refused_in_exit_mode_1(jax_ref):
    """pallas_trace_slots (exit mode 1) has no window; nor has its port."""
    with pytest.raises(ValueError, match="window"):
        _port_slots(jax_ref, "primary", 1, 2, 0, fn=lambda *a, **kw: (
            trace_slots(*a, **kw, t_split=None, window_mode=1)))


def test_unpack_slots_matches_jax(jax_ref):
    """The port's unpack_slots on the JAX kernel's own slots: every field
    the composite and the backward read."""
    got = layout.unpack_slots(
        torch.tensor(jax_ref["secondary_dead_v4/slots"]),
        torch.tensor(jax_ref["secondary_dead_v4/acc"]), K,
        torch.tensor(jax_ref["secondary/o"]),
        torch.tensor(jax_ref["secondary/d"]))
    for name, group in zip(("hits", "attrs", "frames"), got):
        keys = {k.split("/")[2] for k in jax_ref
                if k.startswith(f"unpack/{name}/")}
        assert keys == set(group), name
        for k in keys:
            e, a = jax_ref[f"unpack/{name}/{k}"], group[k].numpy()
            assert a.shape == e.shape, (name, k)
            if e.dtype == bool or e.dtype.kind == "i":
                np.testing.assert_array_equal(a, e, err_msg=f"{name}.{k}")
            else:
                scale = max(1.0, float(np.abs(e).max(initial=0.0)))
                np.testing.assert_allclose(a, e, rtol=REL_TOL,
                                           atol=REL_TOL * scale,
                                           err_msg=f"{name}.{k}")


def test_tables_match_jax(jax_ref):
    def t(group, names):
        return [torch.tensor(jax_ref[f"{group}/{f}"]) for f in names]

    frames = GaussianFrames(*t("frames", GaussianFrames._fields))
    attrs = tgs.SceneAttributes(*t("attrs", tgs.SceneAttributes._fields))
    scene = tgs.GaussianScene(*t("scene", tgs.GaussianScene._fields))
    np.testing.assert_array_equal(layout.pack_attr_table(attrs).numpy(),
                                  jax_ref["table"])
    np.testing.assert_allclose(layout.pack_frame_table(frames, scene).numpy(),
                               jax_ref["ftable"], rtol=1e-6, atol=0)


def test_wrapper_takes_plain_version_for_cpu_tensors(jax_ref):
    before = trace_slots.launches
    a = _port_slots(jax_ref, "primary", 0, 8, 0, fn=trace_slots)
    b = _port_slots(jax_ref, "primary", 0, 8, 0)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)
    assert trace_slots.launches == before  # no kernel launched


def test_exit_mode_follows_the_jax_dispatch(jax_ref):
    for n, fits in zip(CAPACITIES, jax_ref["resident_fits"]):
        assert slots_resident_fits(n) == bool(fits), n
        assert exit_mode_for(n) == ((0, 8) if fits else (1, 2))


if __name__ == "__main__":
    jax_reference(sys.argv[1])
