"""PyTorch port vs JAX package: the streaming scan-composite kernel.

render_scan_reference (the plain version of csrc/render_scan.cu) is held
against pallas_render_culled_v6 (direct pair math) and
pallas_render_culled_v7 (quadric pair math) in interpret mode, on the
room_scene(1024) fixture of tests/test_render_kernel.py at 32x32 rays, with
the JAX side run by tests/test_render_kernel_v5.py::_run.  Clusters 32 and
64, primary and reflected rays, exhaustive and culled candidate lists, a
partly dead `alive`.

Tolerances, set from a reading of every case here (JAX in this process,
where XLA on the CPU may contract multiply-adds into FMAs; the port rounds
every product):
  * direct: float lanes rtol 1e-3, atol 2e-5 (measured: at most 8.4e-5
    absolute, on the depth lane, and at most 4.4e-6 beyond 1e-3 * |ref|;
    besides the FMAs, the JAX kernel builds the in-chunk product with a
    Hillis-Steele tree and sums each chunk in float32, the port in float64
    in table order);
  * quadric: rtol 1e-3, atol 1e-4 (measured: at most 1.2e-4 absolute, on
    the depth lane, and 2.3e-5 beyond 1e-3 * |ref|; the port rounds S, q
    and c once from float64, JAX computes them in float32);
  * the counters (composited hits, traversed Gaussians) exactly;
  * bf16 attributes: atol 1e-2 on the attribute lanes (measured 2.2e-3):
    XLA on the CPU computes the JAX kernel's DEFAULT-precision dot in full
    float32, while the port rounds w and the attribute to bf16 as a TPU's
    one-pass dot does (relative step 2^-8).

The kernel itself runs only on a CUDA card: test_torch_scan_cuda.py
compares it with this plain version there.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editable_gaussian_reflections_tpu.ops import culling as jc
from editable_gaussian_reflections_tpu.ops.pallas.render_kernel_v6 import (
    pallas_render_culled_v6,
)
from editable_gaussian_reflections_tpu.ops.pallas.render_kernel_v7 import (
    pack_quadric_lanes,
    pallas_render_culled_v7,
)
from editable_gaussian_reflections_tpu.ops.pallas.trace_kernel import (
    pack_frames as j_pack,
)
from editable_gaussian_reflections_tpu_torch.ops import culling as tc
from editable_gaussian_reflections_tpu_torch.ops.cuda import layout
from editable_gaussian_reflections_tpu_torch.ops.cuda.scan_kernel import (
    render_scan,
    render_scan_reference,
    scan_fits,
)
from editable_gaussian_reflections_tpu_torch.ops.intersect import (
    GaussianFrames,
)
from tests.test_render_kernel import SETTINGS, _rays, _room
from tests.test_render_kernel_v5 import _run

# the suite runs in several worker processes on shared cores: one torch
# thread per process keeps them from oversubscribing the CPU
torch.set_num_threads(1)

NEAR, FAR = 0.05, 50.0
JAX_KERNELS = {"direct": pallas_render_culled_v6,
               "quadric": pallas_render_culled_v7}
FLOAT_FIELDS = ("rgb", "normal", "f0", "roughness", "depth", "T_final",
                "full_T")
TOL = {"direct": dict(atol=2e-5, rtol=1e-3),
       "quadric": dict(atol=1e-4, rtol=1e-3)}


@functools.cache
def _inputs(kind):
    """The room's frames and attributes, and the rays: primary, or
    reflected-like (origins spread over the room, scattered directions)."""
    _scene, frames, attrs = _room(1024)
    o, d = (np.asarray(a) for a in _rays())
    if kind == "secondary":
        rng = np.random.default_rng(6)
        o = (o + rng.normal(scale=0.5, size=o.shape)).astype(np.float32)
        d = rng.normal(size=d.shape)
        d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return frames, attrs, np.ascontiguousarray(o), np.ascontiguousarray(d)


def _alive(R):
    return (np.arange(R) % 3) != 0


def _port_run(pair_math, frames, attrs, o, d, *, cluster, tile,
              exhaustive=False, thr=None, secondary=0.0, alive=None,
              t_split=None, window_mode=0, secondary_static=-1, stats=True,
              attr_precision="highest"):
    """The port's render_scan on the inputs _run gives the JAX kernel (the
    same candidate lists), as a dict of _run's fields plus the raw lanes."""
    gpack = j_pack(frames, attrs)
    n_c = gpack.shape[1] // cluster
    if exhaustive:
        n_t = o.shape[0] // tile
        cands = np.broadcast_to(np.arange(n_c, dtype=np.int32), (n_t, n_c))
        cnear = np.zeros((n_t, n_c), np.float32)
    else:
        cands, cnear, _n, _o, _t = jc.select_candidates(
            jnp.asarray(o), jnp.asarray(d), jc.cluster_bounds(frames, cluster),
            jnp.float32(NEAR), jnp.float32(FAR), tile=tile, max_clusters=n_c)
    scan = layout.pack_scan_table(torch.tensor(np.asarray(gpack)), pair_math)

    def t(x):
        return None if x is None else torch.tensor(np.ascontiguousarray(x))

    out = render_scan(
        t(o), t(d), scan, t(cands), t(cnear), NEAR, FAR, 3.0, secondary,
        SETTINGS.backfacing_max_dist,
        SETTINGS.backfacing_invalid_normal_threshold,
        transmittance_threshold=(thr if thr is not None
                                 else SETTINGS.transmittance_threshold),
        cluster=cluster, tile=tile, alive=t(alive), t_split=t(t_split),
        window_mode=window_mode, secondary_static=secondary_static,
        stats=stats, attr_precision=attr_precision).numpy()
    comp = {k: np.asarray(v) for k, v in
            layout.unpack_composite(torch.tensor(out)).items()}
    comp["lanes"] = out
    return comp


def _jax_run(pair_math, frames, attrs, o, d, **kw):
    out = _run(JAX_KERNELS[pair_math], frames, attrs, jnp.asarray(o),
               jnp.asarray(d), **{k: (jnp.asarray(v) if isinstance(
                   v, np.ndarray) else v) for k, v in kw.items()})
    return {k: np.asarray(v) for k, v in out.items()}


def assert_matches(out, ref, pair_math, fields=FLOAT_FIELDS, counters=True):
    for f in fields:
        np.testing.assert_allclose(out[f], ref[f], err_msg=f,
                                   **TOL[pair_math])
    if counters:
        for f in ("num_accumulated", "num_traversed"):
            np.testing.assert_array_equal(out[f], ref[f], err_msg=f)


# (pair math, cluster, rays, exhaustive, alive, secondary_static, window)
CASES = {
    "direct_c32_primary_culled": ("direct", 32, "primary", False, False, 0,
                                  0),
    "direct_c64_secondary_exhaustive": ("direct", 64, "secondary", True,
                                        False, 1, 0),
    "direct_c32_secondary_culled_alive": ("direct", 32, "secondary", False,
                                          True, 1, 0),
    "direct_c64_primary_far_window_alive": ("direct", 64, "primary", False,
                                            True, 0, 2),
    "quadric_c32_primary_culled": ("quadric", 32, "primary", False, False, 0,
                                   0),
    "quadric_c64_secondary_culled_alive": ("quadric", 64, "secondary", False,
                                           True, 1, 0),
    "quadric_c64_primary_exhaustive_alive": ("quadric", 64, "primary", True,
                                             True, 0, 0),
}


def _case_kw(case):
    pair_math, cluster, kind, exhaustive, with_alive, ss, wmode = CASES[case]
    frames, attrs, o, d = _inputs(kind)
    R = o.shape[0]
    kw = dict(cluster=cluster, tile=128, exhaustive=exhaustive,
              secondary=1.0 if ss else 0.0, secondary_static=ss,
              alive=_alive(R) if with_alive else None)
    if wmode:
        kw.update(window_mode=wmode, t_split=np.random.default_rng(7).uniform(
            1.0, 4.0, R).astype(np.float32))
    return pair_math, (frames, attrs, o, d), kw


@functools.cache
def _jax_case(case, attr_precision="highest"):
    """The JAX kernel's output for a case (computed once per process)."""
    pair_math, inputs, kw = _case_kw(case)
    if pair_math == "quadric":  # v6 has no attribute-precision option
        kw["attr_precision"] = attr_precision
    return _jax_run(pair_math, *inputs, **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_pallas(case):
    pair_math, inputs, kw = _case_kw(case)
    ref = _jax_case(case)
    out = _port_run(pair_math, *inputs, **kw)
    assert out["lanes"].shape == (inputs[2].shape[0], layout.OUT_LANES)
    assert np.isfinite(out["lanes"]).all()
    assert_matches(out, ref, pair_math)
    if kw["alive"] is not None:
        dead = ~kw["alive"]
        assert np.all(out["lanes"][dead, :layout.OUT_TFINAL] == 0.0)
        assert np.all(out["T_final"][dead] == 1.0)


@pytest.mark.parametrize("case", ["direct_c32_primary_culled",
                                  "quadric_c64_secondary_culled_alive"])
def test_stats_off_matches_pallas_and_zeroes_the_counters(case):
    """stats=False compiles the counters out of the JAX kernels and the
    port's alike; every other lane is unchanged."""
    pair_math, inputs, kw = _case_kw(case)
    out = _port_run(pair_math, *inputs, stats=False, **kw)
    on = _port_run(pair_math, *inputs, stats=True, **kw)
    assert_matches(out, _jax_case(case), pair_math, counters=False)
    counters = slice(layout.OUT_NUMACC, layout.OUT_LANES)
    assert np.all(out["lanes"][:, counters] == 0.0)
    assert on["lanes"][:, layout.OUT_TRAV].min() > 0.0
    np.testing.assert_array_equal(out["lanes"][:, :layout.OUT_NUMACC],
                                  on["lanes"][:, :layout.OUT_NUMACC])


def test_bf16_attributes_match_pallas_to_bf16():
    case = "quadric_c64_secondary_culled_alive"
    pair_math, inputs, kw = _case_kw(case)
    ref = _jax_case(case, "bf16")
    out = _port_run(pair_math, *inputs, attr_precision="bf16", **kw)
    exact = _port_run(pair_math, *inputs, **kw)
    for f in ("rgb", "normal", "f0", "roughness"):
        np.testing.assert_allclose(out[f], ref[f], atol=1e-2, rtol=0,
                                   err_msg=f)
    # only the attribute lanes change; the rounding shows
    assert_matches(out, ref, "quadric", fields=("depth", "T_final", "full_T"))
    assert np.abs(out["rgb"] - exact["rgb"]).max() > 0.0
    np.testing.assert_array_equal(out["depth"], exact["depth"])


def test_bf16_needs_the_quadric_table():
    _, inputs, kw = _case_kw("direct_c32_primary_culled")
    with pytest.raises(ValueError, match="bf16"):
        _port_run("direct", *inputs, attr_precision="bf16", **kw)


def _torch_frames(frames):
    return GaussianFrames(**{f: torch.tensor(np.asarray(getattr(frames, f)))
                             for f in GaussianFrames._fields})


@pytest.mark.parametrize("cluster", [32, 256])
def test_sort_within_clusters_matches(cluster):
    frames, _attrs, _o, _d = _inputs("primary")
    view_dir = np.asarray([0.3, -0.2, -0.9], np.float32)
    ref = np.asarray(jc.sort_within_clusters(frames, jnp.asarray(view_dir),
                                             cluster))
    out = tc.sort_within_clusters(_torch_frames(frames),
                                  torch.tensor(view_dir), cluster).numpy()
    np.testing.assert_array_equal(out, ref)
    # a permutation within each cluster
    assert np.all(out // cluster == np.arange(out.size) // cluster)


def test_quadric_table_matches_pack_quadric_lanes():
    frames, attrs, _o, _d = _inputs("primary")
    gpack = j_pack(frames, attrs)
    tq, center = (np.asarray(a) for a in pack_quadric_lanes(gpack))
    scan = layout.pack_scan_table(torch.tensor(np.asarray(gpack)), "quadric")
    table = scan.table.numpy()
    np.testing.assert_allclose(scan.center.numpy(), center, rtol=1e-6,
                               atol=1e-6)
    S = table[:, layout.Q_S:layout.Q_S + 6]
    # JAX columns (render_kernel_v7.py): w_dd, w_od, -S mu', w_dd, -2 S mu',
    # mu'^T S mu', M^T nrm
    w_dd = np.concatenate([S[:, :3], 2.0 * S[:, 3:]], axis=1)
    nq = table[:, layout.Q_NQ:layout.Q_NQ + 3]
    ours = np.concatenate([w_dd, S, nq, w_dd, 2.0 * nq,
                           table[:, layout.Q_C:layout.Q_C + 1],
                           table[:, layout.Q_ND:layout.Q_ND + 3]], axis=1)
    theirs = tq[:, 32:60]
    # measured: at most 2.0e-7 of each column's scale (JAX rounds S, q and c
    # through float32 products, the port once from float64)
    for j in range(theirs.shape[1]):
        scale = float(np.abs(theirs[:, j]).max())
        np.testing.assert_allclose(ours[:, j], theirs[:, j], rtol=1e-5,
                                   atol=1e-6 * scale, err_msg=f"column {j}")
    g = np.asarray(gpack)
    for col, row in ((layout.Q_OPACITY, 15), (layout.Q_SF2, 16),
                     (layout.Q_NLEN, 20), (layout.Q_VALID, 21)):
        np.testing.assert_array_equal(table[:, col], g[row])
    np.testing.assert_array_equal(
        table[:, layout.SCAN_ATTR:layout.SCAN_ATTR + layout.NUM_ATTR],
        g[list(layout.ATTR_ROWS)].T)
    direct = layout.pack_scan_table(torch.tensor(g), "direct").table.numpy()
    np.testing.assert_array_equal(direct[:, :layout.SCAN_GEOM],
                                  g[:layout.SCAN_GEOM].T)


def test_wrapper_takes_plain_version_for_cpu_tensors():
    pair_math, inputs, kw = _case_kw("quadric_c32_primary_culled")
    before = render_scan.launches
    a = _port_run(pair_math, *inputs, **kw)["lanes"]
    frames, attrs, o, d = inputs
    gpack = torch.tensor(np.asarray(j_pack(frames, attrs)))
    cands, cnear, *_ = jc.select_candidates(
        jnp.asarray(o), jnp.asarray(d), jc.cluster_bounds(frames, 32),
        jnp.float32(NEAR), jnp.float32(FAR), tile=128,
        max_clusters=gpack.shape[1] // 32)
    b = render_scan_reference(
        torch.tensor(o), torch.tensor(d),
        layout.pack_scan_table(gpack, pair_math),
        torch.tensor(np.asarray(cands)), torch.tensor(np.asarray(cnear)),
        NEAR, FAR, 3.0, 0.0, SETTINGS.backfacing_max_dist,
        SETTINGS.backfacing_invalid_normal_threshold, cluster=32, tile=128,
        secondary_static=0).numpy()
    np.testing.assert_array_equal(a, b)
    assert render_scan.launches == before  # no kernel launched


def test_scan_fits_follows_the_jax_budget():
    # (N + C) * 128 lanes * 4 bytes <= 96 MiB (render_kernel_v5.py:373)
    assert scan_fits(100_352, 256)
    assert scan_fits(196_352, 256)
    assert not scan_fits(196_608, 256)
    assert not scan_fits(1_000_000, 128)
