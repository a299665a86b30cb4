"""PyTorch port vs the repository's bench: the port's bench.py twin
(editable_gaussian_reflections_tpu_torch/bench.py) and its four tool twins.

The configuration parser and the bench's configuration are held to the
JAX side's own code: tools/bench_render_sweep.py's parse_render_config
(imported by path; it imports jax only inside its main) and bench.py's
lines 117-147 written out with it, on artifacts/bench_best.json, with the
JAX package's RenderSettings.  Then the bench and each tool twin run once on
the CPU at a tiny size (their plain versions), which is what a CPU can
show: the rows and keys (split-far's included), not a speed.
"""

import importlib.util
import json
from pathlib import Path
from unittest import mock

import pytest
import torch

from editable_gaussian_reflections_tpu.renderer.raytracer import (
    RenderSettings as JaxRenderSettings,
)
from editable_gaussian_reflections_tpu_torch import bench
from editable_gaussian_reflections_tpu_torch.renderer import raytracer
from editable_gaussian_reflections_tpu_torch.renderer.render import (
    dispatch_render_frame,
)
from editable_gaussian_reflections_tpu_torch.tools import (
    bench_render_sweep,
    bench_scan_mode,
    bench_slots_kernel,
    bench_train_step,
    fused_setup,
    probe_cand_stats,
)
from editable_gaussian_reflections_tpu_torch.tools.nonfused_setup import room

ROOT = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu", "--n", "2048", "--res", "32"]


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _configs():
    """bench_best's entry, the sweep's defaults, the scan tool's defaults in
    the parser's form, and split-far, far-depth and cutoff forms."""
    best = json.loads((ROOT / "artifacts" / "bench_best.json").read_text())
    scan = [bench_scan_mode.render_config_string(
        bench_scan_mode.parse_config(c))
        for c in bench_scan_mode.DEFAULT_CONFIGS.split(",")]
    return ([best["mc"]] + bench_render_sweep.DEFAULT_CONFIGS.split(",")
            + scan + ["64:96:s32", "64:96:256:128:s48:k8", "96:128:tc2.52",
                      "64:64:s32:k4:tc3"])


def test_parse_render_config_matches_the_tool():
    jax_parse = _jax_tool("bench_render_sweep").parse_render_config
    for cfg in _configs():
        assert bench_render_sweep.parse_render_config(cfg) == jax_parse(cfg), \
            cfg
    # split-far stays split-far: the render takes the far pass's budget
    # and renders every bounce in two passes, never as a one-pass frame
    kw = bench_render_sweep.parse_render_config("64:96:s32:k16")
    assert kw["split_far"] is True
    assert (kw["mc_far"], kw["max_hits_far"]) == (32, 16)
    scene, camera = room(512, "cpu")
    kw.pop("throughput_cutoff")
    with mock.patch.object(raytracer, "split_bounce",
                           wraps=raytracer.split_bounce) as split:
        _steps, final = dispatch_render_frame(
            scene, camera, bench.RenderSettings(),
            torch.Generator().manual_seed(0), 16, 16, **kw)
    assert split.call_count == 3       # 2 bounces: 3 split passes
    assert torch.isfinite(final).all()


def test_bench_config_matches_bench_py(tmp_path):
    """bench.py:117-147 with the JAX parser, on artifacts/bench_best.json."""
    jax_parse = _jax_tool("bench_render_sweep").parse_render_config
    best = json.loads(bench.BEST_PATH.read_text())
    fused_kw = dict(jax_parse(best["mc"]),
                    max_hits=best.get("max_hits", 16),
                    cull_cluster=best.get("cluster", 128),
                    composite_mode=best.get("mode", "kbuffer"),
                    kernel_stats=best.get("kernel_stats", True),
                    attr_precision=best.get("attr_precision", "highest"))
    settings = JaxRenderSettings()
    tcut = fused_kw.pop("throughput_cutoff", -1.0)
    if tcut > 0:
        settings = settings._replace(secondary_throughput_threshold=tcut)
    kw, port_settings = bench.bench_config()
    assert kw == fused_kw
    assert port_settings._asdict() == settings._asdict()
    # without the file: bench.py's default configuration
    kw, port_settings = bench.bench_config(tmp_path / "missing.json")
    assert kw == dict(max_hits=16, cull_cluster=128, max_clusters=96,
                      max_clusters_secondary=192)
    assert port_settings._asdict() == JaxRenderSettings()._asdict()
    # the smoke's fast path times the same frame
    kw, port_settings = bench.bench_config()
    assert fused_setup.BENCH_KW == kw
    assert fused_setup.BENCH_SETTINGS == port_settings


def test_bench_cpu_route_ends_with_its_json_line(capsys):
    """The line reports the run's own time, rounded as bench.py rounds it
    (a slow CPU may round the figure to 0.0: no speed is asserted)."""
    ret = bench.main(CPU)
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(last) == {"metric", "value", "unit", "vs_baseline", "device"}
    assert last["metric"] == bench.METRIC and last["unit"] == "Mrays/s"
    assert last["device"] == "cpu" and ret["ms"] > 0
    assert ret["rays"] == 32 * 32
    assert ret["mrays"] == pytest.approx(ret["rays"] / ret["ms"] / 1e3,
                                         rel=1e-12)
    assert last["value"] == round(ret["mrays"], 3)
    assert last["vs_baseline"] == round(ret["mrays"] / bench.BASELINE_MRAYS,
                                        4)
    assert 8 <= ret["frames"] <= 1 + bench.WARMUP_MAX + bench.TIMED


def test_bench_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default route runs")
    with pytest.raises(SystemExit):
        bench.main([])


def test_render_sweep_twin(capsys, tmp_path):
    out = tmp_path / "best.json"
    best = bench_render_sweep.main(
        CPU + ["--iters", "1", "--out", str(out), "--configs",
               "64:64,96:128:256:256:tc3,64:96:s32"])
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r.get("mc") for r in rows[:3]] == ["64:64", "96:128:256:256:tc3",
                                                "64:96:s32"]
    # the split-far row is a real row (it printed an error before)
    assert "error" not in rows[2] and len(rows[2]["starved"]) == 3
    assert len(rows[0]["starved"]) == 3 and rows[1]["tc_psnr"] > 45.0
    assert rows[3] == {"best_honest": best} and best is not None
    assert json.loads(out.read_text()) == dict(best, max_hits=16,
                                               cluster=128)
    with pytest.raises(SystemExit):
        bench_render_sweep.main(CPU + ["--out", str(bench.BEST_PATH)])


def test_scan_mode_twin(capsys):
    rows = bench_scan_mode.main(
        CPU + ["--iters", "1", "--configs",
               "kbuffer:128:16:96:192,scanq:32:16:128:256:ns=1:ap=bf16,"
               "scan:32:16:128:256:far=32"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert rows[0]["role"] == "reference"
    assert 20.0 < rows[1]["psnr_vs_kbuffer"] < 99.0
    assert lines[2]["cfg"].endswith("far=32") and "error" not in lines[2]
    assert len(lines[2]["starved_per_pass"]) == 3
    assert "best_honest" in lines[-1]


def test_train_step_twin():
    res = bench_train_step.main(["--device", "cpu", "--n", "2048", "--res",
                                 "32", "--iters", "1"])
    assert res["device"] == "cpu" and res["s_per_iter"] > 0
    assert 0.0 < res["l1_diffuse"] < 1.0


def test_train_step_twin_split_far():
    """The JAX tool's --split_far (--mc_far, --max_hits_far) options."""
    res = bench_train_step.main(["--device", "cpu", "--n", "2048", "--res",
                                 "32", "--iters", "1", "--split_far",
                                 "--max_hits_far", "16"])
    assert res["split_far"] is True and res["s_per_iter"] > 0
    assert 0.0 < res["l1_diffuse"] < 1.0


def test_slots_kernel_twin():
    rows = bench_slots_kernel.main(CPU + ["--iters", "1"])
    assert [r["case"] for r in rows] == ["primary", "secondary_shuffled"]
    assert all(r["rays"] == 1024 and r["kernel_ms"] > 0 for r in rows)


def test_probe_cand_stats_twin(capsys):
    """The candidate-count probe at a tiny size: a row per pass and tile
    size with the repaired cull's counts and the parent's (JAX's cone
    test) beside them; the primary tiles' narrow cones count alike, the
    reflected tiles count at least the parent's."""
    out = probe_cand_stats.main(["--device", "cpu", "--n", "2048", "--res",
                                 "32"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert set(out) == {"primary", "secondary"}
    assert lines[-1]["summary"]["primary"]["256"]["mean"] > 0
    for tile in probe_cand_stats.TILES:
        p, s = out["primary"][tile], out["secondary"][tile]
        assert p["mean"] == p["parent"]["mean"] and p["max"] >= p["p99"]
        assert s["mean"] >= s["parent"]["mean"]


def test_probe_parent_cull_is_jax_cull():
    """The probe's parent cone test is the JAX package's, on wide cones
    with per-tile windows (the cases the repair changed)."""
    import jax.numpy as jnp
    import numpy as np

    from editable_gaussian_reflections_tpu.ops import culling as jc
    from editable_gaussian_reflections_tpu_torch.ops import culling as tc

    rng = np.random.default_rng(5)
    o = rng.normal(scale=0.5, size=(1024, 3)).astype(np.float32)
    d = rng.normal(size=(1024, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    center = rng.uniform(-6, 6, (300, 3)).astype(np.float32)
    radius = rng.uniform(0.1, 1.0, 300).astype(np.float32)
    near = np.linspace(0.0, 3.0, 16).astype(np.float32)
    ref = np.asarray(jc.cone_sphere_visible(
        jc.tile_cones(jnp.asarray(o), jnp.asarray(d), 64),
        jc.ClusterBounds(jnp.asarray(center), jnp.asarray(radius),
                         jnp.ones(300, bool)), jnp.asarray(near), 50.0))
    got = probe_cand_stats.parent_visible(
        tc.tile_cones(torch.tensor(o), torch.tensor(d), 64),
        tc.ClusterBounds(torch.tensor(center), torch.tensor(radius),
                         torch.ones(300, dtype=torch.bool)),
        torch.tensor(near), 50.0)
    np.testing.assert_array_equal(got.numpy(), ref)
