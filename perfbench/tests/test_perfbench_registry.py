"""The harness finds configurations, traffic mixes, traffic kinds and metric
readers by name, picks up one added as files without an edit, and
BENCHMARK.json keeps to the contract's shape."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from perfbench import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
BENCH = registry.benchmark()


def test_every_cell_finds_its_files():
    for cell in BENCH["workloads"]:
        cfg = registry.config(BENCH, cell["config"])
        traffic = registry.traffic(cell["traffic"])
        assert cfg["name"] == cell["config"]
        kind = registry.kind(traffic["kind"])
        assert callable(kind.Driver) and callable(kind.compare)
        assert traffic["kind"] in cfg["limits"]
        for section in ("end_to_end", "per_layer"):
            for m in registry.metrics_for(BENCH, cell["name"], section):
                assert callable(registry.reader(m["name"]))


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    e2e = {m["name"] for m in registry.metrics_for(BENCH, cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert registry.metrics_for(BENCH, cell, "per_layer")


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in BENCH["configs"]] + \
        [w["name"] for w in BENCH["workloads"]] + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    moves = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in moves
        for cell in m["workloads"]:
            reported = {e["name"] for e in registry.metrics_for(
                BENCH, cell, "end_to_end")}
            assert m["moves"] in reported
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_an_added_cell_config_traffic_kind_and_metric_are_found(tmp_path):
    """A later change adds files and entries only: the harness finds them."""
    base = tmp_path / "perfbench"
    shutil.copytree(registry.HERE / "kinds", base / "kinds")
    shutil.copytree(registry.HERE / "traffic", base / "traffic")
    shutil.copytree(registry.HERE / "metrics", base / "metrics")
    shutil.copytree(registry.HERE / "configs", base / "configs")
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((base / "configs" / "gt768.json").read_text())
    cfg["resolution"] = 512
    (base / "configs" / "gt512.json").write_text(json.dumps(cfg))
    bench["configs"].append(dict(name="gt512", source="x",
                                 file="perfbench/configs/gt512.json",
                                 reduced=[], why="x"))
    (base / "kinds" / "replay.py").write_text(
        "FAULTS = ()\n\n\nclass Driver:\n    checked_items = 0\n\n\n"
        "def compare(driver, kept, opts):\n    return {}\n")
    (base / "traffic" / "orbit_fast.json").write_text(json.dumps(
        dict(registry.traffic("orbit"), warmup=1, kind="replay")))
    bench["workloads"].append(dict(name="gt512.fast", config="gt512",
                                   traffic="orbit_fast", chips=1, why="x"))
    (base / "metrics" / "frames_counted.view.py").write_text(
        "def read(run):\n    return run.win.attempted\n")
    bench["per_layer"].append(dict(
        name="frames_counted.view", unit="frames", better="higher",
        source="host_clock", layer="entry", moves="frame_ms",
        workloads=["gt512.fast"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    got = registry.benchmark(tmp_path)
    cell = registry.workload(got, "gt512.fast")
    assert registry.config(got, cell["config"], tmp_path)["resolution"] == 512
    traffic = registry.traffic(cell["traffic"], base)
    assert traffic["warmup"] == 1
    assert registry.kind(traffic["kind"], base).Driver.checked_items == 0
    names = [m["name"] for m in registry.metrics_for(got, "gt512.fast",
                                                     "per_layer")]
    assert "frames_counted.view" in names

    class Run:
        class win:
            attempted = 7

    assert registry.reader("frames_counted.view", base)(Run) == 7
