"""The frozen generators are seeded and repeat bit for bit, and bench800's
keywords are bench.py's pick, copied literally."""

from __future__ import annotations

import json

import pytest
import torch

from perfbench import drivers, inputs, registry

SEED = 2**31 + 77


def room(seed, n_surface=4096, n_far=1024):
    gen = torch.Generator().manual_seed(seed)
    layout = inputs.room_layout("cpu")
    arrays = inputs.room_arrays(gen, n_surface, n_far, layout)
    poses = inputs.ring_cameras(4, "cpu")
    targets = inputs.analytic_targets(gen, poses, 16, 16, layout)
    samples = inputs.tile_samples(gen, 16, 16, 64, 3)
    return arrays, poses, targets, samples


def flat(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in flat(v)]
    return [t for v in x for t in flat(v)]


def test_inputs_repeat_bit_for_bit():
    a, b = room(SEED), room(SEED)
    for x, y in zip(flat(a), flat(b)):
        assert torch.equal(x, y)


def test_inputs_follow_the_seed():
    a, b = room(SEED), room(SEED + 1)
    assert not torch.equal(a[0]["xyz"], b[0]["xyz"])
    assert not torch.equal(a[3][1], b[3][1])


def test_room_shapes_and_padding():
    arrays, poses, targets, _s = room(SEED)
    assert arrays["xyz"].shape == (5120, 3)
    assert set(arrays) == {"xyz", "scaling", "rotation", "opacity",
                           "diffuse", "normal", "f0", "roughness"}
    fields = drivers.scene_fields(arrays, 2048, "cpu")
    assert fields["xyz"].shape[0] == 6144
    assert int(fields["live_mask"].sum()) == 5120
    assert float(fields["opacity"][-1]) == -10.0
    for t in targets:
        assert t["diffuse"].shape == (256, 3) and t["depth"].shape == (256,)
        assert bool((t["depth"] > 0).all())
        assert bool(torch.isfinite(t["specular"]).all())
        n = t["normal"].norm(dim=1)
        assert torch.allclose(n, torch.ones_like(n), atol=1e-5)


def test_pixel_directions_match_the_ports_convention():
    """Targets line up with the program's pixels: the port's
    primary_ray_directions (plain torch) at zero jitter."""
    from perfbench.reference.ops.camera_rays import primary_ray_directions

    _eye, c2w = inputs.room_camera()
    ours = inputs.pixel_directions(24, 16, c2w)
    theirs = primary_ray_directions(24, 16, inputs.FOV_Y, c2w).reshape(-1, 3)
    assert torch.allclose(ours, theirs, atol=1e-6)


def test_bench800_keywords_are_bench_pys_pick():
    """artifacts/bench_best.json's pick as bench.py resolves it:
    mc 128:768:256:256:tc3, K 16, cluster 128, scanq, counters off, bf16
    attributes."""
    cfg = registry.config(registry.benchmark(), "bench800")
    assert cfg["render"] == dict(
        max_hits=16, cull_cluster=128, max_clusters=128,
        max_clusters_secondary=768, cull_tile_secondary=256,
        cull_tile_primary=256, split_far=False, mc_far=32, max_hits_far=0,
        split_radius_scale=1.5, composite_mode="scanq", kernel_stats=False,
        attr_precision="bf16")
    assert cfg["settings"]["secondary_throughput_threshold"] == \
        pytest.approx(1e-3)
    assert (cfg["width"], cfg["height"], cfg["num_bounces"]) == (800, 800, 2)
    sc = cfg["scene"]
    assert sc["init_num_pts"] + sc["init_num_pts_farfield"] == 100_000


def test_gt768_is_upstreams_training_default():
    cfg = registry.config(registry.benchmark(), "gt768")
    sc = cfg["scene"]
    assert (sc["init_num_pts"], sc["init_num_pts_farfield"]) == (100_000,
                                                                  75_000)
    assert drivers.round_up(175_000, sc["pad_multiple"]) == 176_128
    assert cfg["train"]["step"]["max_clusters"] == -(
        -int(192 * 176128 / 100352) // 64) * 64 == 384
    assert cfg["render"]["max_clusters"] == 192
    assert json.dumps(cfg["reduced"]) == "[]"
