"""The reference agrees with the port's plain CPU path at a tiny size (bit
for bit: it is a copy of the port's plain versions on another schedule),
and its bfloat16 control does not."""

from __future__ import annotations

import pytest
import torch

from perfbench import check, controls, drivers, inputs, program, registry

FRAMES = registry.kind("frames")
TRAIN = registry.kind("train")
W = H = 32
SEED = 2**31 + 5


@pytest.fixture(scope="module")
def room():
    gen = torch.Generator().manual_seed(SEED)
    layout = inputs.room_layout("cpu")
    arrays = inputs.room_arrays(gen, 4096, 1024, layout)
    fields = drivers.scene_fields(arrays, 2048, "cpu")
    poses = inputs.ring_cameras(2, "cpu")
    targets = inputs.analytic_targets(gen, poses, W, H, layout)
    return fields, poses, targets


FRAME_KW = dict(
    kbuffer=dict(max_hits=32, cull_cluster=256, max_clusters=8,
                 composite_mode="kbuffer"),
    scanq=dict(max_hits=16, cull_cluster=128, max_clusters=8,
               max_clusters_secondary=16, composite_mode="scanq",
               kernel_stats=False, attr_precision="bf16"))


def render(P, room, kw):
    fields, poses, _t = room
    gen = torch.Generator().manual_seed(SEED)
    jit, us = inputs.frame_samples(gen, W, H, 3)
    return P.dispatch_render_frame(
        drivers.make_scene(P, fields), drivers.camera(P, poses[1]),
        P.RenderSettings(), None, W, H, num_bounces=2,
        samples=P.FrameSamples(jitter=jit, us=us), **kw)


@pytest.mark.parametrize("mode", sorted(FRAME_KW))
def test_frame_equals_the_ports_plain_path(room, mode):
    steps, final = render(program.load(), room, FRAME_KW[mode])
    r_steps, r_final = render(controls.reference_program(), room,
                              FRAME_KW[mode])
    assert torch.equal(final, r_final)
    assert float(final.abs().sum()) > 0 and float(steps.alive[1].sum()) > 0
    for a, b in zip(steps, r_steps):
        assert torch.equal(a, b)
    nums = FRAMES.frame_numbers(steps, final, r_steps, r_final)
    assert nums == dict(final_bad_pct=0.0, gbuf_bad_pct=0.0)


@pytest.mark.parametrize("mode", sorted(FRAME_KW))
def test_the_bf16_control_fails_the_frame_limits(room, mode):
    _s, final = render(controls.reference_program(), room, FRAME_KW[mode])
    l_steps, l_final = render(controls.reference_program(low=True), room,
                              FRAME_KW[mode])
    r_steps, r_final = render(controls.reference_program(), room,
                              FRAME_KW[mode])
    nums = FRAMES.frame_numbers(l_steps, l_final, r_steps, r_final)
    limits = dict(final_bad_pct=0.5, gbuf_bad_pct=0.5)
    assert not check.judge(nums, limits)[0], nums


def step(P, room, opts=None):
    fields, poses, targets = room
    gen = torch.Generator().manual_seed(SEED)
    jit, us = inputs.tile_samples(gen, W, H, 1024, 3)
    lrs = dict(xyz=1e-4, scaling=0.005, rotation=0.001, opacity=0.025,
               diffuse=0.005, normal=0.0025, f0=0.0025, roughness=0.0025)
    hyper = dict(beta_1=0.9, beta_2=0.999, scale_decay=0.9999,
                 apply_grads=1.0)
    state = P.init_train_state(drivers.make_scene(P, fields))
    return P.train_step(
        state, drivers.camera(P, poses[0]), P.RayTargets(**targets[0]),
        P.RenderSettings(loss_weight_diffuse=5.0), lrs, hyper, None,
        W, H, samples=P.TileSamples(jitter=jit, us=us), num_bounces=2,
        max_hits=32, chunk=2048, tile=1024, use_pallas=True,
        exp_power_static=3.0, use_culling=True, cull_tile=256,
        cull_cluster=256, max_clusters=16)


def test_training_step_equals_the_ports_plain_path(room):
    state, m = step(program.load(), room)
    r_state, r_m = step(controls.reference_program(), room)
    assert torch.equal(m["l1_diffuse"], r_m["l1_diffuse"])
    for f in TRAIN.PARAM_FIELDS:
        for tree in ("scene", "mu", "nu"):
            a = getattr(getattr(state, tree), f)
            b = getattr(getattr(r_state, tree), f)
            assert torch.equal(a, b), (tree, f)
    assert float(state.mu.xyz.abs().sum()) > 0


def test_the_bf16_control_moves_the_training_step(room):
    state, m = step(controls.reference_program(), room)
    l_state, l_m = step(controls.reference_program(low=True), room)
    assert float(l_m["l1_diffuse"]) != float(m["l1_diffuse"])
    gp = TRAIN.adam_grad_norms(l_state, dict(beta_1=0.9))
    gr = TRAIN.adam_grad_norms(state, dict(beta_1=0.9))
    assert check.leaf_gaps(gp, gr) > 1e-3
