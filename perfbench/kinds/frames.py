"""The "frames" kind: one viewer's closed loop of frames through the
program's dispatch_render_frame, with the configuration's `render`
keywords passed through whole, along a seeded order of the `views`
cameras, 1 spp, jittered, each frame waited for.

Set-up renders `warmup` frames; the window renders until `--seconds` have
passed; `check_frames` frames drawn from the seed among its first
`check_within` are kept for the comparison (with `check_within` at most
`views`, each kept frame is of another camera).

The comparison: the reference renders each kept frame again.
  final_bad_pct  the share of pixels whose final colour differs from the
                 reference's by more than FINAL_TOL in a channel;
  gbuf_bad_pct   the share of pixels whose first-bounce G-buffer (diffuse,
                 normal, f0, roughness, depth) differs by more than its
                 tolerance;
  the larger over the kept frames.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from perfbench import check, controls, inputs, profile
from perfbench.drivers import (
    Window,
    camera,
    free,
    make_room,
    make_scene,
    peak_bytes,
    sample_seed,
    settings,
    steady_heap,
    sync,
)
from perfbench.reference.renderer import raytracer as rrt

# the faults (controls.faulty) this kind's timed path can have
FAULTS = ("altered",)


def short(traffic: dict) -> dict:
    """calibrate.py's short runs: the kept frames are the window's first."""
    return dict(check_within=traffic["check_frames"], warmup=0)


FINAL_TOL = 1e-3
GBUF_TOL = dict(rgb=1e-3, normal=1e-3, f0=1e-3, roughness=1e-3)
DEPTH_REL_TOL = 1e-4


class Driver:
    """The loop of the module docstring."""

    def __init__(self, P, config: dict, traffic: dict, seed: int, device):
        self.P, self.config, self.traffic = P, config, traffic
        self.seed, self.device = seed, device
        self.W, self.H = config["width"], config["height"]
        self.kw = dict(config["render"], num_bounces=config["num_bounces"],
                       jitter=True)
        self.checked_items = traffic["check_frames"]

    def frame(self, P, scene, cam, sets, samples):
        return P.dispatch_render_frame(scene, cam, sets, None, self.W,
                                       self.H, samples=samples, **self.kw)

    def run(self, seconds: float, trace: bool, t_start: float):
        P, dev, tr = self.P, self.device, self.traffic
        fields, _layout, poses, _gen = make_room(self.config, self.seed, dev)
        scene = make_scene(P, fields)
        cams = [camera(P, p) for p in poses]
        sets = settings(P, self.config)
        rng = np.random.default_rng(self.seed % 2**63)
        order = rng.permutation(self.config["views"]).tolist()
        picks = sorted(rng.choice(tr["check_within"], tr["check_frames"],
                                  replace=False).tolist())
        gen = torch.Generator(device=dev).manual_seed(sample_seed(self.seed))
        steps = self.config["num_bounces"] + 1

        def draw():
            jit, us = inputs.frame_samples(gen, self.W, self.H, steps)
            return P.FrameSamples(jitter=jit, us=us)

        for i in range(tr["warmup"]):
            self.frame(P, scene, cams[order[i % len(order)]], sets, draw())
        sync(dev)
        steady_heap()
        win = Window(setup_s=time.perf_counter() - t_start)
        kept = []
        n = 0

        def one(count: bool):
            nonlocal n
            view = order[n % len(order)]
            samples = draw()
            t0 = time.perf_counter()
            try:
                out = self.frame(P, scene, cams[view], sets, samples)
                sync(dev)
            except (RuntimeError, ValueError) as err:
                print(f"perfbench: frame raised {err!r}", flush=True)
                out = None
            t1 = time.perf_counter()
            ok = out is not None and bool(torch.isfinite(out[1]).all())
            if count:
                win.attempted += 1
                win.failed += 0 if ok else 1
                win.item_s.append(t1 - t0)
            if n in picks and out is not None:
                kept.append(dict(view=view, jitter=samples.jitter,
                                 us=samples.us, final=out[1],
                                 steps=out[0]))
            n += 1

        w0 = time.perf_counter()
        while time.perf_counter() - w0 < seconds:
            one(True)
        win.seconds = time.perf_counter() - w0
        while n <= picks[-1]:
            one(False)                 # a kept frame not reached in the window
        if trace:
            m = tr["profile_frames"]
            base = n

            def loop():
                nonlocal n
                while n < base + m:
                    with torch.profiler.record_function("perfbench.frame"):
                        view = order[n % len(order)]
                        self.frame(P, scene, cams[view], sets, draw())
                        sync(dev)
                    n += 1

            win.stretch = profile.capture(loop, m, dev)
        gc.unfreeze()
        win.memory_peak_bytes = peak_bytes(dev)
        del scene, cams
        free(dev)
        return win, dict(fields=fields, poses=poses, kept=kept,
                         picked=len(picks))


def frame_numbers(prog_steps, prog_final, ref_steps, ref_final) -> dict:
    """final_bad_pct and gbuf_bad_pct of one frame (module docstring)."""
    final_bad = (prog_final - ref_final).abs().amax(dim=-1) > FINAL_TOL
    bad = torch.zeros_like(final_bad)
    for name, tol in GBUF_TOL.items():
        diff = (getattr(prog_steps, name)[0] - getattr(ref_steps, name)[0])
        diff = diff.abs()
        if diff.ndim == 2:
            diff = diff.amax(dim=-1)
        bad |= (diff > tol) | ~torch.isfinite(diff)
    dp, dr = prog_steps.depth[0], ref_steps.depth[0]
    bad |= (dp - dr).abs() > DEPTH_REL_TOL * dr.abs().clamp(min=1.0)
    bad |= ~torch.isfinite(prog_final).all(dim=-1)
    final_bad |= ~torch.isfinite(prog_final).all(dim=-1)
    return dict(final_bad_pct=check.bad_share(final_bad),
                gbuf_bad_pct=check.bad_share(bad))


def compare(driver: Driver, kept: dict, opts) -> dict:
    """The numbers of the module docstring, the larger over kept frames; a
    kept frame that raised reads 100%."""
    R = controls.reference_program()
    fields, poses = kept["fields"], kept["poses"]
    scene = make_scene(R, fields)
    sets = settings(R, driver.config)
    full = 100.0 if len(kept["kept"]) < kept["picked"] else 0.0
    out = dict(final_bad_pct=full, gbuf_bad_pct=full)
    for k in kept["kept"]:
        steps, final = rrt.render_frame_fused(
            scene, camera(R, poses[k["view"]]), sets, None, driver.W,
            driver.H, samples=R.FrameSamples(jitter=k["jitter"], us=k["us"]),
            opts=opts, **driver.kw)
        nums = frame_numbers(k["steps"], k["final"], steps, final)
        for key, v in nums.items():
            out[key] = max(out[key], v)
        del steps, final
    return out
