"""Stand-ins for the program that the comparison must refuse: the control
(the reference in the program's place, computed in bfloat16) and the faults
a cell can have (a training step that returns its state unchanged, one
that leaves half of the batch out, a frame with answers altered where they
are produced).  calibrate.py reads them on the card; the tests read them on
the CPU."""

from __future__ import annotations

from types import SimpleNamespace

from .reference import training as rtr
from .reference.ops.plain.render_kernel import WalkOptions
from .reference.renderer import raytracer as rrt
from .reference.scene import gaussian_scene as rgs
from .registry import ROOT


def reference_program(low: bool = False) -> SimpleNamespace:
    """The reference under the program's entry points; `low` computes its
    pair math in bfloat16 and rounds its attributes to it (the control)."""
    opts = WalkOptions(low=low)

    def train_step(*args, **kw):
        return rtr.train_step(*args, opts=opts, **kw)

    def dispatch_render_frame(scene, cam, settings, generator, W, H, *,
                              samples, **kw):
        return rrt.render_frame_fused(scene, cam, settings, generator, W, H,
                                      samples=samples, opts=opts, **kw)

    return SimpleNamespace(
        GaussianScene=rgs.GaussianScene, CameraParams=rrt.CameraParams,
        RenderSettings=rrt.RenderSettings, RayTargets=rrt.RayTargets,
        FrameSamples=rrt.FrameSamples, TileSamples=rrt.TileSamples,
        init_train_state=rtr.init_train_state, train_step=train_step,
        dispatch_render_frame=dispatch_render_frame,
        build_all=lambda names: [],
        csrc=ROOT / "editable_gaussian_reflections_tpu_torch" / "csrc")


def unchanged_state(P) -> SimpleNamespace:
    """P whose training step returns the state it was given (with the
    step's metrics)."""
    def train_step(state, *args, **kw):
        _new, metrics = P.train_step(state, *args, **kw)
        return state, metrics

    return SimpleNamespace(**dict(vars(P), train_step=train_step))


def half_batch(P) -> SimpleNamespace:
    """P whose training step leaves the lower half of the image's rows out:
    the step runs on the upper half (its targets, jitter and uniforms),
    and its loss is the mean over those rays."""
    def train_step(state, camera, targets, settings, lrs, hyper, generator,
                   width, height, *, samples, tile, **kw):
        h = height // 2
        n = width * h
        tgt = type(targets)(*(a[:n] for a in targets))
        t2 = rtr.pick_tile_size(n, tile)
        S = samples.us.shape[1]
        us = samples.us.reshape(-1)[:n * S * 2].reshape(n // t2, S, t2, 2)
        half = type(samples)(jitter=samples.jitter[:h], us=us)
        return P.train_step(state, camera, tgt, settings, lrs, hyper,
                            generator, width, h, samples=half, tile=t2, **kw)

    return SimpleNamespace(**dict(vars(P), train_step=train_step))


def altered_answer(P, every: int = 20, delta: float = 0.01) -> SimpleNamespace:
    """P whose frames come back with every `every`-th pixel's final colour
    moved by `delta`."""
    def dispatch_render_frame(*args, **kw):
        steps, final = P.dispatch_render_frame(*args, **kw)
        final = final.clone()
        final[::every] += delta
        return steps, final

    return SimpleNamespace(**dict(vars(P),
                                  dispatch_render_frame=dispatch_render_frame))


def faulty(P, name: str) -> SimpleNamespace:
    return dict(unchanged=unchanged_state, half=half_batch,
                altered=altered_answer)[name](P)

