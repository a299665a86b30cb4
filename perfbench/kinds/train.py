"""The "train" kind: the training loop of the port's train.py past its
bounce warm-up, as a closed loop with no synchronize between steps.

Each step pops a camera from a stack refilled with the `views` cameras in
a seeded order, takes that camera's targets (staged on the device once) and
fresh samples, and calls the program's train_step with the configuration's
`train.step` keywords, passed through whole.  Set-up builds the state and
runs `check_steps` steps through that same call (the steps the comparison
follows), then the window runs steps on the same state until `--seconds`
have passed, and closes with one synchronize.

The comparison: the reference follows the first `check_steps` steps from
the same initial state, cameras, targets and samples.
  loss_gap    the largest |loss - reference loss| / reference loss over the
              steps (l1_diffuse, the step's loss metric);
  grad_gap    over the parameter leaves, the largest gap between the norm of
              the program's first gradient (Adam's first moment after one
              step over 1 - beta_1) and the reference's, over the larger of
              the reference's norm of that leaf and of the median leaf;
  change_gap  the same of the parameters' change over the steps, leaving
              out leaves whose reference gradient is under a thousandth of
              the median leaf's (they move by round-off alone).
"""

from __future__ import annotations

import gc
import random
import time

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
from perfbench.reference import training as rtr
from perfbench.reference.training import pick_tile_size
from perfbench.reference.utils.general import get_expon_lr_func

# the faults (controls.faulty) this kind's timed path can have
FAULTS = ("unchanged", "half")


def short(traffic: dict) -> dict:
    """calibrate.py's short runs change no parameter of this kind."""
    return {}


PARAM_FIELDS = ("xyz", "scaling", "rotation", "opacity", "diffuse", "normal",
                "f0", "roughness")


class Driver:
    """The loop of the module docstring."""

    def __init__(self, P, config: dict, traffic: dict, seed: int, device):
        self.P, self.config, self.traffic = P, config, traffic
        self.seed, self.device = seed, device
        tr = config["train"]
        self.W, self.H = config["width"], config["height"]
        self.tile = pick_tile_size(self.W * self.H, tr["ray_tile"])
        self.num_bounces = config["num_bounces"]
        self.step_kw = dict(tr["step"], width=self.W, height=self.H,
                            num_bounces=self.num_bounces, tile=self.tile)
        self.hyper = dict(tr["hyper"])
        self.checked_items = traffic["check_steps"]

    # -- inputs ---------------------------------------------------------
    def build_inputs(self):
        fields, layout, poses, gen = make_room(self.config, self.seed,
                                               self.device)
        targets = inputs.analytic_targets(gen, poses, self.W, self.H, layout,
                                          self.config["scene"]["extent"])
        self.extent = inputs.cameras_extent(poses)
        return fields, poses, targets

    def lrs(self, iteration: int) -> dict:
        """Per-field learning rates at `iteration` (the xyz schedule x the
        cameras' extent), as the port's lr_tree computes them."""
        lr = self.config["train"]["lr"]
        sched = get_expon_lr_func(
            lr_init=lr["xyz_lr_init"] * self.extent,
            lr_final=lr["xyz_lr_final"] * self.extent,
            lr_delay_mult=lr["xyz_lr_delay_mult"],
            max_steps=lr["xyz_lr_max_steps"])
        return dict(xyz=float(sched(iteration)), scaling=lr["scaling"],
                    rotation=lr["rotation"], opacity=lr["opacity"],
                    diffuse=lr["diffuse"], normal=lr["normal"], f0=lr["f0"],
                    roughness=lr["roughness"])

    def view_order(self):
        """Camera indices popped from a stack refilled with every camera,
        a seeded draw each (train.py's viewpoint_stack)."""
        rng = random.Random(self.seed)
        stack = []
        while True:
            if not stack:
                stack = list(range(self.config["views"]))
            yield stack.pop(rng.randint(0, len(stack) - 1))

    def samples(self, P, gen):
        jit, us = inputs.tile_samples(gen, self.W, self.H, self.tile,
                                      self.num_bounces + 1)
        return P.TileSamples(jitter=jit, us=us)

    def step(self, P, state, cams, tgts, sets, view, iteration, gen):
        return P.train_step(state, cams[view], tgts[view], sets,
                            self.lrs(iteration), self.hyper, None,
                            samples=self.samples(P, gen), **self.step_kw)

    # -- the run --------------------------------------------------------
    def run(self, seconds: float, trace: bool, t_start: float):
        P, dev = self.P, self.device
        tr = self.traffic
        fields, poses, targets = self.build_inputs()
        cams = [camera(P, p) for p in poses]
        tgts = [P.RayTargets(**t) for t in targets]
        sets = settings(P, self.config)
        views = self.view_order()
        gen = torch.Generator(device=dev).manual_seed(sample_seed(self.seed))
        iteration = self.config["train"]["iteration"]
        state = P.init_train_state(make_scene(P, fields))
        checked = dict(views=[], losses=[], iteration=iteration)
        for i in range(tr["check_steps"]):
            v = next(views)
            state, m = self.step(P, state, cams, tgts, sets, v, iteration,
                                 gen)
            checked["views"].append(v)
            checked["losses"].append(m["l1_diffuse"])
            if i == 0:
                checked["grad_norms"] = adam_grad_norms(state, self.hyper)
            iteration += 1
        checked["change_norms"] = change_norms(state, fields)
        sync(dev)
        steady_heap()
        win = Window(setup_s=time.perf_counter() - t_start)

        bad = torch.zeros((), dtype=torch.int64, device=dev)
        w0 = time.perf_counter()
        while time.perf_counter() - w0 < seconds:
            win.attempted += 1
            try:
                state, m = self.step(P, state, cams, tgts, sets, next(views),
                                     iteration, gen)
                bad += (~torch.isfinite(m["l1_diffuse"])).to(torch.int64)
            except (RuntimeError, ValueError) as err:
                print(f"perfbench: step raised {err!r}", flush=True)
                win.failed += 1
            iteration += 1
        sync(dev)
        win.seconds = time.perf_counter() - w0
        win.failed += int(bad)
        if not all(bool(torch.isfinite(getattr(state.scene, f)).all())
                   for f in checked["grad_norms"]):
            win.failed += 1

        if trace:
            n = tr["profile_steps"]
            holder = [state, iteration]

            def loop():
                for _ in range(n):
                    with torch.profiler.record_function("perfbench.step"):
                        holder[0], _m = self.step(
                            P, holder[0], cams, tgts, sets, next(views),
                            holder[1], gen)
                    holder[1] += 1

            win.stretch = profile.capture(loop, n, dev)
        gc.unfreeze()
        win.memory_peak_bytes = peak_bytes(dev)
        checked["targets"] = {v: targets[v] for v in checked["views"]}
        del state, tgts, targets, cams
        free(dev)
        return win, dict(fields=fields, poses=poses, checked=checked)


def adam_grad_norms(state, hyper) -> dict:
    """Per leaf, the norm of the first gradient as Adam got it: its first
    moment after one step over (1 - beta_1), in float64."""
    live = state.scene.live_mask
    out = {}
    for f in PARAM_FIELDS:
        m = getattr(state.mu, f)[live].double()
        out[f] = (m / (1.0 - hyper["beta_1"])).norm()
    return out


def change_norms(state, fields: dict) -> dict:
    """Per leaf, the norm of the parameters' change since the initial
    state, in float64."""
    live = fields["live_mask"]
    return {f: (getattr(state.scene, f)[live].double()
                - fields[f][live].double()).norm() for f in PARAM_FIELDS}


def compare(driver: Driver, kept: dict, opts) -> dict:
    """The numbers of the module docstring: the program's kept readings
    against the reference's."""
    R = controls.reference_program()
    dev = driver.device
    fields, poses, checked = kept["fields"], kept["poses"], kept["checked"]
    state = rtr.init_train_state(make_scene(R, fields))
    sets = settings(R, driver.config)
    gen = torch.Generator(device=dev).manual_seed(sample_seed(driver.seed))
    iteration = checked["iteration"]
    losses, grad_norms = [], None
    for i, v in enumerate(checked["views"]):
        jit, us = inputs.tile_samples(gen, driver.W, driver.H, driver.tile,
                                      driver.num_bounces + 1)
        state, m = rtr.train_step(
            state, camera(R, poses[v]),
            R.RayTargets(**checked["targets"][v]), sets,
            driver.lrs(iteration + i), driver.hyper, None,
            samples=R.TileSamples(jitter=jit, us=us), opts=opts,
            **driver.step_kw)
        losses.append(m["l1_diffuse"])
        if i == 0:
            grad_norms = adam_grad_norms(state, driver.hyper)
    changes = change_norms(state, fields)
    med = float(torch.tensor([float(x) for x in grad_norms.values()]).median())
    moving = {f for f, g in grad_norms.items() if float(g) >= 1e-3 * med}
    loss_gap = max(check.gap(float(p), float(r), max(abs(float(r)), 1e-30))
                   for p, r in zip(checked["losses"], losses))
    return dict(loss_gap=loss_gap,
                grad_gap=check.leaf_gaps(checked["grad_norms"], grad_norms),
                change_gap=check.leaf_gaps(checked["change_norms"], changes,
                                           moving))
