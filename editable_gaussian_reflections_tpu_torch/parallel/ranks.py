"""Rank bodies of the parallel modes: what mesh.spawn runs in each process
for the tests, the chip smoke and tools/demo_5m.py.

run_jobs(device, mesh_shape, jobs) builds the mesh once and runs a list of
(job, inputs, options) in order.  Inputs are the port's own objects
(NamedTuples, tensors, dicts) on the host (host_inputs moves them there);
each rank takes a copy of them onto its device.  A scene may instead be
named as a room, inputs["room"] = (n, pad_multiple, seed), which each rank
builds with utils/synth.room_scene on its host.  A gauss_trace job with
neither traces the scene the last gauss_step of the same call stepped.

Every job returns rank 0's outputs as numpy, and per rank (gathered to
rank 0): the host ms of the call (synchronised on the card), the kernel
launches it made (trace_slots by exit mode, scatter_add, trace_hits,
render_culled), the collectives' calls, bytes and ms (mesh.STATS), the
peak device memory and, for the Gaussian-sharded step, the bytes of the
rank's parameter and optimizer rows.
"""

from __future__ import annotations

import inspect
import time
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

from ..ops.cuda.render_kernel import render_culled
from ..ops.cuda.scatter import scatter_add
from ..ops.cuda.trace_hits import trace_hits
from ..ops.cuda.trace_slots import trace_slots, trace_slots_reference
from ..renderer import raytracer
from ..renderer.raytracer import RayTargets, RenderSettings
from ..scene.gaussian_scene import GaussianScene, from_arrays
from ..training import TrainState, init_train_state
from ..utils.synth import room_scene
from . import mesh as pmesh
from .gaussian_sharded import (
    gather_rows,
    gaussian_sharded_trace,
    gaussian_sharded_train_step,
    local_rows,
    shard_scene,
    shard_slots_call,
)
from .sharding import sharded_render, sharded_render_fused, sharded_train_step


def moved(x, dev, copy: bool = False):
    """Tensors, NamedTuples, dicts, lists and tuples of them with every
    tensor on `dev` (copied with `copy`)."""
    if isinstance(x, torch.Tensor):
        return x.to(dev, copy=copy)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(moved(v, dev, copy) for v in x))
    if isinstance(x, dict):
        return {k: moved(v, dev, copy) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(moved(v, dev, copy) for v in x)
    return x


def host_inputs(**values) -> dict:
    """Inputs for run_jobs from the port's objects on any device: the same
    structure with every tensor on the host, as spawn pickles them."""
    return moved(values, "cpu")


def to_numpy(x):
    """Tensors, NamedTuples, dicts and lists of them as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_asdict"):
        return {k: to_numpy(v) for k, v in x._asdict().items()}
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [to_numpy(v) for v in x]
    return x


def random_targets(R: int, dev="cpu", seed: int = 0) -> RayTargets:
    """Uniform G-buffer targets for R rays from a seed (the JAX
    tools/demo_5m.py's)."""
    rng = np.random.default_rng(seed)
    return RayTargets(*(torch.tensor(a.astype(np.float32), device=dev)
                        for a in (rng.uniform(0, 1, (R, 3)),
                                  rng.uniform(0, 0.3, (R, 3)),
                                  rng.uniform(1, 5, (R,)),
                                  rng.normal(size=(R, 3)),
                                  rng.uniform(0, 1, (R,)),
                                  rng.uniform(0, 1, (R, 3)))))


def same_hits(a: dict, b: dict) -> np.ndarray:
    """Per ray of two numpy RayHits: whether both keep the same hits (the
    same valid slots and, on those, the same ids)."""
    return ((a["valid"] == b["valid"])
            & (np.where(a["valid"], a["ids"], -1)
               == np.where(b["valid"], b["ids"], -1))).all(axis=1)


def _room(inputs: dict, dev) -> GaussianScene:
    n, pad, seed = inputs["room"]
    return from_arrays(**room_scene(n, seed=seed), pad_multiple=pad,
                       device=dev)


def _settings(inputs: dict) -> RenderSettings:
    return inputs.get("settings", RenderSettings())


def _counts() -> dict:
    return dict(trace_slots_mode0=trace_slots.launches_by_mode[0],
                trace_slots_mode1=trace_slots.launches_by_mode[1],
                trace_slots_near=trace_slots.launches_by_window[1],
                trace_slots_far=trace_slots.launches_by_window[2],
                scatter_add=scatter_add.launches,
                trace_hits=trace_hits.launches,
                render_culled=render_culled.launches)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measured(dev, fn):
    """(fn(), this rank's numbers for the call: ms, launches, collectives,
    peak GB)."""
    _sync(dev)
    before = _counts()
    pmesh.reset_stats()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    ms = (time.perf_counter() - t0) * 1e3
    after = _counts()
    numbers = dict(
        ms=ms, launches={k: after[k] - before[k] for k in after},
        collectives={k: dict(v) for k, v in pmesh.STATS.items()},
        peak_gb=(torch.cuda.max_memory_allocated(dev) / 1e9
                 if dev.type == "cuda" else None))
    return out, numbers


def _per_rank(numbers) -> list:
    """Every rank's `numbers`, in rank order, on every rank."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, numbers)
    return out


def _tree_bytes(tree) -> int:
    return sum(a.numel() * a.element_size() for a in tree)


def row_bytes(state: TrainState) -> dict:
    """The bytes of a (rank's) TrainState: parameters, optimizer moments
    and the whole state, and its rows."""
    return dict(param_bytes=_tree_bytes(state.scene),
                opt_bytes=_tree_bytes(state.mu) + _tree_bytes(state.nu),
                state_bytes=(_tree_bytes(state.scene) + _tree_bytes(state.mu)
                             + _tree_bytes(state.nu)
                             + state.total_weight.numel()
                             * state.total_weight.element_size()),
                rows=state.scene.capacity)


def dp_step(mesh, dev, inputs: dict, held: dict, repeat: int = 1,
            **kw) -> dict:
    """sharded_train_step on inputs' state, camera, targets, settings, lrs,
    hyper and TileSamples; run `repeat` times from the same state, the
    last one measured."""
    x = moved(inputs, dev, copy=True)

    def step():
        return sharded_train_step(
            mesh, x["state"], x["camera"], x["targets"], _settings(x),
            x["lrs"], x["hyper"], None, samples=x["samples"], **kw)

    for _ in range(repeat - 1):
        step()
    (new, metrics), numbers = measured(dev, step)
    return dict(state=to_numpy(new), metrics=to_numpy(metrics),
                ranks=_per_rank(numbers))


def render(mesh, dev, inputs: dict, held: dict, **kw) -> dict:
    """sharded_render of inputs' scene (or room), camera, settings and
    TileSamples."""
    x = moved(inputs, dev, copy=True)
    scene = x["scene"] if "scene" in x else _room(x, dev)
    final, numbers = measured(dev, lambda: sharded_render(
        mesh, scene, x["camera"], _settings(x), None,
        samples=x.get("samples"), **kw))
    return dict(final=to_numpy(final), ranks=_per_rank(numbers))


def capped_flags(fn, max_hits: int):
    """fn() (a one-pass fused frame) with, per bounce, its rays whose
    k-buffer kept `max_hits` hits or more: (fn's result, [S, R] bool in the
    bounce loop's ray order).  At the frame's own max_hits such a ray
    composites a truncated tail that its tile's walk decides."""
    caps = []
    real = raytracer.bounce_epilogue

    def epilogue(out, call, *args, **kwargs):
        comp = raytracer.unpack_composite(raytracer.canonical(out, call))
        caps.append(comp["num_accumulated"] >= max_hits)
        return real(out, call, *args, **kwargs)

    with mock.patch.object(raytracer, "bounce_epilogue", epilogue):
        out = fn()
    return out, torch.stack(caps)


def render_fused(mesh, dev, inputs: dict, held: dict, repeat: int = 1,
                 capped_at: int | None = None, **kw) -> dict:
    """sharded_render_fused of inputs' scene (or room), camera, settings
    and FrameSamples; run `repeat` times, the last one measured.  With
    `capped_at`, one more (unmeasured) frame gives each rank's capped_flags
    ([S, rays of the rank], under "capped", in rank order)."""
    x = moved(inputs, dev, copy=True)
    scene = x["scene"] if "scene" in x else _room(x, dev)

    def frame():
        return sharded_render_fused(mesh, scene, x["camera"], _settings(x),
                                    None, samples=x.get("samples"), **kw)

    for _ in range(repeat - 1):
        frame()
    (steps, final), numbers = measured(dev, frame)
    out = dict(steps=to_numpy(steps), final=to_numpy(final),
               ranks=_per_rank(numbers))
    if capped_at is not None:
        out["capped"] = _per_rank(to_numpy(capped_flags(frame,
                                                        capped_at)[1]))
    return out


def gauss_step(mesh, dev, inputs: dict, held: dict, gather: bool = True,
               **kw) -> dict:
    """gaussian_sharded_train_step on inputs' state (whose capacity the
    shards divide into whole chunks), or on a fresh state of the room
    padded by shard_scene; the whole state stays on the host and each rank
    moves only its rows to its device.  With `gather` the new state and
    the gradients come back whole.  The rank's stepped scene is held for a
    following gauss_trace."""
    axis = kw.get("gauss_axis", "gauss")
    if "state" in inputs:
        host = inputs["state"]
    else:
        host = init_train_state(shard_scene(_room(inputs, "cpu"),
                                            mesh.shape[axis]))
    state = moved(local_rows(host, mesh, axis), dev)
    del host
    x = moved({k: v for k, v in inputs.items() if k != "state"}, dev,
              copy=True)
    (new, metrics, grads), numbers = measured(dev, lambda: (
        gaussian_sharded_train_step(
            mesh, state, x["camera"], x["targets"], _settings(x), x["lrs"],
            x["hyper"], None, samples=x["samples"], **kw)))
    numbers.update(row_bytes(new), moved=float(
        (new.scene.xyz - state.scene.xyz).abs().max()))
    held["scene"] = new.scene
    out = dict(metrics=to_numpy(metrics), ranks=_per_rank(numbers))
    if gather:
        out.update(state=to_numpy(gather_rows(new, mesh, axis)),
                   grads=to_numpy(type(grads)(*(
                       pmesh.all_gather(g, mesh, axis) for g in grads))))
    return out


def _plain_check(mesh, scene_s, o, d, kw: dict) -> dict:
    """The shard's slots-kernel call of gaussian_sharded_trace (rebuilt:
    its inputs are a function of the shard and the rays) through the
    kernel once more and through its plain version: both outputs on the
    host, the plain version's ms, the call's exit mode and candidates."""
    a = inspect.signature(gaussian_sharded_trace).bind(mesh, scene_s, o, d,
                                                       **kw)
    a.apply_defaults()
    args, kwargs, _perm = shard_slots_call(scene_s, o, d, *(
        a.arguments[k] for k in ("exp_power", "near", "far",
                                 "alpha_threshold", "max_hits",
                                 "cull_cluster", "cull_tile",
                                 "max_clusters")))
    slots, acc = trace_slots(*args, **kwargs)
    _sync(o.device)
    t0 = time.perf_counter()
    ref, ref_acc = trace_slots_reference(*args, **kwargs)
    _sync(o.device)
    return dict(slots=slots.cpu(), acc=acc.cpu(), ref_slots=ref.cpu(),
                ref_acc=ref_acc.cpu(), K=kwargs["max_hits"],
                exit_mode=kwargs["exit_mode"], candidates=args[5].shape[1],
                rows=scene_s.capacity,
                plain_ms=(time.perf_counter() - t0) * 1e3)


def gauss_trace(mesh, dev, inputs: dict, held: dict, plain: bool = False,
                **kw) -> dict:
    """gaussian_sharded_trace of inputs' scene (or room), padded by
    shard_scene, or of the scene the last gauss_step stepped, against
    inputs' rays_o/rays_d.  With `plain` (and use_pallas), every rank also
    runs its shard's kernel call against the kernel's plain version
    (_plain_check), outside the measured call, and the checks come back
    per rank."""
    axis = kw.get("axis", "gauss")
    if "scene" in inputs or "room" in inputs:
        scene = inputs["scene"] if "scene" in inputs else _room(inputs,
                                                                "cpu")
        S = mesh.shape[axis]
        if scene.capacity % (S * kw.get("chunk", 2048)):
            scene = shard_scene(scene, S)
        scene_s = moved(local_rows(scene, mesh, axis), dev)
        del scene
    else:
        scene_s = held["scene"]
    o, d = (inputs[k].to(dev) for k in ("rays_o", "rays_d"))
    hits, numbers = measured(dev, lambda: gaussian_sharded_trace(
        mesh, scene_s, o, d, **kw))
    out = dict(hits=to_numpy(hits), ranks=_per_rank(numbers))
    if plain:
        out["plain"] = _per_rank(_plain_check(mesh, scene_s, o, d, kw))
    return out


JOBS = dict(dp_step=dp_step, render=render, render_fused=render_fused,
            gauss_step=gauss_step, gauss_trace=gauss_trace)


def run_jobs(device, mesh_shape: dict, jobs: list) -> list:
    """The rank body: each (job name, inputs, options) of `jobs` in order
    on the mesh of `mesh_shape`, or of the job's own options["mesh"] (each
    shape's groups are built once, in the order the jobs first name them,
    which is the same on every rank); rank 0's results."""
    meshes, held, out = {}, {}, []
    for name, inputs, kw in jobs:
        kw = dict(kw)
        shape = kw.pop("mesh", mesh_shape)
        key = tuple(shape.items())
        if key not in meshes:
            meshes[key] = pmesh.make_mesh(shape, device)
        out.append(JOBS[name](meshes[key], device, inputs, held, **kw))
    return out
