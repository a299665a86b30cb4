"""Time the walks of one source tree: render_culled and trace_slots on the
primary pass of an 800x800 frame of room_scene(100_000) (the chip_smoke.py
phase 4/5 shapes: K 32, cluster 256, 192 candidates), then trace_hits on
the first launch of the primary and first reflected pass of the non-fused
eval render (culled) and training step (brute), as chip_smoke.py's phases
11 and 12 make them (tools/nonfused_setup.py).  CUDA events, after one
warm-up call.  Needs a CUDA card.

To compare two trees, unpack the other one (`git archive`) into a
directory git ignores and run both in one process sequence, alternating:

    python editable_gaussian_reflections_tpu_torch/tools/walk_ab.py <tree> [<csrc dir>]

<tree> is the root whose package is imported; <csrc dir>, when given,
replaces its csrc/ (a variant of the kernel sources).  The non-fused setup
is this script's own tree's, run on <tree>'s package, so that both trees
are timed on the same launches.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main(argv: list[str]) -> None:
    root = str(Path(argv[0]).resolve())
    sys.path.insert(0, root)
    import torch

    from editable_gaussian_reflections_tpu_torch.ops.cuda import build
    if len(argv) > 1:  # the library's name hashes the sources it is built from
        build.CSRC = Path(argv[1]).resolve()
    from editable_gaussian_reflections_tpu_torch.ops import culling
    from editable_gaussian_reflections_tpu_torch.ops.cuda import layout
    from editable_gaussian_reflections_tpu_torch.ops.cuda.render_kernel import (
        render_culled)
    from editable_gaussian_reflections_tpu_torch.ops.cuda.trace_slots import (
        trace_slots)
    from editable_gaussian_reflections_tpu_torch.renderer import raytracer as rt
    from editable_gaussian_reflections_tpu_torch.scene import (
        gaussian_scene as gs)
    if not rt.__file__.startswith(root):
        raise RuntimeError(f"imported {rt.__file__}, not the tree {root}")

    nf = _nonfused_setup()
    dev = torch.device("cuda")
    scene, cam = nf.room(100_000, dev)
    S = rt.RenderSettings()
    samples = rt.draw_samples(torch.Generator(device=dev).manual_seed(2),
                              800, 800, 3)
    prep = rt._prepare_fused_frame(scene, cam, S, samples, 800, 800,
                                   jitter=True, cull_cluster=256,
                                   cull_tile_primary=256, num_steps=3)
    R = prep["R"]
    Rp = rt.padded_ray_count(R, 192, None, 256, 256)
    dirs = torch.cat([prep["dirs"], prep["dirs"][:Rp - R]])
    o = cam.origin.expand(Rp, 3)
    alive = torch.ones((Rp,), dtype=torch.bool, device=dev)
    c0 = rt.kernel_call(
        o, dirs, alive, 0, prep["gpack"], prep["bounds"], prep["scene_lo"],
        prep["scene_hi"], S, 0.05, 50.0, capacity=scene.capacity,
        max_hits=32, exp_power_static=3.0, cull_cluster=256, max_clusters=192,
        max_clusters_secondary=None, cull_tile_secondary=256,
        cull_tile_primary=256)
    frames, attrs = gs.build_frames(scene, 0.005, 3.0, 1.0)
    perm = culling.morton_order(frames)
    frames, attrs = frames.take(perm), attrs.take(perm)
    sc = gs.GaussianScene(*(a[perm] for a in scene))
    table = layout.pack_attr_table(attrs)
    ftable = layout.pack_frame_table(frames, sc)
    s0 = rt.slots_call(
        o, dirs, alive, 0, prep["gpack"], table, ftable, prep["bounds"],
        prep["scene_lo"], prep["scene_hi"], S, 0.05, 50.0, max_hits=32,
        cull_tile=256, cull_cluster=256, max_clusters=192,
        n_capacity=scene.capacity, exp_power_static=3.0, tile_rays=None)

    rc = [cuda_ms(lambda: render_culled(*c0.args, **c0.kwargs), 10)
          for _ in range(3)]
    ts = [cuda_ms(lambda: trace_slots(*s0.args, **s0.kwargs), 3)
          for _ in range(2)]
    print(f"AB {root} {argv[1:]}: render_culled primary ms "
          f"{[round(x, 3) for x in rc]}; trace_slots primary ms "
          f"{[round(x, 3) for x in ts]}", flush=True)
    del c0, s0, prep, dirs, o, alive, frames, attrs, sc, table, ftable
    trace_hits_ab(nf, root, argv[1:], dev)


def _nonfused_setup():
    """tools/nonfused_setup.py of this script's tree, importing the package
    of the tree on sys.path (the tree timed may predate the module)."""
    spec = importlib.util.spec_from_file_location(
        "nonfused_setup", Path(__file__).with_name("nonfused_setup.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def trace_hits_ab(nf, root: str, variant: list, dev) -> None:
    """trace_hits' four passes at the chip_smoke.py phase 11/12 shapes
    (`nf`: the module tools/nonfused_setup.py)."""
    from editable_gaussian_reflections_tpu_torch.ops.cuda.trace_hits import (
        trace_hits)

    calls = {"culled": nf.render_trace_calls(nf.eval_render(dev))}
    calls["brute"] = nf.step_trace_calls(nf.training_step(dev))
    res = {}
    for mode in ("brute", "culled"):
        for name, (args, kwargs) in zip(("primary", "reflected"),
                                        calls[mode]):
            if (args[3] is None) != (mode == "brute"):
                raise RuntimeError(f"{mode} {name}: traced the other mode")
            reps = 2 if mode == "brute" else 5
            res[f"{mode} {name}"] = [
                round(cuda_ms(lambda: trace_hits(*args, **kwargs), reps), 3)
                for _ in range(2)]
    print(f"AB {root} {variant}: trace_hits ms, first launch of "
          f"{nf.NF_W}x{nf.NF_H} "
          f"({', '.join(f'{k} {v}' for k, v in res.items())})", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
