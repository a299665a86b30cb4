"""Time the k-buffer walks of one source tree: render_culled and trace_slots
on the primary pass of an 800x800 frame of room_scene(100_000) (the
chip_smoke.py phase 4/5 shapes: K 32, cluster 256, 192 candidates), CUDA
events, after one warm-up call.  Needs a CUDA card.

To compare two trees, unpack the other one (`git archive`) into a
directory git ignores and run both in one process sequence, alternating:

    python editable_gaussian_reflections_tpu_torch/tools/walk_ab.py <tree> [<csrc dir>]

<tree> is the root whose package is imported; <csrc dir>, when given,
replaces its csrc/ (a variant of the kernel sources).
"""

from __future__ import annotations

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
    from editable_gaussian_reflections_tpu_torch.utils.synth import (
        room_camera, room_scene)
    if not rt.__file__.startswith(root):
        raise RuntimeError(f"imported {rt.__file__}, not the tree {root}")

    dev = torch.device("cuda")
    scene = gs.from_arrays(**room_scene(100_000), pad_multiple=2048,
                           device=dev)
    eye, c2w = room_camera()
    cam = rt.CameraParams(torch.tensor(eye, device=dev),
                          torch.tensor(c2w, device=dev), 0.9, 0.05, 50.0)
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


if __name__ == "__main__":
    main(sys.argv[1:])
