"""Time the fused path of one source tree end to end, as chip_smoke.py's
phases 4, 7 and 9 do: the 800x800 eval frame of room_scene(100_000) through
dispatch_render_frame (one warm-up, 3 timed and one profiled frame), the
768x768 training step on room_scene(175_000) (one warm-up, 3 timed and one
profiled step), and the fast path on the eval frame's scene: bench.py's
scanq frame and its scan twin (as the eval frame) and measure_fps() at the
Config defaults (its warm-up and timed pass over 8 views, twice), all as
tools/fused_setup.py makes them.  Prints one line per path: ms per frame or
step (and FPS), the profiled run's device time and its render kernel's
share, the starved share, the losses, and a digest of the last timed frame
and of the state after the timed steps, so that two trees can be shown to
compute the same.  Needs a CUDA card.

To compare two trees, unpack the other one (`git archive`) into a
directory git ignores and run both in one process sequence, alternating:

    python editable_gaussian_reflections_tpu_torch/tools/fused_ab.py <tree>

<tree> is the root whose package is imported; the setup is this script's
own tree's, run on <tree>'s package.

    python editable_gaussian_reflections_tpu_torch/tools/fused_ab.py <tree> --steps

times only the training steps: the fused 768x768 step as above, then the
non-fused (brute) 1365x768 step of chip_smoke.py's phase 12
(tools/nonfused_setup.py: one warm-up, 3 timed and one profiled step).
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import sys
from pathlib import Path


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main(argv: list[str]) -> None:
    root = str(Path(argv[0]).resolve())
    sys.path.insert(0, root)
    import torch

    from editable_gaussian_reflections_tpu_torch.renderer import raytracer as rt
    if not rt.__file__.startswith(root):
        raise RuntimeError(f"imported {rt.__file__}, not the tree {root}")
    spec = importlib.util.spec_from_file_location(
        "fused_setup", Path(__file__).with_name("fused_setup.py"))
    fs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fs)

    dev = torch.device("cuda")
    steps_only = "--steps" in argv[1:]
    if steps_only:
        step_ab(fs, root, dev)
        return
    e = fs.eval_frame(dev)
    f = fs.time_frames(e, 3)
    dev_ms = sum(f.by_kernel.values())
    res = dict(tree=root, card=fs.card(), frame_ms=f.ms,
               frame_device_ms=dev_ms,
               frame_render_culled_ms=sum(
                   v for k, v in f.by_kernel.items()
                   if "render_culled_kernel" in k),
               frame_starved=f.steps.overflow.mean().item(),
               frame_digest=digest(f.final, *f.steps))
    print("FUSED_AB " + json.dumps(res), flush=True)
    del e, f
    torch.cuda.empty_cache()

    step_ab(fs, root, dev, brute=False)
    fast_ab(fs, root, dev)


def step_ab(fs, root: str, dev, brute: bool = True) -> None:
    """The fused training step and, with `brute`, the non-fused one (module
    docstring)."""
    import torch

    from editable_gaussian_reflections_tpu_torch import training as tr

    setups = [("fused", fs.training_step)]
    if brute:
        spec = importlib.util.spec_from_file_location(
            "nonfused_setup", Path(__file__).with_name("nonfused_setup.py"))
        nf = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(nf)
        setups.append(("brute", nf.training_step))
    for kind, setup in setups:
        t = setup(dev)
        t.steps = t.residuals = t.targets_b = t.calls = None
        torch.cuda.empty_cache()
        s = fs.time_steps(t, 3)
        dev_ms = sum(s.by_kernel.values())
        st = s.timed_state
        res = dict(tree=root, card=fs.card(), step=kind, step_ms=s.ms,
                   step_device_ms=dev_ms,
                   step_trace_slots_ms=sum(
                       v for k, v in s.by_kernel.items()
                       if "trace_slots_kernel" in k),
                   step_scatter_ms=sum(
                       v for k, v in s.by_kernel.items()
                       if "scatter_add_kernel" in k),
                   l1_diffuse=s.l1s, starved=s.starved, peak_gb=s.peak_gb,
                   state_digest=digest(*(getattr(getattr(st, tree), name)
                                         for tree in ("scene", "mu", "nu")
                                         for name in tr.PARAM_FIELDS)))
        print("FUSED_AB " + json.dumps(res), flush=True)
        del t, s, st
        torch.cuda.empty_cache()


def fast_ab(fs, root: str, dev) -> None:
    """The fast path's frames and measure_fps (module docstring)."""
    import torch

    from editable_gaussian_reflections_tpu_torch.measure_fps import (
        measure_fps)

    model_path = Path(root) / "build" / "fps_model"
    model_path.mkdir(parents=True, exist_ok=True)
    fp = fs.fast_path(dev, str(model_path))
    fp.calls = None
    for mode in ("scanq", "scan"):
        e = fp.bench
        e.frame_kw = dict(e.frame_kw, composite_mode=mode)
        if mode == "scan":
            e.frame_kw["attr_precision"] = "highest"
        f = fs.time_frames(e, 3)
        dev_ms = sum(f.by_kernel.values())
        res = dict(tree=root, card=fs.card(), mode=mode, frame_ms=f.ms,
                   frame_device_ms=dev_ms,
                   frame_render_scan_ms=sum(
                       v for k, v in f.by_kernel.items()
                       if "render_scan_kernel" in k),
                   frame_starved=f.steps.overflow.mean().item(),
                   frame_digest=digest(f.final, *f.steps))
        print("FUSED_AB " + json.dumps(res), flush=True)
        del f
    torch.cuda.empty_cache()
    fps = [measure_fps(fp.cfg, fp.views, fp.scene, fp.settings)
           for _ in range(2)]
    print("FUSED_AB " + json.dumps(dict(tree=root, card=fs.card(),
                                        measure_fps=fps)), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
