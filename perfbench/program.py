"""The system under test, editable_gaussian_reflections_tpu_torch, reached
through its public entry points only: everything the benchmark calls of it
is gathered here, so that a test can put a broken program in its place."""

from __future__ import annotations

import re
from pathlib import Path
from types import SimpleNamespace

PACKAGE = "editable_gaussian_reflections_tpu_torch"


def load() -> SimpleNamespace:
    """The program's entry points (imported at the call, not at import)."""
    from editable_gaussian_reflections_tpu_torch import training
    from editable_gaussian_reflections_tpu_torch.ops.cuda import build
    from editable_gaussian_reflections_tpu_torch.renderer import raytracer
    from editable_gaussian_reflections_tpu_torch.renderer.render import (
        dispatch_render_frame,
    )
    from editable_gaussian_reflections_tpu_torch.scene import gaussian_scene

    return SimpleNamespace(
        GaussianScene=gaussian_scene.GaussianScene,
        pad_to=gaussian_scene.pad_to,
        CameraParams=raytracer.CameraParams,
        RenderSettings=raytracer.RenderSettings,
        RayTargets=raytracer.RayTargets,
        FrameSamples=raytracer.FrameSamples,
        TileSamples=raytracer.TileSamples,
        init_train_state=training.init_train_state,
        train_step=training.train_step,
        dispatch_render_frame=dispatch_render_frame,
        build_all=build.build_all,
        csrc=build.CSRC,
    )


def kernel_sources(csrc: Path) -> list:
    """The names of the program's hand-written CUDA sources (csrc/*.cu)."""
    return sorted(p.stem for p in Path(csrc).glob("*.cu"))


def kernel_symbols(csrc: Path) -> dict:
    """{__global__ function name: its csrc source's stem}: how the device
    trace tells the program's hand-written kernels from PyTorch's own."""
    pattern = re.compile(
        r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)")
    out = {}
    for src in sorted(Path(csrc).glob("*.cu*")):
        for name in pattern.findall(src.read_text()):
            out[name] = src.stem
    return out
