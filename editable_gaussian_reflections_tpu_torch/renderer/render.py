"""Frame dispatch (twin of the JAX renderer/render.py).

Ported: camera_params, default_backend_kwargs and dispatch_render_frame.
render() (the SimpleNamespace facade) comes with a later slice.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..scene.gaussian_scene import GaussianScene
from .raytracer import (
    CameraParams,
    FrameSamples,
    RenderSettings,
    check_composite_mode,
    fused_path_ok,
    render_frame_fused,
)


def camera_params(camera, znear=0.01, zfar=999.9,
                  device: torch.device | str = DEFAULT_DEVICE
                  ) -> CameraParams:
    """A scene camera's render pose (scene/cameras.py render_pose) as
    CameraParams, on the card unless `device` says otherwise."""
    device = resolve_device(device)
    origin, c2w, fovy, zn, zf = camera.render_pose(znear, zfar)
    return CameraParams(
        origin=torch.tensor(np.asarray(origin, np.float32), device=device),
        c2w=torch.tensor(np.asarray(c2w, np.float32), device=device),
        fov_y=float(np.float32(fovy)), znear=float(np.float32(zn)),
        zfar=float(np.float32(zf)))


def default_backend_kwargs(cfg) -> dict:
    """dispatch_render_frame's culling and composite options from a Config
    (render.py:38-60).  The JAX package picks its XLA path on a CPU backend;
    the port has one path, the fused kernels, on every device."""
    return dict(cull_cluster=cfg.cull_cluster,
                max_clusters=cfg.max_clusters,
                max_clusters_secondary=cfg.max_clusters_secondary or None,
                cull_tile_secondary=cfg.cull_tile_secondary,
                split_far=cfg.split_far,
                composite_mode=cfg.composite_mode)


def dispatch_render_frame(scene: GaussianScene, cam: CameraParams,
                          settings: RenderSettings,
                          generator: torch.Generator | None, W: int, H: int,
                          *, num_bounces: int = 2, max_hits: int = 32,
                          jitter: bool = True,
                          samples: FrameSamples | None = None,
                          cull_cluster: int = 256, max_clusters: int = 64,
                          max_clusters_secondary: int | None = None,
                          cull_tile_secondary: int = 256,
                          split_far: bool = False,
                          composite_mode: str = "kbuffer",
                          kernel_stats: bool = True,
                          attr_precision: str = "highest"):
    """Render one frame through the fused path.

    The JAX dispatch falls back to its non-fused render_frame when the fused
    path is not eligible; that renderer is not ported yet, so here such a
    frame raises instead."""
    check_composite_mode(composite_mode, split_far)
    if not fused_path_ok(scene, W, H, cull_cluster, composite_mode):
        raise ValueError(
            f"{W}x{H} with capacity {scene.capacity}, cluster {cull_cluster} "
            f"and composite_mode {composite_mode!r} does not fit the fused "
            "path (16x16 pixel tiles, capacity a multiple of the cluster, "
            "cluster >= 128, or >= 32 for a resident scan table); the "
            "non-fused render_frame it would fall back to is not ported yet")
    return render_frame_fused(
        scene, cam, settings, generator, W, H, num_bounces=num_bounces,
        max_hits=max_hits, jitter=jitter, cull_cluster=cull_cluster,
        max_clusters=max_clusters,
        max_clusters_secondary=max_clusters_secondary,
        cull_tile_secondary=cull_tile_secondary,
        composite_mode=composite_mode, samples=samples,
        kernel_stats=kernel_stats, attr_precision=attr_precision)
