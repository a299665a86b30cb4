"""Frame dispatch and the render() facade (twin of the JAX
renderer/render.py).

dispatch_render_frame routes a frame to the fused whole-frame path
(render_frame_fused) when its shapes allow, and to the non-fused
render_frame otherwise, exactly where the JAX dispatch does.  render()
returns a SimpleNamespace with the JAX facade's field names ([S, C, H, W] /
[3, H, W] numpy arrays); with denoise=True its final image is demodulated
and denoised on the scene's device (renderer/denoise.py).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..scene.gaussian_scene import GaussianScene
from .denoise import denoise_specular
from .raytracer import (
    CameraParams,
    FrameSamples,
    RenderSettings,
    TileSamples,
    check_composite_mode,
    fused_path_ok,
    render_frame,
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
    (render.py:38-60).

    The split-far options (split_far, mc_far, max_hits_far,
    split_radius_scale) reach the fused path only, as in JAX.
    cfg.backend "xla" renders as the JAX package's XLA path does: unculled,
    through the k-buffer composite, without split-far - here the brute
    trace_hits, which JAX holds equal to its XLA trace.  "auto" and
    "pallas" cull as cfg.cull says, on every device: the card takes the
    TPU's part (JAX's "auto" picks XLA on a CPU backend; the port has no
    such path, its kernels' plain versions run on CPU tensors)."""
    if cfg.backend == "xla":
        return dict(use_culling=False, split_far=False,
                    composite_mode="kbuffer")
    return dict(use_culling=cfg.cull, cull_tile=cfg.cull_tile,
                cull_cluster=cfg.cull_cluster,
                max_clusters=cfg.max_clusters,
                max_clusters_secondary=cfg.max_clusters_secondary or None,
                cull_tile_secondary=cfg.cull_tile_secondary,
                split_far=cfg.split_far, mc_far=cfg.mc_far,
                max_hits_far=cfg.max_hits_far,
                split_radius_scale=cfg.split_radius_scale,
                composite_mode=cfg.composite_mode)


def nonfused_kwargs(cfg) -> dict:
    """render_frame's options (render_accumulated's, fused=False) from a
    Config: default_backend_kwargs' culling options without the fused-path
    knobs (split-far's among them: the non-fused render has no split, as
    in JAX).  Unknown composite modes raise, as in the dispatch; a scan
    mode has no non-fused form and renders the k-buffer here, as in the
    JAX package."""
    bk = default_backend_kwargs(cfg)
    check_composite_mode(bk["composite_mode"])
    return {k: bk[k] for k in ("use_culling", "cull_tile", "cull_cluster",
                               "max_clusters") if k in bk}


def dispatch_render_frame(scene: GaussianScene, cam: CameraParams,
                          settings: RenderSettings,
                          generator: torch.Generator | None, W: int, H: int,
                          *, num_bounces: int = 2, max_hits: int = 32,
                          chunk: int = 2048, tile: int = 8192,
                          jitter: bool = True,
                          samples: FrameSamples | TileSamples | None = None,
                          use_culling: bool = True, cull_tile: int = 256,
                          cull_cluster: int = 256,
                          max_clusters: int | None = None,
                          max_clusters_secondary: int | None = None,
                          cull_tile_secondary: int = 256,
                          cull_tile_primary: int = 256,
                          split_far: bool = False, mc_far: int = 32,
                          max_hits_far: int = 0,
                          split_radius_scale: float = 1.5,
                          composite_mode: str = "kbuffer",
                          kernel_stats: bool = True,
                          attr_precision: str = "highest"):
    """Render one frame (render.py:63-109): through render_frame_fused when
    culling is asked for and fused_path_ok holds (16x16
    pixel tiles, a cluster-padded capacity, the cluster minimum), else
    through the non-fused render_frame, which itself falls back from
    culled to brute where the shapes do not divide.

    The two paths draw their samples differently, as in the JAX package:
    `samples` is a FrameSamples (us [S, H*W, 2]) for the fused path and a
    TileSamples (us [T, S, tile, 2]) for render_frame.  max_clusters None
    takes each path's own default (64 fused, 192 non-fused).  The fused-path
    knobs (secondary budget, both cull tiles, split-far, composite mode,
    kernel_stats, attr_precision) are not read by render_frame; chunk and
    tile are not read by the fused path.  Unknown composite modes raise."""
    check_composite_mode(composite_mode)
    if use_culling and fused_path_ok(scene, W, H, cull_cluster,
                                     composite_mode):
        return render_frame_fused(
            scene, cam, settings, generator, W, H, num_bounces=num_bounces,
            max_hits=max_hits, jitter=jitter, cull_cluster=cull_cluster,
            max_clusters=64 if max_clusters is None else max_clusters,
            max_clusters_secondary=max_clusters_secondary,
            cull_tile_secondary=cull_tile_secondary,
            cull_tile_primary=cull_tile_primary, split_far=split_far,
            mc_far=mc_far, max_hits_far=max_hits_far,
            split_radius_scale=split_radius_scale,
            composite_mode=composite_mode, samples=samples,
            kernel_stats=kernel_stats, attr_precision=attr_precision)
    return render_frame(
        scene, cam, settings, generator, W, H, num_bounces=num_bounces,
        max_hits=max_hits, chunk=chunk, tile=tile, jitter=jitter,
        use_culling=use_culling, cull_tile=cull_tile,
        cull_cluster=cull_cluster,
        max_clusters=192 if max_clusters is None else max_clusters,
        samples=samples)


def render(
    camera,
    scene: GaussianScene,
    settings: RenderSettings = RenderSettings(),
    generator: torch.Generator | None = None,
    num_bounces: int = 2,
    max_hits: int = 32,
    chunk: int = 2048,
    tile: int = 8192,
    jitter: bool = True,
    denoise: bool = False,
    znear: float = 0.01,
    zfar: float = 999.9,
    targets_available: bool = True,
    **backend_kwargs,
):
    """Render a scene camera (scene/cameras.py) through
    dispatch_render_frame on the scene's device; `backend_kwargs` are
    dispatch_render_frame's (default_backend_kwargs(cfg) splats in).
    Without a generator (and without `samples`) the frame draws from a
    generator seeded 0.  Returns a SimpleNamespace: rgb [S, 3, H, W] per
    bounce, final [3, H, W], overflow_frac (the share of starved bounce x
    ray slots), depth / normal / roughness / f0 / transmittance [S, C, H, W]
    and the camera's targets [C, H, W] (None without them).  denoise=True
    filters the specular part of `final` guided by the primary G-buffer
    (render.py:144-153)."""
    dev = scene.xyz.device
    if generator is None and backend_kwargs.get("samples") is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    H, W = camera.image_height, camera.image_width
    cam = camera_params(camera, znear, zfar, device=dev)
    steps, final = dispatch_render_frame(
        scene, cam, settings, generator, W, H, num_bounces=num_bounces,
        max_hits=max_hits, chunk=chunk, tile=tile, jitter=jitter,
        **backend_kwargs)

    def chw(a):  # [S, R, C] -> [S, C, H, W]
        a = a.cpu().numpy()
        if a.ndim == 2:
            a = a[..., None]
        return a.reshape(a.shape[0], H, W, a.shape[-1]).transpose(0, 3, 1, 2)

    final_img = final.reshape(H, W, 3)
    if denoise:
        final_img = denoise_specular(
            final_img, steps.rgb[0].reshape(H, W, 3),
            steps.normal[0].reshape(H, W, 3), steps.depth[0].reshape(H, W),
            steps.roughness[0].reshape(H, W))

    t = camera if targets_available else None

    def tgt(name):
        img = None if t is None else getattr(t, name, None)
        return None if img is None else np.asarray(img).transpose(2, 0, 1)

    return SimpleNamespace(
        rgb=chw(steps.rgb),
        final=final_img.cpu().numpy().transpose(2, 0, 1),
        # share of (step, ray) slots starved by candidate-list overflow
        overflow_frac=float(steps.overflow.mean()),
        depth=chw(steps.depth),
        normal=chw(steps.normal),
        roughness=chw(steps.roughness),
        f0=chw(steps.f0),
        transmittance=chw(steps.transmittance),
        target=tgt("original_image"),
        target_diffuse=tgt("diffuse_image"),
        target_specular=tgt("specular_image"),
        target_depth=tgt("depth_image"),
        target_normal=tgt("normal_image"),
        target_roughness=tgt("roughness_image"),
        target_f0=tgt("f0_image"),
    )
