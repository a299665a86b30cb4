"""Viewer state machine - the GUI-free core of the reference's
GaussianViewer (twin of the JAX package's viewer/state.py; reference
gaussian_viewer.py:71-891 with the imgui layer removed).

Render-mode list, exposure/znear/scaling-modifier, SPP accumulation with
dirty-tracked resets, per-object Edit state from bounding_boxes.json,
duplicate/remove objects, and point-and-click object selection via
selection-mask renders (one-hot diffuse, gaussian_viewer.py:292-321).

The G-buffers, the accumulation and the display image stay on the scene's
device (the card unless the scene was built with device="cpu"); a tick
copies the display image to the host once (viewer/service.py), and
inspect_pixel and object_at_pixel read one pixel each.  Each tick's frame
draws its samples from a torch.Generator seeded with the accumulation count
(the JAX package: PRNGKey(count)), each selection mask from one seeded 0;
`samples`, when set, supplies them instead (see ViewerState.samples).
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..config import Config, load_config
from ..device import DEFAULT_DEVICE, resolve_device
from ..ops.activations import sigmoid_act
from ..ops.ellipsoid_raster import rasterize_ellipsoids
from ..ops.precision import WIDE, div, mean_last, norm, rounded
from ..ops.tonemap import tonemap
from ..renderer import raytracer as rt
from ..renderer.raytracer import RenderSettings, fused_path_ok
from ..renderer.render import (
    camera_params,
    default_backend_kwargs,
    dispatch_render_frame,
)
from ..scene.cameras import MiniCam
from ..scene.editable import DUPLICATION_OFFSET, Edit, EditableGaussianScene
from ..scene.scene import load_scene_ply, search_for_max_iteration

RENDER_MODES = ["RGB", "Normals", "Depth", "F0", "Roughness", "Ellipsoids",
                "Points"]


class ViewerState:
    def __init__(self, scene: EditableGaussianScene, cfg: Config,
                 width: int, height: int, fovy: float,
                 settings: Optional[RenderSettings] = None):
        self.gaussians = scene
        self.cfg = cfg
        self.width = width
        self.height = height
        self.fovy = fovy
        self.settings = settings or RenderSettings()

        self.render_mode = 0
        self.exposure = 1.0
        self.znear = 0.05
        self.zfar = 1000.0
        self.scaling_modifier = 1.0
        self.accumulate_samples = True
        self.denoise = False
        self.num_bounces = 2
        self.spp = 1
        # interactive preview downscale (1/2/4): the client drops to s>1
        # during camera/gizmo drags (render cost falls ~s^2; the frame is
        # nearest-upscaled back to width x height so the protocol shape,
        # pick/inspect coordinates, and accumulation buffers never change)
        self.preview_scale = 1
        # EllipsoidViewer widget knobs (viewer/widgets/ellipsoid_viewer.py:
        # 315-317): alpha clip limit for the solid stage, the widget's own
        # scale modifier (composed with scaling_modifier), and whether the
        # additive sub-limit "floaters" stage renders
        self.ellipsoid_limit = 0.2
        self.ellipsoid_scale = 0.5
        self.render_floaters = False

        self._accum = None
        self._accum_count = 0
        self._last_pose = None
        self.is_dirty = True
        self.selection_masks: Dict[str, torch.Tensor] = {}
        self.dataset_cameras: list = []  # CameraSelect poses (from_ply)
        # samples(seed, width, height, num_steps, fused, tile, jitter) ->
        # the FrameSamples (fused) or TileSamples a frame takes, on the
        # scene's device; None draws them from a generator seeded `seed`
        self.samples: Optional[Callable] = None

    @property
    def device(self) -> torch.device:
        return self.gaussians.base.xyz.device

    @classmethod
    def from_ply(cls, model_path: str, iteration: Optional[int] = None,
                 resolution: Optional[int] = None,
                 device: torch.device | str = DEFAULT_DEVICE):
        """gaussian_viewer.py:125-184: a self-contained model directory,
        its Gaussians on `device` (the card unless "cpu")."""
        from ..training import settings_from_config

        dev = resolve_device(device)
        cfg_path = os.path.join(model_path, "cfg.json")
        cfg = load_config(cfg_path) if os.path.exists(cfg_path) else Config()
        if resolution:
            cfg.resolution = resolution
        iteration = iteration or search_for_max_iteration(
            os.path.join(model_path, "point_cloud"))
        ply = os.path.join(model_path, "point_cloud",
                           f"iteration_{iteration}", "point_cloud.ply")
        base = load_scene_ply(ply, pad_multiple=cfg.trace_chunk, device=dev)
        scene = EditableGaussianScene.from_model_dir(base, model_path)

        fovy = 0.7
        tj = os.path.join(model_path, "transforms_train.json")
        width = height = cfg.resolution or 512
        dataset_cameras = []
        if os.path.exists(tj):
            with open(tj) as f:
                contents = json.load(f)
            fovy = contents.get("camera_angle_y",
                                contents.get("camera_angle_x", 0.7))
            # dataset camera poses for the CameraSelect widget analog
            # (viewer/widgets/camera_select.py): the OpenGL->COLMAP
            # conversion of dataset/blender.py
            for frame in contents.get("frames", [])[:100]:
                c2w = np.array(frame["transform_matrix"], np.float64)
                c2w[:3, 1:3] *= -1
                w2c = np.linalg.inv(c2w)
                dataset_cameras.append(dict(
                    name=os.path.basename(str(frame.get("file_path", ""))),
                    R=np.transpose(w2c[:3, :3]).tolist(),
                    camera_center=c2w[:3, 3].tolist(),
                ))
        st = cls(scene, cfg, width, height, fovy, settings_from_config(cfg))
        st.dataset_cameras = dataset_cameras
        return st

    # ------------------------------------------------------------------

    def _pose_key(self, camera: MiniCam):
        return (np.asarray(camera.R).tobytes(),
                np.asarray(camera.camera_center).tobytes(),
                self.znear, self.zfar, self.render_mode, self.num_bounces,
                self.preview_scale, self.ellipsoid_limit,
                self.ellipsoid_scale, self.render_floaters)

    def _check_dirty(self, camera: MiniCam):
        scene_dirty = self.gaussians.dirty_check(self.scaling_modifier)
        pose = self._pose_key(camera)
        cam_dirty = pose != self._last_pose
        self._last_pose = pose
        if scene_dirty or cam_dirty or not self.accumulate_samples:
            self._accum = None
            self._accum_count = 0
            return True
        return False

    def _frame_randomness(self, seed, width, height, num_steps, fused,
                          jitter=True):
        """(generator, samples) for a frame seeded `seed`."""
        if self.samples is not None:
            tile = min(self.cfg.ray_tile, width * height)
            return None, self.samples(seed, width, height, num_steps, fused,
                                      tile, jitter)
        return torch.Generator(device=self.device).manual_seed(seed), None

    def step(self, camera: MiniCam) -> torch.Tensor:
        """One render tick; returns the HWC display image in [0, 1] on the
        scene's device (gaussian_viewer.py:256-381)."""
        self._check_dirty(camera)
        scene = self.gaussians.edited_scene()
        # drag-time preview downscale: every route needs 16 | H, W (fused
        # pixel tiling, cull-tile divisibility, raster tiles), so only
        # drop when the reduced frame still qualifies
        s = int(self.preview_scale)
        if s not in (2, 4) or self.height % (16 * s) or self.width % (16 * s):
            s = 1
        H, W = self.height // s, self.width // s
        mode = RENDER_MODES[self.render_mode]
        if mode in ("Ellipsoids", "Points"):
            frame = self._raster_frame(scene, camera, W, H,
                                       points=(mode == "Points"))
        else:
            if self.scaling_modifier != 1.0:
                settings = self.settings._replace(
                    global_scale_factor=self.scaling_modifier)
            else:
                settings = self.settings
            cam = camera_params(camera, znear=self.znear, zfar=self.zfar,
                                device=self.device)
            bk = default_backend_kwargs(self.cfg)
            if s > 1 and bk.get("use_culling"):
                # drag-time preview: the drain-free scan composite (~3x
                # faster, streaming-order approximation) compounds with the
                # downscale; the full-res settled frame re-renders exact
                bk["composite_mode"] = "scan"
                bk["kernel_stats"] = False  # preview needs no counters
            fused = bool(bk.get("use_culling")) and fused_path_ok(
                scene, W, H, bk["cull_cluster"], bk["composite_mode"])
            generator, samples = self._frame_randomness(
                self._accum_count, W, H, self.num_bounces + 1, fused)
            steps, final = dispatch_render_frame(
                scene, cam, settings, generator, W, H,
                num_bounces=self.num_bounces,
                max_hits=self.cfg.max_hits,
                chunk=self.cfg.trace_chunk, tile=self.cfg.ray_tile,
                samples=samples, **bk,
            )
            frame = dict(
                rgb=final.reshape(H, W, 3),
                normal=steps.normal[0].reshape(H, W, 3),
                depth=steps.depth[0].reshape(H, W, 1),
                f0=steps.f0[0].reshape(H, W, 3),
                roughness=steps.roughness[0].reshape(H, W, 1),
            )
        if s > 1:  # nearest-upscale so downstream shapes stay full-res
            frame = {k: v.repeat_interleave(s, 0).repeat_interleave(s, 1)
                     for k, v in frame.items()}
        if self.accumulate_samples:
            gid = frame.pop("gid", None)  # integer G-buffer: never averaged
            if self._accum is None:
                self._accum = frame
                self._accum_count = 1
            else:
                self._accum = {k: a + frame[k]
                               for k, a in self._accum.items()}
                self._accum_count += 1
            frame = {k: div(v, float(self._accum_count))
                     for k, v in self._accum.items()}
            if gid is not None:
                frame["gid"] = gid
        self._last_frame = frame  # G-buffer stash for inspect_pixel

        if mode == "RGB":
            img = tonemap(frame["rgb"] * self.exposure)
        elif mode == "Normals":
            n = frame["normal"]
            n = n / torch.clamp(norm(n, keepdim=True), min=1e-8)
            img = n * 0.5 + 0.5
        elif mode == "Depth":
            dmax = torch.clamp(frame["depth"].max(), min=1e-8)
            img = (frame["depth"] / dmax).expand(-1, -1, 3)
        elif mode == "F0":
            img = frame["f0"] * self.exposure
        elif mode == "Roughness":
            img = frame["roughness"].expand(-1, -1, 3)
        else:  # Ellipsoids/Points: the preview colors ride the rgb channel
            img = frame["rgb"]
        return torch.clamp(img, 0.0, 1.0)

    # ------------------------------------------------------------------

    def compute_selection_masks(self, camera: MiniCam):
        """Point-and-click selection via one-hot diffuse renders
        (gaussian_viewer.py:292-321): render each object's selection as its
        diffuse color, threshold to get per-pixel object masks (bool
        tensors on the scene's device)."""
        scene = self.gaussians.edited_scene()
        cam = camera_params(camera, znear=self.znear, zfar=self.zfar,
                            device=self.device)
        H, W = self.height, self.width
        for key, sel in self.gaussians.selections.items():
            if key == "everything":
                continue
            onehot = sel[:, None].to(torch.float32).expand(-1, 3)
            sel_scene = scene._replace(diffuse=onehot.contiguous())
            generator, samples = self._frame_randomness(
                0, W, H, 1, False, jitter=False)
            _, final = rt.render_frame(
                sel_scene, cam, self.settings, generator, W, H,
                num_bounces=0, max_hits=self.cfg.max_hits,
                chunk=self.cfg.trace_chunk, tile=self.cfg.ray_tile,
                jitter=False, samples=samples,
            )
            img = final.reshape(H, W, 3)
            self.selection_masks[key] = mean_last(img) > 0.5
        return self.selection_masks

    def object_at_pixel(self, x: int, y: int) -> Optional[str]:
        # in raster modes the hit-id G-buffer resolves the pick at once
        # (no per-object mask renders needed)
        frame = getattr(self, "_last_frame", None)
        if frame is not None and "gid" in frame \
                and 0 <= y < self.height and 0 <= x < self.width:
            gid = int(frame["gid"][y, x, 0])
            if gid < 0:
                return None
            keys = [k for k, sel in self.gaussians.selections.items()
                    if k != "everything" and gid < sel.shape[0]]
            if not keys:
                return None
            hit = torch.stack([self.gaussians.selections[k][gid]
                               for k in keys]).tolist()
            return next((k for k, h in zip(keys, hit) if h), None)
        keys = [k for k, m in self.selection_masks.items()
                if 0 <= y < m.shape[0] and 0 <= x < m.shape[1]]
        if not keys:
            return None
        hit = torch.stack([self.selection_masks[k][y, x]
                           for k in keys]).tolist()
        return next((k for k, h in zip(keys, hit) if h), None)

    def inspect_pixel(self, x: int, y: int) -> Optional[dict]:
        """G-buffer values at a pixel of the LAST rendered frame - the
        PixelInspector widget analog (viewer/widgets/inspector.py)."""
        frame = getattr(self, "_last_frame", None)
        if frame is None or not (0 <= y < self.height
                                 and 0 <= x < self.width):
            return None
        vals = [v[y, x].reshape(-1).to(WIDE) for v in frame.values()]
        flat = torch.cat(vals).tolist()  # one copy to the host
        out, i = {}, 0
        for k, v in zip(frame, vals):
            out[k] = [round(float(c), 4) for c in flat[i:i + v.numel()]]
            i += v.numel()
        return out

    def duplicate_object(self, name: str):
        self.gaussians.duplicate_object(name, DUPLICATION_OFFSET)
        self.__dict__.pop("_raw_centers", None)  # gizmo anchors changed

    def reset_edits(self):
        for k in self.gaussians.edits:
            self.gaussians.edits[k] = Edit()
        self.gaussians.is_dirty = True

    # serialization for the websocket protocol -------------------------

    def object_centers(self) -> dict:
        """World-space gizmo anchor per selectable object: raw xyz mean plus
        the edit's translation (scale/rotate pivot about the center, so only
        translate moves it - editable.py geometry semantics).  The mean is
        summed in float64 and rounded to float32 once (numpy sums float32
        pairwise)."""
        if not hasattr(self, "_raw_centers"):
            xyz = self.gaussians.base.xyz
            keys = [k for k in self.gaussians.selections
                    if k != "everything"]
            self._raw_centers = {}
            if keys:
                sels = torch.stack([self.gaussians.selections[k]
                                    for k in keys])              # [K, N]
                counts = sels.sum(1)
                sums = torch.where(sels[..., None], xyz, 0.0).to(WIDE).sum(1)
                means = (sums / counts[:, None]).to(xyz.dtype).cpu().numpy()
                for k, c, n in zip(keys, means, counts.tolist()):
                    if n > 0:
                        self._raw_centers[k] = c
        out = {}
        for key, c in self._raw_centers.items():
            e = self.gaussians.edits.get(key)
            t = (np.array([e.translate_x, e.translate_y, e.translate_z])
                 if e is not None else 0.0)
            out[key] = (c + t).tolist()
        return out

    def _raster_frame(self, scene, camera, width, height, points=False):
        """Ellipsoids/Points preview via the screen-space instanced
        ellipsoid rasterizer (ops/ellipsoid_raster.py - the EllipsoidViewer
        / PointRenderer widget analogs) instead of the ray tracer."""
        n = scene.capacity
        dev = scene.xyz.device
        if points:
            # every Gaussian as a small opaque isotropic sphere keeping its
            # diffuse color
            xyz = scene.xyz
            extent = float(norm(xyz.amax(0) - xyz.amin(0))) or 1.0
            radius = max(0.004 * extent, 1e-4) * self.scaling_modifier
            radii = torch.full((n, 3), radius, dtype=torch.float32,
                               device=dev)
            colors = torch.clamp(scene.diffuse, 0.0, 1.0)
            alphas = torch.ones((n,), dtype=torch.float32, device=dev)
        else:
            # per-Gaussian hash colors (the low 24 bits of a uint32
            # product), widget half-axes 2 * scale * modifier, sigmoid
            # alphas clipped at the limit
            idx = torch.arange(n, dtype=torch.int64, device=dev)
            h = (idx * 2654435761) & 0xFFFFFF
            colors = (torch.stack([h & 0xFF, (h >> 8) & 0xFF,
                                   (h >> 16) & 0xFF], -1).to(WIDE)
                      / 255.0).to(torch.float32)
            radii = 2.0 * rounded(torch.exp, scene.scaling) * (
                self.ellipsoid_scale * self.scaling_modifier)
            alphas = rounded(sigmoid_act, scene.opacity)

        cam = camera_params(camera, znear=self.znear, zfar=self.zfar,
                            device=dev)
        out = rasterize_ellipsoids(
            scene.xyz, scene.rotation, radii, colors, alphas,
            scene.live_mask, cam.c2w, cam.origin, cam.fov_y,
            width=width, height=height, znear=self.znear, zfar=self.zfar,
            alpha_limit=0.0 if points else self.ellipsoid_limit,
            render_floaters=bool(self.render_floaters) and not points)
        zeros = torch.zeros((height, width, 3), dtype=torch.float32,
                            device=dev)
        return dict(
            rgb=out.rgb,
            normal=out.normal,
            depth=out.depth[..., None],
            f0=zeros,
            roughness=zeros[..., :1],
            gid=out.gid[..., None],
        )

    def get_state(self) -> dict:
        return dict(
            object_centers=self.object_centers(),
            render_mode=self.render_mode,
            exposure=self.exposure,
            znear=self.znear,
            zfar=self.zfar,
            scaling_modifier=self.scaling_modifier,
            accumulate_samples=self.accumulate_samples,
            num_bounces=self.num_bounces,
            preview_scale=self.preview_scale,
            ellipsoid_limit=self.ellipsoid_limit,
            ellipsoid_scale=self.ellipsoid_scale,
            render_floaters=self.render_floaters,
            objects=list(self.gaussians.edits.keys()),
            edits={k: asdict(e) for k, e in self.gaussians.edits.items()},
            width=self.width,
            height=self.height,
            dataset_camera_names=[c["name"] for c in self.dataset_cameras],
        )

    def set_state(self, state: dict):
        for k in ("render_mode", "exposure", "znear", "zfar",
                  "scaling_modifier", "accumulate_samples", "num_bounces",
                  "preview_scale", "ellipsoid_limit", "ellipsoid_scale",
                  "render_floaters"):
            if k in state:
                setattr(self, k, state[k])
        for name, e in state.get("edits", {}).items():
            if name in self.gaussians.edits:
                cur = self.gaussians.edits[name]
                for field, val in e.items():
                    if isinstance(val, list):
                        val = tuple(val)
                    setattr(cur, field, val)
