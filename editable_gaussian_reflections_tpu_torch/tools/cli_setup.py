"""The training CLI's loop (train.train_scene) on a dataset built in
memory, as `chip_smoke.py` phase 18 drives it.

The dataset: views orbiting room_camera (fused_setup.orbit_views), their
G-buffers (render, diffuse, specular, depth, normal, roughness, f0) the
port's render of the seed-0 room_scene(n) at each view, and the seed-1
room's centres and diffuse colours as the initial point cloud (zero
normals).  `train_cli(...)` runs set_seeds(), prepare_output_and_logger,
Scene(cfg, scene_info=...) and train_scene on it, as train.main does on a
dataset read from disk.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from editable_gaussian_reflections_tpu_torch import train as ttrain
from editable_gaussian_reflections_tpu_torch.config import Config
from editable_gaussian_reflections_tpu_torch.renderer.raytracer import (
    RenderSettings,
)
from editable_gaussian_reflections_tpu_torch.renderer.render import (
    camera_params,
    dispatch_render_frame,
)
from editable_gaussian_reflections_tpu_torch.scene.cameras import Camera
from editable_gaussian_reflections_tpu_torch.scene.dataset_readers import (
    SceneInfo,
    getNerfppNorm,
)
from editable_gaussian_reflections_tpu_torch.scene.gaussian_scene import (
    from_arrays,
)
from editable_gaussian_reflections_tpu_torch.scene.scene import Scene
from editable_gaussian_reflections_tpu_torch.tools.fused_setup import (
    orbit_views,
)
from editable_gaussian_reflections_tpu_torch.tools.nonfused_setup import (
    FRAME_KW,
)
from editable_gaussian_reflections_tpu_torch.utils.general import set_seeds
from editable_gaussian_reflections_tpu_torch.utils.graphics import (
    BasicPointCloud,
)
from editable_gaussian_reflections_tpu_torch.utils.synth import room_scene


def gbuffer_views(n: int, side: int, n_train: int, n_test: int,
                  device) -> tuple:
    """(train cameras, test cameras): n_train + n_test views orbiting the
    room at side x side pixels, each holding the G-buffers of the seed-0
    room_scene(n) rendered on `device` (2 bounces, the Config defaults'
    k-buffer, a generator seeded with the view's index)."""
    scene = from_arrays(**room_scene(n, seed=0), pad_multiple=2048,
                        device=device)
    views = []
    for i, v in enumerate(orbit_views(n_train + n_test, side, side)):
        cam = camera_params(v, v.znear, v.zfar, device=device)
        gen = torch.Generator(device=device).manual_seed(i)
        steps, final = dispatch_render_frame(
            scene, cam, RenderSettings(), gen, side, side, num_bounces=2,
            **FRAME_KW)

        def img(a, ch=3):
            return a.reshape(side, side, ch).cpu().numpy()

        split = "train" if i < n_train else "test"
        views.append(Camera(
            colmap_id=i, R=v.R, T=v.T, FoVx=v.FoVx, FoVy=v.FoVy,
            image=img(final), image_name=f"{split}_{i:03d}", uid=i,
            diffuse_image=img(steps.rgb[0]),
            specular_image=img(steps.rgb[1] + steps.rgb[2]),
            depth_image=img(steps.depth[0], 1),
            normal_image=img(steps.normal[0]),
            roughness_image=img(steps.roughness[0], 1),
            f0_image=img(steps.f0[0])))
    del scene
    return views[:n_train], views[n_train:]


def scene_info(n: int, train_views, test_views) -> SceneInfo:
    """The dataset: the views and the seed-1 room's centres and diffuse
    colours as the point cloud (zero normals)."""
    room = room_scene(n, seed=1)
    pcd = BasicPointCloud(points=room["xyz"], colors=room["diffuse"],
                          normals=np.zeros_like(room["xyz"]))
    return SceneInfo(point_cloud=pcd, train_cameras=list(train_views),
                     test_cameras=list(test_views),
                     nerf_normalization=getNerfppNorm(list(train_views)),
                     ply_path="")


def cli_config(model_path: str, side: int, **overrides) -> Config:
    """The Config defaults at side x side pixels, writing to model_path."""
    data = os.path.join(model_path, "no_dataset")
    return Config(source_path=data, model_path=model_path, resolution=side,
                  **overrides)


def train_cli(cfg: Config, info: SceneInfo, device, resume: bool = False):
    """train.main on a dataset built in memory: (final TrainState, Scene).
    The camera lists are copied before the Scene shuffles them, so one
    SceneInfo gives every run the same order."""
    seed = set_seeds()
    tb_writer = ttrain.prepare_output_and_logger(cfg)
    info = dataclasses.replace(info, train_cameras=list(info.train_cameras),
                               test_cameras=list(info.test_cameras))
    scene = Scene(cfg, scene_info=info, device=device)
    state = ttrain.train_scene(cfg, scene, tb_writer, resume=resume,
                               seed=seed)
    return state, scene
