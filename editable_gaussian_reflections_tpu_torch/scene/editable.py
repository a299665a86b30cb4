"""EditableGaussianScene - post-training scene editing (twin of the JAX
package's scene/editable.py; reference scene/editable_gaussian_model.py:
11-328 and the Edit dataclass of gaussian_viewer.py:38-68).

Boolean selections built from bounding_boxes.json (axis-aligned boxes,
elliptic cylinders via "cyl", per-property value filters with optional
zrange conditionals, "exclude" composition), plus dirty-tracked per-object
material and geometry edits applied to a base GaussianScene.

The selections are bool tensors and the edits tensor operations on the
scene's device, so an edit of a large scene does not pass through the host.
The arithmetic is the JAX package's numpy arithmetic: float32, with the
rotation built and applied in float64 (numpy promotes `x @ Rm.T` there) and
the rotated quaternion's matrix rounded to float32 before it is converted
back, as the JAX package's jnp round trip does with x64 off.  The 3x3
products are spelled out, so every device rounds them alike.
"""

from __future__ import annotations

import copy
import json
import math
import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.precision import WIDE, mean_last, norm, rounded
from ..ops.quaternion import quat_to_rotmat, rotmat_to_quat
from ..utils.color import (
    axis_angle_to_rotation_matrix,
    floor_mod,
    hsv_to_rgb,
    rgb_to_hsv,
)
from .gaussian_scene import GaussianScene

DUPLICATION_OFFSET = 0.08


@dataclass(eq=True)
class Edit:
    """gaussian_viewer.py:38-68."""

    roughness_shift: float = 0.0
    roughness_mult: float = 1.0

    diffuse_override: tuple = (0.5, 0.5, 0.5, 0.0)
    diffuse_hue_shift: float = 0.0
    diffuse_saturation_shift: float = 0.0
    diffuse_saturation_mult: float = 1.0
    diffuse_value_shift: float = 0.0
    diffuse_value_mult: float = 1.0

    use_roughness_override: bool = False
    roughness_override: float = 0.0

    specular_override: tuple = (0.5, 0.5, 0.5, 0.0)
    specular_hue_shift: float = 0.0
    specular_saturation_shift: float = 0.0
    specular_saturation_mult: float = 1.0
    specular_value_shift: float = 0.0
    specular_value_mult: float = 1.0

    translate_x: float = 0.0
    translate_y: float = 0.0
    translate_z: float = 0.0

    scale: float = 1.0

    rotate_x: float = 0.0
    rotate_y: float = 0.0
    rotate_z: float = 0.0


def _host(a, like: torch.Tensor) -> torch.Tensor:
    """A small numpy array (its dtype kept) on `like`'s device."""
    return torch.as_tensor(np.asarray(a), device=like.device)


def _f32(x) -> float:
    """A host scalar rounded to float32, as numpy casts a Python scalar
    meeting a float32 array."""
    return float(np.float32(x))


def _matvec(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """x @ m.T over the last axis (size 3) in m's dtype, summed left to
    right."""
    x = x.to(m.dtype)
    return torch.stack([x[..., 0] * m[j, 0] + x[..., 1] * m[j, 1]
                        + x[..., 2] * m[j, 2] for j in range(3)], dim=-1)


def _matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [3, 3] @ b [..., 3, 3] in a's dtype, summed left to right."""
    b = b.to(a.dtype)
    rows = [torch.stack([a[j, 0] * b[..., 0, k] + a[j, 1] * b[..., 1, k]
                         + a[j, 2] * b[..., 2, k] for k in range(3)], dim=-1)
            for j in range(3)]
    return torch.stack(rows, dim=-2)


def compute_bbox_mask(xyz: torch.Tensor, bounding_box: dict) -> torch.Tensor:
    """editable_gaussian_model.py:30-52."""
    min_b = np.asarray(bounding_box["min"], np.float32)
    max_b = np.asarray(bounding_box["max"], np.float32)
    if "cyl" in bounding_box:
        center_xy = _host(0.5 * (min_b[:2] + max_b[:2]), xyz)
        half_xy = _host(0.5 * (max_b[:2] - min_b[:2]), xyz)
        normalized = (xyz[:, :2] - center_xy) / half_xy
        inside_ellipse = (normalized[:, 0] * normalized[:, 0]
                          + normalized[:, 1] * normalized[:, 1]) <= 1.0
        inside_z = (xyz[:, 2] >= _f32(min_b[2])) & (xyz[:, 2]
                                                     <= _f32(max_b[2]))
        return inside_ellipse & inside_z
    return (torch.all(xyz >= _host(min_b, xyz), -1)
            & torch.all(xyz <= _host(max_b, xyz), -1))


def compute_selections(scene: GaussianScene, bounding_boxes: dict,
                       model_path: Optional[str] = None
                       ) -> Dict[str, torch.Tensor]:
    """make_editable's selection pass (editable_gaussian_model.py:16-91),
    with the cached selections/<key>.npy; bool tensors on the scene's
    device."""
    xyz = scene.xyz
    raw = {"f0": scene.f0, "roughness": scene.roughness[:, None],
           "diffuse": scene.diffuse}
    selections = {}
    for key, bounding_box in bounding_boxes.items():
        if model_path:
            p = os.path.join(model_path, "selections", key + ".npy")
            if os.path.exists(p):
                cached = np.load(p).astype(bool).reshape(-1)
                sel = np.zeros(scene.capacity, bool)
                sel[:cached.shape[0]] = cached
                selections[key] = _host(sel, xyz)
                continue

        within = compute_bbox_mask(xyz, bounding_box)
        for prop in ("f0", "roughness", "metalness", "diffuse"):
            if prop in bounding_box:
                prop_mean = mean_last(raw["f0" if prop == "metalness"
                                           else prop])
                lo = _f32(bounding_box[prop][0])
                hi = _f32(bounding_box[prop][1])
                if "zrange" in bounding_box:
                    low = np.asarray(bounding_box["min"], np.float32)
                    high = np.asarray(bounding_box["max"], np.float32)
                    zlow = low + (high - low) * bounding_box["zrange"]
                    m = (torch.all(xyz >= _host(zlow, xyz), -1)
                         & torch.all(xyz <= _host(high, xyz), -1))
                    within = within & ((prop_mean >= lo) | m)
                    within = within & ((prop_mean <= hi) | m)
                else:
                    within = within & (prop_mean >= lo)
                    within = within & (prop_mean <= hi)
        for exclusion in bounding_box.get("exclude", ()):
            within = within & ~compute_bbox_mask(xyz,
                                                 bounding_boxes[exclusion])
        selections[key] = within & scene.live_mask
    selections["everything"] = scene.live_mask.clone()
    return selections


def _hsv_edit(rgb, sel, override, hue_shift, sat_shift, sat_mult,
              val_shift, val_mult):
    """An Edit's colour override and HSV shifts on the selected rows
    (editable_gaussian_model.py:126-170)."""
    ov = np.asarray(override, np.float32)
    base = rgb * float(1 - ov[3]) + _host(ov[None, :3] * ov[3], rgb)
    hsv = rgb_to_hsv(base)
    h = floor_mod(hsv[:, 0] + math.pi * hue_shift, 2 * math.pi)
    s = torch.clamp(sat_mult * (hsv[:, 1] + sat_shift), 0.0, 1.0)
    v = torch.clamp(val_mult * (hsv[:, 2] + val_shift), min=0.0)
    edited = hsv_to_rgb(torch.stack([h, s, v], dim=-1))
    return torch.where(sel[:, None], edited, rgb)


class EditableGaussianScene:
    """Holds a base scene, selections and per-object edits; produces the
    edited scene on demand with dirty tracking."""

    def __init__(self, scene: GaussianScene):
        self.base = scene
        self.ready_for_editing = False
        self.edits: Dict[str, Edit] = {}
        self.bounding_boxes: Dict[str, dict] = {}
        self.selections: Dict[str, torch.Tensor] = {}
        self.created_objects = []
        self.is_dirty = True
        self.last_edits = None
        self.last_scaling_modifier = 1.0
        self._cached = None

    @classmethod
    def from_model_dir(cls, scene: GaussianScene, model_path: str):
        obj = cls(scene)
        bb_path = os.path.join(model_path, "bounding_boxes.json")
        if os.path.exists(bb_path):
            with open(bb_path) as f:
                boxes = json.load(f)
            edits = {k: Edit() for k in boxes}
            obj.make_editable(edits, boxes, model_path)
        return obj

    def make_editable(self, edits: Dict[str, Edit], bounding_boxes: dict,
                      model_path: Optional[str] = None):
        assert set(edits.keys()) == set(bounding_boxes.keys())
        self.edits = edits
        self.bounding_boxes = bounding_boxes
        self.created_objects = list(edits.keys())
        self.selections = compute_selections(self.base, bounding_boxes,
                                             model_path)
        self.ready_for_editing = True
        self.is_dirty = True
        self.last_edits = None

    def dirty_check(self, scaling_modifier: float = 1.0):
        """editable_gaussian_model.py:95-103."""
        if (self.last_edits is None or self.edits != self.last_edits
                or self.last_scaling_modifier != scaling_modifier):
            self.last_edits = copy.deepcopy(self.edits)
            self.last_scaling_modifier = scaling_modifier
            self.is_dirty = True
        else:
            self.is_dirty = False
        return self.is_dirty

    def edited_scene(self) -> GaussianScene:
        """Apply all edits; returns the scene to render."""
        if not self.ready_for_editing:
            return self.base
        if not self.is_dirty and self._cached is not None:
            return self._cached

        b = self.base
        xyz = b.xyz
        scaling = rounded(torch.exp, b.scaling)
        rotation = b.rotation
        diffuse = torch.clamp(b.diffuse, min=0.0)
        normal = b.normal
        f0 = torch.clamp(b.f0, 0.0, 1.0)
        roughness = torch.clamp(b.roughness, 0.0, 1.0)

        for key, edit in self.edits.items():
            # every operation below is a select on `sel`: an empty
            # selection leaves the scene as it is
            sel = self.selections[key]
            sel3 = sel[:, None]

            # * roughness (editable_gaussian_model.py:106-124)
            if edit.use_roughness_override:
                base_r = torch.full_like(roughness,
                                         _f32(edit.roughness_override**2))
            else:
                base_r = roughness
            mod_r = torch.clamp(
                edit.roughness_mult
                * (base_r + math.copysign(edit.roughness_shift,
                                          edit.roughness_shift**2)),
                0.0, 1.0)
            roughness = torch.where(sel, mod_r, roughness)

            # * diffuse and f0 in HSV (:126-170)
            diffuse = _hsv_edit(
                diffuse, sel, edit.diffuse_override, edit.diffuse_hue_shift,
                edit.diffuse_saturation_shift, edit.diffuse_saturation_mult,
                edit.diffuse_value_shift, edit.diffuse_value_mult)
            f0 = _hsv_edit(
                f0, sel, edit.specular_override, edit.specular_hue_shift,
                edit.specular_saturation_shift, edit.specular_saturation_mult,
                edit.specular_value_shift, edit.specular_value_mult)

            # * geometry (:172-279)
            angles = np.deg2rad([edit.rotate_x, edit.rotate_y,
                                 edit.rotate_z])
            Rm = axis_angle_to_rotation_matrix(
                torch.as_tensor(np.asarray(angles, np.float64))).to(
                    xyz.device)
            normal = torch.where(sel3, _matvec(normal, Rm).to(normal.dtype),
                                 normal)

            t = np.array([edit.translate_x, edit.translate_y,
                          edit.translate_z], np.float32)
            xyz = torch.where(sel3, xyz + _host(t, xyz), xyz)
            bb = self.bounding_boxes.get(key)
            if bb is not None and "min" in bb:
                center = _host(np.array(
                    [(bb["min"][i] + bb["max"][i]) / 2 for i in range(3)],
                    np.float32) + t, xyz)
            else:
                # the selected rows' mean, summed in float64 and rounded
                # once (numpy sums float32 pairwise)
                count = sel.sum().to(WIDE)
                center = (torch.where(sel3, xyz, 0.0).to(WIDE).sum(0)
                          / count).to(xyz.dtype)
            xyz = torch.where(sel3, (xyz - center) * edit.scale + center,
                              xyz)
            rotated = _matvec(xyz - center, Rm) + center.to(WIDE)
            xyz = torch.where(sel3, rotated.to(xyz.dtype), xyz)

            scaling = torch.where(sel3, scaling * edit.scale, scaling)

            if any(abs(a) > 1e-12 for a in angles):
                q = rotation / norm(rotation, keepdim=True)
                Rq = _matmul3(Rm, quat_to_rotmat(q)).to(rotation.dtype)
                rotation = torch.where(sel3, rotmat_to_quat(Rq), rotation)

        edited = b._replace(
            xyz=xyz,
            scaling=rounded(torch.log, torch.clamp(scaling, min=1e-30)),
            rotation=rotation,
            diffuse=diffuse,
            normal=normal,
            f0=f0,
            roughness=roughness,
        )
        self._cached = edited
        self.is_dirty = False
        return edited

    def duplicate_object(self, obj_name: str,
                         offset: float = DUPLICATION_OFFSET):
        """editable_gaussian_model.py:283-322: append copies (unpadded, as
        the JAX package does) and grow the selections."""
        sel = self.selections[obj_name]
        idx = torch.nonzero(sel).squeeze(1)
        edit = self.edits[obj_name]
        b = self.base
        delta = _host(np.array([edit.translate_x, edit.translate_y,
                                edit.translate_z], np.float32), b.xyz)
        n_new = int(idx.numel())

        def cat(arr, new):
            return torch.cat([arr, new], dim=0)

        self.base = GaussianScene(
            xyz=cat(b.xyz, b.xyz[idx] + offset + delta),
            scaling=cat(b.scaling, b.scaling[idx]),
            rotation=cat(b.rotation, b.rotation[idx]),
            opacity=cat(b.opacity, b.opacity[idx]),
            diffuse=cat(b.diffuse, b.diffuse[idx]),
            normal=cat(b.normal, b.normal[idx]),
            f0=cat(b.f0, b.f0[idx]),
            roughness=cat(b.roughness, b.roughness[idx]),
            live_mask=cat(b.live_mask, torch.ones(
                n_new, dtype=torch.bool, device=sel.device)),
        )
        copy_key = obj_name + "_copy"
        self.selections[copy_key] = torch.zeros_like(sel)
        for key in list(self.selections):
            extra = torch.full((n_new,), key in ("everything", copy_key),
                               dtype=torch.bool, device=sel.device)
            self.selections[key] = cat(self.selections[key], extra)
        self.edits[copy_key] = Edit()
        self.bounding_boxes[copy_key] = dict(
            self.bounding_boxes.get(obj_name, {}))
        self.created_objects.append(copy_key)
        self.is_dirty = True
        self._cached = None

    def remove_object(self, obj_name: str):
        """editable_gaussian_model.py:324-328 (opacity -> -1e8)."""
        sel = self.selections[obj_name]
        op = self.base.opacity
        self.base = self.base._replace(
            opacity=torch.where(sel, op * 0.0 - 100000000.0, op))
        self.is_dirty = True
        self._cached = None
