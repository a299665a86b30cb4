"""PyTorch port vs JAX package: the editing layer (scene/editable.py) and
its colour maths (utils/color.py).

  * tests/test_editing.py's cases on the port.
  * rgb_to_hsv / hsv_to_rgb over random colours, greys (deltac == 0), hue
    past 2pi and negative hues: equal to the JAX package's numpy functions
    within 1e-6; Rodrigues' formula within 1e-12, the theta < 1e-12
    identity included.
  * Selections from a bounding_boxes.json with a box, a "cyl", an f0
    filter with a zrange, an "exclude" and a cached selections/<key>.npy,
    on a padded scene: bit-equal bool masks.
  * edited_scene with every Edit field set alone, then all of them, on two
    objects: every GaussianScene field within 1e-6 (relative or absolute:
    the rotation's quaternion round trip runs through XLA on the JAX side,
    and numpy's float32 exp/log are not correctly rounded), the live mask
    equal.  duplicate_object (capacity, selections, the _copy key, the
    copies' rows), remove_object and the dirty tracking with the scaling
    modifier, against the JAX package's.
Everything runs in this process: the JAX editing layer is numpy.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from editable_gaussian_reflections_tpu.scene import editable as jed
from editable_gaussian_reflections_tpu.scene import gaussian_scene as jgs
from editable_gaussian_reflections_tpu.utils import color as jcolor
from editable_gaussian_reflections_tpu_torch.scene import gaussian_scene as tgs
from editable_gaussian_reflections_tpu_torch.scene.editable import (
    Edit,
    EditableGaussianScene,
    compute_bbox_mask,
)
from editable_gaussian_reflections_tpu_torch.utils import color as tcolor

torch.set_num_threads(1)

TOL = 1e-6


def scene_arrays(n=20, seed=0):
    """tests/test_editing.py:make_scene's arrays."""
    rng = np.random.default_rng(seed)
    return dict(
        xyz=rng.uniform(-2, 2, (n, 3)).astype(np.float32),
        scaling=np.full((n, 3), -1.0, np.float32),
        rotation=np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)),
        opacity=np.zeros(n, np.float32),
        diffuse=rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32),
        normal=rng.normal(size=(n, 3)).astype(np.float32),
        f0=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        roughness=rng.uniform(0, 1, n).astype(np.float32),
    )


def make_scene(n=20, seed=0):
    return tgs.from_arrays(**scene_arrays(n, seed), pad_multiple=8,
                           device="cpu")


def rich_arrays(n=300, seed=5):
    """A scene whose rotations, scalings and colours all vary, for the
    parity cases."""
    rng = np.random.default_rng(seed)
    a = scene_arrays(n, seed)
    a.update(scaling=rng.uniform(-3, 0, (n, 3)).astype(np.float32),
             rotation=rng.normal(size=(n, 4)).astype(np.float32),
             opacity=rng.uniform(-2, 3, n).astype(np.float32),
             diffuse=rng.uniform(-0.1, 1.2, (n, 3)).astype(np.float32),
             f0=rng.uniform(-0.1, 1.1, (n, 3)).astype(np.float32),
             roughness=rng.uniform(-0.1, 1.1, n).astype(np.float32))
    # a few greys, where the hue is 0 by definition
    a["diffuse"][:10] = a["diffuse"][:10, :1]
    a["f0"][10:20] = a["f0"][10:20, 1:2]
    return a


def both_scenes(arrays, pad_multiple=64):
    jscene = jgs.from_arrays(**arrays, pad_multiple=pad_multiple)
    tscene = tgs.from_numpy({f: np.asarray(getattr(jscene, f))
                             for f in jgs.GaussianScene._fields},
                            device="cpu")
    return jscene, tscene


def assert_scenes_close(port, ref, tol=TOL):
    for f in jgs.GaussianScene._fields:
        a = getattr(port, f).numpy()
        b = np.asarray(getattr(ref, f))
        assert a.shape == b.shape, f
        if f == "live_mask":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=f)


# -- tests/test_editing.py's cases on the port ------------------------------


def test_bbox_masks():
    xyz = torch.tensor([[0, 0, 0], [2, 0, 0], [0.4, 0.4, 0.5]])
    box = {"min": [-1, -1, -1], "max": [1, 1, 1]}
    assert compute_bbox_mask(xyz, box).tolist() == [True, False, True]
    cyl = {"min": [-1, -1, -1], "max": [1, 1, 1], "cyl": True}
    assert compute_bbox_mask(xyz, cyl).tolist() == [True, False, True]
    m3 = compute_bbox_mask(torch.tensor([[0.9, 0.9, 0.0]]), cyl)
    assert m3.tolist() == [False]  # corner outside ellipse but inside box


def test_edit_translate_and_remove():
    scene = make_scene()
    es = EditableGaussianScene(scene)
    boxes = {"obj": {"min": [-3, -3, -3], "max": [3, 3, 3]}}
    es.make_editable({"obj": Edit(translate_x=1.0)}, boxes)
    edited = es.edited_scene()
    live = scene.live_mask
    d = (edited.xyz[live] - scene.xyz[live]).numpy()
    np.testing.assert_allclose(d[:, 0], 1.0, atol=1e-6)
    np.testing.assert_allclose(d[:, 1:], 0.0, atol=1e-6)

    es.remove_object("obj")
    assert bool(torch.all(es.base.opacity[es.selections["obj"]] < -1e7))


def test_edit_roughness_override_and_dirty_tracking():
    scene = make_scene()
    es = EditableGaussianScene(scene)
    boxes = {"obj": {"min": [-3, -3, -3], "max": [3, 3, 3]}}
    edits = {"obj": Edit(use_roughness_override=True, roughness_override=0.5)}
    es.make_editable(edits, boxes)
    assert es.dirty_check(1.0) is True
    e1 = es.edited_scene()
    live = scene.live_mask
    np.testing.assert_allclose(e1.roughness[live].numpy(), 0.25, atol=1e-6)
    assert es.dirty_check(1.0) is False  # unchanged edits -> clean
    edits["obj"].roughness_mult = 2.0
    assert es.dirty_check(1.0) is True
    e2 = es.edited_scene()
    np.testing.assert_allclose(e2.roughness[live].numpy(), 0.5, atol=1e-6)


def test_duplicate_object_grows_selections():
    scene = make_scene()
    es = EditableGaussianScene(scene)
    boxes = {"obj": {"min": [0, -3, -3], "max": [3, 3, 3]}}
    es.make_editable({"obj": Edit()}, boxes)
    n_sel = int(es.selections["obj"].sum())
    cap0 = es.base.capacity
    es.duplicate_object("obj")
    assert es.base.capacity == cap0 + n_sel
    assert "obj_copy" in es.selections
    assert int(es.selections["obj_copy"].sum()) == n_sel
    assert int(es.selections["everything"].sum()) == int(
        scene.live_mask.sum()) + n_sel
    # original selection must NOT include the copies
    assert int(es.selections["obj"].sum()) == n_sel


def test_hue_shift_changes_diffuse():
    scene = make_scene()
    es = EditableGaussianScene(scene)
    boxes = {"obj": {"min": [-3, -3, -3], "max": [3, 3, 3]}}
    es.make_editable({"obj": Edit(diffuse_hue_shift=1.0)}, boxes)
    edited = es.edited_scene()
    live = scene.live_mask
    base = torch.clamp(scene.diffuse[live], min=0).numpy()
    got = edited.diffuse[live].numpy()
    assert np.abs(got - base).max() > 0.01  # hue rotated
    # value (max channel) preserved under pure hue shift
    np.testing.assert_allclose(got.max(-1), base.max(-1), atol=1e-4)


# -- colour maths against utils/color.py ------------------------------------


def colour_cases():
    rng = np.random.default_rng(11)
    rgb = rng.uniform(0, 2, (500, 3)).astype(np.float32)
    rgb[:50] = rgb[:50, :1]                       # greys: deltac == 0
    rgb[50:60] = 0.0                              # black
    rgb[60:80, 0] = rgb[60:80, 1]                 # ties for the max channel
    return rgb


def test_rgb_to_hsv_matches_jax():
    rgb = colour_cases()
    ours = tcolor.rgb_to_hsv(torch.from_numpy(rgb)).numpy()
    ref = jcolor.rgb_to_hsv(rgb)
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shift", [0.0, 2.5, 7.0, -1.3, -9.0])
def test_hsv_to_rgb_matches_jax(shift):
    """Hues shifted past 2pi and below 0 wrap by floor-mod on both sides."""
    hsv = jcolor.rgb_to_hsv(colour_cases())
    hsv[:, 0] = hsv[:, 0] + np.float32(shift)
    ours = tcolor.hsv_to_rgb(torch.from_numpy(hsv)).numpy()
    ref = jcolor.hsv_to_rgb(hsv)
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("angles", [
    [0.0, 0.0, 0.0], [1e-13, 0.0, -1e-13], [0.3, -0.2, 0.9],
    [np.pi, 0.0, 0.0], [-2.0, 5.0, 0.5]])
def test_rodrigues_matches_jax(angles):
    a = np.asarray(angles, np.float64)
    ours = tcolor.axis_angle_to_rotation_matrix(torch.from_numpy(a))
    assert ours.dtype == torch.float64
    np.testing.assert_allclose(ours.numpy(),
                               jcolor.axis_angle_to_rotation_matrix(a),
                               rtol=0, atol=1e-12)


# -- selections --------------------------------------------------------------

BOXES = {
    "box": {"min": [-1.5, -1.0, -2.0], "max": [0.5, 1.5, 1.0],
            "exclude": ["pillar"]},
    "pillar": {"min": [-0.5, -0.5, -2.0], "max": [0.5, 0.5, 2.0],
               "cyl": True},
    "shiny": {"min": [-2.0, -2.0, -2.0], "max": [2.0, 2.0, 2.0],
              "f0": [0.45, 1.0], "zrange": 0.6},
    "rough": {"min": [0.0, -2.0, -2.0], "max": [2.0, 2.0, 2.0],
              "roughness": [0.0, 0.5], "diffuse": [0.2, 0.9]},
    "metal": {"min": [-2.0, -2.0, 0.0], "max": [2.0, 2.0, 2.0],
              "metalness": [0.3, 0.8]},
}


def test_selections_bit_equal(tmp_path):
    jscene, tscene = both_scenes(rich_arrays(), pad_multiple=128)
    assert jscene.capacity > 300  # padded rows are dead on both sides
    sel_dir = tmp_path / "selections"
    sel_dir.mkdir()
    cached = np.random.default_rng(2).uniform(size=250) > 0.5
    np.save(sel_dir / "metal.npy", cached)
    (tmp_path / "bounding_boxes.json").write_text(json.dumps(BOXES))
    ref = jed.EditableGaussianScene.from_model_dir(jscene, str(tmp_path))
    ours = EditableGaussianScene.from_model_dir(tscene, str(tmp_path))
    assert list(ours.selections) == list(ref.selections)
    for key, sel in ref.selections.items():
        got = ours.selections[key]
        assert got.dtype == torch.bool and got.shape == sel.shape, key
        np.testing.assert_array_equal(got.numpy(), sel, err_msg=key)
    # every kind of filter selects something and leaves something out
    for key in BOXES:
        assert 0 < int(ours.selections[key].sum()) < 300, key
    assert int(ours.selections["metal"][:250].sum()) == int(cached.sum())


# -- edited_scene, field by field --------------------------------------------

EDIT_VALUES = dict(
    roughness_shift=0.2, roughness_mult=1.5,
    diffuse_override=(0.9, 0.1, 0.2, 0.6), diffuse_hue_shift=0.7,
    diffuse_saturation_shift=-0.2, diffuse_saturation_mult=1.3,
    diffuse_value_shift=0.1, diffuse_value_mult=0.8,
    use_roughness_override=True, roughness_override=0.6,
    specular_override=(0.2, 0.8, 0.4, 0.5), specular_hue_shift=-1.3,
    specular_saturation_shift=0.15, specular_saturation_mult=0.7,
    specular_value_shift=-0.05, specular_value_mult=1.4,
    translate_x=0.3, translate_y=-0.2, translate_z=0.5, scale=1.3,
    rotate_x=30.0, rotate_y=-45.0, rotate_z=100.0,
)
assert set(EDIT_VALUES) == {f.name for f in dataclasses.fields(Edit)}
TWO_BOXES = {"a": {"min": [-2.0, -2.0, -2.0], "max": [0.3, 2.0, 2.0]},
             "b": {"min": [-0.5, -1.5, -2.0], "max": [1.5, 1.5, 2.0],
                   "cyl": True}}


def edit_pair(fields):
    """Edits of both objects: `fields` set on "a", and on "b" the same
    fields with the signs of the shifts and angles flipped."""
    def edit(sign):
        kw = {}
        for f in fields:
            v = EDIT_VALUES[f]
            if f.endswith(("_shift", "rotate_x", "rotate_y", "rotate_z",
                           "translate_x", "translate_y", "translate_z")):
                v = sign * v
            kw[f] = v
        return kw
    return {"a": edit(1.0), "b": edit(-1.0)}


@pytest.mark.parametrize("fields", [[f] for f in EDIT_VALUES]
                         + [list(EDIT_VALUES)],
                         ids=list(EDIT_VALUES) + ["all"])
def test_edited_scene_matches_jax(fields):
    jscene, tscene = both_scenes(rich_arrays())
    kw = edit_pair(fields)
    ref = jed.EditableGaussianScene(jscene)
    ref.make_editable({k: jed.Edit(**v) for k, v in kw.items()}, TWO_BOXES)
    ours = EditableGaussianScene(tscene)
    ours.make_editable({k: Edit(**v) for k, v in kw.items()}, TWO_BOXES)
    assert_scenes_close(ours.edited_scene(), ref.edited_scene())


def test_duplicate_and_remove_match_jax():
    jscene, tscene = both_scenes(rich_arrays())
    kw = edit_pair(["translate_x", "translate_z", "diffuse_hue_shift"])
    ref = jed.EditableGaussianScene(jscene)
    ref.make_editable({k: jed.Edit(**v) for k, v in kw.items()},
                      json.loads(json.dumps(TWO_BOXES)))
    ours = EditableGaussianScene(tscene)
    ours.make_editable({k: Edit(**v) for k, v in kw.items()},
                       json.loads(json.dumps(TWO_BOXES)))
    ref.duplicate_object("a")
    ours.duplicate_object("a")
    assert ours.base.capacity == ref.base.capacity  # unpadded, as in JAX
    assert_scenes_close(ours.base, ref.base, tol=0.0)
    assert list(ours.selections) == list(ref.selections)
    for key, sel in ref.selections.items():
        np.testing.assert_array_equal(ours.selections[key].numpy(), sel,
                                      err_msg=key)
    assert ours.created_objects == ref.created_objects == ["a", "b",
                                                           "a_copy"]
    assert ours.bounding_boxes["a_copy"] == ref.bounding_boxes["a_copy"]
    assert ours.edits["a_copy"] == Edit()
    ours.edits["a_copy"].rotate_y = 25.0
    ref.edits["a_copy"].rotate_y = 25.0
    for es in (ours, ref):
        es.dirty_check(1.0)
    assert_scenes_close(ours.edited_scene(), ref.edited_scene())

    ref.remove_object("b")
    ours.remove_object("b")
    assert_scenes_close(ours.base, ref.base, tol=0.0)
    assert np.all(ours.base.opacity[ours.selections["b"]].numpy() == -1e8)
    for es in (ours, ref):
        es.dirty_check(1.0)
    assert_scenes_close(ours.edited_scene(), ref.edited_scene())


def test_dirty_tracking_matches_jax():
    jscene, tscene = both_scenes(rich_arrays())
    ref = jed.EditableGaussianScene(jscene)
    ref.make_editable({"a": jed.Edit(), "b": jed.Edit()}, TWO_BOXES)
    ours = EditableGaussianScene(tscene)
    ours.make_editable({"a": Edit(), "b": Edit()}, TWO_BOXES)
    seq = []
    for step in range(6):
        if step == 2:
            for es in (ours, ref):
                es.edits["b"].scale = 0.7
        modifier = 0.5 if step in (3, 4) else 1.0
        got = ours.dirty_check(modifier)
        assert got == ref.dirty_check(modifier)
        seq.append(got)
        if got:
            assert_scenes_close(ours.edited_scene(), ref.edited_scene())
        else:
            # a clean check returns the cached scene
            assert ours.edited_scene() is ours.edited_scene()
    assert seq == [True, False, True, True, False, True]
