"""PyTorch port vs JAX package: the viewer (viewer/state.py, service.py,
local.py) and `train --viewer`.

  * tests/test_viewer.py's cases on the port, on its fixture (24 Gaussians,
    32x32, Config(trace_chunk=32, max_hits=8, ray_tile=1024)) built on the
    CPU.
  * A scripted session (SESSION) through RenderService.tick on both
    packages' ViewerState on that fixture: every render mode at 0 and 2
    bounces, accumulation, the preview at preview_scale 2, the
    rasterizer's modes with floaters, inspect, picks on both routes (the
    raster gid, the selection masks), goto_camera, edits and a duplicate.
    The port takes JAX's samples (PRNGKey(accumulation count) per tick,
    PRNGKey(0) per selection mask, rebuilt here from the key).  Both sides
    trace brute through the non-fused path (the capacity is no multiple of
    cull_cluster; JAX on the CPU renders through XLA).  The float display
    image before quantisation: within 1e-5 where the frame is bounce 0 (the
    G-buffer modes, RGB at 0 bounces) or a raster frame, at all but 0.5% of
    the elements, all within test_torch_render_frame.py's bounce-0 bound
    (rtol 1e-4, atol 5e-5; measured: 0.2% of the elements beyond 1e-5, by
    at most 1.9e-5, where the XLA tables' exp/pow move alpha by an ulp);
    by PSNR >= 60 dB (test_torch_scan_frame.py's bound) for RGB with
    bounces.  Metadata
    equal apart from `perf` (object_centers within 1e-6: the float32 means
    are summed in another order); the selection masks equal.
  * from_ply on a model directory written by the port's save_scene_ply,
    with cfg.json, bounding_boxes.json and transforms_train.json, read by
    both packages: the same state.
  * The entry points need a card unless given the CPU; `serve` without
    `websockets` raises an ImportError naming it.
  * `train --viewer` on a tiny dataset: the thread's `serve` replaced by
    one that ticks the service; the viewer shows the state after each
    iteration, and test_iterations is emptied.
The JAX session runs in a child process whose XLA is capped at AVX (see
test_torch_render_frame.py).
"""

import asyncio
import copy
import importlib
import json
import os
import subprocess
import sys
import threading
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from editable_gaussian_reflections_tpu_torch import train as ttrain
from editable_gaussian_reflections_tpu_torch.config import Config, save_config
from editable_gaussian_reflections_tpu_torch.renderer.raytracer import (
    TileSamples,
)
from editable_gaussian_reflections_tpu_torch.scene.editable import (
    Edit,
    EditableGaussianScene,
)
from editable_gaussian_reflections_tpu_torch.scene.gaussian_scene import (
    from_arrays,
)
from editable_gaussian_reflections_tpu_torch.scene.scene import (
    save_scene_ply,
)
from editable_gaussian_reflections_tpu_torch.viewer import local as tlocal
from editable_gaussian_reflections_tpu_torch.viewer import service as tservice
from editable_gaussian_reflections_tpu_torch.viewer.service import (
    RenderService,
)
from editable_gaussian_reflections_tpu_torch.viewer.state import (
    RENDER_MODES,
    ViewerState,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
MIN_PSNR_DB = 60.0
BOXES = {"blob": {"min": [-2, -2, 2], "max": [2, 2, 6]}}
CFG = dict(trace_chunk=32, max_hits=8, ray_tile=1024)
DATASET_CAMERAS = [dict(name="train_000", R=np.eye(3).tolist(),
                        camera_center=[0.0, 0.0, -2.0])]


def fixture_arrays():
    """tests/test_viewer.py's scene."""
    rng = np.random.default_rng(0)
    n = 24
    return dict(
        xyz=np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                      np.full(n, 4.0)], -1).astype(np.float32),
        scaling=np.full((n, 3), np.log(0.4), np.float32),
        rotation=np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)),
        opacity=np.full(n, 2.0, np.float32),
        diffuse=rng.uniform(0.2, 1.0, (n, 3)).astype(np.float32),
        normal=np.tile(np.array([0, 0, -1], np.float32), (n, 1)),
        f0=np.full((n, 3), 0.04, np.float32),
        roughness=np.full(n, 0.5, np.float32),
    )


def make_state():
    base = from_arrays(**fixture_arrays(), pad_multiple=32, device="cpu")
    scene = EditableGaussianScene(base)
    scene.make_editable({"blob": Edit()}, copy.deepcopy(BOXES))
    return ViewerState(scene, Config(**CFG), width=32, height=32, fovy=0.9)


@pytest.fixture(scope="module")
def state():
    return make_state()


# -- tests/test_viewer.py's cases on the port --------------------------------


def test_render_modes_produce_images(state):
    svc = RenderService(state)
    for mode in range(len(RENDER_MODES)):
        meta, frame = svc.tick({"viewer": {"render_mode": mode,
                                           "num_bounces": 0}})
        h, w, c = meta["frame_shape"]
        img = np.frombuffer(frame, np.uint8).reshape(h, w, c)
        assert img.shape == (32, 32, 3)
        if RENDER_MODES[mode] in ("RGB", "Ellipsoids"):
            assert img.max() > 0, f"mode {RENDER_MODES[mode]} rendered black"


def test_tick_reports_perf_history(state):
    svc = RenderService(state)
    for _ in range(3):
        meta, _ = svc.tick({"viewer": {"num_bounces": 0}})
    perf = meta["perf"]
    assert perf["render_ms"] > 0 and perf["fps"] > 0
    assert len(perf["history_ms"]) == 3
    assert perf["history_ms"][-1] == perf["render_ms"]


def test_inspect_pixel_reports_gbuffer(state):
    svc = RenderService(state)
    meta, _ = svc.tick({"viewer": {"num_bounces": 0}, "inspect": [16, 16]})
    ins = meta["inspect"]
    assert {"rgb", "normal", "depth", "f0", "roughness"} <= set(ins)
    assert len(ins["rgb"]) == 3 and len(ins["depth"]) == 1
    assert svc.tick({"viewer": {}, "inspect": [9999, 0]})[0]["inspect"] is None


def test_goto_dataset_camera(state):
    state.dataset_cameras = copy.deepcopy(DATASET_CAMERAS)
    svc = RenderService(state)
    meta, _ = svc.tick({"viewer": {"num_bounces": 0}, "goto_camera": 0})
    assert meta["dataset_camera_names"] == ["train_000"]
    assert meta["camera_jump"]["name"] == "train_000"
    assert meta["camera_jump"]["camera_center"] == [0.0, 0.0, -2.0]
    meta2, _ = svc.tick({"viewer": {}, "goto_camera": 5})
    assert "camera_jump" not in meta2


def test_edit_applies_through_service(state):
    svc = RenderService(state)
    req = {"viewer": {"render_mode": 4, "num_bounces": 0}}  # roughness mode
    _, frame0 = svc.tick(req)
    img0 = np.frombuffer(frame0, np.uint8).astype(np.float32)
    req["viewer"]["edits"] = {
        "blob": {"use_roughness_override": True, "roughness_override": 1.0}
    }
    meta, frame1 = svc.tick(req)
    img1 = np.frombuffer(frame1, np.uint8).astype(np.float32)
    assert img1.mean() > img0.mean() + 5  # roughness 0.5 -> 1.0
    assert meta["edits"]["blob"]["roughness_override"] == 1.0


def test_raster_mode_gid_pick(state):
    svc = RenderService(state)
    mode = RENDER_MODES.index("Ellipsoids")
    meta, frame = svc.tick({"viewer": {"render_mode": mode}})
    img = np.frombuffer(frame, np.uint8).reshape(
        *meta["frame_shape"]).max(-1)
    ys, xs = np.nonzero(img)
    assert len(ys), "ellipsoid view rendered black"
    y, x = int(ys[len(ys) // 2]), int(xs[len(ys) // 2])
    meta, _ = svc.tick({"viewer": {"render_mode": mode}, "pick": [x, y]})
    assert meta["picked_object"] == "blob"
    bg = np.argwhere(img == 0)
    if len(bg):
        meta, _ = svc.tick({"viewer": {"render_mode": mode},
                            "pick": [int(bg[0][1]), int(bg[0][0])]})
        assert meta["picked_object"] is None


def test_accumulation_resets_on_edit(state):
    svc = RenderService(state)
    req = {"viewer": {"render_mode": 0, "num_bounces": 0,
                      "accumulate_samples": True}}
    svc.tick(req)
    svc.tick(req)
    assert state._accum_count == 2
    req["viewer"]["edits"] = {"blob": {"translate_x": 0.3}}
    svc.tick(req)
    assert state._accum_count == 1  # dirty -> reset


class FakeSocket:
    """A client that sends `requests` and then hangs up."""

    def __init__(self, requests, sent):
        self.requests = list(requests)
        self.sent = sent

    async def recv(self):
        if not self.requests:
            raise ConnectionError("client done")
        return json.dumps(self.requests.pop(0))

    async def send(self, payload):
        self.sent.append(payload)

    async def close(self):
        pass


def test_pipelined_handler_overlaps_and_replies_in_order(state):
    svc = RenderService(state)
    sent = []
    reqs = [{"viewer": {"render_mode": 0}} for _ in range(4)]
    asyncio.run(svc._handle(FakeSocket(reqs, sent)))
    # 3 messages per tick (metadata json, binary map json, frame bytes)
    assert len(sent) == 12
    frames = [p for p in sent if isinstance(p, (bytes, bytearray))]
    assert len(frames) == 4
    for f in frames:
        assert len(f) == state.height * state.width * 3
    assert [json.loads(p) for p in sent[1::3]] == [["viewer"]] * 4


def test_object_centers_follow_translation(state):
    svc = RenderService(state)
    meta, _ = svc.tick({"viewer": {"render_mode": 0, "num_bounces": 0,
                                   "edits": {"blob": {"translate_x": 0.0}}}})
    c0 = np.array(meta["object_centers"]["blob"])
    meta, _ = svc.tick({"viewer": {"render_mode": 0, "num_bounces": 0,
                                   "edits": {"blob": {"translate_x": 0.5}}}})
    c1 = np.array(meta["object_centers"]["blob"])
    np.testing.assert_allclose(c1 - c0, [0.5, 0.0, 0.0], atol=1e-6)


def test_local_orbit_camera_convention(state):
    """LOCAL mode's OrbitCamera emits the web client's pose convention: an
    orbit aimed at the blob cluster renders it."""
    cam = tlocal.OrbitCamera(target=np.array([0.0, 0.0, 4.0]), dist=4.0,
                             yaw=0.0, pitch=0.0, fovy=0.9)
    d = cam.camera_dict()
    R = np.asarray(d["R"])
    np.testing.assert_allclose(R.T @ R, np.eye(3), atol=1e-12)
    np.testing.assert_allclose(d["camera_center"], [0, 0, 0], atol=1e-12)
    np.testing.assert_allclose(R[:, 2], [0, 0, 1], atol=1e-12)

    svc = RenderService(state)
    meta, frame = svc.tick({"viewer": {"render_mode": 0, "num_bounces": 0},
                            "camera": d})
    assert np.frombuffer(frame, np.uint8).max() > 0
    cam2 = tlocal.OrbitCamera(target=np.array([0.0, 0.0, -4.0]), dist=4.0,
                              yaw=np.pi, pitch=0.0, fovy=0.9)
    _, frame2 = svc.tick({"viewer": {"render_mode": 0, "num_bounces": 0},
                          "camera": cam2.camera_dict()})
    assert np.frombuffer(frame2, np.uint8).max() == 0


def test_preview_scale_keeps_protocol_shape(state):
    svc = RenderService(state)
    meta, frame = svc.tick({"viewer": {"render_mode": 0, "num_bounces": 0,
                                       "preview_scale": 2,
                                       "accumulate_samples": False}})
    assert meta["frame_shape"] == [32, 32, 3]
    assert meta["preview_scale"] == 2
    img = np.frombuffer(frame, np.uint8).reshape(32, 32, 3)
    assert np.array_equal(img[0::2, 0::2], img[1::2, 1::2])
    assert img.max() > 0
    meta4, frame4 = svc.tick({"viewer": {"preview_scale": 4}})
    assert np.frombuffer(frame4, np.uint8).max() > 0
    svc.tick({"viewer": {"preview_scale": 1, "accumulate_samples": True}})


# -- the scripted session on both packages -----------------------------------

ELL, PTS = RENDER_MODES.index("Ellipsoids"), RENDER_MODES.index("Points")
SESSION = (
    [(f"mode{m}_b0", {"viewer": {"render_mode": m, "num_bounces": 0}})
     for m in range(len(RENDER_MODES))]
    + [(f"mode{m}_b2", {"viewer": {"render_mode": m, "num_bounces": 2}})
       for m in range(5)]
    + [("accum2", {"viewer": {"render_mode": 0, "num_bounces": 2}}),
       ("accum3", {"viewer": {"render_mode": 0, "num_bounces": 2}}),
       ("preview_b2", {"viewer": {"render_mode": 0, "preview_scale": 2}}),
       ("preview_b0", {"viewer": {"render_mode": 0, "num_bounces": 0}}),
       ("preview_normals", {"viewer": {"render_mode": 1}}),
       ("floaters", {"viewer": {"render_mode": ELL, "preview_scale": 1,
                                "render_floaters": True}}),
       ("points", {"viewer": {"render_mode": PTS, "scaling_modifier": 40.0},
                   "inspect": [16, 16]}),
       ("ellipsoid_pick", {"viewer": {"render_mode": ELL,
                                      "scaling_modifier": 1.0,
                                      "render_floaters": False},
                           "pick": [16, 16], "inspect": [16, 16]}),
       ("selections", {"viewer": {"render_mode": 0, "num_bounces": 0},
                       "compute_selections": True, "pick": [16, 16],
                       "inspect": [3, 5]}),
       ("background_pick", {"viewer": {}, "pick": [0, 0]}),
       ("goto", {"viewer": {}, "goto_camera": 0}),
       ("edited", {"viewer": {"edits": {"blob": {
           "translate_x": 0.3, "diffuse_hue_shift": 0.4, "rotate_z": 30.0,
           "scale": 0.8}}}}),
       ("edited_normals", {"viewer": {"render_mode": 1}}),
       # the JAX XLA trace needs the capacity a multiple of trace_chunk,
       # which the unpadded copies break (56 of 32): the copies are held
       # in the rasterizer's frame
       ("duplicate", {"viewer": {"render_mode": ELL}, "duplicate": "blob",
                      "pick": [20, 16]})]
)
# frames held by PSNR (bounces through the brute trace's samples)
PSNR_TICKS = {"mode0_b2", "accum2", "accum3", "preview_b2"}
# Points at the widget's radius (0.4% of the extent) cover no pixel centre
# at 32x32; the "points" tick scales them up
BLACK_TICKS = {"mode6_b0"}
# bounce-0 frames: at most this share of elements beyond TOL, every element
# within the kernel tolerance of test_torch_render_frame.py (the exp, log
# and pow tables round differently: ROADMAP Queue 3)
OFF_TOL_SHARE = 0.005


def run_session(pkg: str, samples=None):
    """SESSION through package `pkg`'s RenderService on the fixture; returns
    (metadata without perf per tick, the float display image per tick,
    the selection masks after the compute_selections tick)."""
    mod = importlib.import_module
    cfg_mod = mod(pkg + ".config")
    ed = mod(pkg + ".scene.editable")
    gs = mod(pkg + ".scene.gaussian_scene")
    st_mod = mod(pkg + ".viewer.state")
    svc_mod = mod(pkg + ".viewer.service")
    kw = {} if pkg == "editable_gaussian_reflections_tpu" else {
        "device": "cpu"}
    base = gs.from_arrays(**fixture_arrays(), pad_multiple=32, **kw)
    scene = ed.EditableGaussianScene(base)
    scene.make_editable({"blob": ed.Edit()}, copy.deepcopy(BOXES))
    st = st_mod.ViewerState(scene, cfg_mod.Config(**CFG), width=32,
                            height=32, fovy=0.9)
    st.dataset_cameras = copy.deepcopy(DATASET_CAMERAS)
    if samples is not None:
        st.samples = samples
    images, metas, masks = [], [], {}
    real_step = st.step

    def step(camera):
        img = real_step(camera)
        images.append(np.array(img.numpy() if torch.is_tensor(img)
                               else img, np.float32))
        return img

    st.step = step
    svc = svc_mod.RenderService(st)
    for _, request in SESSION:
        meta, rgb8 = svc.tick(copy.deepcopy(request))
        assert len(rgb8) == 32 * 32 * 3
        meta.pop("perf")
        metas.append(meta)
        if request.get("compute_selections"):
            masks = {k: np.asarray(v.numpy() if torch.is_tensor(v) else v)
                     for k, v in st.selection_masks.items()}
    return metas, images, masks


def jax_session(path):
    """The JAX package's session, saved to `path` (npz + json).  Run by
    the jax_run fixture in a child process."""
    metas, images, masks = run_session("editable_gaussian_reflections_tpu")
    np.savez(path, images=np.stack(images),
             **{f"mask/{k}": v for k, v in masks.items()})
    Path(str(path) + ".json").write_text(json.dumps(metas))


def jax_samples_hook(seed, width, height, num_steps, fused, tile, jitter):
    """The samples JAX's viewer draws from PRNGKey(seed)."""
    import jax

    from tests.test_torch_render_frame import jax_samples
    from tests.test_torch_render_tile import jax_tile_samples

    key = jax.random.PRNGKey(seed)
    if fused:
        return jax_samples(key, width, height, num_steps)
    jit, us = jax_tile_samples(key, width, height, tile, num_steps)
    return TileSamples(jitter=torch.tensor(jit), us=torch.tensor(us))


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """(the JAX session, the port's): the JAX one in a child process,
    started first, while this process runs the port's."""
    path = tmp_path_factory.mktemp("jax_viewer") / "session.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_cpu_max_isa=AVX").strip(),
               PYTHONPATH=os.pathsep.join(
                   p for p in (str(ROOT), os.environ.get("PYTHONPATH"))
                   if p))
    child = subprocess.Popen([sys.executable, __file__, str(path)], env=env)
    try:
        port = run_session("editable_gaussian_reflections_tpu_torch",
                           samples=jax_samples_hook)
    finally:
        assert child.wait(timeout=600) == 0
    with np.load(path) as data:
        arrays = dict(data)
    metas = json.loads(Path(str(path) + ".json").read_text())
    jax = (metas, list(arrays["images"]), {
        k.split("/", 1)[1]: v for k, v in arrays.items()
        if k.startswith("mask/")})
    return jax, port


@pytest.fixture(scope="module")
def jax_run(sessions):
    return sessions[0]


@pytest.fixture(scope="module")
def port_run(sessions):
    return sessions[1]


def psnr(a, b):
    mse = float(np.mean((a.astype(np.float64) - b) ** 2))
    return float("inf") if mse == 0 else -10.0 * np.log10(mse)


@pytest.mark.parametrize("tick", [name for name, _ in SESSION])
def test_session_frames_match_jax(tick, jax_run, port_run):
    i = [name for name, _ in SESSION].index(tick)
    ours, ref = port_run[1][i], jax_run[1][i]
    assert ours.shape == ref.shape == (32, 32, 3)
    assert (ref.max() > 0) != (tick in BLACK_TICKS), "black reference"
    if tick in PSNR_TICKS:
        assert psnr(ours, ref) >= MIN_PSNR_DB, psnr(ours, ref)
    else:
        off = np.abs(ours - ref) > TOL * (1.0 + np.abs(ref))
        assert off.mean() <= OFF_TOL_SHARE, off.mean()
        np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=5e-5)


def close_metadata(ours, ref, where=""):
    """Equal, with floats within 1e-6 (object_centers' float32 means and
    inspect's 4-decimal rounding of them)."""
    if isinstance(ref, dict):
        assert isinstance(ours, dict) and set(ours) == set(ref), where
        for k in ref:
            close_metadata(ours[k], ref[k], f"{where}/{k}")
    elif isinstance(ref, (list, tuple)):
        assert isinstance(ours, (list, tuple)) and len(ours) == len(ref), \
            where
        for k, (a, b) in enumerate(zip(ours, ref)):
            close_metadata(a, b, f"{where}[{k}]")
    elif isinstance(ref, float) and not isinstance(ref, bool):
        assert ours == pytest.approx(ref, rel=1e-6, abs=1e-4 if "inspect"
                                     in where else 1e-6), where
    else:
        assert ours == ref, where


def test_session_metadata_matches_jax(jax_run, port_run):
    for (name, _), ours, ref in zip(SESSION, port_run[0], jax_run[0]):
        close_metadata(ours, ref, name)
    by_name = dict(zip([n for n, _ in SESSION], port_run[0]))
    assert by_name["ellipsoid_pick"]["picked_object"] == "blob"
    assert by_name["selections"]["picked_object"] == "blob"
    assert by_name["background_pick"]["picked_object"] is None
    assert by_name["goto"]["camera_jump"]["name"] == "train_000"
    assert by_name["duplicate"]["objects"] == ["blob", "blob_copy"]
    assert "gid" in by_name["ellipsoid_pick"]["inspect"]


def test_session_selection_masks_match_jax(jax_run, port_run):
    ours, ref = port_run[2], jax_run[2]
    assert set(ours) == set(ref) == {"blob"}
    for k in ref:
        assert ours[k].dtype == bool and ref[k].any() and not ref[k].all()
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


# -- from_ply, the entry points' device, serve without websockets ------------


def write_model(root: Path) -> Path:
    """A model directory as train.py writes it, with the port's writers."""
    model = root / "model"
    scene = from_arrays(**fixture_arrays(), pad_multiple=1, device="cpu")
    ply = model / "point_cloud" / "iteration_3" / "point_cloud.ply"
    ply.parent.mkdir(parents=True)
    save_scene_ply(str(ply), scene)
    (model / "point_cloud" / "iteration_1").mkdir()
    save_config(Config(resolution=32, **CFG), str(model / "cfg.json"))
    (model / "bounding_boxes.json").write_text(json.dumps(
        {"blob": {"min": [-2, -2, 2], "max": [0, 2, 6]},
         "disc": {"min": [-1, -1, 3], "max": [1, 1, 5], "cyl": True,
                  "exclude": ["blob"]}}))
    frames = []
    for i, eye in enumerate(([0.0, 0.0, -2.0], [1.0, 0.5, -3.0])):
        c2w = np.eye(4)
        c2w[:3, 3] = eye
        c2w[:3, 2] = [0.0, 0.0, -1.0]
        c2w[:3, 1] = [0.0, -1.0, 0.0]
        frames.append(dict(file_path=f"./train/r_{i}",
                           transform_matrix=c2w.tolist()))
    (model / "transforms_train.json").write_text(json.dumps(
        dict(camera_angle_x=0.8, frames=frames)))
    return model


def test_from_ply_matches_jax(tmp_path):
    from editable_gaussian_reflections_tpu.viewer.state import (
        ViewerState as JViewerState,
    )

    model = write_model(tmp_path)
    ref = JViewerState.from_ply(str(model))
    ours = ViewerState.from_ply(str(model), device="cpu")
    for k in ("width", "height", "fovy", "dataset_cameras"):
        assert getattr(ours, k) == getattr(ref, k), k
    assert ours.settings._asdict() == pytest.approx(ref.settings._asdict())
    assert ours.cfg == Config(**{**ref.cfg.__dict__})
    for f in ref.gaussians.base._fields:
        np.testing.assert_array_equal(
            getattr(ours.gaussians.base, f).numpy(),
            np.asarray(getattr(ref.gaussians.base, f)), err_msg=f)
    assert set(ours.gaussians.selections) == set(ref.gaussians.selections)
    for k, v in ref.gaussians.selections.items():
        np.testing.assert_array_equal(ours.gaussians.selections[k].numpy(),
                                      v, err_msg=k)
    meta, frame = RenderService(ours).tick({"viewer": {"num_bounces": 0},
                                            "goto_camera": 1})
    assert meta["camera_jump"] == ref.dataset_cameras[1]
    assert meta["objects"] == ["blob", "disc"]
    assert np.frombuffer(frame, np.uint8).max() > 0


def test_entry_points_need_a_card_or_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    model = str(write_model(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ViewerState.from_ply(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tservice.main(["-m", model])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlocal.main(["-m", model])


def test_serve_without_websockets_names_the_package(state):
    svc = RenderService(state)
    with mock.patch.dict(sys.modules, websockets=None):
        with pytest.raises(ImportError, match="'websockets'"):
            svc.serve(port=0)
        with pytest.raises(ImportError, match="'websockets'"):
            tservice.main(["-m", "unused", "--device", "cpu"])


# -- train --viewer ------------------------------------------------------------

SIZE = 24
TRAIN_ARGV = ["-r", str(SIZE), "--iterations", "5",
              "--no_bounces_until_iter", "2", "--test_iterations", "5",
              "--save_iterations", "5", "--trace_chunk", "64",
              "--max_hits", "8", "--ray_tile", str(SIZE * SIZE),
              "--init_num_pts_farfield", "64", "--pruning_interval", "4",
              "--pruning_start_iter", "3", "--val_view", "0", "--viewer",
              "--device", "cpu"]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    sys.path.insert(0, os.path.dirname(__file__))
    from make_synth_dataset import make_dataset

    d = tmp_path_factory.mktemp("synth_viewer")
    return make_dataset(str(d / "data"), size=SIZE, n_train=3, n_test=1,
                        n_points=64)


def test_train_viewer_shows_each_iteration(dataset, tmp_path):
    services, started = [], threading.Event()
    seen, frames, reports = [], [], []
    real_step = ttrain.train_step

    def serve(self, *args, **kwargs):  # runs in the viewer's thread
        services.append(self)
        frames.append(self.tick({"viewer": {"num_bounces": 0}}))
        started.set()

    def step(state, *args, **kw):
        assert started.wait(60)
        viewer = services[0].state
        # the viewer shows the state this iteration starts from
        seen.append(viewer.gaussians.base is state.scene)
        frames.append(services[0].tick({"viewer": {"num_bounces": 0}}))
        return real_step(state, *args, **kw)

    with mock.patch.object(RenderService, "serve", serve), \
            mock.patch.object(ttrain, "train_step", step), \
            mock.patch.object(ttrain, "training_report",
                              lambda *a, **k: reports.append(a)), \
            mock.patch.dict(os.environ, NO_WORKERS="1"):
        final = ttrain.cli(["-s", dataset, "-m", str(tmp_path / "m")]
                           + TRAIN_ARGV)
    assert seen == [True] * 5
    assert services[0].state.gaussians.base is final.scene
    assert not reports  # --viewer empties test_iterations
    assert (services[0].state.width, services[0].state.height) == (SIZE,
                                                                  SIZE)
    for meta, rgb8 in frames:
        assert meta["frame_shape"] == [SIZE, SIZE, 3]
        assert len(rgb8) == SIZE * SIZE * 3
    assert max(np.frombuffer(f, np.uint8).max() for _, f in frames) > 0


def test_train_viewer_without_websockets_raises_before_a_step(dataset,
                                                              tmp_path):
    steps = []
    with mock.patch.dict(sys.modules, websockets=None), \
            mock.patch.object(ttrain, "train_step",
                              lambda *a, **k: steps.append(a)), \
            mock.patch.dict(os.environ, NO_WORKERS="1"):
        with pytest.raises(ImportError, match="'websockets'"):
            ttrain.cli(["-s", dataset, "-m", str(tmp_path / "m")]
                       + TRAIN_ARGV)
    assert not steps


if __name__ == "__main__":
    jax_session(sys.argv[1])
