"""PyTorch port vs the root tools/make_room_dataset.py.

Both tools write the dataset at --size 16 --n_gaussians 2048 --n_train 2
--n_test 1 --spp 2: JAX on its CPU route (non-fused, its XLA tracer), the
port with --device cpu (non-fused, the plain tracer ops/trace.py), fed the
samples JAX draws (view k: PRNGKey(1000 + k) folded per sample, each
frame's jitter and per-tile uniforms rebuilt from the key).

  * transforms_{train,test}.json: equal; gt_scene.ply and
    point_cloud_dense.ply: equal byte for byte.
  * Every TIFF buffer: test_torch_backend.py's frame rule, at most 0.5% of
    its elements outside 2e-4*|ref| + 2e-5*scale (scale = max(1,
    max|ref|)); read back with the port's read_tiff.
  * The forced fused route (render_view(fused=True), K 32, cluster 128, 192
    candidates) of view 0 at 1 spp on the CPU against JAX's
    render_accumulated_fused of the same view in interpret mode, with
    test_torch_render_frame.py's tolerances: the primary buffers (diffuse,
    depth, normal, roughness, f0) within rtol 1e-4 / atol 5e-5, specular
    and render at most 0.5% of elements outside the bound above.
  * Without a card and without --device cpu the tool exits non-zero.
The JAX side runs in a child process capped at AVX (see
test_torch_render_frame.py).
"""

import contextlib
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from editable_gaussian_reflections_tpu_torch.renderer import raytracer as trt
from editable_gaussian_reflections_tpu_torch.tools import (
    make_room_dataset as tmrd,
)
from editable_gaussian_reflections_tpu_torch.utils.image import read_tiff

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ARGV = ["--size", "16", "--n_gaussians", "2048", "--n_train", "2",
        "--n_test", "1", "--spp", "2"]
SIZE, N_VIEWS, SPP = 16, 3, 2
FUSED_VIEW = 0
PRIMARY = ("diffuse", "depth", "normal", "roughness", "f0")
# the frame rule: at most this share of elements outside the bound
FRAME_SHARE = 0.005


def root_module(name, rel):
    spec = importlib.util.spec_from_file_location(f"root_{name}", ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child_env():
    """The environment of a JAX child: CPU, XLA capped at AVX, the repo on
    the path."""
    return dict(os.environ, JAX_PLATFORMS="cpu", NO_WORKERS="1",
                XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                           + " --xla_cpu_max_isa=AVX").strip(),
                PYTHONPATH=os.pathsep.join(
                    p for p in (str(ROOT), os.environ.get("PYTHONPATH"))
                    if p))


def run_child(script, *args, timeout=600):
    subprocess.run([sys.executable, str(script), *map(str, args)],
                   env=child_env(), check=True, timeout=timeout)


def mismatch(a, b) -> float:
    """The share of elements of `a` outside 2e-4*|b| + 2e-5*scale."""
    scale = max(1.0, float(np.abs(b).max(initial=0.0)))
    ok = np.abs(a - b) <= 2e-4 * np.abs(b) + 2e-5 * scale
    return 1.0 - float(ok.mean())


def sample_keys(seed: int, n: int, offset: int = 0) -> list:
    """The keys of a JAX render seeded PRNGKey(seed): fold_in(key, i) for
    its n samples."""
    import jax

    key = jax.random.PRNGKey(seed)
    return [jax.random.fold_in(key, offset + i) for i in range(n)]


@contextlib.contextmanager
def jax_samples_fed(keys: list):
    """Every frame the port renders (render_frame or render_frame_fused)
    takes, in order, the samples JAX draws from the next key of `keys`;
    all of them are used by the end."""
    from tests.test_torch_render_frame import jax_samples
    from tests.test_torch_render_tile import jax_tile_samples

    queue = list(keys)
    real_frame, real_fused = trt.render_frame, trt.render_frame_fused

    def frame(scene, camera, settings, generator, width, height, **kw):
        jitter, us = jax_tile_samples(queue.pop(0), width, height,
                                      kw["tile"], kw["num_bounces"] + 1)
        kw["samples"] = trt.TileSamples(jitter=torch.tensor(jitter),
                                        us=torch.tensor(us))
        return real_frame(scene, camera, settings, None, width, height, **kw)

    def fused(scene, camera, settings, generator, width, height, **kw):
        kw["samples"] = jax_samples(queue.pop(0), width, height,
                                    kw.get("num_bounces", 2) + 1)
        return real_fused(scene, camera, settings, None, width, height, **kw)

    with mock.patch.object(trt, "render_frame", frame), \
            mock.patch.object(trt, "render_frame_fused", fused):
        yield
    assert not queue, f"{len(queue)} keys left"


def jax_fused_view(path):
    """JAX's render_accumulated_fused of view FUSED_VIEW as the root tool
    calls it, at 1 spp in interpret mode; its seven buffers to `path`."""
    import jax
    import jax.numpy as jnp

    from editable_gaussian_reflections_tpu.renderer import raytracer as jrt
    from editable_gaussian_reflections_tpu.scene.gaussian_scene import (
        from_arrays,
    )
    from editable_gaussian_reflections_tpu.utils.synth import room_scene

    root = root_module("make_room_dataset", "tools/make_room_dataset.py")
    scene = from_arrays(**room_scene(2048, extent=3.0,
                                     farfield_fraction=0.25),
                        pad_multiple=2048)
    eye = tmrd.orbit_eye(FUSED_VIEW, N_VIEWS, 3.0)
    c2w = root.look_at_blender_c2w(eye, np.array([0.0, 0.0, 2.25]))
    cam = jrt.CameraParams(
        origin=jnp.asarray(eye, jnp.float32),
        c2w=jnp.asarray(c2w[:3, :3], jnp.float32), fov_y=jnp.asarray(0.9),
        znear=jnp.asarray(0.05), zfar=jnp.asarray(50.0))
    steps, final = jrt.render_accumulated_fused(
        scene, cam, jrt.RenderSettings(), jax.random.PRNGKey(1000 + FUSED_VIEW),
        SIZE, SIZE, spp=1, num_bounces=2, max_hits=32, cull_cluster=128,
        max_clusters=192, interpret=True)
    H = W = SIZE
    np.savez(path, render=np.asarray(final).reshape(H, W, 3),
             diffuse=np.asarray(steps.rgb[0]).reshape(H, W, 3),
             specular=np.asarray(steps.rgb[1:].sum(0)).reshape(H, W, 3),
             depth=np.asarray(steps.depth[0]).reshape(H, W),
             normal=np.asarray(steps.normal[0]).reshape(H, W, 3),
             roughness=np.asarray(steps.roughness[0]).reshape(H, W),
             f0=np.asarray(steps.f0[0]).reshape(H, W, 3))


def jax_runs(out: str):
    """The root tool into out/jax, and the fused view to out/fused.npz."""
    sys.argv = ["make_room_dataset"]
    root_module("make_room_dataset", "tools/make_room_dataset.py").main(
        ["--out", os.path.join(out, "jax")] + ARGV)
    jax_fused_view(os.path.join(out, "fused.npz"))


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    out = tmp_path_factory.mktemp("room_dataset")
    run_child(__file__, out)
    keys = [k for v in range(N_VIEWS) for k in sample_keys(1000 + v, SPP)]
    with jax_samples_fed(keys):
        tmrd.main(["--out", str(out / "port"), "--device", "cpu"] + ARGV)
    return out


def test_transforms_and_plys_equal(datasets):
    jax_dir, port_dir = datasets / "jax", datasets / "port"
    for split in ("train", "test"):
        name = f"transforms_{split}.json"
        assert json.loads((port_dir / name).read_text()) == json.loads(
            (jax_dir / name).read_text())
    for name in ("gt_scene.ply", "point_cloud_dense.ply"):
        assert (port_dir / name).read_bytes() == (jax_dir / name).read_bytes()


def test_buffers_within_the_frame_rule(datasets):
    jax_dir, port_dir = datasets / "jax", datasets / "port"
    names = sorted(p.name for p in jax_dir.glob("*.tiff"))
    assert names == sorted(p.name for p in port_dir.glob("*.tiff"))
    assert len(names) == N_VIEWS * len(tmrd.BUFFERS)
    for name in names:
        a, b = read_tiff(str(port_dir / name)), read_tiff(str(jax_dir / name))
        assert a.shape == b.shape and np.isfinite(a).all(), name
        assert mismatch(a, b) <= FRAME_SHARE, (name, mismatch(a, b))


def test_forced_fused_route_matches_jax(datasets):
    ref = np.load(datasets / "fused.npz")
    scene = tmrd.from_arrays(**tmrd.room_scene(2048, extent=3.0,
                                               farfield_fraction=0.25),
                             pad_multiple=2048, device="cpu")
    eye = tmrd.orbit_eye(FUSED_VIEW, N_VIEWS, 3.0)
    c2w = tmrd.look_at_blender_c2w(eye, np.array([0.0, 0.0, 2.25]))
    with jax_samples_fed(sample_keys(1000 + FUSED_VIEW, 1)):
        bufs = tmrd.render_view(scene, c2w, eye, 1000 + FUSED_VIEW, SIZE, 1,
                                True, torch.device("cpu"))
    assert sorted(bufs) == sorted(ref.files)
    for name in PRIMARY:
        np.testing.assert_allclose(bufs[name], ref[name], rtol=1e-4,
                                   atol=5e-5, err_msg=name)
    for name in ("specular", "render"):
        assert mismatch(bufs[name], ref[name]) <= FRAME_SHARE, name


def test_route_follows_the_jax_tool():
    scene = tmrd.from_arrays(**tmrd.room_scene(2048), pad_multiple=2048,
                             device="cpu")
    cpu = torch.device("cpu")
    assert not tmrd.use_fused(scene, 128, cpu)
    fake = mock.Mock(type="cuda")
    assert tmrd.use_fused(scene, 128, fake)
    assert not tmrd.use_fused(scene, 120, fake)     # not 16 | 120


def test_tool_needs_a_card_or_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default route runs")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmrd.main(["--out", str(tmp_path / "d")] + ARGV)
    done = subprocess.run(
        [sys.executable, "-m", "editable_gaussian_reflections_tpu_torch.tools."
         "make_room_dataset", "--out", str(tmp_path / "d")] + ARGV,
        env=child_env(), capture_output=True, text=True, timeout=300)
    assert done.returncode != 0 and "device='cpu'" in done.stderr
    assert not (tmp_path / "d").exists()


if __name__ == "__main__":
    jax_runs(sys.argv[1])
