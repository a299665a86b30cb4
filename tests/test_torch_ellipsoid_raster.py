"""PyTorch port vs JAX package: the ellipsoid rasterizer
(ops/ellipsoid_raster.py).

  * tests/test_ellipsoid_raster.py's cases on the port, against that
    file's float64 per-pixel oracle (no tiles, no candidate caps), with its
    tolerance (99.5% of pixels within 2e-3).
  * The JAX rasterize_ellipsoids on the same float32 inputs, solid, with
    floaters, and at a general pose, with select_chunk below N (the
    streaming top-k merges several chunks) and max_per_tile small enough
    to evict: gid equal wherever the two nearest depths (float64, over
    every eligible ellipsoid) differ by more than 1e-6, the other pixels
    counted and bounded (GID_TIES); rgb, depth and normal within 1e-5
    wherever gid agrees.  Both sides keep lax.top_k's order, so the same
    ellipsoids make each tile's cut.
The JAX frames are rasterized in a child process whose XLA is capped at
AVX (see test_torch_render_frame.py): with FMA contraction the near-tangent
quadratic (b*b - 4ac) moves depths by up to 1.6e-4 and normals by 8.7e-4
at 1-4% of the pixels; without it the two sides were bit-equal here.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from editable_gaussian_reflections_tpu_torch.ops.ellipsoid_raster import (
    rasterize_ellipsoids,
    rasterize_scene,
)
from editable_gaussian_reflections_tpu_torch.scene.gaussian_scene import (
    from_arrays,
)
from tests.test_ellipsoid_raster import (
    CAM,
    _assert_match,
    _oracle,
    _quat_to_rot,
    _random_scene,
    _ray_dirs,
)

torch.set_num_threads(1)

TOL = 1e-5
# pixels whose gid may differ without an exact depth tie (a grazing
# silhouette or a near-tie of priorities flipping on an ulp), of 3072
GID_TIES = 6


def _f32(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _run_port(scene, c2w=None, origin=None, alpha_limit=0.2,
              render_floaters=False, max_per_tile=64, select_chunk=32):
    centers, quats, radii, colors, alphas, valid = scene
    c2w = CAM["c2w"] if c2w is None else c2w
    origin = CAM["origin"] if origin is None else origin
    return rasterize_ellipsoids(
        _f32(centers), _f32(quats), _f32(radii), _f32(colors), _f32(alphas),
        torch.as_tensor(np.asarray(valid, bool)), _f32(c2w), _f32(origin),
        CAM["fovy"], CAM["width"], CAM["height"], znear=CAM["znear"],
        zfar=CAM["zfar"], alpha_limit=alpha_limit,
        render_floaters=render_floaters, max_per_tile=max_per_tile,
        select_chunk=select_chunk)


def _run_both(scene, alpha_limit=0.2, render_floaters=False,
              max_per_tile=64):
    """tests/test_ellipsoid_raster.py:_run_both on the port."""
    out = _run_port(scene, alpha_limit=alpha_limit,
                    render_floaters=render_floaters,
                    max_per_tile=max_per_tile)
    ref = _oracle(*scene, CAM["c2w"], CAM["origin"], CAM["fovy"],
                  CAM["width"], CAM["height"], CAM["znear"], CAM["zfar"],
                  alpha_limit, render_floaters)
    return out, ref


def _np(out):
    return type(out)(*(t.numpy() for t in out))


# -- tests/test_ellipsoid_raster.py's cases on the port ---------------------


def test_matches_oracle_solid():
    rng = np.random.default_rng(0)
    out, ref = _run_both(_random_scene(rng, 60))
    _assert_match(_np(out), ref)


def test_matches_oracle_floaters():
    rng = np.random.default_rng(1)
    out, ref = _run_both(_random_scene(rng, 60), render_floaters=True)
    _assert_match(_np(out), ref)


def test_anisotropic_rotated():
    rng = np.random.default_rng(2)
    centers, quats, radii, colors, alphas, valid = _random_scene(rng, 40)
    radii[:, 0] *= 4.0   # strongly anisotropic
    out, ref = _run_both((centers, quats, radii, colors, alphas, valid))
    _assert_match(_np(out), ref)


def test_analytic_single_sphere():
    """Sphere of radius 1 straight ahead: center-pixel depth and shading."""
    centers = np.array([[0.0, 0.0, -5.0]])
    quats = np.array([[1.0, 0.0, 0.0, 0.0]])
    radii = np.ones((1, 3))
    colors = np.array([[0.2, 0.1, 0.0]])
    out, _ = _run_both((centers, quats, radii, colors,
                        np.ones(1), np.ones(1, bool)))
    h, w = CAM["height"] // 2, CAM["width"] // 2
    assert abs(float(out.depth[h, w]) - 4.0) < 2e-2
    np.testing.assert_allclose(out.rgb[h, w].numpy(),
                               (colors[0] + 0.05) * 3, atol=2e-2)
    assert int(out.gid[h, w]) == 0
    assert int(out.gid[0, 0]) == -1
    assert float(out.depth[0, 0]) == 0.0


def test_occlusion_order():
    """A near sphere must occlude a far one regardless of array order."""
    centers = np.array([[0.0, 0.0, -8.0], [0.0, 0.0, -4.0]])
    quats = np.tile([1.0, 0, 0, 0], (2, 1))
    radii = np.full((2, 3), 0.5)
    colors = np.array([[0.3, 0.0, 0.0], [0.0, 0.3, 0.0]])
    out, _ = _run_both((centers, quats, radii, colors,
                        np.ones(2), np.ones(2, bool)))
    h, w = CAM["height"] // 2, CAM["width"] // 2
    assert int(out.gid[h, w]) == 1
    assert abs(float(out.depth[h, w]) - 3.5) < 2e-2


def test_camera_inside_uses_far_surface():
    centers = np.array([[0.0, 0.0, 0.0]])  # camera at the origin is inside
    quats = np.array([[1.0, 0.0, 0.0, 0.0]])
    radii = np.full((1, 3), 2.0)
    colors = np.array([[0.2, 0.2, 0.2]])
    out, _ = _run_both((centers, quats, radii, colors,
                        np.ones(1), np.ones(1, bool)))
    h, w = CAM["height"] // 2, CAM["width"] // 2
    assert int(out.gid[h, w]) == 0
    assert abs(float(out.depth[h, w]) - 2.0) < 2e-2


def general_pose_scene(n=50, seed=7):
    rng = np.random.default_rng(seed)
    q = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    origin = rng.normal(size=3) * 2.0
    look = -q[:, 2]  # camera looks along -col2
    centers = (origin[None, :] + look[None, :] * rng.uniform(3, 8, (n, 1))
               + rng.normal(size=(n, 3)) * 1.2)
    scene = (centers, rng.normal(size=(n, 4)), rng.uniform(0.1, 0.7, (n, 3)),
             rng.uniform(0, 0.4, (n, 3)), rng.uniform(0, 1, n),
             np.ones(n, bool))
    return scene, q, origin


def test_matches_oracle_general_pose():
    """Rotated, off-origin camera."""
    scene, q, origin = general_pose_scene()
    out = _run_port(scene, c2w=q, origin=origin)
    ref = _oracle(*scene, q, origin, CAM["fovy"], CAM["width"],
                  CAM["height"], CAM["znear"], CAM["zfar"], 0.2, False)
    assert (ref[2] >= 0).any(), "oracle saw nothing - bad test setup"
    _assert_match(_np(out), ref)


def test_offscreen_crowd_does_not_evict():
    """Hundreds of spheres beside/behind the camera must not consume
    candidate slots and evict the visible scene."""
    rng = np.random.default_rng(8)
    crowd = rng.normal(size=(300, 3))
    crowd /= np.linalg.norm(crowd, axis=1, keepdims=True)
    crowd = crowd * 0.8 + np.array([0.0, 0.0, 1.5])
    target = np.array([[0.0, 0.0, -5.0]])
    centers = np.concatenate([crowd, target])
    n = centers.shape[0]
    out, _ = _run_both((centers, np.tile([1.0, 0, 0, 0], (n, 1)),
                        np.full((n, 3), 0.3), np.full((n, 3), 0.2),
                        np.ones(n), np.ones(n, bool)), max_per_tile=8)
    h, w = CAM["height"] // 2, CAM["width"] // 2
    assert int(out.gid[h, w]) == n - 1  # the visible target survives


def test_scene_wrapper():
    rng = np.random.default_rng(3)
    n = 20
    xyz = rng.uniform(-1, 1, (n, 3))
    xyz[:, 2] -= 5.0
    scene = from_arrays(
        xyz, np.log(rng.uniform(0.2, 0.5, (n, 3))), rng.normal(size=(n, 4)),
        np.full(n, 4.0), rng.uniform(0, 1, (n, 3)), rng.normal(size=(n, 3)),
        rng.uniform(0, 1, (n, 3)), rng.uniform(0, 1, n), device="cpu")
    out = rasterize_scene(scene, _f32(rng.uniform(0, 1, (scene.capacity, 3))),
                          _f32(CAM["c2w"]), _f32(CAM["origin"]), CAM["fovy"],
                          CAM["width"], CAM["height"])
    assert bool((out.gid >= 0).any())
    assert bool(torch.isfinite(out.rgb).all())


# -- the port against the JAX rasterizer ------------------------------------


def two_nearest(scene, c2w, origin, alpha_limit):
    """Per pixel, the two smallest solid-stage hit depths over every
    eligible ellipsoid (float64; inf where fewer hit)."""
    centers, quats, radii, colors, alphas, valid = scene
    dirs = _ray_dirs(CAM["width"], CAM["height"], CAM["fovy"], c2w)
    view = -c2w[:, 2]
    dv = dirs @ view
    depths = []
    for i in range(centers.shape[0]):
        if not (valid[i] and alphas[i] >= alpha_limit):
            continue
        rot = _quat_to_rot(quats[i])
        o_l = rot.T @ (origin - centers[i]) / radii[i]
        d_l = (dirs @ rot) / radii[i]
        a = np.sum(d_l * d_l, -1)
        b = 2 * np.sum(o_l * d_l, -1)
        c = np.sum(o_l * o_l) - 1
        disc = b * b - 4 * a * c
        sq = np.sqrt(np.maximum(disc, 0))
        t1, t2 = (-b - sq) / (2 * a), (-b + sq) / (2 * a)
        t = np.where(t1 * dv >= CAM["znear"], t1, t2)
        d = t * dv
        ok = (disc >= 0) & (d >= CAM["znear"]) & (d <= CAM["zfar"])
        depths.append(np.where(ok, d, np.inf))
    depths = np.sort(np.stack(depths + [np.full(dv.shape, np.inf)] * 2), 0)
    return depths[0], depths[1]


PARITY = {
    "solid": dict(seed=0, n=200, floaters=False, pose=False),
    "floaters": dict(seed=1, n=200, floaters=True, pose=False),
    "general_pose": dict(seed=7, n=150, floaters=False, pose=True),
}


def parity_inputs(case):
    """float32 inputs of a PARITY case: (scene, c2w, origin, kwargs)."""
    p = PARITY[case]
    if p["pose"]:
        scene, c2w, origin = general_pose_scene(p["n"], p["seed"])
    else:
        scene = _random_scene(np.random.default_rng(p["seed"]), p["n"])
        c2w, origin = CAM["c2w"], CAM["origin"]
    scene = tuple(np.asarray(a, bool if i == 5 else np.float32)
                  for i, a in enumerate(scene))
    kw = dict(alpha_limit=0.2, render_floaters=p["floaters"],
              max_per_tile=8, select_chunk=32)
    return (scene, np.asarray(c2w, np.float32),
            np.asarray(origin, np.float32), kw)


def rasterize_jax(path):
    """The JAX rasterize_ellipsoids of every PARITY case, saved to `path`
    as npz.  Run by jax_rasters in a child process."""
    import jax.numpy as jnp

    from editable_gaussian_reflections_tpu.ops import ellipsoid_raster as jr

    arrays = {}
    for case in PARITY:
        scene, c2w, origin, kw = parity_inputs(case)
        out = jr.rasterize_ellipsoids(
            *(jnp.asarray(a) for a in scene), jnp.asarray(c2w),
            jnp.asarray(origin), CAM["fovy"], CAM["width"], CAM["height"],
            znear=CAM["znear"], zfar=CAM["zfar"], **kw)
        for name, a in out._asdict().items():
            arrays[f"{case}/{name}"] = np.asarray(a)
    np.savez(path, **arrays)


@pytest.fixture(scope="module")
def jax_rasters(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_rasters") / "rasters.npz"
    root = str(Path(__file__).resolve().parents[1])
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_cpu_max_isa=AVX").strip(),
               PYTHONPATH=os.pathsep.join(
                   p for p in (root, os.environ.get("PYTHONPATH")) if p))
    subprocess.run([sys.executable, __file__, str(path)], env=env, check=True,
                   timeout=600)
    with np.load(path) as data:
        return dict(data)


@pytest.mark.parametrize("case", list(PARITY))
def test_matches_jax(case, jax_rasters):
    scene, c2w, origin, kw = parity_inputs(case)
    ours = _np(_run_port(scene, c2w=c2w, origin=origin, **kw))
    ref = type(ours)(*(jax_rasters[f"{case}/{f}"] for f in ours._fields))
    # the cap evicts: without it some pixel resolves to another ellipsoid
    uncapped = _run_port(scene, c2w=c2w, origin=origin,
                         **dict(kw, max_per_tile=256)).gid.numpy()
    assert (uncapped != ours.gid).any() and (ours.gid >= 0).mean() > 0.2

    d1, d2 = two_nearest(scene, c2w.astype(np.float64),
                         origin.astype(np.float64), 0.2)
    with np.errstate(invalid="ignore"):  # inf - inf where nothing hits
        tie = np.abs(d2 - d1) <= 1e-6
    differ = ours.gid != ref.gid
    assert int((differ & ~tie).sum()) <= GID_TIES, (
        f"gid differs off depth ties at {int((differ & ~tie).sum())} pixels")
    same = ~differ
    for name in ("rgb", "depth", "normal"):
        a, b = getattr(ours, name)[same], getattr(ref, name)[same]
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL, err_msg=name)


if __name__ == "__main__":
    rasterize_jax(sys.argv[1])
