"""PyTorch port vs JAX package: the math core of the eval render.

Both sides get the same inputs (numpy arrays made from a seed, or JAX's own
draws rebuilt from its key) and are compared at atol 1e-6 x the output's
magnitude: the same float32 formulas, rounded by two libraries."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editable_gaussian_reflections_tpu.ops import ggx as jggx
from editable_gaussian_reflections_tpu.ops.activations import (
    clipped_relu_act as j_clipped_relu,
    inverse_sigmoid as j_inverse_sigmoid,
    relu_act as j_relu,
    sigmoid_act as j_sigmoid,
)
from editable_gaussian_reflections_tpu.ops.camera_rays import (
    primary_ray_directions as j_rays,
)
from editable_gaussian_reflections_tpu.ops.gaussian_kernel import (
    compute_scaling_factor as j_sf,
)
from editable_gaussian_reflections_tpu.ops.pallas.trace_kernel import (
    pack_frames as j_pack,
)
from editable_gaussian_reflections_tpu.ops.quaternion import (
    quat_to_rotmat as j_quat,
)
from editable_gaussian_reflections_tpu.ops.tonemap import (
    tonemap as j_tonemap,
    untonemap as j_untonemap,
)
from editable_gaussian_reflections_tpu.scene import gaussian_scene as jgs
from editable_gaussian_reflections_tpu.utils.synth import (
    room_camera as j_room_camera,
    room_scene as j_room_scene,
)
from editable_gaussian_reflections_tpu_torch.ops import ggx
from editable_gaussian_reflections_tpu_torch.ops.activations import (
    clipped_relu_act,
    inverse_sigmoid,
    relu_act,
    sigmoid_act,
)
from editable_gaussian_reflections_tpu_torch.ops.camera_rays import (
    primary_ray_directions,
)
from editable_gaussian_reflections_tpu_torch.ops.cuda.layout import (
    pack_frames,
)
from editable_gaussian_reflections_tpu_torch.ops.gaussian_kernel import (
    compute_scaling_factor,
)
from editable_gaussian_reflections_tpu_torch.ops.quaternion import (
    quat_to_rotmat,
)
from editable_gaussian_reflections_tpu_torch.ops.tonemap import (
    tonemap,
    untonemap,
)
from editable_gaussian_reflections_tpu_torch.scene import gaussian_scene as tgs
from editable_gaussian_reflections_tpu_torch.utils.synth import (
    room_camera,
    room_scene,
)

# the suite runs in several worker processes on shared cores: one torch
# thread per process keeps them from oversubscribing the CPU
torch.set_num_threads(1)

ALPHA_THRESHOLD, EXP_POWER = 0.005, 3.0


def close(port, ref, tol=1e-6):
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else port
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(port, ref, rtol=0, atol=tol * scale)


def jax_scene_numpy(scene):
    return {f: np.asarray(getattr(scene, f)) for f in jgs.GaussianScene._fields}


@pytest.fixture(scope="module")
def room():
    params = j_room_scene(2048)
    return params, jgs.from_arrays(**params, pad_multiple=512)


def test_synth_copy_matches():
    a, b = room_scene(1000, seed=3), j_room_scene(1000, seed=3)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    for x, y in zip(room_camera(), j_room_camera()):
        np.testing.assert_array_equal(x, y)


def test_from_arrays_and_from_numpy_match(room):
    params, jscene = room
    port = tgs.from_arrays(**params, pad_multiple=512, device="cpu")
    carried = tgs.from_numpy(jax_scene_numpy(jscene), device="cpu")
    assert port.capacity == jscene.capacity == 2048
    for f in jgs.GaussianScene._fields:
        ref = np.asarray(getattr(jscene, f))
        np.testing.assert_array_equal(getattr(port, f).numpy(), ref, f)
        np.testing.assert_array_equal(getattr(carried, f).numpy(), ref, f)


@pytest.mark.parametrize("global_scale", [1.0, 0.7])
def test_build_frames_and_pack(room, global_scale):
    _, jscene = room
    jf, ja = jgs.build_frames(jscene, ALPHA_THRESHOLD, EXP_POWER, global_scale)
    tf, ta = tgs.build_frames(tgs.from_numpy(jax_scene_numpy(jscene),
                                              device="cpu"),
                              ALPHA_THRESHOLD, EXP_POWER, global_scale)
    for f in jf._fields:
        if f == "valid":
            np.testing.assert_array_equal(tf.valid.numpy(),
                                          np.asarray(jf.valid))
        else:
            close(getattr(tf, f), getattr(jf, f))
    for f in ja._fields:
        close(getattr(ta, f), getattr(ja, f))
    close(pack_frames(tf, ta), j_pack(jf, ja))
    close(pack_frames(tf), j_pack(jf))


def test_activations_and_scaling_factor():
    rng = np.random.default_rng(0)
    x = rng.normal(scale=3.0, size=4096).astype(np.float32)
    x[:4] = [0.0, -10.0, 10.0, np.log(0.005 / 0.995)]  # sf clamp edge
    tx = torch.from_numpy(x)
    close(sigmoid_act(tx), j_sigmoid(jnp.asarray(x)))
    close(relu_act(tx), j_relu(jnp.asarray(x)))
    close(clipped_relu_act(tx), j_clipped_relu(jnp.asarray(x)))
    p = np.linspace(0.01, 0.99, 512).astype(np.float32)
    close(inverse_sigmoid(torch.from_numpy(p)),
          j_inverse_sigmoid(jnp.asarray(p)))
    op = sigmoid_act(tx)
    close(compute_scaling_factor(op, ALPHA_THRESHOLD, EXP_POWER),
          j_sf(j_sigmoid(jnp.asarray(x)), ALPHA_THRESHOLD, EXP_POWER))
    y = np.abs(x)
    close(tonemap(torch.from_numpy(y)), j_tonemap(jnp.asarray(y)))
    v = np.linspace(0.0, 0.95, 512).astype(np.float32)
    close(untonemap(torch.from_numpy(v)), j_untonemap(jnp.asarray(v)))


def test_quat_to_rotmat():
    q = np.random.default_rng(1).normal(size=(512, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    close(quat_to_rotmat(torch.from_numpy(q)), j_quat(jnp.asarray(q)))


@pytest.mark.parametrize("size", [(32, 32), (48, 16)])
def test_primary_ray_directions_with_injected_jitter(size):
    W, H = size
    _, c2w = j_room_camera()
    key = jax.random.PRNGKey(5)
    ref = j_rays(W, H, jnp.asarray(0.9), jnp.asarray(c2w), jitter_key=key)
    # the JAX function's own draw, rebuilt from its key
    jitter = np.asarray(jax.random.uniform(key, (H, W, 2), jnp.float32)) - 0.5
    port = primary_ray_directions(W, H, 0.9, torch.from_numpy(c2w),
                                  jitter=torch.from_numpy(jitter))
    close(port, ref)
    close(primary_ray_directions(W, H, 0.9, torch.from_numpy(c2w)),
          j_rays(W, H, jnp.asarray(0.9), jnp.asarray(c2w)))


def test_ggx_sampling_and_weight():
    rng = np.random.default_rng(2)
    n = 4096

    def unit(a):
        return (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(
            np.float32)

    N = unit(rng.normal(size=(n, 3)))
    N[:8] = [0.0, 0.0, 1.0]          # the tangent-frame branch on N.z
    V = unit(rng.normal(size=(n, 3)) + 2.0 * N)
    rough = rng.uniform(0.01, 1.0, n).astype(np.float32)
    u = rng.uniform(0.0, 1.0, (n, 2)).astype(np.float32)
    f0 = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    f0[:16] = 0.0                    # zero-f0 rows weigh nothing
    T = torch.from_numpy
    L = ggx.sample_cook_torrance(T(N), T(V), T(rough), T(u))
    L_ref = jggx.sample_cook_torrance(jnp.asarray(N), jnp.asarray(V),
                                      jnp.asarray(rough), jnp.asarray(u))
    # sin_theta = sqrt(1 - cos_theta^2) amplifies a one-ulp difference in
    # cos_theta by cos/sin (~45x at cos = 0.9998): scale each row's
    # tolerance by that condition number
    a2 = rough.astype(np.float64) ** 4
    cos_t = np.sqrt((1.0 - u[:, 1]) / (1.0 + (a2 - 1.0) * u[:, 1]))
    cond = cos_t / np.maximum(np.sqrt(np.clip(1.0 - cos_t**2, 0, 1)), 1e-3)
    err = np.abs(L.numpy() - np.asarray(L_ref)).max(axis=-1)
    assert np.all(err <= 1e-6 * np.maximum(1.0, cond)), err.max()
    w = ggx.cook_torrance_weight(T(N), T(V), L, T(rough), T(f0))
    w_ref = jggx.cook_torrance_weight(jnp.asarray(N), jnp.asarray(V), L_ref,
                                      jnp.asarray(rough), jnp.asarray(f0))
    # the weight divides by NdotH * NdotV: compare relative to each value
    ref = np.asarray(w_ref)
    np.testing.assert_allclose(w.numpy(), ref, rtol=1e-5,
                               atol=1e-6 * max(1.0, np.median(np.abs(ref))))
    assert np.all(w.numpy()[:16] == 0.0)
