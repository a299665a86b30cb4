"""PyTorch port vs JAX package: the math leftovers and utils/loss.py.

  * The activation twins no render path calls (softplus, exp, identity,
    normalize and their backwards, relu's and clipped relu's backwards):
    equal to the JAX functions within 1e-6 x the output's magnitude, and
    the backward rules against autograd (tests/test_math_core.py's checks).
  * ggx.D_GGX and cook_torrance_brdf against JAX within 1e-6 relative, and
    autograd against the reference's closed-form derivatives of D and G1
    (ggx_brdf.h:15-111, test_math_core.py's tolerances); the f0 == 0
    short-circuit.
  * gaussian_kernel.eval_gaussian (at the scaling factor's isosurface) and
    compute_alpha's clamp; quaternion.normalize and quat_multiply.
  * culling.cull_clusters: JAX's candidates, counts and overflow, equal;
    the candidates a superset of the clusters JAX's trace hits
    (tests/test_culling.py:68).
  * utils/loss.py: l1, l2, the Gaussian window and SSIM (HWC and gray)
    within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editable_gaussian_reflections_tpu.ops import activations as jact
from editable_gaussian_reflections_tpu.ops import ggx as jggx
from editable_gaussian_reflections_tpu.ops import quaternion as jquat
from editable_gaussian_reflections_tpu.ops.culling import (
    cull_clusters as j_cull_clusters,
)
from editable_gaussian_reflections_tpu.ops.gaussian_kernel import (
    eval_gaussian as j_eval_gaussian,
)
from editable_gaussian_reflections_tpu.ops.trace import trace_rays
from editable_gaussian_reflections_tpu.scene import gaussian_scene as jgs
from editable_gaussian_reflections_tpu.utils import loss as jloss
from editable_gaussian_reflections_tpu_torch.ops import activations as act
from editable_gaussian_reflections_tpu_torch.ops import ggx
from editable_gaussian_reflections_tpu_torch.ops import quaternion as quat
from editable_gaussian_reflections_tpu_torch.ops.culling import cull_clusters
from editable_gaussian_reflections_tpu_torch.ops.gaussian_kernel import (
    MAX_ALPHA,
    compute_alpha,
    compute_scaling_factor,
    eval_gaussian,
)
from editable_gaussian_reflections_tpu_torch.scene import gaussian_scene as tgs
from editable_gaussian_reflections_tpu_torch.utils import loss
from tests.test_culling import make_scene, rays

torch.set_num_threads(1)

TOL = 1e-6


def close(port, ref, tol=TOL):
    port = port.detach().numpy() if torch.is_tensor(port) else port
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(port, ref, rtol=0, atol=tol * scale)


def t(a):
    return torch.tensor(np.asarray(a))


def inputs(seed=0, shape=(64,)):
    rng = np.random.default_rng(seed)
    return rng.uniform(-4, 4, shape).astype(np.float32)


# -- activations ---------------------------------------------------------------

UNARY = ["softplus_act", "exp_act", "identity_act", "relu_act",
         "clipped_relu_act", "sigmoid_act"]


@pytest.mark.parametrize("name", UNARY)
def test_activation_matches_jax(name):
    x = inputs(1)
    close(getattr(act, name)(t(x)), getattr(jact, name)(jnp.asarray(x)))


@pytest.mark.parametrize("name", ["backward_relu_act",
                                  "backward_clipped_relu_act",
                                  "backward_exp_act",
                                  "backward_identity_act",
                                  "backward_sigmoid_act"])
def test_backward_matches_jax(name):
    g, y = inputs(2), inputs(3) / 3.0
    close(getattr(act, name)(t(g), t(y)),
          getattr(jact, name)(jnp.asarray(g), jnp.asarray(y)))


def test_softplus_backward_and_normalize_match_jax():
    g, x = inputs(4), inputs(5)
    y = act.softplus_act(t(x))
    close(act.backward_softplus_act(t(g), t(x), y),
          jact.backward_softplus_act(jnp.asarray(g), jnp.asarray(x),
                                     jnp.asarray(y.numpy())))
    v = inputs(6, (16, 4))
    for eps in (0.0, 0.5):
        close(act.normalize_act(t(v), eps=eps),
              jact.normalize_act(jnp.asarray(v), eps=eps))
    ct = inputs(7, (16, 4))
    close(act.backward_normalize_act(t(ct), t(v)),
          jact.backward_normalize_act(jnp.asarray(ct), jnp.asarray(v),
                                      None), tol=1e-5)


@pytest.mark.parametrize("fwd,bwd", [
    (act.sigmoid_act, act.backward_sigmoid_act),
    (act.exp_act, act.backward_exp_act),
    (act.identity_act, act.backward_identity_act),
])
def test_activation_backward_matches_autograd(fwd, bwd):
    xs = torch.linspace(-3.0, 3.0, 41, requires_grad=True)
    (auto,) = torch.autograd.grad(fwd(xs).sum(), xs)
    hand = bwd(torch.ones(41), fwd(xs).detach())
    np.testing.assert_allclose(hand.numpy(), auto.numpy(), rtol=1e-5)


def test_softplus_backward_matches_autograd():
    xs = torch.linspace(-3.0, 3.0, 41, requires_grad=True)
    (auto,) = torch.autograd.grad(act.softplus_act(xs).sum(), xs)
    hand = act.backward_softplus_act(torch.ones(41), xs.detach())
    np.testing.assert_allclose(hand.numpy(), auto.numpy(), rtol=1e-5)


def test_normalize_backward_matches_autograd():
    x = torch.tensor(inputs(8, (16, 4)), requires_grad=True)
    ct = torch.tensor(inputs(9, (16, 4)))
    (auto,) = torch.autograd.grad((act.normalize_act(x) * ct).sum(), x)
    hand = act.backward_normalize_act(ct, x.detach())
    np.testing.assert_allclose(hand.numpy(), auto.numpy(), rtol=1e-4,
                               atol=1e-5)


# -- kernel maths and quaternions ---------------------------------------------


def test_eval_gaussian_and_scaling_factor():
    # kernel.cu:3-6 - zero below threshold, isosurface radius above
    sf0 = compute_scaling_factor(torch.tensor(0.001), 0.005, 3.0)
    assert float(sf0) == 0.0
    sf = float(compute_scaling_factor(torch.tensor(0.9), 0.005, 3.0))
    g = float(eval_gaussian(torch.tensor([sf, 0.0, 0.0]), 3.0))
    np.testing.assert_allclose(g * 0.9, 0.005, rtol=1e-4)
    hits = inputs(10, (32, 3)) / 3.0
    close(eval_gaussian(t(hits), 3.0), j_eval_gaussian(jnp.asarray(hits),
                                                        3.0))


def test_alpha_clamp():
    a = compute_alpha(torch.tensor(1.0), torch.tensor(1.0))
    assert float(a) == pytest.approx(MAX_ALPHA)


def test_quaternion_normalize_and_multiply_match_jax():
    a, b = inputs(11, (32, 4)), inputs(12, (32, 4))
    close(quat.normalize(t(a)), jquat.normalize(jnp.asarray(a)))
    close(quat.normalize(t(a), eps=1.0), jquat.normalize(jnp.asarray(a),
                                                         eps=1.0))
    close(quat.quat_multiply(t(a), t(b)),
          jquat.quat_multiply(jnp.asarray(a), jnp.asarray(b)))
    # the Hamilton product composes rotations: R(a*b) = R(a) R(b)
    na, nb = quat.normalize(t(a)), quat.normalize(t(b))
    lhs = quat.quat_to_rotmat(quat.quat_multiply(na, nb))
    rhs = quat.quat_to_rotmat(na) @ quat.quat_to_rotmat(nb)
    np.testing.assert_allclose(lhs.numpy(), rhs.numpy(), atol=1e-5)


# -- GGX -----------------------------------------------------------------------


def _rand_unit(seed, shape):
    v = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_ggx_d_and_brdf_match_jax():
    N, V, L = _rand_unit(20, (64, 3)), _rand_unit(21, (64, 3)), _rand_unit(
        22, (64, 3))
    H = _rand_unit(23, (64, 3))
    alpha = np.linspace(0.05, 0.95, 64).astype(np.float32)
    f0 = np.random.default_rng(24).uniform(0, 1, (64, 3)).astype(np.float32)
    f0[:8] = 0.0
    close(ggx.D_GGX(t(N), t(H), t(alpha)),
          jggx.D_GGX(jnp.asarray(N), jnp.asarray(H), jnp.asarray(alpha)),
          tol=1e-5)
    close(ggx.cook_torrance_brdf(t(N), t(V), t(L), t(alpha), t(f0)),
          jggx.cook_torrance_brdf(jnp.asarray(N), jnp.asarray(V),
                                  jnp.asarray(L), jnp.asarray(alpha),
                                  jnp.asarray(f0)), tol=1e-5)


def test_ggx_d_derivative_matches_reference_closed_form():
    # dD/dalpha from ggx_brdf.h:15-30: (2a(d - 2a^2 x^2)) / (pi d^3)
    N, H = t(_rand_unit(2, (8, 3))), t(_rand_unit(3, (8, 3)))
    alpha = torch.linspace(0.1, 0.9, 8, requires_grad=True)
    (auto,) = torch.autograd.grad(ggx.D_GGX(N, H, alpha).sum(), alpha)
    x = torch.clamp((N * H).sum(-1), min=0.0)
    a = alpha.detach()
    a2 = a * a
    d = x * x * (a2 - 1.0) + 1.0
    closed = (2.0 * a * (d - 2.0 * a2 * x * x)) / (np.pi * d ** 3)
    np.testing.assert_allclose(auto.numpy(), closed.numpy(), rtol=1e-3,
                               atol=1e-5)


def test_ggx_g1_derivative_matches_reference_closed_form():
    N, W = t(_rand_unit(4, (8, 3))), t(_rand_unit(5, (8, 3)))
    alpha = torch.linspace(0.15, 0.85, 8, requires_grad=True)
    (auto,) = torch.autograd.grad(ggx.G1(N, W, alpha).sum(), alpha)
    x = torch.clamp((N * W).sum(-1), min=0.0)
    a = alpha.detach()
    k = a * a * 0.5
    d = x * (1.0 - k) + k + ggx.BRDF_EPS
    closed = -x * ((1.0 - x) * a) / (d * d)
    np.testing.assert_allclose(auto.numpy(), closed.numpy(), rtol=1e-3,
                               atol=1e-5)


def test_cook_torrance_zero_f0_shortcircuit():
    N = torch.tensor([0.0, 0.0, 1.0])
    V, L = t(_rand_unit(6, (3,))), t(_rand_unit(7, (3,)))
    z = torch.zeros(3)
    r = torch.tensor(0.3)
    assert bool(torch.all(ggx.cook_torrance_brdf(N, V, L, r, z) == 0.0))
    assert bool(torch.all(ggx.cook_torrance_weight(N, V, L, r, z) == 0.0))


# -- cull_clusters -------------------------------------------------------------


def test_cull_clusters_matches_jax_and_keeps_hit_clusters():
    from editable_gaussian_reflections_tpu.scene.gaussian_scene import (
        build_frames as j_build_frames,
    )

    jscene = make_scene(n=240, seed=3)
    jframes, _ = j_build_frames(jscene, 0.005, 3.0)
    tscene = tgs.from_numpy({f: np.asarray(getattr(jscene, f))
                             for f in jgs.GaussianScene._fields},
                            device="cpu")
    tframes, _ = tgs.build_frames(tscene, 0.005, 3.0)
    o, d = rays(r=16, seed=4)
    near, far = 0.1, 100.0
    cluster = tile = 16
    mc = tframes.mean.shape[0] // cluster
    ours = cull_clusters(t(o), t(d), tframes, near, far, tile=tile,
                         cluster=cluster, max_clusters=mc)
    ref = j_cull_clusters(o, d, jframes, jnp.float32(near),
                          jnp.float32(far), tile=tile, cluster=cluster,
                          max_clusters=mc)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    cand_set = set(int(c) for c in ours[0][0].tolist() if c >= 0)
    hits = trace_rays(o, d, jframes, 3.0, jnp.float32(near),
                      jnp.float32(far), max_hits=64, chunk=16)
    hit_ids = np.asarray(hits.ids)[np.asarray(hits.valid)]
    missing = set(int(i) // cluster for i in hit_ids) - cand_set
    assert not missing, f"culling dropped hit clusters: {missing}"
    assert not bool(ours[2].any())


# -- utils/loss.py -------------------------------------------------------------


def test_l1_l2_and_window_match_jax():
    a, b = inputs(30, (12, 10, 3)), inputs(31, (12, 10, 3))
    close(loss.l1_loss(t(a), t(b)), jloss.l1_loss(jnp.asarray(a),
                                                  jnp.asarray(b)))
    close(loss.l2_loss(t(a), t(b)), jloss.l2_loss(jnp.asarray(a),
                                                  jnp.asarray(b)))
    close(loss.gaussian_window(11, 1.5), jloss.gaussian_window(11, 1.5))


@pytest.mark.parametrize("shape", [(24, 20, 3), (17, 23)])
def test_ssim_matches_jax(shape):
    rng = np.random.default_rng(32)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    ours = loss.ssim(t(a), t(b))
    close(ours, jloss.ssim(jnp.asarray(a), jnp.asarray(b)))
    assert float(loss.ssim(t(a), t(a))) == pytest.approx(1.0, abs=1e-6)
    assert 0.0 < float(ours) < 1.0
