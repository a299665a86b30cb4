"""GGX / Cook-Torrance importance sampling and throughput weight.

Twin of the JAX ops/ggx.py (reference ggx_brdf.h).  Shape-polymorphic over
leading batch dims with the vector axis last.  D_GGX and cook_torrance_brdf
are differentiable through autograd, as the JAX functions are through
jax.grad; the reference's closed-form derivatives are checked against them
in tests/test_torch_math_extra.py.
"""

from __future__ import annotations

import math

import torch

from .precision import cross3, norm, rounded
from .precision import dot as _dot

BRDF_EPS = 1e-8


def _normalize(v, eps=0.0):
    return v / (norm(v, keepdim=True) + eps)


def D_GGX(N, H, alpha):
    """ggx_brdf.h:8-13 (normal distribution function)."""
    NdotH = torch.clamp(_dot(N, H), min=0.0)
    a2 = alpha * alpha
    denom = NdotH * NdotH * (a2 - 1.0) + 1.0
    return a2 / (math.pi * (denom * denom) + BRDF_EPS)


def G1(N, W, alpha):
    """ggx_brdf.h:32-37 (Schlick-GGX masking, k = alpha^2/2)."""
    NdotW = torch.clamp(_dot(N, W), min=0.0)
    k = (alpha * alpha) / 2.0
    return NdotW / (NdotW * (1.0 - k) + k + BRDF_EPS)


def G_Smith(N, V, L, alpha):
    """ggx_brdf.h:64."""
    return G1(N, V, alpha) * G1(N, L, alpha)


def fresnel_schlick(f0, cos_theta):
    """ggx_brdf.h:84. ``cos_theta`` broadcasts against f0's last axis."""
    c = cos_theta[..., None]
    return f0 + (1.0 - f0) * rounded(torch.pow, 1.0 - c, 5.0)


def cook_torrance_brdf(N, V, L, roughness, f0):
    """ggx_brdf.h:113-132. Returns 0 where f0 == 0 (all channels)."""
    H = _normalize(V + L)
    alpha = roughness * roughness
    D = D_GGX(N, H, alpha)
    G = G_Smith(N, V, L, alpha)
    cos_theta = torch.clamp(_dot(L, H), min=0.0)
    F = fresnel_schlick(f0, cos_theta)
    NdotL = torch.clamp(_dot(N, L), min=0.0)
    NdotV = torch.clamp(_dot(N, V), min=0.0)
    denom = 4.0 * NdotL * NdotV + BRDF_EPS
    brdf = (D * G / denom)[..., None] * F
    zero_f0 = torch.all(f0 == 0.0, dim=-1, keepdim=True)
    return torch.where(zero_f0, torch.zeros_like(brdf), brdf)


def cook_torrance_weight(N, V, L, roughness, f0):
    """Importance-sampling throughput weight F*G*VdotH/(NdotH*NdotV).

    ggx_brdf.h:134-150: brdf/pdf for Walter's half-vector sampling (eps in
    the half-vector normalization: L == -V would produce NaN)."""
    H = _normalize(V + L, eps=1e-20)
    NdotH = torch.clamp(_dot(N, H), min=0.0)
    VdotH = torch.clamp(_dot(V, H), min=0.0)
    NdotV = torch.clamp(_dot(N, V), min=0.0)
    alpha = roughness * roughness
    G = G_Smith(N, V, L, alpha)
    F = fresnel_schlick(f0, VdotH)
    w = F * (G * VdotH / (NdotH * NdotV + BRDF_EPS))[..., None]
    zero_f0 = torch.all(f0 == 0.0, dim=-1, keepdim=True)
    return torch.where(zero_f0, torch.zeros_like(w), w)


def reflect(i, n):
    """Mirror ``i`` about ``n`` (NVIDIA vec_math.h convention)."""
    return i - 2.0 * n * _dot(n, i)[..., None]


def sample_cook_torrance(N, V, roughness, uniform_samples):
    """GGX half-vector importance sampling, ggx_brdf.h:152-168.

    uniform_samples: (..., 2) in [0,1).  Returns the sampled bounce direction
    reflect(-V, H), normalized when N and V are."""
    alpha = roughness * roughness
    u0 = uniform_samples[..., 0]
    u1 = uniform_samples[..., 1]
    phi = 2.0 * math.pi * u0
    cos_theta = rounded(torch.sqrt,
                        (1.0 - u1) / (1.0 + (alpha * alpha - 1.0) * u1))
    sin_theta = rounded(torch.sqrt,
                        torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    H_local = torch.stack(
        [sin_theta * rounded(torch.cos, phi),
         sin_theta * rounded(torch.sin, phi), cos_theta],
        dim=-1)

    # tangent frame (matches the reference's branch on N.z, ggx_brdf.h:161-163)
    z_up = torch.tensor([0.0, 0.0, 1.0], dtype=N.dtype, device=N.device)
    x_up = torch.tensor([1.0, 0.0, 0.0], dtype=N.dtype, device=N.device)
    up = torch.where((N[..., 2] < 0.999)[..., None], z_up, x_up)
    T = _normalize(cross3(up, N), eps=1e-20)
    B = cross3(N, T)
    H = (H_local[..., 0:1] * T
         + H_local[..., 1:2] * B
         + H_local[..., 2:3] * N)
    return reflect(-V, H)
