"""RGB<->HSV with hue in radians [0, 2pi] (kornia conventions), on tensors
(twin of the JAX package's numpy utils/color.py).

Used by the editing layer (scene/editable.py), which edits diffuse and f0
in HSV on the scene's device.  The HSV maths stays in the input's dtype
(float32 for a scene), Rodrigues' formula in float64, as in the JAX
package; floor-mod is spelled out from `fmod` (exact on every device) as
numpy computes it.
"""

from __future__ import annotations

import math

import torch

from ..ops.precision import div

TWO_PI = 2.0 * math.pi


def floor_mod(x: torch.Tensor, m: float) -> torch.Tensor:
    """x % m for a positive host scalar m, as numpy's float remainder
    (fmod, then m added where the sign differs; a zero is +0)."""
    mod = torch.fmod(x, torch.tensor(m, dtype=x.dtype, device=x.device))
    return torch.where(mod < 0, mod + m, mod + 0.0)


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """[N, 3] in [0, inf) -> [N, 3] with h in [0, 2pi], s in [0, 1],
    v >= 0."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    deltac = maxc - minc
    zero = torch.zeros_like(maxc)
    s = torch.where(maxc > 0, deltac / torch.clamp(maxc, min=1e-20), zero)

    dc = torch.where(deltac == 0, torch.ones_like(deltac), deltac)
    rc = (maxc - r) / dc
    gc = (maxc - g) / dc
    bc = (maxc - b) / dc

    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(deltac == 0, zero, h)
    h = floor_mod(div(h, 6.0), 1.0) * TWO_PI
    return torch.stack([h, s, v], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h = div(floor_mod(hsv[..., 0], TWO_PI), TWO_PI) * 6.0
    s = hsv[..., 1]
    v = hsv[..., 2]
    fl = torch.floor(h)
    i = torch.remainder(fl.to(torch.int64), 6)
    f = h - fl
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    choices = (
        (v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q),
    )
    # np.select: the first true condition wins, 0 where none holds
    rgb = torch.zeros_like(hsv)
    for k in reversed(range(6)):
        rgb = torch.where((i == k)[..., None], torch.stack(choices[k], -1),
                          rgb)
    return rgb


def axis_angle_to_rotation_matrix(angles_rad: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula on a (3,) axis-angle vector (kornia semantics),
    in float64 on the vector's device."""
    a = angles_rad.to(torch.float64)
    theta = float(torch.linalg.norm(a))
    eye = torch.eye(3, dtype=torch.float64, device=a.device)
    if theta < 1e-12:
        return eye
    k = a / theta
    zero = torch.zeros((), dtype=torch.float64, device=a.device)
    K = torch.stack([
        torch.stack([zero, -k[2], k[1]]),
        torch.stack([k[2], zero, -k[0]]),
        torch.stack([-k[1], k[0], zero]),
    ])
    return eye + math.sin(theta) * K + (1 - math.cos(theta)) * (K @ K)
