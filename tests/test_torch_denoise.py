"""PyTorch port vs JAX package: the denoisers (renderer/denoise.py and
renderer/denoise_net.py) and render(denoise=True).

On 32x32 seeded inputs (specular in [0, 2), random normals, depth in
[0, 5), roughness in [0, 1)), each function against its JAX twin, within
1e-5 relative (atol 1e-5 * the reference's largest magnitude):
_atrous_specular (4 iterations, spp 1 and 8), features, apply_net on the
in-repo KPN weights, apply_kernel, denoise_specular_learned,
denoise_specular at spp 1 (the KPN), 8 (the a-trous filter) and with
learned=False, and atrous_denoise.  Then the properties the JAX package's
tests/test_denoise.py and test_denoise_net.py check, on the port:
convexity, the constant fixed point, the SPP back-off, edge clamping in
apply_kernel (the feature windows wrap, as JAX's roll does), mirror pixels
kept, absent weights -> None and the warned fallback.

render(denoise=True): the 2048-Gaussian room of
tests/test_torch_render_tile.py at 32x32, 2 bounces, K 16, backend "xla"
(brute) on both sides, the port on JAX's samples rebuilt from the key
render() uses (PRNGKey(0)).  The port's denoiser on JAX's own frame
(final and G-buffer) gives JAX's denoised final within the 1e-5 rule; the
port's whole render(denoise=True) holds at most 0.5% of elements outside
2e-4*|ref| + 2e-5*scale (test_torch_backend.py's frame rule: the frames
themselves differ there on ulp-level hits).
The JAX side runs in a child process capped at AVX (see
test_torch_render_frame.py).
"""

import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from editable_gaussian_reflections_tpu_torch.config import Config
from editable_gaussian_reflections_tpu_torch.renderer import denoise as tden
from editable_gaussian_reflections_tpu_torch.renderer import denoise_net as tdn
from editable_gaussian_reflections_tpu_torch.renderer import render as trd
from editable_gaussian_reflections_tpu_torch.renderer.raytracer import (
    RenderSettings,
)
from editable_gaussian_reflections_tpu_torch.scene import gaussian_scene as tgs
from editable_gaussian_reflections_tpu_torch.utils.synth import (
    room_camera,
    room_scene,
)
from tests.test_torch_render_tile import MISMATCH, ZFAR, ZNEAR, _mismatch
from tests.test_torch_render_tile import _samples as tile_samples

torch.set_num_threads(1)

S = 32
NB, K = 2, 16
RTOL = 1e-5


class View:
    """The room camera as render() reads a scene camera: its size, its
    render pose, no targets."""
    image_height = image_width = S
    original_image = diffuse_image = specular_image = None

    def render_pose(self, znear, zfar):
        eye, c2w = room_camera()
        return (np.asarray(eye, np.float32), np.asarray(c2w, np.float32),
                np.float32(0.9), np.float32(znear), np.float32(zfar))


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    spec = (rng.uniform(size=(S, S, 3)) * 2.0).astype(np.float32)
    diffuse = rng.uniform(0.2, 0.5, (S, S, 3)).astype(np.float32)
    return dict(spec=spec, diffuse=diffuse, final=diffuse + spec,
                normal=rng.normal(size=(S, S, 3)).astype(np.float32),
                depth=(rng.uniform(size=(S, S)) * 5.0).astype(np.float32),
                rough=rng.uniform(size=(S, S)).astype(np.float32))


def jax_reference(path):
    """JAX outputs of every test here, saved to `path` as npz.  Run by the
    jax_ref fixture in a child process."""
    import jax.numpy as jnp

    from editable_gaussian_reflections_tpu.config import Config as JConfig
    from editable_gaussian_reflections_tpu.renderer import denoise as jden
    from editable_gaussian_reflections_tpu.renderer import denoise_net as jdn
    from editable_gaussian_reflections_tpu.renderer.render import (
        default_backend_kwargs,
    )
    from editable_gaussian_reflections_tpu.renderer.render import (
        render as jrender,
    )
    from editable_gaussian_reflections_tpu.renderer.raytracer import (
        RenderSettings as JSettings,
    )
    from editable_gaussian_reflections_tpu.scene import gaussian_scene as jgs

    x = inputs()
    g = [jnp.asarray(x[k]) for k in ("normal", "depth", "rough")]
    spec = jnp.asarray(x["spec"])
    out = {}
    for spp in (1.0, 8.0):
        out[f"atrous/{spp}"] = jden._atrous_specular(
            spec, *g, iterations=4, spp=jnp.float32(spp))
    params = jdn.load_params()
    feat = jdn.features(spec, *g)
    out["features"] = feat
    logits = jdn.apply_net(params, feat)
    out["logits"] = logits
    out["kernel"] = jdn.apply_kernel(spec, logits)
    out["learned"] = jdn.denoise_specular_learned(params, spec, *g)
    for name, kw in (("spp1", dict(spp=1)), ("spp8", dict(spp=8)),
                     ("atrous_forced", dict(spp=1, learned=False))):
        out[f"denoise/{name}"] = jden.denoise_specular(
            x["final"], x["diffuse"], x["normal"], x["depth"], x["rough"],
            **kw)
    out["legacy"] = jden.atrous_denoise(x["final"], x["normal"], x["depth"])

    scene = jgs.from_arrays(**room_scene(2048), pad_multiple=512)
    kw = default_backend_kwargs(JConfig(backend="xla"))
    for denoise in (False, True):
        pkg = jrender(View(), scene, JSettings(), num_bounces=NB,
                      max_hits=K, tile=S * S, znear=ZNEAR, zfar=ZFAR,
                      denoise=denoise, **kw)
        for f in ("final", "rgb", "normal", "depth", "roughness"):
            out[f"render/{denoise}/{f}"] = getattr(pkg, f)
    np.savez(path, **{k: np.asarray(v) for k, v in out.items()})


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """jax_reference's arrays, computed by XLA without FMA contraction
    (module docstring) in a child process."""
    path = tmp_path_factory.mktemp("jax_denoise") / "ref.npz"
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


def _close(a, b, what):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    assert a.shape == b.shape, what
    np.testing.assert_allclose(a, b, rtol=RTOL,
                               atol=RTOL * float(np.abs(b).max()),
                               err_msg=what)


def _t(x):
    return {k: torch.tensor(v) for k, v in x.items()}


def test_atrous_specular_matches_jax(jax_ref):
    x = _t(inputs())
    for spp in (1.0, 8.0):
        _close(tden._atrous_specular(x["spec"], x["normal"], x["depth"],
                                     x["rough"], iterations=4, spp=spp),
               jax_ref[f"atrous/{spp}"], f"spp {spp}")


def test_kpn_stages_match_jax(jax_ref):
    x = _t(inputs())
    g = (x["normal"], x["depth"], x["rough"])
    params = tdn.load_params()
    assert params is not None and params["w0"].shape == (3, 3, 9, 32)
    feat = tdn.features(x["spec"], *g)
    _close(feat, jax_ref["features"], "features")
    # each stage on JAX's inputs, so that one stage's error does not carry
    logits = tdn.apply_net(params, torch.tensor(jax_ref["features"]))
    _close(logits, jax_ref["logits"], "apply_net")
    _close(tdn.apply_kernel(x["spec"], torch.tensor(jax_ref["logits"])),
           jax_ref["kernel"], "apply_kernel")
    _close(tdn.denoise_specular_learned(params, x["spec"], *g),
           jax_ref["learned"], "denoise_specular_learned")


@pytest.mark.parametrize("name,kw", [("spp1", dict(spp=1)),
                                     ("spp8", dict(spp=8)),
                                     ("atrous_forced",
                                      dict(spp=1, learned=False))])
def test_denoise_specular_matches_jax(jax_ref, name, kw):
    x = inputs()
    out = tden.denoise_specular(x["final"], x["diffuse"], x["normal"],
                                x["depth"], x["rough"], **kw)
    assert out.dtype == torch.float32
    _close(out, jax_ref[f"denoise/{name}"], name)


def test_atrous_denoise_matches_jax(jax_ref):
    x = inputs()
    _close(tden.atrous_denoise(x["final"], x["normal"], x["depth"]),
           jax_ref["legacy"], "atrous_denoise")


def test_render_denoise_matches_jax(jax_ref):
    scene = tgs.from_arrays(**room_scene(2048), pad_multiple=512,
                            device="cpu")
    kw = trd.default_backend_kwargs(Config(backend="xla"))
    samples = tile_samples(S, S, S * S, NB + 1, key=0)
    pkg = {d: trd.render(View(), scene, RenderSettings(), num_bounces=NB,
                         max_hits=K, tile=S * S, znear=ZNEAR, zfar=ZFAR,
                         samples=samples, denoise=d, **kw)
           for d in (False, True)}
    # the port's denoiser on JAX's frame
    ref = {f: jax_ref[f"render/False/{f}"]
           for f in ("final", "rgb", "normal", "depth", "roughness")}
    on_jax = tden.denoise_specular(
        ref["final"].transpose(1, 2, 0), ref["rgb"][0].transpose(1, 2, 0),
        ref["normal"][0].transpose(1, 2, 0), ref["depth"][0, 0],
        ref["roughness"][0, 0])
    _close(on_jax.numpy().transpose(2, 0, 1), jax_ref["render/True/final"],
           "denoised JAX frame")
    # the whole render, on the port's frame
    for d in (False, True):
        b = jax_ref[f"render/{d}/final"]
        assert pkg[d].final.shape == b.shape == (3, S, S)
        assert _mismatch(pkg[d].final, b) <= MISMATCH, d
    assert not np.array_equal(pkg[True].final, pkg[False].final)
    np.testing.assert_array_equal(pkg[True].rgb, pkg[False].rgb)


def _fake(seed, H=32, W=32):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((H, W, 3), generator=g) * 2.0,
            torch.randn((H, W, 3), generator=g),
            torch.rand((H, W), generator=g) * 5.0,
            torch.rand((H, W), generator=g))


def test_kpn_is_convex_and_keeps_constants():
    params = tdn.init_params(torch.Generator().manual_seed(0))
    spec, normal, depth, rough = _fake(1)
    out = tdn.denoise_specular_learned(params, spec, normal, depth, rough)
    assert out.shape == spec.shape and torch.isfinite(out).all()
    assert out.max() <= spec.max() + 1e-5 and out.min() >= spec.min() - 1e-5
    const = torch.full((32, 32, 3), 0.7)
    out = tdn.denoise_specular_learned(params, const, normal, depth, rough)
    torch.testing.assert_close(out, const, atol=1e-5, rtol=0)


def test_spp_backoff_and_mirror_pixels():
    params = tdn.init_params(torch.Generator().manual_seed(0))
    spec, normal, depth, rough = _fake(3)
    hi = tdn.denoise_specular_learned(params, spec, normal, depth, rough,
                                      spp=512.0)
    lo = tdn.denoise_specular_learned(params, spec, normal, depth, rough,
                                      spp=1.0)
    d_hi = (hi - spec).abs().max().item()
    d_lo = (lo - spec).abs().max().item()
    assert d_hi <= 0.003 * max(d_lo, 1e-9) + 1e-7
    # the a-trous path backs off at 128 spp, and leaves mirrors alone
    x = inputs(4)
    img = x["diffuse"] + 0.05 * x["spec"]
    out = tden.denoise_specular(img, x["diffuse"], x["normal"], x["depth"],
                                x["rough"], spp=128)
    np.testing.assert_allclose(out.numpy(), img, atol=2e-3)
    mirror = np.full((S, S), 0.01, np.float32)
    out = tden.denoise_specular(x["final"], x["diffuse"], x["normal"],
                                x["depth"], mirror, spp=1)
    np.testing.assert_allclose(out.numpy(), x["final"], atol=5e-3)


def test_edge_clamp_not_wraparound():
    """A bright top row must not reach the bottom row through apply_kernel
    (edge padding), while the features' 3x3 windows wrap as JAX's roll."""
    H = W = 32
    spec = torch.zeros((H, W, 3))
    spec[0] = 100.0
    logits = torch.zeros((H, W, tdn.KSIZE * tdn.KSIZE))  # a uniform kernel
    out = tdn.apply_kernel(spec, logits)
    assert out[-1].max().item() == 0.0 and out[0].max().item() > 0.0
    normal = torch.tensor([0.0, 0.0, 1.0]).expand(H, W, 3)
    feat = tdn.features(spec, normal, torch.ones((H, W)), torch.ones((H, W)))
    assert feat[-1, :, 8].max().item() > 0.0      # MAD sees the wrapped row


def test_absent_weights(tmp_path, monkeypatch):
    monkeypatch.setenv(tdn.WEIGHTS_ENV, str(tmp_path / "nope.npz"))
    assert tdn.load_params() is None
    params = tdn.init_params(torch.Generator().manual_seed(0))
    path = str(tmp_path / "w.npz")
    tdn.save_params(params, path)
    loaded = tdn.load_params(path)
    for k in params:
        torch.testing.assert_close(loaded[k], params[k], rtol=0, atol=0)
    # learned=True without weights: the a-trous path, with a warning
    monkeypatch.setattr(tden, "_LEARNED_PARAMS", "unset")
    x = inputs(5)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = tden.denoise_specular(x["final"], x["diffuse"], x["normal"],
                                    x["depth"], x["rough"], learned=True)
    assert any("no KPN weights" in str(w.message) for w in caught)
    forced = tden.denoise_specular(x["final"], x["diffuse"], x["normal"],
                                   x["depth"], x["rough"], learned=False)
    torch.testing.assert_close(out, forced, rtol=0, atol=0)


if __name__ == "__main__":
    jax_reference(sys.argv[1])
