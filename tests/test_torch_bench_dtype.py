"""PyTorch port vs JAX package: the dtype micro-benchmark's op mix.

mix_reference (the plain version of csrc/bench_dtype.cu) against the same
mix written in jax.numpy.  The tool's Pallas kernel lives inside
tools/bench_vpu_dtype.py's main() and cannot be imported, so its body
(lines 38-47) is written out here, on the tool's block (256 x 512, uniform
in [0.1, 0.9], seed 0).  bf16: equal bit for bit at 16 rounds (both round
every operation to bf16 through float32).  float32: to rtol 1e-5 at 4
rounds (6.2e-6 measured), with the same infinities: XLA on the CPU
contracts a * b + c into a fused multiply-add, which rounds once where the
port rounds twice, and 28% of the elements grow about cubically per round
towards infinity, which multiplies such differences.

The kernels themselves run only on a CUDA card:
test_torch_sort_dtype_cuda.py compares them with this plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from editable_gaussian_reflections_tpu_torch.ops.cuda.bench_dtype import (
    MIX_OPS,
    mix,
    mix_reference,
)

X = np.random.default_rng(0).uniform(0.1, 0.9, (256, 512)).astype(np.float32)


def _jax_mix(x, reps, dtype):
    """tools/bench_vpu_dtype.py:36-49, outside Pallas."""
    x = jnp.asarray(x).astype(dtype)
    half = jnp.asarray(0.5, dtype)

    def body(i, acc):
        a = acc * x + half
        b = a * a - x
        c = b * acc + a
        d = jnp.maximum(c, half)
        return d * jnp.exp(-jnp.minimum(d, half))

    return np.asarray(jax.jit(lambda x: jax.lax.fori_loop(
        0, reps, body, x).astype(jnp.float32))(x))


@pytest.mark.parametrize("name,reps,rtol", [("bf16", 16, 0.0),
                                            ("f32", 4, 1e-5)])
def test_reference_matches_jax(name, reps, rtol):
    jdt, tdt = {"bf16": (jnp.bfloat16, torch.bfloat16),
                "f32": (jnp.float32, torch.float32)}[name]
    ref = _jax_mix(X, reps, jdt)
    out = mix_reference(torch.tensor(X), reps, tdt).numpy()
    assert out.dtype == np.float32 and out.shape == X.shape
    np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
    assert np.isfinite(ref).any()
    fin = np.isfinite(ref)
    np.testing.assert_allclose(out[fin], ref[fin], rtol=rtol, atol=0)


def test_wrapper_takes_plain_version_for_cpu_tensors():
    x = torch.tensor(X[:8, :16])
    before = mix.launches
    for dt in (torch.float32, torch.bfloat16):
        torch.testing.assert_close(mix(x, 8, dt), mix_reference(x, 8, dt),
                                   rtol=0, atol=0)
    assert mix.launches == before
    with pytest.raises(ValueError, match="dtype"):
        mix(x, 8, torch.float16)
    assert MIX_OPS == 12  # the tool's count per element and round
