"""PyTorch port vs the root tools/eval_sweep.py.

Both tools sweep the model directory tests/test_torch_eval_cli.py's
build_model writes (tests/make_synth_dataset.py's views at 24x24, 300
random Gaussians, backend "xla", K 8: the non-fused brute trace on both
sides, JAX's XLA tracer and the port's trace_hits plain version) at --spp 1
2, denoise 0 and 1 (the KPN at these spp), the port with --device cpu fed
the samples JAX draws (view v: fold_in(fold_in(PRNGKey(v), 0), i) for its
sample i).  Every entry of the port's eval_sweep.json is within 0.05 dB of
the root tool's (both round to 0.01 dB), and its iteration, view count and
znear are equal.  Without a card and without --device cpu the tool exits
non-zero.  The JAX side runs in a child process capped at AVX (see
test_torch_render_frame.py).
"""

import json
import os
import shutil
import subprocess
import sys
from unittest import mock

import pytest
import torch

from editable_gaussian_reflections_tpu_torch.renderer import denoise_net as tdn
from editable_gaussian_reflections_tpu_torch.tools import eval_sweep as tsweep
from tests.test_torch_eval_cli import build_model
from tests.test_torch_room_dataset import (
    child_env,
    jax_samples_fed,
    root_module,
    run_child,
)

torch.set_num_threads(1)

SPPS = (1, 2)
N_VIEWS = 2        # build_model's test views
PSNR_DB = 0.05


def jax_sweep(model: str):
    os.environ.pop(tdn.WEIGHTS_ENV, None)
    sys.argv = ["eval_sweep"]
    root_module("eval_sweep", "tools/eval_sweep.py").main(
        ["-m", model, "--spp"] + [str(s) for s in SPPS])


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_sweep")
    _data, model = build_model(root)
    jax_model, port_model = root / "jax_model", root / "port_model"
    shutil.copytree(model, jax_model)
    shutil.copytree(model, port_model)
    run_child(__file__, jax_model)
    return dict(jax=jax_model, port=port_model)


def _keys():
    """JAX's keys in the order the port renders: spp, denoise, view,
    sample (render_accumulated_chunked's one chunk, done = 0)."""
    import jax

    return [k for spp in SPPS for _denoise in range(2)
            for v in range(N_VIEWS) for k in sample_keys_of(
                jax.random.fold_in(jax.random.PRNGKey(v), 0), spp)]


def sample_keys_of(key, n: int) -> list:
    import jax

    return [jax.random.fold_in(key, i) for i in range(n)]


def test_eval_sweep_matches_root(models):
    with jax_samples_fed(_keys()), mock.patch.dict(os.environ):
        os.environ.pop(tdn.WEIGHTS_ENV, None)
        ours = tsweep.main(["-m", str(models["port"]), "--spp"]
                           + [str(s) for s in SPPS] + ["--device", "cpu"])
    mine = json.loads((models["port"] / "eval_sweep.json").read_text())
    theirs = json.loads((models["jax"] / "eval_sweep.json").read_text())
    assert mine["results"] == ours
    for k in ("iteration", "n_views", "znear"):
        assert mine[k] == theirs[k], k
    assert theirs["n_views"] == N_VIEWS
    assert list(mine["results"]) == list(theirs["results"]) == [
        f"spp{s}_denoise{d}" for s in SPPS for d in (0, 1)]
    for key, row in theirs["results"].items():
        assert list(mine["results"][key]) == list(row)
        for k, v in row.items():
            assert abs(mine["results"][key][k] - v) <= PSNR_DB + 1e-9, (
                key, k, mine["results"][key][k], v)


def test_tool_needs_a_card_or_the_cpu(models):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default route runs")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsweep.main(["-m", str(models["port"])])
    done = subprocess.run(
        [sys.executable, "-m",
         "editable_gaussian_reflections_tpu_torch.tools.eval_sweep", "-m",
         str(models["port"])], env=child_env(), capture_output=True,
        text=True, timeout=300)
    assert done.returncode != 0 and "device='cpu'" in done.stderr


def test_help_names_the_k_limit():
    done = subprocess.run(
        [sys.executable, "-m",
         "editable_gaussian_reflections_tpu_torch.tools.eval_sweep",
         "--help"], env=child_env(), capture_output=True, text=True,
        timeout=300)
    assert done.returncode == 0 and "K 8, 16, 32 or 64" in done.stdout


if __name__ == "__main__":
    jax_sweep(sys.argv[1])
