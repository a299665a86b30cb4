"""The port imports no JAX: every module under
editable_gaussian_reflections_tpu_torch/tools/, every other module of the
package, and chip_smoke.py import in a child process where `jax`, `optax`
and `editable_gaussian_reflections_tpu` are None in sys.modules (an import
of any of them raises there).  Nothing may raise.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = "editable_gaussian_reflections_tpu_torch"

CHILD = r"""
import importlib, importlib.util, pathlib, sys
for name in ("jax", "optax", "editable_gaussian_reflections_tpu"):
    sys.modules[name] = None
which, package, root = sys.argv[1], sys.argv[2], pathlib.Path(sys.argv[3])
if which == "chip_smoke":
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_module", root / "chip_smoke.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    names = ["chip_smoke.py"]
else:
    names = []
    for path in sorted((root / package).rglob("*.py")):
        parts = path.relative_to(root).with_suffix("").parts
        if (parts[1] == "tools") != (which == "tools"):
            continue
        names.append(".".join(parts[:-1] if parts[-1] == "__init__"
                              else parts))
    assert names, which
    for name in names:
        importlib.import_module(name)
print(len(names), "modules imported")
"""


@pytest.mark.parametrize("which", ["tools", "package", "chip_smoke"])
def test_port_modules_import_without_jax(which):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    done = subprocess.run(
        [sys.executable, "-c", CHILD, which, PACKAGE, str(ROOT)], env=env,
        cwd=str(ROOT), capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-4000:]
    count = int(done.stdout.split()[-3])
    if which == "tools":
        # the five tools of this slice are among them
        for tool in ("make_room_dataset", "denoiser_eval", "eval_sweep",
                     "denoise_train", "colmap2nerf"):
            assert (ROOT / PACKAGE / "tools" / f"{tool}.py").is_file()
        assert count >= len(list((ROOT / PACKAGE / "tools").glob("*.py")))
