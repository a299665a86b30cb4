"""Nothing the benchmark runs imports JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), and the reference imports nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

from perfbench.run import FORBIDDEN

HERE = Path(__file__).resolve().parents[1]
REPO = HERE.parent
PORT = "editable_gaussian_reflections_tpu_torch"


def imported_tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_source_of_the_benchmark_imports_jax():
    for path in HERE.rglob("*.py"):
        assert not imported_tops(path) & set(FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        tops = imported_tops(path)
        assert PORT not in tops and not tops & set(FORBIDDEN), path
    for path in [HERE / "check.py", HERE / "controls.py",
                 *(HERE / "kinds").glob("*.py")]:
        assert PORT not in imported_tops(path), path


def _modules_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=REPO, capture_output=True, text=True, check=True, timeout=300)
    return set(out.stdout.split())


def test_loading_the_harness_and_the_program_loads_no_jax():
    tops = _modules_after(
        "import perfbench.run, perfbench.drivers, perfbench.check, "
        "perfbench.calibrate, perfbench.controls\n"
        "from perfbench import program, registry\nprogram.load()\n"
        "[registry.kind(k) for k in ('train', 'frames')]")
    assert PORT in tops
    assert not tops & set(FORBIDDEN), tops & set(FORBIDDEN)


def test_loading_the_reference_loads_nothing_of_the_program():
    tops = _modules_after(
        "import perfbench.reference.training, "
        "perfbench.reference.renderer.raytracer, perfbench.check, "
        "perfbench.controls\nfrom perfbench import registry\n"
        "[registry.kind(k) for k in ('train', 'frames')]")
    assert PORT not in tops and not tops & set(FORBIDDEN)
