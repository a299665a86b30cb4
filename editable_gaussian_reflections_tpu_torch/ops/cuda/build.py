"""Build the CUDA sources at first use and load them with ctypes.

Each csrc/<name>.cu is compiled by nvcc into a shared library with a plain C
interface, under build/kernels/ beside the package (a directory git
ignores).  A measurement tool may build a source of its own directory the
same way, with csrc/ on the include path.  The library's file name carries a hash of the sources and flags,
so an edited source is rebuilt and a stale library is never loaded.  Nothing
here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

# sm_90a: Hopper with its architecture-specific instructions.  No fast math
# and no FMA contraction, so a kernel rounds like its plain PyTorch version
# (ops/precision.py; csrc/render_culled.cu says what FMA changes there).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-fmad=false", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """nvcc of the CUDA toolkit PyTorch finds (CUDA_HOME, CUDA_PATH, PATH)."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None or not (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path(name: str, src_dir: Path | None = None) -> Path:
    """Where <src_dir>/<name>.cu (csrc/ by default) is built, keyed by the
    sources it may include and the flags."""
    src_dir = Path(src_dir or CSRC)
    h = hashlib.sha256()
    for src in sorted({*CSRC.glob("*.cu*"), *src_dir.glob("*.cu*")}):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names, src_dir: Path | None = None) -> list[Path]:
    """Compile each <src_dir>/<name>.cu (csrc/ by default) whose library
    does not exist yet, one nvcc process per source, all started together;
    returns the libraries' paths in the order of `names`.

    The compiler's output (registers, spills from -Xptxas -v) is kept
    beside each library as <library>.log."""
    src_dir = Path(src_dir or CSRC)
    outs = [library_path(name, src_dir) for name in names]
    jobs = []
    try:
        for name, out in zip(names, outs):
            if out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
                   str(src_dir / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((name, out, tmp, proc))
        failed = []
        for name, out, tmp, proc in jobs:
            log, _ = proc.communicate()
            out.with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {name}.cu (rc "
                              f"{proc.returncode}):\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for _name, _out, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return outs


def build(name: str, src_dir: Path | None = None) -> Path:
    """Compile <src_dir>/<name>.cu unless its library exists; returns its
    path."""
    return build_all([name], src_dir)[0]


@functools.cache
def load(name: str, src_dir: Path | None = None) -> ctypes.CDLL:
    """Build (once) and load <src_dir>/<name>.cu's library."""
    return ctypes.CDLL(str(build(name, src_dir)))
