"""Build the port's CUDA sources into shared libraries and load them.

Each kernel is plain CUDA C++ under ``repro_torch/csrc/`` with an
``extern "C"`` entry point.  At first use it is compiled by ``nvcc`` for
``sm_90a`` into ``build/repro_torch/`` at the root of the checkout (listed
in ``.gitignore``), named by a hash of its sources and flags so an edit
rebuilds and an unchanged source loads the cached library, then loaded
with ``ctypes``.  No PyTorch headers are compiled, so a build takes
seconds.

A missing ``nvcc`` or a failed build raises: nothing falls back to a
kernel's plain version.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for path in candidates:
        if path and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (searched PATH and CUDA_HOME): the repro_torch CUDA "
        "kernels are compiled at first use and need the CUDA toolkit")


def library_path(name: str, sources: Sequence[str]) -> Path:
    """Compile ``sources`` (file names under csrc/) unless cached; return
    the shared library's path.  The compiler's log, ptxas register and
    shared-memory report included, sits beside it as ``.log``."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    paths = [CSRC / s for s in sources]
    for p in paths:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    out = BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, paths)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {name} failed ({' '.join(cmd)}):\n"
                           f"{proc.stdout}{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)              # atomic: concurrent builds agree
    return out


@functools.lru_cache(maxsize=None)
def load(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """Build if needed and load once per process."""
    return ctypes.CDLL(str(library_path(name, tuple(sources))))
