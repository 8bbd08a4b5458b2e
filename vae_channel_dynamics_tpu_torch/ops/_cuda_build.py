"""Build and load the port's hand-written CUDA kernels.

Each library is one ``csrc/<name>.cu`` file with a plain C interface (it may
include the shared ``csrc/*.cuh`` headers). On first
use it is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library
under ``build/torch_kernels/`` at the repository root and loaded with
``ctypes``. The library's file name carries a hash of the source, so an
edited ``.cu`` builds anew. Importing this module builds nothing and needs no
``nvcc``; a missing compiler or a failed build raises when a kernel is first
called on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # registers, shared memory and spills per kernel, kept in the build log
    "-Xptxas", "-v",
)

# one lock per library, so that two libraries build at the same time
_locks: Dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# seconds each library took to build in this process (0.0 when it was found
# already built) and nvcc's output when it was built, for chip_smoke.py
build_seconds: Dict[str, float] = {}
build_logs: Dict[str, str] = {}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the default
    toolkit location. Raises when none exists."""
    candidates = []
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for cand in candidates:
        if os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (looked at $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built"
    )


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to: the name carries a hash of the
    source, of every shared header in ``csrc/`` and of the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def _build(name: str, out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    # compile to a private name, then rename: concurrent processes never load
    # a half-written library
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {name} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    build_seconds[name] = time.perf_counter() - t0
    build_logs[name] = proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed.
    Different libraries may be loaded from different threads at once."""
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib: Optional[ctypes.CDLL] = _loaded.get(name)
        if lib is not None:
            return lib
        out = library_path(name)
        if os.path.exists(out):
            build_seconds[name] = 0.0
        else:
            _build(name, out)
        lib = ctypes.CDLL(out)
        _loaded[name] = lib
        return lib
