"""ctypes binding for the native C++ decode and preprocess
(``csrc/preprocess.cpp``, ``csrc/decode.cpp``).

The port's copy of ``vae_channel_dynamics_tpu/data/native.py``: the same C
ABI (``vcd_preprocess_image``, ``vcd_decode_preprocess``), the same g++
flags and the same two builds, tried in order: with the JPEG/PNG decode
linked against libjpeg and libpng, then the preprocess kernel alone. It
builds the port's own copies of the two sources, at first use, into
``build/torch_kernels/`` under a name that carries a hash of the sources,
the compiler command and the host CPU (``-march=native`` code runs only on
the CPU it was built for); it compiles to a private name and renames, so
that two processes never load a half-written library.

Unlike the JAX binding, a build that fails both ways raises
:class:`NativeBuildError`, which names each compiler command and its
stderr, instead of leaving the caller to fall back to PIL: a run that asks
for the native loader never measures PIL under its name.
:func:`available` turns that error into ``False`` for the callers that only
ask.

``counts`` records which path each image took in the native transform
(``data/pipeline.py``): ``decode`` (the fused decode and preprocess),
``preprocess`` (a decoded array through the preprocess kernel) and ``pil``
(an input the native code does not take, sent to the PIL transform).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import platform
import subprocess
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
# beside the CUDA libraries (ops/_cuda_build.py)
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
SRC = os.path.join(_CSRC_DIR, "preprocess.cpp")
SRC_DECODE = os.path.join(_CSRC_DIR, "decode.cpp")

CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

# images per path taken by the native transform in this process
counts: Dict[str, int] = {"decode": 0, "preprocess": 0, "pil": 0}
_counts_lock = threading.Lock()

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_key: Optional[Tuple[object, ...]] = None
_error: Optional["NativeBuildError"] = None
# "decode" or "preprocess-only": which of the two builds was loaded
build_kind: Optional[str] = None


class NativeBuildError(RuntimeError):
    """Neither build of the native library compiled and loaded."""


def count(path: str) -> None:
    """Add one image to ``counts[path]``."""
    with _counts_lock:
        counts[path] += 1


def reset_counts() -> None:
    with _counts_lock:
        for key in counts:
            counts[key] = 0


@functools.lru_cache(maxsize=1)
def _host_cpu() -> str:
    """The CPU's model name and feature flags, which ``-march=native``
    compiles for."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [line for line in f if line.startswith(("model name", "flags"))]
        return "".join(lines[:2])
    except OSError:
        return platform.processor()


def _attempts() -> List[Tuple[str, List[str]]]:
    """(kind, compiler command without ``-o``) of the two builds, in order."""
    base = [CXX, *CXX_FLAGS]
    return [
        ("decode", base + [SRC, SRC_DECODE, "-ljpeg", "-lpng"]),
        ("preprocess-only", base + [SRC]),
    ]


def library_path(cmd: Sequence[str]) -> str:
    """Where ``cmd`` builds to: the name carries a hash of the sources it
    compiles, the command and the host CPU."""
    digest = hashlib.sha256(" ".join(cmd).encode())
    digest.update(platform.machine().encode())
    digest.update(_host_cpu().encode())
    for src in (SRC, SRC_DECODE):
        if src in cmd:
            with open(src, "rb") as f:
                digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libvcdprep-{digest.hexdigest()[:16]}.so")


def _build(cmd: List[str], out: str) -> Optional[str]:
    """Compile ``cmd`` into ``out``; the failure's description, or None."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    full = cmd + ["-o", tmp]
    try:
        proc = subprocess.run(full, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{' '.join(full)}\n{e}"
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        return f"{' '.join(full)} (exit {proc.returncode})\n{proc.stderr.strip()}"
    os.replace(tmp, out)
    return None


def _bind(lib: ctypes.CDLL) -> None:
    lib.vcd_preprocess_image.restype = ctypes.c_int
    lib.vcd_preprocess_image.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
    ]
    if hasattr(lib, "vcd_decode_preprocess"):
        lib.vcd_decode_preprocess.restype = ctypes.c_int
        lib.vcd_decode_preprocess.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
            ctypes.c_int,
        ]


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed: the build with decode,
    else the preprocess-only one. Raises :class:`NativeBuildError` with
    every compiler command and its stderr when neither builds."""
    global _lib, _lib_key, _error, build_kind
    # what the library depends on besides its sources, which do not change
    # while the process runs
    key = (CXX, CXX_FLAGS, BUILD_DIR)
    if _lib_key == key and _lib is not None:
        return _lib
    with _lock:
        if _lib_key == key:
            if _error is not None:
                raise _error
            return _lib
        failures = []
        for kind, cmd in _attempts():
            out = library_path(cmd)
            if not os.path.exists(out):
                failure = _build(cmd, out)
                if failure is not None:
                    failures.append(failure)
                    continue
            try:
                lib = ctypes.CDLL(out)
            except OSError as e:
                failures.append(f"loading {out}: {e}")
                continue
            _bind(lib)
            if failures:
                logger.warning("Native decode did not build; preprocess only:\n%s",
                               "\n".join(failures))
            logger.info("Native preprocess library (%s): %s", kind, out)
            _lib, _lib_key, _error, build_kind = lib, key, None, kind
            return lib
        _lib, _lib_key, build_kind = None, key, None
        _error = NativeBuildError(
            "the native preprocess library did not build:\n" + "\n".join(failures))
        raise _error


def available() -> bool:
    """True when the library builds (or is built) and loads."""
    try:
        get_lib()
    except NativeBuildError:
        return False
    return True


def decode_available() -> bool:
    """True when the library was linked against libjpeg/libpng and can run
    the fused decode+preprocess path."""
    return available() and hasattr(get_lib(), "vcd_decode_preprocess")


def decode_preprocess(data: bytes, out_res: int, dct_scaling: bool = True) -> np.ndarray:
    """JPEG/PNG bytes -> float32 (out_res, out_res, 3) in [-1, 1], decoded
    and preprocessed in one native call. ``dct_scaling`` lets libjpeg decode
    at 1/2-1/8 size when the source is much larger than the target (the
    resample filter still runs). Raises ``RuntimeError`` on containers and
    colour spaces the decoder does not take (the transform sends those to
    PIL)."""
    lib = get_lib()
    if not hasattr(lib, "vcd_decode_preprocess"):
        raise RuntimeError("native decode unavailable: the library was built "
                           "preprocess-only (libjpeg/libpng did not link)")
    buf = np.frombuffer(data, np.uint8)
    dst = np.empty((out_res, out_res, 3), np.float32)
    rc = lib.vcd_decode_preprocess(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(data),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out_res,
        1 if dct_scaling else 0,
    )
    if rc != 0:
        raise RuntimeError(f"native decode failed with code {rc}")
    return dst


def preprocess_image(img_hwc_uint8: np.ndarray, out_res: int) -> np.ndarray:
    """uint8 HWC (1 or 3 channels) -> float32 (out_res, out_res, 3) in [-1, 1]."""
    lib = get_lib()
    src = np.ascontiguousarray(img_hwc_uint8)
    if src.ndim == 2:
        src = src[:, :, None]
    if src.dtype != np.uint8 or src.ndim != 3 or src.shape[2] not in (1, 3):
        raise ValueError(f"Unsupported image array: {src.shape} {src.dtype}")
    h, w, c = src.shape
    dst = np.empty((out_res, out_res, 3), np.float32)
    rc = lib.vcd_preprocess_image(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h, w, c,
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out_res,
    )
    if rc != 0:
        raise RuntimeError(f"native preprocess failed with code {rc}")
    return dst
