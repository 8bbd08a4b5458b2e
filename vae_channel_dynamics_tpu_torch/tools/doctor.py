"""Environment self-check: ``python -m vae_channel_dynamics_tpu_torch.tools.doctor
[--device cuda]``. The port of ``vae_channel_dynamics_tpu/tools/doctor.py``,
with the TPU checks replaced by the card's.

Diagnoses the setup problems that would stop a run on the GPU before it
starts: a CPU-only torch build, no visible card, no ``nvcc``, a build
directory that cannot be written, a kernel library that does not build
(``ops/_cuda_build.py`` builds each ``csrc/*.cu`` for ``sm_90a`` at its
first launch), a native decode library that does not build with g++
(``data/native.py``: with libjpeg/libpng, else preprocess-only, a warning),
and the card's name and power limit as ``nvidia-smi`` reports them. With ``--device cuda`` it also times the dispatch round trip
and a calibration bf16 matmul with CUDA events.

Prints one ``ok | warn | FAIL`` line per check; exits nonzero if any FAIL.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List

_RESULTS: List[str] = []


def _report(status: str, name: str, detail: str = "") -> None:
    _RESULTS.append(status)
    pad = {"ok": "  ok  ", "warn": " warn ", "FAIL": " FAIL "}[status]
    print(f"[{pad}] {name}" + (f": {detail}" if detail else ""), flush=True)


def check_versions() -> None:
    import numpy as np
    import torch

    _report("ok", "versions", f"python {sys.version.split()[0]}, torch {torch.__version__}, "
            f"numpy {np.__version__}")


def check_torch_cuda() -> bool:
    import torch

    if torch.version.cuda is None:
        _report("FAIL", "torch CUDA build", f"torch {torch.__version__} is built without CUDA")
        return False
    _report("ok", "torch CUDA build", f"CUDA {torch.version.cuda}, cuDNN "
            f"{torch.backends.cudnn.version()}")
    if not torch.cuda.is_available():
        _report("FAIL", "CUDA device", "torch sees no CUDA device")
        return False
    _report("ok", "CUDA device", f"{torch.cuda.device_count()} x "
            f"{torch.cuda.get_device_name(0)}, capability "
            f"{'.'.join(map(str, torch.cuda.get_device_capability(0)))}")
    return True


def check_nvcc() -> bool:
    from ..ops import _cuda_build

    try:
        nvcc = _cuda_build.find_nvcc()
    except RuntimeError as e:
        _report("FAIL", "nvcc", str(e))
        return False
    proc = subprocess.run([nvcc, "--version"], capture_output=True, text=True)
    lines = proc.stdout.strip().splitlines()
    _report("ok" if proc.returncode == 0 else "FAIL", "nvcc",
            f"{nvcc}: {lines[-1] if lines else proc.stderr.strip()}")
    return proc.returncode == 0


def check_build_dir() -> bool:
    from ..ops import _cuda_build

    try:
        os.makedirs(_cuda_build.BUILD_DIR, exist_ok=True)
        probe = os.path.join(_cuda_build.BUILD_DIR, f".doctor_probe.{os.getpid()}")
        with open(probe, "w") as f:
            f.write("x")
        os.remove(probe)
    except OSError as e:
        _report("FAIL", "build directory", f"{_cuda_build.BUILD_DIR} not writable: {e}")
        return False
    _report("ok", "build directory", _cuda_build.BUILD_DIR)
    return True


def libraries() -> List[str]:
    """The kernel libraries ``ops/_cuda_build.py`` builds: one a ``csrc/*.cu``."""
    from ..ops import _cuda_build

    return sorted(f[:-3] for f in os.listdir(_cuda_build.CSRC_DIR) if f.endswith(".cu"))


def check_libraries(can_build: bool) -> None:
    """Each library built (all at once, as chip_smoke.py builds them) and
    loaded, or found already built."""
    from ..ops import _cuda_build

    names = libraries()
    if not can_build:
        for name in names:
            _report("FAIL", f"library {name}", "not built: no nvcc or no writable build dir")
        return

    def build(name: str):
        t0 = time.perf_counter()
        try:
            _cuda_build.load(name)
            return name, None, time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 — reported as the check's FAIL
            return name, e, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        results = list(pool.map(build, names))
    for name, error, seconds in results:
        if error is not None:
            _report("FAIL", f"library {name}", str(error).splitlines()[0])
        elif _cuda_build.build_seconds.get(name):
            _report("ok", f"library {name}", f"built in {seconds:.1f} s")
        else:
            _report("ok", f"library {name}", "already built, loaded")


def check_native() -> None:
    """The native decode library builds and runs: ``preprocess_image`` on
    an 8px array and, with the decode linked, ``decode_preprocess`` on a
    JPEG written in memory by PIL (JAX ``tools/doctor.py``'s check)."""
    import io

    import numpy as np

    from ..data import native

    try:
        native.get_lib()
    except native.NativeBuildError as e:
        _report("FAIL", "native preprocess", str(e).replace("\n", " | "))
        return
    arr = np.full((16, 20, 3), 128, np.uint8)
    out = native.preprocess_image(arr, 8)
    if out.shape != (8, 8, 3):
        _report("FAIL", "native preprocess", f"bad output shape {out.shape}")
        return
    if not native.decode_available():
        _report("warn", "native preprocess",
                "preprocess-only (libjpeg/libpng not linked); PIL decodes")
        return
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "JPEG")
    dec = native.decode_preprocess(buf.getvalue(), 8)
    status = "ok" if dec.shape == (8, 8, 3) and np.isfinite(dec).all() else "FAIL"
    _report(status, "native preprocess", "decode+preprocess path active")


def check_nvidia_smi() -> None:
    cmd = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        _report("FAIL", "nvidia-smi", f"{' '.join(cmd)}: {e}")
        return
    out = proc.stdout.strip()
    if proc.returncode != 0 or not out:
        _report("FAIL", "nvidia-smi", f"exit {proc.returncode}: {proc.stderr.strip()}")
        return
    _report("ok", "card (nvidia-smi name, power limit)", out.replace("\n", "; "))


def check_device(device: str) -> None:
    """The dispatch round trip of a small op and a bf16 matmul's rate, both
    timed with CUDA events."""
    import torch

    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        _report("FAIL", "device probes", f"need a CUDA device, got {device!r}")
        return
    dev = torch.device(device)
    x = torch.ones((8, 8), device=dev)
    float(x.sum())
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    val = float(x.sum())
    rtt = time.perf_counter() - t0
    if val != 64.0:
        _report("FAIL", "device round trip", f"sum said {val}")
        return
    start.record()
    for _ in range(100):
        x.add_(0.0)
    end.record()
    end.synchronize()
    _report("ok", "device round trip", f"{rtt * 1e3:.3f} ms launch+compute+copy (host clock); "
            f"{start.elapsed_time(end) * 10:.2f} us a small kernel (CUDA events, 100 in a row)")
    n = 8192
    a = torch.randn((n, n), device=dev, dtype=torch.bfloat16)
    for _ in range(3):
        a @ a
    start.record()
    for _ in range(10):
        a @ a
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / 10
    _report("ok", "matmul calibration", f"{2 * n ** 3 / (ms * 1e-3) / 1e12:.0f} TFLOP/s bf16 "
            f"{n}^3 ({ms:.3f} ms, CUDA events)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Environment self-check.")
    parser.add_argument("--device", default=None,
                        help="Also probe this device (cuda or cuda:N): the dispatch round "
                        "trip and a bf16 matmul, timed with CUDA events.")
    args = parser.parse_args(argv)
    _RESULTS.clear()

    check_versions()
    cuda = check_torch_cuda()
    nvcc = check_nvcc()
    writable = check_build_dir()
    check_libraries(nvcc and writable)
    check_native()
    check_nvidia_smi()
    if args.device is not None:
        if cuda:
            check_device(args.device)
        else:
            _report("FAIL", "device probes", f"no CUDA device for {args.device!r}")

    fails = _RESULTS.count("FAIL")
    warns = _RESULTS.count("warn")
    print(f"\n{len(_RESULTS)} checks: {fails} failed, {warns} warnings")
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
