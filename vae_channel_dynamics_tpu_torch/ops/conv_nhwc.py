"""The NHWC 3x3 convolution with bias, on a hand-written CUDA kernel.

Counterpart of the Pallas prototype in ``experiments/conv_bench.py``: both of
its formulations, ``_conv_kernel_v9`` (:34, nine shifted ``(tile_h*W, Cin) @
(Cin, Cout)`` products) and ``_conv_kernel_v3`` (:72, three products over the
dx-concatenated window), become the one CUDA kernel ``conv3x3_nhwc`` in
``csrc/conv_nhwc.cu`` (sm_90a, built by ``nvcc`` at first use and called
through ``ctypes``, ``ops/_cuda_build.py``). v3's weight keeps v9's K order
(dx-major, then Cin), so in an implicit GEMM over K = 9 * Cin the two are the
same loop; the source's header has the design.

The layout is the prototype's: x NHWC ``(N, H, W, Cin)``, w HWIO ``(3, 3,
Cin, Cout)``, bias ``(Cout,)``, y NHWC ``(N, H, W, Cout)``; SAME padding,
fp32 accumulation, the bias added in fp32, y rounded once to x's dtype. No
activation is transposed. The JAX prototype has no VJP, so neither has this.

:func:`conv3x3_nhwc_reference` is the plain version: the nine shifted fp32
products of the JAX kernel's body, summed in its order, then the bias. On a
CPU tensor :func:`conv3x3_nhwc` runs it; on a CUDA tensor the kernel runs or
the call raises (bf16 only, :func:`eligible` shapes). On the card the plain
version's fp32 products need TF32 off to be the reference (PyTorch's default
for matmul). ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _cuda_build

LIBRARY = "conv_nhwc"
KERNELS = ("conv3x3_nhwc",)
CIN_MULTIPLE = 32   # the kernel's smallest K chunk
COUT_MULTIPLE = 64  # half the kernel's output-channel tile, masked past Cout
TILE_PIXELS = 128   # the kernel's M tile: a rectangle of 128 pixels of one image

# kernel launches in this process; only the CUDA branch below adds to it
launches: Dict[str, int] = {name: 0 for name in KERNELS}

_P, _I = ctypes.c_void_p, ctypes.c_int
_fns: Dict[str, object] = {}  # ctypes functions, bound at first launch


def eligible(x, cout: int) -> bool:
    """Shapes the CUDA kernel takes, for NHWC ``x`` (a tensor or a shape):
    Cin a multiple of 32, Cout a multiple of 64, any H and W, N up to
    65535."""
    shape = tuple(getattr(x, "shape", x))
    if len(shape) != 4:
        return False
    n, h, w, cin = shape
    return (1 <= n <= 65535 and h >= 1 and w >= 1 and cin >= CIN_MULTIPLE
            and cin % CIN_MULTIPLE == 0 and cout >= COUT_MULTIPLE
            and cout % COUT_MULTIPLE == 0)


def pixel_tile(h: int, w: int) -> Tuple[int, int]:
    """The kernel's pixel rectangle ``(rows, cols)`` for an H x W image:
    cols a power of two, rows * cols = 128, the one that covers the image
    with the fewest pixels (the widest among equals)."""
    best = None
    for cols in (128, 64, 32, 16, 8, 4, 2, 1):
        rows = TILE_PIXELS // cols
        covered = -(-h // rows) * rows * -(-w // cols) * cols
        if best is None or covered < best[0]:
            best = (covered, rows, cols)
    return best[1], best[2]


def conv3x3_nhwc_reference(x: torch.Tensor, w: torch.Tensor,
                           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX kernel's body in PyTorch: y = sum over (dy, dx) of the
    zero-padded window shifted by (dy, dx), times ``w[dy, dx]``, in fp32 on
    the weight rounded to x's dtype, plus the bias in fp32, rounded once to
    x's dtype."""
    n, h, wd, cin = x.shape
    cout = w.shape[-1]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))  # (N, H+2, W+2, Cin)
    wf = w.to(x.dtype).float()
    acc = torch.zeros((n * h * wd, cout), dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            win = xp[:, dy:dy + h, dx:dx + wd, :].reshape(n * h * wd, cin)
            acc += win @ wf[dy, dx]
    if bias is not None:
        acc += bias.float()
    return acc.reshape(n, h, wd, cout).to(x.dtype)


def _fn():
    fn = _fns.get("conv3x3_nhwc")
    if fn is None:
        lib = _cuda_build.load(LIBRARY)
        fn = lib.vcd_conv3x3_nhwc
        fn.argtypes = [_P] * 4 + [_I] * 6 + [_P]
        fn.restype = ctypes.c_int
        lib.vcd_conv_nhwc_error_string.argtypes = [ctypes.c_int]
        lib.vcd_conv_nhwc_error_string.restype = ctypes.c_char_p
        _fns["conv3x3_nhwc"] = fn
    return fn


def build() -> None:
    """Build (or find built) and load the kernel library."""
    _fn()


def _check(x: torch.Tensor, w: torch.Tensor,
           bias: Optional[torch.Tensor]) -> Tuple[int, int, int, int, int]:
    name = "conv3x3_nhwc"
    if x.device.type != "cuda":
        raise RuntimeError(f"{name}: unsupported device {x.device}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise NotImplementedError(
            f"{name}: the CUDA kernel takes bf16 x and w, got {x.dtype} and {w.dtype}"
        )
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, x.shape[-1]):
        raise ValueError(f"{name}: x must be NHWC and w HWIO (3, 3, Cin, Cout) over x's "
                         f"channels, got {tuple(x.shape)} and {tuple(w.shape)}")
    n, h, wd, cin = x.shape
    cout = w.shape[-1]
    if not eligible(x, cout):
        raise ValueError(
            f"{name}: shape {tuple(x.shape)} -> {cout} channels is not eligible: Cin must "
            f"be a multiple of {CIN_MULTIPLE} and Cout of {COUT_MULTIPLE}"
        )
    if bias is not None and (tuple(bias.shape) != (cout,) or bias.device != x.device):
        raise ValueError(f"{name}: bias must be ({cout},) on {x.device}, got "
                         f"{tuple(bias.shape)} on {bias.device}")
    for what, t in (("x", x), ("w", w)):
        if t.device != x.device:
            raise ValueError(f"{name}: {what} is on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be contiguous and 16-byte aligned")
    return n, h, wd, cin, cout


def conv3x3_nhwc(x: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``conv3x3_SAME(x, w) + bias`` over NHWC ``x`` and HWIO ``w``: the
    kernel on a CUDA tensor (bf16, :func:`eligible` shapes, else it
    raises), :func:`conv3x3_nhwc_reference` on a CPU tensor."""
    if x.device.type == "cpu":
        return conv3x3_nhwc_reference(x, w, bias)
    n, h, wd, cin, cout = _check(x, w, bias)
    b32 = (torch.zeros(cout, dtype=torch.float32, device=x.device) if bias is None
           else bias.float().contiguous())
    y = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    _rows, cols = pixel_tile(h, wd)
    fn = _fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), w.data_ptr(), b32.data_ptr(), y.data_ptr(), n, h, wd, cin, cout,
                cols, stream)
    if rc != 0:
        msg = _cuda_build.load(LIBRARY).vcd_conv_nhwc_error_string(rc)
        raise RuntimeError(f"conv3x3_nhwc kernel launch failed: CUDA error {rc} "
                           f"({msg.decode() if msg else 'unknown'})")
    launches["conv3x3_nhwc"] += 1
    return y


__all__ = [
    "KERNELS",
    "build",
    "conv3x3_nhwc",
    "conv3x3_nhwc_reference",
    "eligible",
    "launches",
    "pixel_tile",
]
