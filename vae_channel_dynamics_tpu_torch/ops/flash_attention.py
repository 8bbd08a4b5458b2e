"""Flash-attention forward for the VAE mid block, on a hand-written CUDA kernel.

Counterpart of ``vae_channel_dynamics_tpu/ops/pallas_attention.py``: its
forward ``_flash_kernel`` without the log-sum-exp output (the serving path
never needs it) becomes ``csrc/flash_attention_fwd.cu``, a CUDA C++ kernel
for Hopper (``sm_90a``) built by ``nvcc`` at first use and called through
``ctypes`` (``ops/_cuda_build.py``).

What bounds it on the H100, and what the design does about it: at the mid
block's C = 512 the op does ``4*B*N^2*C`` FLOPs against about ``8*B*N*C``
bytes of q/k/v/o traffic, N/2 FLOPs per byte, so it is tensor-core bound at
every token count the serving path uses (N = 4096 at 512px, 16384 at 1024px).
The kernel keeps the (32 x 64) logits tile and the fp32 running max,
denominator and output accumulator on chip, so no O(N^2) buffer exists and
device memory sees only the linear traffic; its products run on bf16 tensor
cores (``mma.sync``). The source's header comment has the tile layout.

On a CPU tensor :func:`flash_attention` computes
:func:`flash_attention_reference`, the plain PyTorch version of the same
function. On a CUDA tensor it launches the kernel or raises; nothing falls
back. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda_build

KERNEL_NAME = "flash_attention_fwd"
# The kernel's channel widths: its output accumulator lives in registers, split
# over 8 warps by columns, so each width is a compiled instantiation; 512 (the
# SDXL/SD mid block) is the widest that keeps it at 64 fp32 per thread.
SUPPORTED_CHANNELS = (128, 256, 384, 512)
TOKEN_MULTIPLE = 128

# kernel launches in this process; only the CUDA branch below adds to it
launches = 0

_fn = None  # the kernel's ctypes function, bound at first launch


def eligible(num_tokens: int, channels: int) -> bool:
    """Shapes the CUDA kernel takes: tokens a multiple of 128 (the JAX
    kernel's smallest block; the CUDA kernel itself tiles by 32 queries and
    64 keys) and channels in :data:`SUPPORTED_CHANNELS`. The JAX kernel takes
    any multiple of 128 channels; the register-resident accumulator limits
    this one to 512, and wider heads resolve to ``chunked``."""
    return (
        num_tokens > 0
        and num_tokens % TOKEN_MULTIPLE == 0
        and channels in SUPPORTED_CHANNELS
    )


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """Plain PyTorch ``softmax(q k^T * scale) v`` with the kernel's casts:
    fp32 logits and softmax, probabilities cast to the input dtype before the
    product with ``v``. ``(B, N, C)`` in, ``(B, N, C)`` of ``out_dtype`` out."""
    logits = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(p, v).to(out_dtype)


def _kernel():
    global _fn
    if _fn is None:
        lib = _cuda_build.load(KERNEL_NAME)
        fn = lib.vcd_flash_attention_fwd_bf16
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        lib.vcd_cuda_error_string.argtypes = [ctypes.c_int]
        lib.vcd_cuda_error_string.restype = ctypes.c_char_p
        _fn = fn
    return _fn


def build() -> None:
    """Build (or find built) and load the kernel library."""
    _kernel()


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """Single-head ``softmax(q @ k^T * scale) @ v`` over ``(B, N, C)``.

    CPU tensors go to :func:`flash_attention_reference`. CUDA tensors go to
    the kernel, which takes contiguous bf16 q/k/v of one shape, a bf16
    ``out_dtype`` and an :func:`eligible` shape; anything else raises."""
    global launches
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale, out_dtype)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: unsupported device {q.device}")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)) or out_dtype != torch.bfloat16:
        raise NotImplementedError(
            "the CUDA flash-attention kernel takes bf16 q/k/v and a bf16 "
            f"output, got {q.dtype}/{k.dtype}/{v.dtype} -> {out_dtype}; the "
            "serving path runs bf16 (use attn_impl='naive' or 'chunked' for "
            "fp32)"
        )
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            "flash_attention expects q, k, v of one (B, N, C) shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not all(t.device == q.device for t in (k, v)):
        raise ValueError("flash_attention: q, k, v on different devices")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    b, n, c = q.shape
    if not eligible(n, c):
        raise ValueError(
            f"flash_attention: shape (B={b}, N={n}, C={c}) is not eligible: "
            f"N must be a multiple of {TOKEN_MULTIPLE} and C one of "
            f"{SUPPORTED_CHANNELS}"
        )
    fn = _kernel()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, n, c, float(scale), stream)
    if rc != 0:
        msg = _cuda_build.load(KERNEL_NAME).vcd_cuda_error_string(rc)
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {rc} "
            f"({msg.decode() if msg else 'unknown'})"
        )
    launches += 1
    return out


__all__ = ["eligible", "flash_attention", "flash_attention_reference"]
