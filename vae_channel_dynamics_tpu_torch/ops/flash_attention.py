"""Flash attention for the VAE mid block, forward and backward on hand-written
CUDA kernels.

Counterpart of ``vae_channel_dynamics_tpu/ops/pallas_attention.py``. Its
Pallas kernels become CUDA C++ kernels for Hopper (``sm_90a``), built by
``nvcc`` at first use and called through ``ctypes`` (``ops/_cuda_build.py``):

===========================  ==================================================
CUDA kernel (count key)      replaces
===========================  ==================================================
``flash_attention_fwd``      ``_flash_kernel`` (:136) without the log-sum-exp:
                             the serving forward (``csrc/flash_attention_fwd
                             .cu``)
``flash_attention_fwd_lse``  the same kernel with ``with_lse=True``
                             (:177-178, :203-210): the training forward, which
                             also writes the fp32 per-row ``m + log l``
``flash_attention_bwd_dkv``  ``_flash_bwd_dkv_kernel`` (:304): dK, dV, keys
                             outer, queries inner (``csrc/flash_attention_bwd
                             .cu``)
``flash_attention_bwd_dq``   ``_flash_bwd_dq_kernel`` (:284): dQ, queries outer,
                             keys inner
===========================  ==================================================

What bounds them on the H100, and what the design does about it: at the mid
block's C = 512 the forward does ``4*B*N^2*C`` FLOPs, dK/dV ``8*B*N^2*C``
and dQ ``6*B*N^2*C``, against a few ``B*N*C`` bytes of device-memory
traffic, N/2 FLOPs per byte or more: all four are tensor-core bound at every
token count the model uses (N = 4096 at 512px, 16384 at 1024px). Each keeps
its logits tile and fp32 accumulators on chip, so no O(N^2) buffer exists,
and runs its products on bf16 tensor cores (``mma.sync``). The sources'
header comments have the tile layouts.

:func:`flash_attention` is the op the model calls. With autograd recording
and an input that requires a gradient it runs :class:`_FlashAttention`,
whose forward is the LSE kernel and whose backward is δ = rowsum(dO·O) in
plain PyTorch (as the JAX package leaves it to XLA), then the dK/dV kernel,
then the dQ kernel. Otherwise it runs the serving forward. On CPU tensors
each kernel's plain PyTorch version (``*_reference``) runs in its place; on
a CUDA tensor the kernel launches or the call raises, and nothing falls
back. ``launches`` counts kernel launches per kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from . import _cuda_build

FWD_LIBRARY = "flash_attention_fwd"
BWD_LIBRARY = "flash_attention_bwd"
KERNELS = ("flash_attention_fwd", "flash_attention_fwd_lse",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dq")
# The kernels' channel widths: their accumulators live in registers, split
# over 8 warps by columns, so each width is a compiled instantiation; 512 (the
# SDXL/SD mid block) is the widest that keeps them at 64 fp32 per thread.
SUPPORTED_CHANNELS = (128, 256, 384, 512)
TOKEN_MULTIPLE = 128

# kernel launches in this process, per kernel; only the CUDA branches below
# add to them
launches: Dict[str, int] = {name: 0 for name in KERNELS}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# kernel -> (library, C symbol, argument types)
_SYMBOLS = {
    "flash_attention_fwd": (FWD_LIBRARY, "vcd_flash_attention_fwd_bf16",
                            [_P] * 4 + [_I, _I, _I, _F, _P]),
    "flash_attention_fwd_lse": (FWD_LIBRARY, "vcd_flash_attention_fwd_lse_bf16",
                                [_P] * 5 + [_I, _I, _I, _F, _P]),
    "flash_attention_bwd_dkv": (BWD_LIBRARY, "vcd_flash_attention_bwd_dkv_bf16",
                                [_P] * 8 + [_I, _I, _I, _F, _P]),
    "flash_attention_bwd_dq": (BWD_LIBRARY, "vcd_flash_attention_bwd_dq_bf16",
                               [_P] * 7 + [_I, _I, _I, _F, _P]),
}
_fns: Dict[str, object] = {}  # ctypes functions, bound at first launch


def eligible(num_tokens: int, channels: int) -> bool:
    """Shapes the CUDA kernels take: tokens a multiple of 128 (the JAX
    kernels' smallest block; the CUDA kernels tile by 16, 32 and 64) and
    channels in :data:`SUPPORTED_CHANNELS`. The JAX kernels take any multiple
    of 128 channels; the register-resident accumulators limit these to 512,
    and wider heads resolve to ``chunked``."""
    return (
        num_tokens > 0
        and num_tokens % TOKEN_MULTIPLE == 0
        and channels in SUPPORTED_CHANNELS
    )


# --------------------------------------------------------------------------- #
# Plain versions: the kernels' functions in PyTorch, used for CPU tensors and
# as the card's reference. q, k, v, do: (B, N, C); lse, delta: (B, N) fp32.
# --------------------------------------------------------------------------- #
def _logits(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    return torch.matmul(q.float(), k.float().transpose(1, 2)) * scale


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
    p = torch.softmax(_logits(q, k, scale), dim=-1).to(q.dtype)
    return torch.matmul(p, v).to(out_dtype)


def flash_attention_fwd_lse_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    out_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_reference` plus the fp32 per-row log-sum-exp of
    the scaled logits, ``(B, N)``."""
    logits = _logits(q, k, scale)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(p, v).to(out_dtype), torch.logsumexp(logits, dim=-1)


def _bwd_tiles(q, k, v, do, lse, delta, scale) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX ``_bwd_tile`` over the whole (N, N) at once: P = exp(S - lse) and
    dS = P (dO V^T - delta) scale, each cast to the input dtype (and back to
    fp32 for the products, which accumulate in fp32)."""
    p = torch.exp(_logits(q, k, scale) - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(1, 2))
    ds = p * (dp - delta[..., None]) * scale
    return p.to(q.dtype).float(), ds.to(q.dtype).float()


def flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, scale
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV kernel's function: dK = dS^T Q, dV = P^T dO."""
    p, ds = _bwd_tiles(q, k, v, do, lse, delta, scale)
    dk = torch.matmul(ds.transpose(1, 2), q.float())
    dv = torch.matmul(p.transpose(1, 2), do.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, scale) -> torch.Tensor:
    """The dQ kernel's function: dQ = dS K."""
    _p, ds = _bwd_tiles(q, k, v, do, lse, delta, scale)
    return torch.matmul(ds, k.float()).to(q.dtype)


def flash_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    do: torch.Tensor,
    lse: torch.Tensor,
    delta: torch.Tensor,
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Both backward kernels' function (JAX ``_bwd_tile`` and its two
    kernels): P = exp(S - lse), dS = P (dO V^T - delta) scale, with P and dS
    cast to the input dtype before dV = P^T dO, dK = dS^T Q, dQ = dS K, all
    accumulated in fp32. Returns ``(dq, dk, dv)`` in q's, k's and v's dtypes.
    q, do, lse and delta may hold fewer rows than k and v."""
    dk, dv = flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, scale)
    return flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, scale), dk, dv


# --------------------------------------------------------------------------- #
# Kernel wrappers
# --------------------------------------------------------------------------- #
def _fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        library, symbol, argtypes = _SYMBOLS[name]
        lib = _cuda_build.load(library)
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.vcd_cuda_error_string.argtypes = [ctypes.c_int]
        lib.vcd_cuda_error_string.restype = ctypes.c_char_p
        _fns[name] = fn
    return fn


def build_forward() -> None:
    """Build (or find built) and load the forward library."""
    _fn("flash_attention_fwd")
    _fn("flash_attention_fwd_lse")


def build_backward() -> None:
    """Build (or find built) and load the backward library."""
    _fn("flash_attention_bwd_dkv")
    _fn("flash_attention_bwd_dq")


def _check_cuda(*tensors: torch.Tensor, out_dtype: torch.dtype = torch.bfloat16) -> None:
    q = tensors[0]
    if q.device.type != "cuda":
        raise RuntimeError(f"flash attention: unsupported device {q.device}")
    if any(t.dtype != torch.bfloat16 for t in tensors) or out_dtype != torch.bfloat16:
        raise NotImplementedError(
            "the CUDA flash-attention kernels take bf16 q/k/v (and dO) and give "
            f"a bf16 output, got {[str(t.dtype) for t in tensors]} -> {out_dtype}; "
            "use attn_impl='naive' or 'chunked' for fp32"
        )
    if q.dim() != 3 or any(t.shape != q.shape for t in tensors):
        raise ValueError(
            "flash attention expects q, k, v (and dO) of one (B, N, C) shape, got "
            f"{[tuple(t.shape) for t in tensors]}"
        )
    if not all(t.device == q.device for t in tensors):
        raise ValueError("flash attention: operands on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash attention: operands must be contiguous")
    b, n, c = q.shape
    if not eligible(n, c):
        raise ValueError(
            f"flash attention: shape (B={b}, N={n}, C={c}) is not eligible: "
            f"N must be a multiple of {TOKEN_MULTIPLE} and C one of "
            f"{SUPPORTED_CHANNELS}"
        )


def _launch(name: str, device: torch.device, *args) -> None:
    fn = _fn(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        msg = _cuda_build.load(_SYMBOLS[name][0]).vcd_cuda_error_string(rc)
        raise RuntimeError(
            f"{name} kernel launch failed: CUDA error {rc} "
            f"({msg.decode() if msg else 'unknown'})"
        )
    launches[name] += 1


def flash_attention_fwd(q, k, v, *, scale: float, out_dtype: torch.dtype) -> torch.Tensor:
    """The serving forward: ``softmax(q k^T * scale) v`` over ``(B, N, C)``.
    CPU tensors go to :func:`flash_attention_reference`; CUDA tensors to the
    kernel, which takes contiguous bf16 q/k/v of one :func:`eligible` shape
    and a bf16 ``out_dtype``, or the call raises. A CUDA input that requires
    a gradient raises too: this kernel leaves nothing for a backward."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale, out_dtype)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention_fwd has no backward; an input that requires a "
            "gradient goes through flash_attention (the LSE forward and the "
            "backward kernels)"
        )
    _check_cuda(q, k, v, out_dtype=out_dtype)
    b, n, c = q.shape
    out = torch.empty_like(q)
    _launch("flash_attention_fwd", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, n, c, float(scale))
    return out


def flash_attention_fwd_lse(q, k, v, *, scale: float, out_dtype: torch.dtype
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward: ``(o, lse)``, lse the fp32 ``(B, N)`` per-row
    log-sum-exp of the scaled logits. CPU tensors go to
    :func:`flash_attention_fwd_lse_reference`."""
    if q.device.type == "cpu":
        return flash_attention_fwd_lse_reference(q, k, v, scale, out_dtype)
    _check_cuda(q, k, v, out_dtype=out_dtype)
    b, n, c = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, n), dtype=torch.float32, device=q.device)
    _launch("flash_attention_fwd_lse", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, n, c, float(scale))
    return out, lse


def _bwd_operands(q, k, v, do, lse, delta) -> Tuple[int, ...]:
    """Check the backward kernels' operands; their pointers."""
    _check_cuda(q, k, v, do)
    b, n, _c = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (b, n)
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(
                f"flash attention backward: {name} must be contiguous fp32 "
                f"{(b, n)} on {q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    return tuple(t.data_ptr() for t in (q, k, v, do, lse, delta))


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, scale: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)`` from the dK/dV kernel; CPU tensors go to
    :func:`flash_attention_bwd_dkv_reference`. On CUDA, q/k/v/do are
    contiguous bf16 of one eligible shape and lse, delta contiguous fp32
    ``(B, N)``."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, scale)
    ptrs = _bwd_operands(q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_attention_bwd_dkv", q.device, *ptrs, dk.data_ptr(), dv.data_ptr(),
            *q.shape, float(scale))
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, scale: float) -> torch.Tensor:
    """``dq`` from the dQ kernel; CPU tensors go to
    :func:`flash_attention_bwd_dq_reference`. Operands as
    :func:`flash_attention_bwd_dkv`."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, scale)
    ptrs = _bwd_operands(q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    _launch("flash_attention_bwd_dq", q.device, *ptrs, dq.data_ptr(), *q.shape, float(scale))
    return dq


class _FlashAttention(torch.autograd.Function):
    """Flash attention with the JAX ``custom_vjp`` (pallas_attention.py:
    390-414): the forward keeps q, k, v, o and lse; the backward forms
    δ = rowsum(dO·O) in fp32 and calls the two backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, out_dtype: torch.dtype):
        o, lse = flash_attention_fwd_lse(q, k, v, scale=scale, out_dtype=out_dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        do = g.to(q.dtype).contiguous()
        delta = (g.float() * o.float()).sum(dim=-1)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale=ctx.scale)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """Single-head ``softmax(q @ k^T * scale) @ v`` over ``(B, N, C)``,
    differentiable: :class:`_FlashAttention` when autograd records and an
    input requires a gradient, else the serving forward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, scale, out_dtype)
    return flash_attention_fwd(q, k, v, scale=scale, out_dtype=out_dtype)


__all__ = [
    "eligible",
    "flash_attention",
    "flash_attention_bwd_dkv",
    "flash_attention_bwd_dkv_reference",
    "flash_attention_bwd_dq",
    "flash_attention_bwd_dq_reference",
    "flash_attention_bwd_reference",
    "flash_attention_fwd",
    "flash_attention_fwd_lse",
    "flash_attention_fwd_lse_reference",
    "flash_attention_reference",
]
