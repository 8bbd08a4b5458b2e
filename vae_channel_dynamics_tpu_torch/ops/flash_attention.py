"""Flash attention for the VAE mid block, forward and backward on hand-written
CUDA kernels.

Counterpart of ``vae_channel_dynamics_tpu/ops/pallas_attention.py``. Its
Pallas kernels become CUDA C++ kernels for Hopper (``sm_90a``), built by
``nvcc`` at first use and called through ``ctypes`` (``ops/_cuda_build.py``):

===============================  ==============================================
CUDA kernel (count key)          replaces
===============================  ==============================================
``flash_attention_fwd``          ``_flash_kernel`` (:136) without the
                                 log-sum-exp: the serving forward
                                 (``csrc/flash_attention_fwd.cu``)
``flash_attention_fwd_f32``      the same kernel run in fp32 at
                                 ``Precision.HIGHEST``: fp32 q/k/v and output,
                                 P kept in fp32, each product as three TF32
                                 products on ``wgmma`` (same file)
``flash_attention_fwd_lse``      the same kernel with ``with_lse=True``
                                 (:177-178, :203-210): the training forward,
                                 which also writes the fp32 per-row
                                 ``m + log l``
``flash_attention_fwd_lse_f32``  the fp32 kernel with ``with_lse=True``: fp32
                                 training's forward (same file)
``flash_attention_bwd_dkv``      ``_flash_bwd_dkv_kernel`` (:304): dK, dV, keys
                                 outer, queries inner
                                 (``csrc/flash_attention_bwd.cu``), the
                                 channels split over a thread-block cluster
``flash_attention_bwd_dq``       ``_flash_bwd_dq_kernel`` (:284): dQ, queries
                                 outer, keys inner, the same split
``flash_attention_bwd_dkv_f32``  ``_flash_bwd_dkv_kernel`` in fp32 at
                                 ``Precision.HIGHEST``: the same split, dP and
                                 the outputs as three TF32 products on
                                 ``wgmma``, S by FFMA
                                 (``csrc/flash_attention_bwd_f32.cu``)
``flash_attention_bwd_dq_f32``   ``_flash_bwd_dq_kernel`` in fp32 (same file)
===============================  ==============================================

Every kernel takes C from 128 to 1024 channels in steps of 128
(:data:`SUPPORTED_CHANNELS`), as the JAX kernels take any multiple of 128;
past 1024 a CUDA call raises, naming its ROADMAP item (:data:`WIDE_HEADS`).

What bounds them on the H100, and what the design does about it: at the mid
block's C = 512 the forward does ``4*B*N^2*C`` FLOPs, dK/dV ``8*B*N^2*C``
and dQ ``6*B*N^2*C``, against a few ``B*N*C`` bytes of device-memory
traffic, N/2 FLOPs per byte or more: all are bound by arithmetic (the
tensor cores'; the fp32 backward's S, by FFMA, by its shared-memory loads)
at every token count
the model uses (N = 4096 at 512px, 16384 at 1024px). Each keeps
its logits tile and fp32 accumulators on chip, so no O(N^2) buffer exists.
The bf16 forward (serving, and with the LSE) runs on ``wgmma`` with TMA
loads: a CTA owns 64 query rows, two consumer warpgroups half the channels
each, fed by a producer warpgroup. Both forwards keep O in registers, so
past 512 channels (:func:`fwd_cluster_size`) a thread-block cluster of two
CTAs shares the 64 rows, each owning a slice of :func:`fwd_slice` channels
of Q, K, V and O, and the two add their partial logits through distributed
shared memory, so both hold the same S, m, l and P. The fp32 forward runs
each fp32 product as three TF32 ones (hi·hi + hi·lo + lo·hi, hi and lo the
rounded split of each operand; one TF32 product keeps too few bits) on
``wgmma`` with TMA loads, bound by the TF32 rate over three. The bf16
backward kernels run on ``wgmma`` with TMA loads, as clusters of
:func:`bwd_cluster_size` CTAs (1 to 8) that own :data:`BWD_SLICE` channels
each and add their partial logits in rank order through distributed shared
memory.
The fp32 backward keeps that split and takes dP and the outputs as 3xTF32
on ``wgmma``, the outputs transposed (dK^T = Q^T dS, dV^T = dO^T P, dQ^T =
K^T dS^T: tf32 ``wgmma`` takes K-major operands only), P and dS fp32 until
they are split; S is one FMA chain a logit over the channels in order, the
plain matmul's order, which P = exp(S - lse) needs at logits of several
hundred.
The sources' header comments have the tile layouts.

Every kernel takes the query count ``nq`` and the key count ``nk`` apart,
as the JAX kernels do (``_flash_forward``, ``_flash_backward``): under a
spatial group (``ops/spatial_conv.py``) each rank's queries are its rows of
the image and its keys and values every rank's, so ``nq = N / S``. The
query extent sets the grid of the forwards and of dQ and the length of the
row vectors ``lse`` and ``delta`` (``(B, nq)``); the key extent sets their
key loop. dK/dV's grid runs over the keys and its loop over the queries.
At ``nq == nk`` each kernel computes what it computed before, bit for bit.

:func:`flash_attention` is the op the model calls. With autograd recording
and an input that requires a gradient it runs :class:`_FlashAttention`,
whose forward is the LSE kernel and whose backward is δ = rowsum(dO·O) in
plain PyTorch (as the JAX package leaves it to XLA), then the dK/dV kernel,
then the dQ kernel. Otherwise it runs the serving forward, which is
registered as the custom op ``vcd::flash_attention_fwd``
(``torch.library.custom_op``: the plain version on the CPU, the kernel on
CUDA, a fake that gives the output's shape and dtype), so that
``torch.export`` keeps it as one node of an exported program
(``tools/export_model.py``); the training kernels are not registered. Every entry
picks its kernel by the operands' dtype, all bf16 or all fp32
(``mixed_precision`` ``no`` trains and evaluates in fp32); mixed dtypes
raise. On CPU tensors each kernel's plain PyTorch version (``*_reference``)
runs in its place; on a CUDA tensor the kernel launches or the call raises,
and nothing falls back. ``launches`` counts kernel launches per kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import _cuda_build

FWD_LIBRARY = "flash_attention_fwd"
BWD_LIBRARY = "flash_attention_bwd"
BWD_F32_LIBRARY = "flash_attention_bwd_f32"
KERNELS = ("flash_attention_fwd", "flash_attention_fwd_f32", "flash_attention_fwd_lse",
           "flash_attention_bwd_dkv", "flash_attention_bwd_dq", "flash_attention_fwd_lse_f32",
           "flash_attention_bwd_dkv_f32", "flash_attention_bwd_dq_f32")
# The kernels' channel widths, each a compiled instantiation: every multiple
# of 128 up to 1024. The forwards' accumulators live in registers, split over
# two warpgroups by channels, and 512 (the SDXL/SD mid block) is the widest
# one CTA holds at 128 fp32 a thread; wider heads split over a cluster of two
# CTAs. The backward's cluster has one CTA per BWD_SLICE channels, at most 8,
# the largest portable cluster.
MAX_CHANNELS = 1024
SUPPORTED_CHANNELS = tuple(range(128, MAX_CHANNELS + 1, 128))
TOKEN_MULTIPLE = 128
BWD_SLICE = 128
# the ROADMAP item that a head wider than MAX_CHANNELS waits on
WIDE_HEADS = "ROADMAP Q2, #6-#8 at heads wider than 1024 channels"
# shared memory a CTA may have, bytes: one CTA an SM (227 KB), and each of
# two CTAs an SM (the bf16 dQ kernel: half of the SM's 228 KB, less 1 KB a
# CTA that the system keeps)
SMEM_CTA = 232448
SMEM_HALF_SM = 228 * 1024 // 2 - 1024

# kernel launches in this process, per kernel; only the CUDA branches below
# add to them
launches: Dict[str, int] = {name: 0 for name in KERNELS}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# kernel -> (library, C symbol, argument types)
# every kernel's trailing arguments: b, nq, nk, c, scale, the stream
_SHAPE = [_I, _I, _I, _I, _F, _P]
_SYMBOLS = {
    "flash_attention_fwd": (FWD_LIBRARY, "vcd_flash_attention_fwd_bf16", [_P] * 4 + _SHAPE),
    "flash_attention_fwd_f32": (FWD_LIBRARY, "vcd_flash_attention_fwd_f32",
                                [_P] * 4 + _SHAPE),
    "flash_attention_fwd_lse": (FWD_LIBRARY, "vcd_flash_attention_fwd_lse_bf16",
                                [_P] * 5 + _SHAPE),
    "flash_attention_bwd_dkv": (BWD_LIBRARY, "vcd_flash_attention_bwd_dkv_bf16",
                                [_P] * 8 + _SHAPE),
    "flash_attention_bwd_dq": (BWD_LIBRARY, "vcd_flash_attention_bwd_dq_bf16",
                               [_P] * 7 + _SHAPE),
    "flash_attention_fwd_lse_f32": (FWD_LIBRARY, "vcd_flash_attention_fwd_lse_f32",
                                    [_P] * 5 + _SHAPE),
    "flash_attention_bwd_dkv_f32": (BWD_F32_LIBRARY, "vcd_flash_attention_bwd_dkv_f32",
                                    [_P] * 8 + _SHAPE),
    "flash_attention_bwd_dq_f32": (BWD_F32_LIBRARY, "vcd_flash_attention_bwd_dq_f32",
                                   [_P] * 7 + _SHAPE),
}
_fns: Dict[str, object] = {}  # ctypes functions, bound at first launch


def eligible(num_tokens: int, channels: int, num_keys: Optional[int] = None) -> bool:
    """Shapes the CUDA kernels take: queries (``num_tokens``) and keys
    (``num_keys``, the queries' count by default) each a multiple of 128
    (the JAX kernels' smallest block; the CUDA kernels tile by 32 and 64)
    and channels in :data:`SUPPORTED_CHANNELS`, every multiple of 128 up to
    1024: the JAX ``eligible`` (unmeshed) up to that width. The JAX kernels
    take wider heads too; here they wait on :data:`WIDE_HEADS`, and
    :func:`refuse_wider_heads` raises where the JAX kernels would run."""
    num_keys = num_tokens if num_keys is None else num_keys
    return (
        min(num_tokens, num_keys) > 0
        and num_tokens % TOKEN_MULTIPLE == 0
        and num_keys % TOKEN_MULTIPLE == 0
        and channels in SUPPORTED_CHANNELS
    )


def refuse_wider_heads(num_tokens: int, channels: int, num_keys: Optional[int] = None) -> None:
    """Raise ``NotImplementedError`` naming :data:`WIDE_HEADS` where the JAX
    kernels would take the shape (tokens a multiple of 128, channels a
    multiple of 128) but the channels are past :data:`MAX_CHANNELS`."""
    num_keys = num_tokens if num_keys is None else num_keys
    if (channels > MAX_CHANNELS and channels % BWD_SLICE == 0
            and eligible(num_tokens, BWD_SLICE, num_keys)):
        raise NotImplementedError(
            f"flash attention at {channels} channels: the CUDA kernels take heads of up to "
            f"{MAX_CHANNELS} channels (a backward cluster of 8 CTAs); {WIDE_HEADS}"
        )


def fwd_cluster_size(channels: int) -> int:
    """CTAs in a thread-block cluster of the forward kernels at this width
    (``FwdSplit`` in ``csrc/flash_attention_fwd.cu``): one up to 512
    channels, two past it."""
    return 1 if channels <= 512 else 2


def fwd_slice(channels: int) -> int:
    """Channels of one CTA of the forwards' cluster: all of them up to 512,
    else ``128 * ceil(C / 256)``; at 640 and 896 the second slice ends 128
    channels past C (zero-filled, not stored)."""
    return channels if channels <= 512 else -(-channels // 256) * 128


def bwd_cluster_size(channels: int) -> int:
    """CTAs in a thread-block cluster of the backward kernels at this width:
    one per :data:`BWD_SLICE` channels."""
    return channels // BWD_SLICE


def fwd_smem_bytes(channels: int, f32: bool = False) -> int:
    """Dynamic shared memory a CTA of the forward takes at this width
    (``Layout`` and ``F32Units`` in ``csrc/flash_attention_fwd.cu``): Q
    resident and a ring of 8 stages of 16 KB (bf16), or a ring of 6 stages,
    the split buffers and P (fp32); a cluster adds two 16 KB slots of the
    other CTA's partial logits; the barriers and the 1024-byte alignment."""
    xch, barriers, pad = 64 * 64 * 4, 256, 1024
    if f32:
        base = 6 * 16384 + 4 * 16384 + 2 * xch
        return base + (2 * 6 * 8 if fwd_cluster_size(channels) == 1
                       else barriers + 2 * xch) + pad
    cs, stages = fwd_slice(channels), 8
    ring = cs * 128 + (0 if cs >= 256 else 2 * xch)
    base = ring + stages * 2 * 64 * 128
    return base + ((2 * stages + 1) * 8 if fwd_cluster_size(channels) == 1
                   else barriers + 2 * xch) + pad


def bwd_tile(channels: int, dkv: bool) -> int:
    """Streamed rows a tile of the bf16 backward: 64 queries for dK/dV (32
    at a cluster of 7, whose exchange buffer for 64 would not fit), 32 keys
    for dQ (``Layout`` in ``csrc/flash_attention_bwd.cu``)."""
    return 64 if dkv and bwd_cluster_size(channels) != 7 else 32


def bwd_smem_bytes(channels: int, dkv: bool, f32: bool = False) -> int:
    """Dynamic shared memory a CTA of the backward takes at this width
    (``Layout`` in ``csrc/flash_attention_bwd.cu`` and
    ``csrc/flash_attention_bwd_f32.cu``). bf16: two resident 64-row slices,
    the ring, the exchange buffer (each rank's R slots of its own pairs and
    its outbox of the others', sized for the rank that owns the most), the
    gather buffers, dK/dV's lse and delta; fp32: the resident slices, two
    stages, the split buffer, the B tiles, the partial slots (from R = 5 the
    outbox lives in the B tiles), the row vectors."""
    r, pair = bwd_cluster_size(channels), 128 * 16
    if f32:
        tile, ksteps = 32, 4
        nb = 4 if dkv else 2
        owned = [len([j for j in range(ksteps) if j * r // ksteps == q]) * 2 for q in range(r)]
        slots = max((r * o if r > 4 else (r - 1) * o + tile // 4) for o in owned) * pair
        vec = (2 * 2 * tile if dkv else 2 * 64) * 4
        body = 2 * 4 * 64 * 128 + 2 * 2 * 4 * tile * 128 + 2 * 4 * tile * 128
        body += ksteps * nb * 2 * 1024 + slots + vec
        return body + (2 + 3) * 8 + 1024
    tile = bwd_tile(channels, dkv)
    stages, gathers, g = (3, 2, 8) if dkv else (2, 1, 4)
    pairs = tile // 4
    held = (r - 1) * -(-pairs // r) + pairs
    body = 2 * 2 * 64 * 128 + stages * 2 * 2 * tile * 128 + held * pair
    body += gathers * pairs * 128 * g + (stages * 2 * tile * 4 if dkv else 0)
    return body + (stages + 3) * 8 + 1024


# --------------------------------------------------------------------------- #
# Plain versions: the kernels' functions in PyTorch, used for CPU tensors and
# as the card's reference. q, do: (B, nq, C); k, v: (B, nk, C); lse, delta:
# (B, nq) fp32.
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
    product with ``v``. q ``(B, nq, C)`` against k, v ``(B, nk, C)``; ``(B,
    nq, C)`` of ``out_dtype`` out."""
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
    the scaled logits, ``(B, nq)``."""
    logits = _logits(q, k, scale)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(p, v).to(out_dtype), torch.logsumexp(logits, dim=-1)


def _bwd_tiles(q, k, v, do, lse, delta, scale) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX ``_bwd_tile`` over the whole (nq, nk) at once: P = exp(S - lse) and
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
    _fn("flash_attention_fwd_f32")
    _fn("flash_attention_fwd_lse")
    _fn("flash_attention_fwd_lse_f32")


def build_backward() -> None:
    """Build (or find built) and load the bf16 backward library."""
    _fn("flash_attention_bwd_dkv")
    _fn("flash_attention_bwd_dq")


def build_backward_f32() -> None:
    """Build (or find built) and load the fp32 backward library."""
    _fn("flash_attention_bwd_dkv_f32")
    _fn("flash_attention_bwd_dq_f32")


def _check_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *rest: torch.Tensor,
                out_dtype: torch.dtype) -> None:
    """Raise unless the kernels take ``q, k, v`` (and dO in ``rest``): all
    bf16 in and out, or all fp32 in and out; q (and dO) ``(B, nq, C)``, k
    and v ``(B, nk, C)``, both lengths :func:`eligible`."""
    tensors = (q, k, v) + rest
    if q.device.type != "cuda":
        raise RuntimeError(f"flash attention: unsupported device {q.device}")
    dtypes = {t.dtype for t in tensors} | {out_dtype}
    if dtypes not in ({torch.bfloat16}, {torch.float32}):
        raise NotImplementedError(
            "the CUDA flash-attention kernels take q/k/v (and dO) and give the "
            "output all bf16 or all fp32, got "
            f"{[str(t.dtype) for t in tensors]} -> {out_dtype}"
        )
    _check_fwd_shapes(q, k, v)
    if any(t.shape != q.shape for t in rest):
        raise ValueError(
            "flash attention expects dO of q's (B, nq, C) shape, got "
            f"{[tuple(t.shape) for t in tensors]}"
        )
    if not all(t.device == q.device for t in tensors):
        raise ValueError("flash attention: operands on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash attention: operands must be contiguous")
    b, nq, c = q.shape
    nk = k.shape[1]
    refuse_wider_heads(nq, c, nk)
    if not eligible(nq, c, nk):
        raise ValueError(
            f"flash attention: shape (B={b}, nq={nq}, nk={nk}, C={c}) is not eligible: "
            f"nq and nk must be multiples of {TOKEN_MULTIPLE} and C a multiple of "
            f"{BWD_SLICE} up to {MAX_CHANNELS}"
        )


def _by_dtype(name: str, q: torch.Tensor) -> str:
    """The kernel ``name`` for q's dtype: ``name`` on bf16, ``name_f32`` on fp32."""
    return f"{name}_f32" if q.dtype == torch.float32 else name


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


def _check_fwd_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if (q.dim() != 3 or k.dim() != 3 or k.shape != v.shape
            or (k.shape[0], k.shape[2]) != (q.shape[0], q.shape[2])):
        raise ValueError(
            "flash attention expects q (B, nq, C) and k, v of one (B, nk, C) shape, got "
            f"{[tuple(t.shape) for t in (q, k, v)]}"
        )


@torch.library.custom_op("vcd::flash_attention_fwd", mutates_args=(), device_types="cpu")
def _flash_attention_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                            out_dtype: torch.dtype) -> torch.Tensor:
    """``vcd::flash_attention_fwd`` on the CPU: the plain version."""
    _check_fwd_shapes(q, k, v)
    return flash_attention_reference(q, k, v, scale, out_dtype)


@_flash_attention_fwd_op.register_kernel("cuda")
def _flash_attention_fwd_cuda(q, k, v, scale, out_dtype):
    """``vcd::flash_attention_fwd`` on the card: the serving kernel,
    ``flash_attention_fwd`` on bf16 and ``flash_attention_fwd_f32`` on fp32."""
    _check_cuda(q, k, v, out_dtype=out_dtype)
    # the kernel loads 16 bytes at a time (TMA boxes)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash attention: operands must be 16-byte aligned")
    b, nq, c = q.shape
    out = torch.empty_like(q)
    name = _by_dtype("flash_attention_fwd", q)
    _launch(name, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, nq,
            k.shape[1], c, float(scale))
    return out


@_flash_attention_fwd_op.register_fake
def _flash_attention_fwd_fake(q, k, v, scale, out_dtype):
    """The output's shape and dtype, after the checks that need no pointer
    (a fake tensor has none): what ``torch.export`` traces."""
    if q.device.type == "cuda":
        _check_cuda(q, k, v, out_dtype=out_dtype)
    else:
        _check_fwd_shapes(q, k, v)
    return q.new_empty(q.shape, dtype=out_dtype)


def flash_attention_fwd(q, k, v, *, scale: float, out_dtype: torch.dtype) -> torch.Tensor:
    """The serving forward: ``softmax(q k^T * scale) v``, q ``(B, nq, C)``
    against k, v ``(B, nk, C)``,
    through the custom op ``vcd::flash_attention_fwd`` (so that
    ``torch.export`` records it as one node). CPU tensors go to
    :func:`flash_attention_reference`; CUDA tensors to the kernel, which
    takes contiguous, 16-byte aligned q/k/v of one :func:`eligible` shape,
    all bf16 with a bf16 ``out_dtype`` or all fp32 with an fp32 one (the
    ``flash_attention_fwd_f32`` kernel), or the call raises. A CUDA input
    that requires a gradient raises too: this kernel leaves nothing for a
    backward (a CPU one runs the differentiable plain version)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if q.device.type == "cpu":
            return flash_attention_reference(q, k, v, scale, out_dtype)
        raise RuntimeError(
            "flash_attention_fwd has no backward; an input that requires a "
            "gradient goes through flash_attention (the LSE forward and the "
            "backward kernels)"
        )
    return torch.ops.vcd.flash_attention_fwd(q, k, v, float(scale), out_dtype)


def flash_attention_fwd_lse(q, k, v, *, scale: float, out_dtype: torch.dtype
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward: ``(o, lse)``, lse the fp32 ``(B, nq)`` per-row
    log-sum-exp of the scaled logits. CPU tensors go to
    :func:`flash_attention_fwd_lse_reference`; CUDA tensors to
    ``flash_attention_fwd_lse`` (all bf16) or ``flash_attention_fwd_lse_f32``
    (all fp32), or the call raises."""
    if q.device.type == "cpu":
        return flash_attention_fwd_lse_reference(q, k, v, scale, out_dtype)
    _check_cuda(q, k, v, out_dtype=out_dtype)
    b, nq, c = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, nq), dtype=torch.float32, device=q.device)
    _launch(_by_dtype("flash_attention_fwd_lse", q), q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), lse.data_ptr(), b, nq, k.shape[1], c, float(scale))
    return out, lse


def _bwd_operands(q, k, v, do, lse, delta) -> Tuple[int, ...]:
    """Check the backward kernels' operands; their pointers."""
    _check_cuda(q, k, v, do, out_dtype=q.dtype)
    b, nq, _c = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (b, nq)
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(
                f"flash attention backward: {name} must be contiguous fp32 "
                f"{(b, nq)} on {q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
    tensors = (q, k, v, do, lse, delta)
    # the kernels load 16 bytes at a time (TMA boxes, cp.async)
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("flash attention backward: operands must be 16-byte aligned")
    return tuple(t.data_ptr() for t in tensors)


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, scale: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dk, dv)`` from the dK/dV kernel; CPU tensors go to
    :func:`flash_attention_bwd_dkv_reference`. On CUDA, q/k/v/do are
    contiguous and all bf16 (``flash_attention_bwd_dkv``) or all fp32
    (``flash_attention_bwd_dkv_f32``), q and do ``(B, nq, C)``, k and v
    ``(B, nk, C)``, both lengths eligible, and lse, delta contiguous fp32
    ``(B, nq)``."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta, scale)
    ptrs = _bwd_operands(q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    b, nq, c = q.shape
    _launch(_by_dtype("flash_attention_bwd_dkv", q), q.device, *ptrs, dk.data_ptr(),
            dv.data_ptr(), b, nq, k.shape[1], c, float(scale))
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, scale: float) -> torch.Tensor:
    """``dq`` from the dQ kernel; CPU tensors go to
    :func:`flash_attention_bwd_dq_reference`. Operands as
    :func:`flash_attention_bwd_dkv`."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_reference(q, k, v, do, lse, delta, scale)
    ptrs = _bwd_operands(q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    b, nq, c = q.shape
    _launch(_by_dtype("flash_attention_bwd_dq", q), q.device, *ptrs, dq.data_ptr(), b, nq,
            k.shape[1], c, float(scale))
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
    """Single-head ``softmax(q @ k^T * scale) @ v``, q ``(B, nq, C)``
    against k, v ``(B, nk, C)``, differentiable: :class:`_FlashAttention` when autograd records and an
    input requires a gradient, else the serving forward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, scale, out_dtype)
    return flash_attention_fwd(q, k, v, scale=scale, out_dtype=out_dtype)


__all__ = [
    "bwd_cluster_size",
    "bwd_smem_bytes",
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
    "fwd_cluster_size",
    "fwd_slice",
    "fwd_smem_bytes",
    "refuse_wider_heads",
]
