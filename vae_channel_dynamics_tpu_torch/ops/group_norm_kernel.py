"""GroupNorm(+SiLU) forward and backward on hand-written CUDA kernels.

Counterpart of ``vae_channel_dynamics_tpu/ops/pallas_group_norm.py``. Its
five Pallas kernels become four CUDA kernels in ``csrc/group_norm.cu``
(sm_90a, built by ``nvcc`` at first use and called through ``ctypes``,
``ops/_cuda_build.py``):

============================  ===============================================
CUDA kernel (wrapper here)    replaces
============================  ===============================================
``gn_fwd_reduce``             ``_reduce_kernel`` (:83): fp32 sum x, sum x^2
                              per (sample, channel)
``gn_fwd_normalize``          ``_normalize_kernel`` (:126) and
                              ``_normalize_stats_kernel`` (:134): y = x*a + b,
                              optional SiLU, optional fp32 sum |z| of the
                              pre-SiLU z per (sample, channel)
``gn_bwd_reduce``             ``_bwd_reduce_kernel`` (:222): sum g_eff and
                              sum g_eff*x, SiLU' folded into g_eff
``gn_bwd_dx``                 ``_bwd_dx_kernel`` (:245): dx = g_eff*ca + x*cb
                              + cc
============================  ===============================================

All four are bound by device-memory bandwidth on the H100 (a few flops per
2-byte element); each makes one pass over its inputs, one thread block per
(sample, channel) plane of the NCHW tensor, and writes each per-plane sum
once without atomics. Where B x C is too small to fill the card (the 1024px
batch-1 step), ``gn_fwd_normalize``, ``gn_bwd_reduce`` and ``gn_bwd_dx``
split each plane over :func:`normalize_splits`, :func:`reduce_splits` or
:func:`dx_splits` blocks; the first two add their per-split partials (the
|z| tap; sum g_eff and sum g_eff*x) in a second pass, in order, and dx,
elementwise, needs none. The source's header has the design.

The small (B, C) algebra between the kernels stays in PyTorch, as the JAX
package keeps it in XLA: the group combine C -> G and the reference's
var = E[x^2] - mean^2 with rsqrt(var + eps) (:192-204), the affine fold into
per-(sample, channel) a, b (:207-216), and the backward's dgamma, dbeta, ca,
cb, cc (:316-357). :func:`group_norm_silu` and
:func:`group_norm_silu_with_stats` are ``torch.autograd.Function``s with the
JAX VJP; the |z| output is non-differentiable, as JAX's stop-gradient makes
it.

Each kernel has its plain PyTorch version beside it (``*_reference``), and
each wrapper runs that plain version only for a tensor that lies on the CPU.
A CUDA tensor goes to the kernel, or the call raises; nothing falls back.
``launches`` counts kernel launches per kernel.

Under a spatial group (``ops/spatial_conv.py``) the kernels run on this
rank's rows unchanged: #1's and #4's per-(sample, channel) sums are
all-reduced over the group between the kernels, the group statistics and
the backward's coefficients count the whole image, and dgamma, dbeta come
from this rank's own sums (the gradient all-reduce adds the ranks'). The
split heuristics read the local H*W.

Under a tensor group (``ops/tensor_parallel.py``) they run on the rank's
C/T channels with its G/T whole groups, and need no collective: every
statistic is per (sample, group). The host checks and the split rules take
any plane count (B x C/T planes), so the 64- and 32-channel blocks of a
128-channel layer launch as they are; :func:`eligible` reads the whole
layer's channels.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import _cuda_build
from .spatial_conv import active_spatial_group
from .stats import mask_count, mask_for

LIBRARY = "group_norm"
KERNELS = ("gn_fwd_reduce", "gn_fwd_normalize", "gn_bwd_reduce", "gn_bwd_dx")
CHANNEL_MULTIPLE = 128  # the JAX kernels' lane width (pallas_group_norm.py:40)
HW_MULTIPLE = 8  # the JAX kernels' sublane; here the 16-byte bf16 vectors
THREADS = 256  # a kernel block
NORM_LOADS = 4  # gn_fwd_normalize's 16-byte loads in flight a thread
# gn_bwd_reduce's least split: this many rounds of one 16-byte load a thread
# (32 KB of x and of g); a smaller one saves less than its second pass costs
REDUCE_ROUNDS = 8
DX_LOADS = 2  # gn_bwd_dx's 16-byte loads of x, and as many of g, in flight a thread
NORM_TARGET_BLOCKS = 8 * 132  # 2048 resident threads on each of the H100's 132 SMs

# kernel launches in this process, per kernel; only the CUDA branches below
# add to them
launches: Dict[str, int] = {name: 0 for name in KERNELS}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_fns: Dict[str, object] = {}  # ctypes functions, bound at first launch

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "gn_fwd_reduce": [_P, _P, _P, _I, _I, _I, _P],
    "gn_fwd_normalize": [_P] * 6 + [_I] * 6 + [_P],
    "gn_bwd_reduce": [_P] * 7 + [_I] * 6 + [_P],
    "gn_bwd_dx": [_P] * 8 + [_I] * 5 + [_P],
}


def eligible(x: torch.Tensor, num_groups: int, shards: int = 1) -> bool:
    """The shapes the kernels take, the JAX kernels' own rule
    (pallas_group_norm.py:43-57 with ``impl="pallas"``): a 4-D tensor whose
    channels are a multiple of 128 and of ``num_groups``, with H*W a multiple
    of 8. ``x`` with ``num_groups`` groups may be one of ``shards`` channel
    blocks of a tensor group: the rule is judged on the whole layer, as the
    JAX kernel sees the global shape, and the kernels then run on the
    block (they work a (sample, channel) plane at a time)."""
    if x.dim() != 4:
        return False
    c = x.shape[1] * shards
    hw = x.shape[2] * x.shape[3]
    return (c % CHANNEL_MULTIPLE == 0 and c % (num_groups * shards) == 0
            and hw % HW_MULTIPLE == 0)


def split_chunk(hw: int, splits: int) -> int:
    """Elements of one of a plane's ``splits`` splits in ``gn_fwd_normalize``,
    ``gn_bwd_reduce`` and ``gn_bwd_dx``:
    ceil(hw / splits) rounded up to a multiple of 8 (16 bytes of bf16).
    Split k covers [min(k * chunk, hw), min((k + 1) * chunk, hw))."""
    per_split = -(-hw // splits)
    return -(-per_split // 8) * 8


def _splits(planes: int, hw: int, element_size: int, rounds: int) -> int:
    """The smallest power of two S with planes * S >= ``NORM_TARGET_BLOCKS``,
    halved while a split would hold less than ``rounds`` 16-byte loads by
    each of the block's threads or the last split would be empty."""
    s = 1
    while planes * s < NORM_TARGET_BLOCKS:
        s *= 2
    least = THREADS * (16 // element_size) * rounds
    while s > 1 and (split_chunk(hw, s) < least or (s - 1) * split_chunk(hw, s) >= hw):
        s //= 2
    return s


def normalize_splits(planes: int, hw: int, element_size: int) -> int:
    """How many blocks ``gn_fwd_normalize`` splits each of ``planes`` planes
    of ``hw`` elements over: a split holds at least one round of
    ``NORM_LOADS`` loads a thread. 1 wherever the planes alone reach
    ``NORM_TARGET_BLOCKS``. The kernel refuses a call made with any other
    count."""
    return _splits(planes, hw, element_size, NORM_LOADS)


def reduce_splits(planes: int, hw: int, element_size: int) -> int:
    """How many blocks ``gn_bwd_reduce`` splits each plane over: as
    :func:`normalize_splits`, but a split holds at least ``REDUCE_ROUNDS``
    rounds of one load a thread. The kernel refuses any other count."""
    return _splits(planes, hw, element_size, REDUCE_ROUNDS)


def dx_splits(planes: int, hw: int, element_size: int) -> int:
    """How many blocks ``gn_bwd_dx`` splits each plane over: as
    :func:`normalize_splits`, but a split holds at least one round of its
    ``DX_LOADS`` loads of x and of g a thread. dx is elementwise, so a split
    needs no partials. The kernel refuses any other count."""
    return _splits(planes, hw, element_size, DX_LOADS)


# --------------------------------------------------------------------------- #
# Plain versions: the kernels' functions in PyTorch, used for CPU tensors and
# as the card's reference. x, g: (B, C, H, W); a, b, ca, cb, cc: (B, C) fp32.
# --------------------------------------------------------------------------- #
def _bc(v: torch.Tensor) -> torch.Tensor:
    return v[:, :, None, None]


def _grad_eff(xf, gf, a, b, fuse_silu: bool) -> torch.Tensor:
    if not fuse_silu:
        return gf
    z = xf * _bc(a) + _bc(b)
    sig = torch.sigmoid(z)
    return gf * (sig * (1.0 + z * (1.0 - sig)))


def fwd_reduce_reference(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    return xf.sum(dim=(2, 3)), xf.square().sum(dim=(2, 3))


def fwd_normalize_reference(
    x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, fuse_silu: bool,
    with_stats: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    z = x.float() * _bc(a) + _bc(b)
    abs_sum = z.abs().sum(dim=(2, 3)) if with_stats else None
    y = z * torch.sigmoid(z) if fuse_silu else z
    return y.to(x.dtype), abs_sum


def bwd_reduce_reference(
    x: torch.Tensor, g: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
    fuse_silu: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    ge = _grad_eff(xf, g.float(), a, b, fuse_silu)
    return ge.sum(dim=(2, 3)), (ge * xf).sum(dim=(2, 3))


def bwd_dx_reference(
    x: torch.Tensor, g: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
    ca: torch.Tensor, cb: torch.Tensor, cc: torch.Tensor, fuse_silu: bool,
) -> torch.Tensor:
    xf = x.float()
    ge = _grad_eff(xf, g.float(), a, b, fuse_silu)
    return (ge * _bc(ca) + xf * _bc(cb) + _bc(cc)).to(x.dtype)


# --------------------------------------------------------------------------- #
# Kernel wrappers
# --------------------------------------------------------------------------- #
def _fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        lib = _cuda_build.load(LIBRARY)
        fn = getattr(lib, f"vcd_{name}")
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
        lib.vcd_gn_error_string.argtypes = [ctypes.c_int]
        lib.vcd_gn_error_string.restype = ctypes.c_char_p
        _fns[name] = fn
    return fn


def build() -> None:
    """Build (or find built) and load the kernel library."""
    for name in KERNELS:
        _fn(name)


def _on_cpu(x: torch.Tensor, name: str) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise RuntimeError(f"{name}: unsupported device {x.device}")
    return False


def _check_layout(name: str, t: torch.Tensor, what: str) -> None:
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: {what} must be contiguous and 16-byte aligned")


def _check_x(name: str, x: torch.Tensor) -> Tuple[int, int, int]:
    if x.dtype not in _DTYPE_CODES:
        raise NotImplementedError(
            f"{name}: the CUDA GroupNorm kernels take bf16 or fp32, got {x.dtype}"
        )
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be NCHW, got shape {tuple(x.shape)}")
    b, c, h, w = x.shape
    if (h * w) % HW_MULTIPLE:
        raise ValueError(f"{name}: H*W = {h * w} is not a multiple of {HW_MULTIPLE}")
    _check_layout(name, x, "x")
    return b * c, h * w, _DTYPE_CODES[x.dtype]


def _check_g(name: str, g: torch.Tensor, x: torch.Tensor) -> None:
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(
            f"{name}: g must match x ({tuple(x.shape)}, {x.dtype}, {x.device}), got "
            f"({tuple(g.shape)}, {g.dtype}, {g.device})"
        )
    _check_layout(name, g, "g")


def _check_vec(name: str, x: torch.Tensor, **vecs: torch.Tensor) -> None:
    want = (x.shape[0], x.shape[1])
    for what, v in vecs.items():
        if (tuple(v.shape) != want or v.dtype != torch.float32 or v.device != x.device
                or not v.is_contiguous()):
            raise ValueError(
                f"{name}: {what} must be contiguous fp32 {want} on {x.device}, got "
                f"{tuple(v.shape)} {v.dtype} on {v.device}"
            )


def _launch(name: str, x: torch.Tensor, *args) -> None:
    fn = _fn(name)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        msg = _cuda_build.load(LIBRARY).vcd_gn_error_string(rc)
        raise RuntimeError(
            f"{name} kernel launch failed: CUDA error {rc} "
            f"({msg.decode() if msg else 'unknown'})"
        )
    launches[name] += 1


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _new_vec(x: torch.Tensor) -> torch.Tensor:
    return torch.empty((x.shape[0], x.shape[1]), dtype=torch.float32, device=x.device)


def fwd_reduce(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(sample, channel) fp32 sum and sum of squares of NCHW ``x``."""
    name = "gn_fwd_reduce"
    if _on_cpu(x, name):
        return fwd_reduce_reference(x)
    planes, hw, dt = _check_x(name, x)
    sums, sqs = _new_vec(x), _new_vec(x)
    _launch(name, x, x.data_ptr(), sums.data_ptr(), sqs.data_ptr(), planes, hw, dt)
    return sums, sqs


def fwd_normalize(
    x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, fuse_silu: bool,
    with_stats: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """y = x*a + b (then SiLU when ``fuse_silu``) in x's dtype, and with
    ``with_stats`` the fp32 sum |z| of the pre-SiLU z per (sample, channel)."""
    name = "gn_fwd_normalize"
    if _on_cpu(x, name):
        return fwd_normalize_reference(x, a, b, fuse_silu, with_stats)
    planes, hw, dt = _check_x(name, x)
    _check_vec(name, x, a=a, b=b)
    splits = normalize_splits(planes, hw, x.element_size())
    y = torch.empty_like(x)
    abs_sum = _new_vec(x) if with_stats else None
    # the tap's per-split partials, (planes, splits), where there are several
    part = (torch.empty((planes, splits), dtype=torch.float32, device=x.device)
            if with_stats and splits > 1 else None)
    _launch(name, x, x.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(),
            _ptr(abs_sum), _ptr(part), planes, hw, dt, int(fuse_silu), splits,
            0 if part is None else part.shape[1])
    return y, abs_sum


def bwd_reduce(
    x: torch.Tensor, g: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
    fuse_silu: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(sample, channel) sum g_eff and sum g_eff*x, fp32."""
    name = "gn_bwd_reduce"
    if _on_cpu(x, name):
        return bwd_reduce_reference(x, g, a, b, fuse_silu)
    planes, hw, dt = _check_x(name, x)
    _check_g(name, g, x)
    _check_vec(name, x, a=a, b=b)
    splits = reduce_splits(planes, hw, x.element_size())
    gsum, gxsum = _new_vec(x), _new_vec(x)
    # the per-split pairs of partials, (planes, splits, 2), where there are several
    part = (torch.empty((planes, splits, 2), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    _launch(name, x, x.data_ptr(), g.data_ptr(), a.data_ptr(), b.data_ptr(),
            gsum.data_ptr(), gxsum.data_ptr(), _ptr(part), planes, hw, dt, int(fuse_silu),
            splits, 0 if part is None else part.shape[1])
    return gsum, gxsum


def bwd_dx(
    x: torch.Tensor, g: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
    ca: torch.Tensor, cb: torch.Tensor, cc: torch.Tensor, fuse_silu: bool,
) -> torch.Tensor:
    """dx = g_eff*ca + x*cb + cc in x's dtype."""
    name = "gn_bwd_dx"
    if _on_cpu(x, name):
        return bwd_dx_reference(x, g, a, b, ca, cb, cc, fuse_silu)
    planes, hw, dt = _check_x(name, x)
    _check_g(name, g, x)
    _check_vec(name, x, a=a, b=b, ca=ca, cb=cb, cc=cc)
    splits = dx_splits(planes, hw, x.element_size())
    dx = torch.empty_like(x)
    _launch(name, x, x.data_ptr(), g.data_ptr(), a.data_ptr(), b.data_ptr(),
            ca.data_ptr(), cb.data_ptr(), cc.data_ptr(), dx.data_ptr(),
            planes, hw, dt, int(fuse_silu), splits)
    return dx


# --------------------------------------------------------------------------- #
# The (B, C) algebra between the kernels, and the autograd Functions
# --------------------------------------------------------------------------- #
def _group_stats(sums, sqs, hw: int, num_groups: int, eps: float):
    """(B, C) channel sums -> per-(sample, group) mean and rstd."""
    b, c = sums.shape
    cg = c // num_groups
    n = hw * cg
    gsum = sums.reshape(b, num_groups, cg).sum(dim=-1)
    gsq = sqs.reshape(b, num_groups, cg).sum(dim=-1)
    mean = gsum / n
    var = gsq / n - mean * mean
    return mean, torch.rsqrt(var + eps)


def _affine_coeffs(mean, rstd, scale, bias, num_groups: int):
    """Fold the group statistics and the affine into per-(sample, channel)
    a, b with y = x*a + b."""
    cg = scale.shape[0] // num_groups
    mean_c = mean.repeat_interleave(cg, dim=1)
    rstd_c = rstd.repeat_interleave(cg, dim=1)
    a = rstd_c * scale[None, :]
    off = bias[None, :] - mean_c * a
    return a.float().contiguous(), off.float().contiguous()


def _summed_over_rows(a: torch.Tensor, b: torch.Tensor, sp):
    """``a`` and ``b`` summed over the spatial group ``sp``'s row shards
    (one all-reduce), and the group's size; as they are, and 1, without."""
    if sp is None:
        return a, b, 1
    both = torch.stack([a, b])
    torch.distributed.all_reduce(both, group=sp.group)
    return both[0], both[1], sp.size


def _fwd(x, scale, bias, num_groups, eps, fuse_silu, with_stats):
    x = x.contiguous()
    sums, sqs = fwd_reduce(x)
    sums, sqs, shards = _summed_over_rows(sums, sqs, active_spatial_group())
    hw = x.shape[2] * x.shape[3] * shards
    mean, rstd = _group_stats(sums, sqs, hw, num_groups, eps)
    a, b = _affine_coeffs(mean, rstd, scale, bias, num_groups)
    y, abs_sum = fwd_normalize(x, a, b, fuse_silu, with_stats)
    return y, abs_sum, (x, scale, bias, mean, rstd, a, b)


def _bwd(res, num_groups: int, fuse_silu: bool, g: torch.Tensor, sp=None):
    x, scale, bias, mean, rstd, a, b = res
    bsz, c, h, w = x.shape
    cg = c // num_groups
    n = h * w * cg
    g = g.to(x.dtype).contiguous()
    gsum, gxsum = bwd_reduce(x, g, a, b, fuse_silu)

    mean_c = mean.repeat_interleave(cg, dim=1)
    rstd_c = rstd.repeat_interleave(cg, dim=1)
    # parameter grads: dbeta = sum g_eff, dgamma = sum g_eff * x_hat, over
    # this rank's rows
    dbeta = gsum.sum(dim=0)
    dgamma = ((gxsum - mean_c * gsum) * rstd_c).sum(dim=0)
    # dx reads the sums over the whole image
    gsum, gxsum, shards = _summed_over_rows(gsum, gxsum, sp)
    n *= shards
    centred = (gxsum - mean_c * gsum) * rstd_c
    # dx = rstd*(gamma*g_eff - d1/n - x_hat*d2/n) with per-group
    # d1 = sum gamma*g_eff and d2 = sum gamma*g_eff*x_hat, folded into
    # dx = g_eff*ca + x*cb + cc
    gamma = scale[None, :]
    d1 = (gamma * gsum).reshape(bsz, num_groups, cg).sum(dim=-1)
    d2 = (gamma * centred).reshape(bsz, num_groups, cg).sum(dim=-1)
    d1_c = d1.repeat_interleave(cg, dim=1)
    d2_c = d2.repeat_interleave(cg, dim=1)
    cb = -(rstd_c * rstd_c) * d2_c / n
    cc = rstd_c * (mean_c * rstd_c * d2_c / n - d1_c / n)
    dx = bwd_dx(x, g, a, b, a, cb.contiguous(), cc.contiguous(), fuse_silu)
    return dx, dgamma.to(scale.dtype), dbeta.to(bias.dtype)


class GroupNormSilu(torch.autograd.Function):
    """GroupNorm(+SiLU) over NCHW ``x`` with the kernels' forward and the
    JAX VJP (pallas_group_norm.py:300-365) as the backward."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, fuse_silu):
        y, _abs, res = _fwd(x, scale, bias, num_groups, eps, fuse_silu, False)
        ctx.save_for_backward(*res)
        ctx.num_groups, ctx.fuse_silu = num_groups, fuse_silu
        ctx.sp = active_spatial_group()
        return y

    @staticmethod
    def backward(ctx, g):
        dx, dgamma, dbeta = _bwd(ctx.saved_tensors, ctx.num_groups, ctx.fuse_silu, g, ctx.sp)
        return dx, dgamma, dbeta, None, None, None


class GroupNormSiluStats(torch.autograd.Function):
    """:class:`GroupNormSilu` that also returns the (B, C) fp32 sum |z| of
    the pre-SiLU output from the normalize kernel's write pass
    (pallas_group_norm.py:386-409). That output is non-differentiable."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, fuse_silu):
        y, abs_sum, res = _fwd(x, scale, bias, num_groups, eps, fuse_silu, True)
        ctx.save_for_backward(*res)
        ctx.num_groups, ctx.fuse_silu = num_groups, fuse_silu
        ctx.sp = active_spatial_group()
        ctx.mark_non_differentiable(abs_sum)
        return y, abs_sum

    @staticmethod
    def backward(ctx, g, _g_abs):
        dx, dgamma, dbeta = _bwd(ctx.saved_tensors, ctx.num_groups, ctx.fuse_silu, g, ctx.sp)
        return dx, dgamma, dbeta, None, None, None


def group_norm_silu(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-6,
    fuse_silu: bool = False,
) -> torch.Tensor:
    """NCHW GroupNorm(+SiLU) through the kernels (differentiable)."""
    return GroupNormSilu.apply(x, scale.float(), bias.float(), int(num_groups),
                               float(eps), bool(fuse_silu))


def group_norm_silu_with_stats(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    num_groups: int = 32,
    eps: float = 1e-6,
    fuse_silu: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """GroupNorm(+SiLU) that also returns ``mean_abs_activation_per_channel``
    of the pre-SiLU norm output, shape (C,), from inside the normalize kernel.
    The per-sample sums are weighted by the installed batch-validity mask
    (``ops.stats.tap_mask``) like every other tap (pallas_group_norm.py:
    436-450), so pad rows carry no weight; the statistic is detached."""
    b, _c, h, w = x.shape
    y, abs_sum = GroupNormSiluStats.apply(x, scale.float(), bias.float(),
                                          int(num_groups), float(eps), bool(fuse_silu))
    m = mask_for(abs_sum)
    if m is None:
        return y, abs_sum.sum(dim=0) / float(b * h * w)
    # under a spatial group, this rank's share of the whole image's mean
    # (the train step sums the shares, as ops.stats' taps)
    sp = active_spatial_group()
    hw = h * w * (1 if sp is None else sp.size)
    return y, (abs_sum * m[:, None]).sum(dim=0) / (mask_count(m) * float(hw))


__all__ = [
    "KERNELS",
    "GroupNormSilu",
    "GroupNormSiluStats",
    "build",
    "bwd_dx",
    "bwd_dx_reference",
    "bwd_reduce",
    "bwd_reduce_reference",
    "dx_splits",
    "eligible",
    "fwd_normalize",
    "fwd_normalize_reference",
    "fwd_reduce",
    "fwd_reduce_reference",
    "group_norm_silu",
    "group_norm_silu_with_stats",
    "launches",
    "normalize_splits",
    "reduce_splits",
    "split_chunk",
]
