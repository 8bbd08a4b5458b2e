"""Fused GroupNorm+SiLU+conv3x3 for the resnet blocks, on hand-written CUDA
kernels.

Counterpart of ``vae_channel_dynamics_tpu/ops/pallas_resnet.py``. Its three
Pallas kernels become three CUDA kernels in ``csrc/fused_resnet.cu``
(sm_90a, built by ``nvcc`` at first use and called through ``ctypes``,
``ops/_cuda_build.py``):

=========================  ====================================================
CUDA kernel (wrapper here)  replaces
=========================  ====================================================
``fused_gn_silu_conv3x3``  ``_fused_fwd_kernel`` (:173): y = conv3x3(silu(a*x
                           + o)) + bias (+ residual), with the optional sum |z|
                           tap of the image's own pixels and the optional sum
                           y, sum y^2 of the fp32 output, per (sample,
                           channel); s computed once by an NHWC pre-pass, the
                           conv on kernel #12's loop (``csrc/sm90_conv3x3.cuh``)
``conv3x3``                ``_plain_conv_kernel`` (:361): conv3x3(x) + bias; the
                           backward's ds = conv3x3(dy, w flipped and
                           transposed) (:348-358); x copied once to NHWC by
                           the pre-pass, the conv on kernel #12's loop
``conv3x3_dw``             ``_dw_kernel`` (:423): dW = sum over N, H, W of
                           silu(a*x + o) shifted times dy, s recomputed from x
=========================  ====================================================

The layout is the model's: NCHW activations and the OIHW weight. The
wrappers lay the small weight out for the kernels, HWIO ``(3, 3, Cin,
Cout)`` for #9 and #10 (kernel #12's B operand), and transpose no activation
themselves: #9 and #11 write s = silu(a*x + o) once into an NHWC scratch
that the wrapper allocates, and #10 its input x unchanged. All three are tensor-core bound on
the H100 (implicit GEMMs with K = 9 * channels); the source's header has the
design.

Each kernel takes bf16 or fp32; the wrapper picks it by x's dtype (the
counters ``fused_gn_silu_conv3x3_f32``, ``conv3x3_f32`` and
``conv3x3_dw_f32`` for fp32), and x, w, residual and dy of one call share
that dtype, or the call raises. The fp32 kernels take every product as three
TF32 products on the tensor cores (3xTF32: hi hi + hi lo + lo hi, hi and lo
the operand rounded to TF32 and its rounded remainder), keep every tensor-
core accumulation short and add the partial sums in fp32. #9 and #10 read
the weight K-major and split, (2, 3, 3, Cout, Cin) (:func:`weight_kmajor_split`),
and their pre-pass writes the NHWC scratch as hi and lo planes, (2, N, H,
W, Cin); #11's pre-passes write s NCHW in fp32, (N, Cin, H, W), and dy split,
(2, N, Cout, H, W), and its splits write their dW partials, (S, Cout, Cin,
3, 3), which a second pass adds in order of the split.

:func:`gn_silu_conv3x3` is the op the model calls: a
``torch.autograd.Function`` with the JAX custom VJP (pallas_resnet.py:
550-628). Its forward takes the GroupNorm statistics with the GroupNorm
kernels' reduce (``group_norm_kernel.fwd_reduce``, kernel #1) and folds them
with the affine into per-(sample, channel) a, o; its backward runs
``conv3x3`` on dy with the flipped, channel-swapped weight, ``conv3x3_dw``,
and the GroupNorm+SiLU backward on ds (kernels #4 and #5, through
``group_norm_kernel._bwd``). The tap and the moments are non-differentiable;
d(residual) = dy, db = sum dy, and dW comes back in the weight's dtype, from
which autograd carries it to the fp32 master. It runs on the card in bf16
and in fp32; the model fuses only bf16 compute (JAX ``models/vae.py:538``:
fp32 parity there asks for HIGHEST-precision convs), so its fp32 paths run
the plain convs.

Each kernel has its plain PyTorch version beside it (``*_reference``), with
the kernel's arithmetic: s rounded to x's dtype, the conv accumulated in fp32
on the rounded s and w, bias and residual added in fp32, y rounded once. A
wrapper runs its plain version only for a tensor on the CPU; a CUDA tensor
goes to the kernel or the call raises. On a CUDA tensor the plain versions'
fp32 convolutions need TF32 off (``torch.backends.cudnn.allow_tf32 =
False``) to be the reference. ``launches`` counts kernel launches per kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _cuda_build
from . import group_norm_kernel as gnk
from .conv_nhwc import pixel_tile
from .stats import mask_count, mask_for

LIBRARY = "fused_resnet"
BF16_KERNELS = ("fused_gn_silu_conv3x3", "conv3x3", "conv3x3_dw")
# each kernel at fp32 (3xTF32), picked by x's dtype (:func:`_by_dtype`)
KERNELS = BF16_KERNELS + tuple(f"{name}_f32" for name in BF16_KERNELS)
LANE = 128  # the JAX kernels' channel multiple (pallas_group_norm.py:40)
W_MULTIPLE = 16  # the JAX kernels' W rule; here also the 16-byte NCHW stores' width
SILU_PIXELS = 64  # pixels of one block of the NHWC pre-pass (#9's tap partials)
DW_BLOCK_CHANNELS = (64, 64)  # conv3x3_dw's (out, in) channels per block
DW_F32_BLOCK_CHANNELS = (64, 64)  # conv3x3_dw_f32's: 3 x 32 summed + 32 fresh fp32 a thread
DW_UNIT_PIXELS = 128  # conv3x3_dw's pixel unit: rows x cols of one image
DW_F32_UNIT_PIXELS = 64  # conv3x3_dw_f32's: each tap's fresh accumulation
DW_F32_STAGES = 2  # conv3x3_dw_f32's ring of units in shared memory
DW_TARGET_BLOCKS = 132  # the H100's SMs: conv3x3_dw holds one block on each
DW_MAX_SPLITS = 8  # in bf16 the splits of a channel block form one thread-block cluster

# kernel launches in this process, per kernel; only the CUDA branches below
# add to them
launches: Dict[str, int] = {name: 0 for name in KERNELS}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "fused_gn_silu_conv3x3": [_P] * 13 + [_I] * 8 + [_P],
    "conv3x3": [_P] * 5 + [_I] * 6 + [_P],
    "conv3x3_dw": [_P] * 6 + [_I] * 6 + [_P],
    "conv3x3_dw_max_clusters": [_I, _I],
    "fused_gn_silu_conv3x3_f32": [_P] * 13 + [_I] * 8 + [_P],
    "conv3x3_f32": [_P] * 5 + [_I] * 6 + [_P],
    "conv3x3_dw_f32": [_P] * 8 + [_I] * 6 + [_P],
    "conv3x3_dw_f32_smem": [_I],
}
_fns: Dict[str, object] = {}  # ctypes functions, bound at first launch


# --------------------------------------------------------------------------- #
# Which shapes fuse: the JAX rule, copied
# --------------------------------------------------------------------------- #
def _pick_tile_h(h: int, w: int, cin: int, cout: int) -> Optional[int]:
    """The JAX rule (pallas_resnet.py:143-167), copied so that both packages
    fuse the same blocks: the largest row tile whose working set fits
    Mosaic's scoped-VMEM budget, or None. It is a TPU budget; the CUDA
    kernels take any H, but a shape this refuses is not fused here either."""
    w_bytes = 3 * 3 * cin * cout * 2
    for tile_h in (16, 8, 4, 2):
        if h % tile_h:
            continue
        win = (tile_h + 2) * w * cin
        out = tile_h * w * cout
        est = (
            2 * win * 2
            + win * 4
            + win * 2
            + 3 * win * 2
            + out * 4
            + 4 * out * 2
            + w_bytes
        )
        if est <= 14_000_000:
            return tile_h
    return None


def eligible(x, cout: int, num_groups: int) -> bool:
    """The JAX rule (pallas_resnet.py:124-140) for NCHW ``x`` (a tensor or a
    shape): channels multiples of 128 and of the group count, W a multiple
    of 16, and a row tile in both directions, since the backward's input
    gradient runs the conv with the channels swapped."""
    shape = tuple(getattr(x, "shape", x))
    if len(shape) != 4:
        return False
    _, cin, h, w = shape
    if cin % LANE or cout % LANE or cin % num_groups:
        return False
    if w % W_MULTIPLE or _pick_tile_h(h, w, cin, cout) is None:
        return False
    return _pick_tile_h(h, w, cout, cin) is not None


# --------------------------------------------------------------------------- #
# Plain versions: the kernels' functions in PyTorch, used for CPU tensors and
# as the card's reference. x (N, Cin, H, W); a, o (N, Cin) fp32; w (Cout, Cin,
# 3, 3); bias (Cout,) fp32 or None; residual and dy (N, Cout, H, W). Their sums
# are fp32, or fp64 where x is fp64: the fp32 kernels' fp64 reference.
# --------------------------------------------------------------------------- #
def _acc(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _silu_rounded(x: torch.Tensor, a: torch.Tensor, o: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """z = a*x + o in fp32, and s = silu(z) rounded to x's dtype (returned in
    fp32; both in fp64 for fp64 x). The conv's zero padding is the kernels'
    mask after the affine."""
    acc = _acc(x)
    z = x.to(acc) * a.to(acc)[:, :, None, None] + o.to(acc)[:, :, None, None]
    return z, (z * torch.sigmoid(z)).to(x.dtype).to(acc)


def fused_fwd_reference(
    x: torch.Tensor, a: torch.Tensor, o: torch.Tensor, w: torch.Tensor,
    bias: Optional[torch.Tensor], residual: Optional[torch.Tensor] = None,
    emit_tap: bool = False, emit_moments: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """``(y, tap, moments)``: y = conv3x3(silu(a*x + o)) + bias (+ residual)
    in x's dtype; tap the fp32 (N, Cin) sum |z|; moments the fp32 (N, Cout)
    sum y and sum y^2 of the fp32 y."""
    acc = _acc(x)
    z, s = _silu_rounded(x, a, o)
    tap = z.abs().sum(dim=(2, 3)) if emit_tap else None
    del z
    y = F.conv2d(s, w.to(x.dtype).to(acc), padding=1)
    if bias is not None:
        y = y + bias.to(acc)[None, :, None, None]
    if residual is not None:
        y = y + residual.to(acc)
    moments = (y.sum(dim=(2, 3)), y.square().sum(dim=(2, 3))) if emit_moments else None
    return y.to(x.dtype), tap, moments


def conv3x3_reference(x: torch.Tensor, w: torch.Tensor,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """conv3x3(x) + bias, fp32 accumulation, in x's dtype."""
    acc = _acc(x)
    y = F.conv2d(x.to(acc), w.to(x.dtype).to(acc), padding=1)
    if bias is not None:
        y = y + bias.to(acc)[None, :, None, None]
    return y.to(x.dtype)


def conv_dw_reference(x: torch.Tensor, a: torch.Tensor, o: torch.Tensor,
                      dy: torch.Tensor) -> torch.Tensor:
    """dW (Cout, Cin, 3, 3) fp32 (fp64 for fp64 x): the weight gradient of
    conv3x3 at input s = silu(a*x + o) (rounded to x's dtype) and output
    gradient dy."""
    _z, s = _silu_rounded(x, a, o)
    w_shape = (dy.shape[1], x.shape[1], 3, 3)
    return torch.nn.grad.conv2d_weight(s, w_shape, dy.to(s.dtype), padding=1)


def flipped_weight(w: torch.Tensor) -> torch.Tensor:
    """The input gradient's weight, OIHW (Cin, Cout, 3, 3): ``w`` flipped in
    both spatial axes with its channels swapped (JAX :354-357 in the
    ``(3, 3Cin, Cout)`` layout, here from OIHW)."""
    return w.flip(2, 3).transpose(0, 1)


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
        lib.vcd_fused_error_string.argtypes = [ctypes.c_int]
        lib.vcd_fused_error_string.restype = ctypes.c_char_p
        _fns[name] = fn
    return fn


def build() -> None:
    """Build (or find built) and load the kernel library."""
    for name in _SIGNATURES:
        _fn(name)


def _on_cpu(x: torch.Tensor, name: str) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise RuntimeError(f"{name}: unsupported device {x.device}")
    return False


def _check_dtype(name: str, what: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    """x, w, residual and dy of one call share x's dtype, bf16 or fp32."""
    if t.dtype != dtype or dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(
            f"{name}: the CUDA fused-resnet kernels take x, w, residual and dy all bf16 or "
            f"all fp32, got {what} {t.dtype} with x {dtype}"
        )


def _by_dtype(name: str, x: torch.Tensor) -> str:
    """The kernel ``name`` for x's dtype: ``name`` on bf16, ``name_f32`` on fp32."""
    return f"{name}_f32" if x.dtype == torch.float32 else name


def _check_act(name: str, what: str, t: torch.Tensor, shape: Tuple[int, ...],
               device: torch.device, dtype: torch.dtype) -> None:
    _check_dtype(name, what, t, dtype)
    if tuple(t.shape) != shape or t.device != device:
        raise ValueError(f"{name}: {what} must be {shape} on {device}, got "
                         f"{tuple(t.shape)} on {t.device}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: {what} must be contiguous and 16-byte aligned")


def _check_vec(name: str, what: str, v: torch.Tensor, shape: Tuple[int, ...],
               device: torch.device) -> None:
    if (tuple(v.shape) != shape or v.dtype != torch.float32 or v.device != device
            or not v.is_contiguous()):
        raise ValueError(f"{name}: {what} must be contiguous fp32 {shape} on {device}, got "
                         f"{tuple(v.shape)} {v.dtype} on {v.device}")


def _check_x(name: str, x: torch.Tensor) -> Tuple[int, int, int, int]:
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be NCHW, got shape {tuple(x.shape)}")
    _check_act(name, "x", x, tuple(x.shape), x.device, x.dtype)
    return tuple(x.shape)


def _check_rule(name: str, x: torch.Tensor, cout: int) -> None:
    """The shapes the JAX kernels take (see :func:`eligible`), in its words."""
    _n, cin, h, wd = x.shape
    if cin % LANE or cout % LANE:
        raise ValueError(f"{name}: Cin/Cout must be multiples of {LANE}, got {cin}/{cout}")
    if wd % W_MULTIPLE:
        raise ValueError(f"{name}: W must be a multiple of {W_MULTIPLE}, got {wd}")
    if _pick_tile_h(h, wd, cin, cout) is None:
        raise ValueError(f"{name}: no row tile for {tuple(x.shape)} -> {cout} channels")


def _check_weight(name: str, w: torch.Tensor, x: torch.Tensor) -> None:
    if w.dim() != 4 or tuple(w.shape[1:]) != (x.shape[1], 3, 3) or w.device != x.device:
        raise ValueError(f"{name}: w must be an OIHW 3x3 weight over x's {x.shape[1]} "
                         f"channels on {x.device}, got {tuple(w.shape)} on {w.device}")
    _check_dtype(name, "w", w, x.dtype)


def weight_hwio(w: torch.Tensor) -> torch.Tensor:
    """The OIHW (Cout, Cin, 3, 3) weight as HWIO (3, 3, Cin, Cout),
    contiguous: the weight of ``fused_gn_silu_conv3x3`` and ``conv3x3``,
    read by kernel #12's loop as its MN-major B."""
    return w.permute(2, 3, 1, 0).contiguous()


def tf32_split(v: torch.Tensor) -> torch.Tensor:
    """fp32 ``v`` as ``(hi, lo)`` stacked on a new first axis: hi = v rounded
    to TF32 (10 mantissa bits) to nearest, ties away from zero, lo = v - hi
    rounded the same; the kernels' ``cvt.rna.tf32.f32``, by integer
    arithmetic on the bits (add half of TF32's last place to the magnitude,
    clear the 13 bits TF32 drops)."""

    def rna(t: torch.Tensor) -> torch.Tensor:
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    hi = rna(v)
    return torch.stack((hi, rna(v - hi)))


def weight_kmajor_split(w: torch.Tensor) -> torch.Tensor:
    """The fp32 OIHW (Cout, Cin, 3, 3) weight as the K-major (3, 3, Cout,
    Cin), split by :func:`tf32_split` into (2, 3, 3, Cout, Cin), contiguous:
    the weight of the fp32 ``fused_gn_silu_conv3x3`` and ``conv3x3``, whose
    tf32 wgmma takes K-major operands only."""
    return tf32_split(w.permute(2, 3, 0, 1))


def tap_chunks(h: int, w: int) -> int:
    """The pre-pass's pixel chunks of one image, which ``fused_gn_silu_conv3x3``
    writes its |z| partials over: chunk k is the flattened pixels [64k,
    min(64k + 64, H*W)). The kernel refuses a call sized by any other
    count."""
    return -(-(h * w) // SILU_PIXELS)


def fused_tiles(h: int, w: int) -> int:
    """``fused_gn_silu_conv3x3``'s pixel rectangles of one image
    (:func:`conv_nhwc.pixel_tile`), which it writes its moment partials
    over. The kernel refuses a call sized by any other count."""
    rows, cols = pixel_tile(h, w)
    return -(-h // rows) * -(-w // cols)


def dw_unit(w: int, f32: bool = False) -> Tuple[int, int]:
    """``conv3x3_dw``'s pixel unit ``(rows, cols)`` for width ``w`` (a
    multiple of 16): cols the widest of 64, 32, 16 that divides it, rows *
    cols = 128; for ``conv3x3_dw_f32`` (``f32``), whose dy rows are 128-byte
    swizzled fp32, the widest of 32, 16, rows * cols = 64."""
    widths = (32, 16) if f32 else (64, 32, 16)
    cols = next(c for c in widths if w % c == 0)
    return (DW_F32_UNIT_PIXELS if f32 else DW_UNIT_PIXELS) // cols, cols


def dw_f32_window(w: int) -> Tuple[int, int]:
    """``conv3x3_dw_f32``'s window of s a unit, ``(rows, cols)`` of each of
    its 64 channels, at width ``w``: from one row and four columns before
    the unit (TMA starts a row on whole 16 bytes), the unit's rows plus its
    halo and one row more, 44 columns at 32-column units and 28 at 16, so
    that a channel's plane is an odd multiple of 4 floats (a fragment's 8
    channels x 4 columns fall on 32 banks)."""
    rows, cols = dw_unit(w, True)
    return rows + 3, 44 if cols == 32 else 28


def dw_f32_smem_bytes(w: int) -> int:
    """``conv3x3_dw_f32``'s dynamic shared memory a block at width ``w``: a
    ring of ``DW_F32_STAGES`` units, each the window of s (64 channels, fp32,
    to whole KB) and the unit's rows of dy's hi and lo ([64 channels][cols]
    fp32 each), then 1 KB for the alignment and the ring's barriers. After
    the loop the ring stages the block's sums, [64 co][64 ci x 9 + 1] fp32.
    The C entry ``vcd_conv3x3_dw_f32_smem`` gives the built kernel's bytes."""
    rows, cols = dw_unit(w, True)
    win_rows, win_cols = dw_f32_window(w)
    co, ci = DW_F32_BLOCK_CHANNELS
    window = -(-(ci * win_rows * win_cols * 4) // 1024) * 1024
    stage = window + 2 * rows * co * cols * 4
    return DW_F32_STAGES * stage + 1024 + 2 * DW_F32_STAGES * 8


def dw_grid(cin: int, cout: int, splits: int, f32: bool = False) -> Tuple[int, int, int]:
    """``conv3x3_dw``'s grid (``_f32``'s with ``f32``): (Cin / ci, Cout /
    co, splits) blocks of ``DW_BLOCK_CHANNELS`` (``DW_F32_BLOCK_CHANNELS``)
    channels; in bf16 the splits of a channel block are one cluster, at
    fp32 independent blocks."""
    co, ci = DW_F32_BLOCK_CHANNELS if f32 else DW_BLOCK_CHANNELS
    return cin // ci, cout // co, splits


def dw_units(n: int, h: int, w: int, f32: bool = False) -> int:
    """The pixel units of ``conv3x3_dw`` (``_f32`` with ``f32``) over N
    images, in order of (sample, unit row, unit column); the last unit row
    may lie partly below H."""
    rows, cols = dw_unit(w, f32)
    return n * -(-h // rows) * (w // cols)


def dw_splits(n: int, cin: int, cout: int, h: int, w: int,
              max_clusters: Optional[Callable[[int], int]] = None, f32: bool = False) -> int:
    """How many pixel chunks ``conv3x3_dw`` splits its units into. The S
    splits of a channel block form one cluster of S blocks, each holding an
    SM; ``max_clusters(S)`` is how many such clusters the card runs at once
    (:func:`dw_max_clusters` on the card; ``DW_TARGET_BLOCKS // S``, an H100
    whose every GPC divides by S, when not given). S, at most 8 and at most
    one chunk per unit, minimises waves x units per block, the smaller S on
    a tie. Chunk k covers units [k*U//S, (k+1)*U//S) of the U =
    :func:`dw_units`. With ``f32``, ``conv3x3_dw_f32``'s blocks and units:
    its splits are independent blocks (no cluster), so ``DW_TARGET_BLOCKS //
    S`` groups of S run at once and ``max_clusters`` is not given."""
    co, ci = DW_F32_BLOCK_CHANNELS if f32 else DW_BLOCK_CHANNELS
    out_blocks = (cout // co) * (cin // ci)
    units = dw_units(n, h, w, f32)
    active = max_clusters or (lambda s: DW_TARGET_BLOCKS // s)
    best, best_cost = 1, None
    for s in range(1, min(units, DW_MAX_SPLITS) + 1):
        clusters = active(s)
        if clusters < 1:
            continue
        cost = -(-out_blocks // clusters) * -(-units // s)
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    return best


@functools.lru_cache(maxsize=None)
def dw_max_clusters(w: int, splits: int) -> int:
    """How many clusters of ``splits`` ``conv3x3_dw`` blocks the current
    card runs at once at width ``w`` (``cudaOccupancyMaxActiveClusters``)."""
    count = _fn("conv3x3_dw_max_clusters")(w, splits)
    if count < 0:
        msg = _cuda_build.load(LIBRARY).vcd_fused_error_string(-count)
        raise RuntimeError(f"conv3x3_dw cluster query failed: CUDA error {-count} "
                           f"({msg.decode() if msg else 'unknown'})")
    return count


def _launch(name: str, x: torch.Tensor, *args) -> None:
    fn = _fn(name)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        msg = _cuda_build.load(LIBRARY).vcd_fused_error_string(rc)
        raise RuntimeError(
            f"{name} kernel launch failed: CUDA error {rc} "
            f"({msg.decode() if msg else 'unknown'})"
        )
    launches[name] += 1


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _loop_operands(x: torch.Tensor, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The weight and the NHWC scratch of #9 and #10 for x's dtype: bf16,
    :func:`weight_hwio` and (N, H, W, Cin); fp32, :func:`weight_kmajor_split`
    and the hi and lo planes (2, N, H, W, Cin)."""
    n, cin, h, wd = x.shape
    if x.dtype == torch.float32:
        return weight_kmajor_split(w), torch.empty((2, n, h, wd, cin), dtype=x.dtype,
                                                   device=x.device)
    return weight_hwio(w), torch.empty((n, h, wd, cin), dtype=x.dtype, device=x.device)


def fused_fwd(
    x: torch.Tensor, a: torch.Tensor, o: torch.Tensor, w: torch.Tensor,
    bias: Optional[torch.Tensor], residual: Optional[torch.Tensor] = None,
    emit_tap: bool = False, emit_moments: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """``(y, tap, moments)`` of :func:`fused_fwd_reference` from the
    ``fused_gn_silu_conv3x3`` kernel (``_f32`` on fp32 x)."""
    name = "fused_gn_silu_conv3x3"
    if _on_cpu(x, name):
        return fused_fwd_reference(x, a, o, w, bias, residual, emit_tap, emit_moments)
    n, cin, h, wd = _check_x(name, x)
    _check_weight(name, w, x)
    cout = w.shape[0]
    _check_rule(name, x, cout)
    dev = x.device
    _check_vec(name, "a", a, (n, cin), dev)
    _check_vec(name, "o", o, (n, cin), dev)
    if bias is not None:
        _check_vec(name, "bias", bias, (cout,), dev)
    if residual is not None:
        _check_act(name, "residual", residual, (n, cout, h, wd), dev, x.dtype)
    y = torch.empty((n, cout, h, wd), dtype=x.dtype, device=dev)
    wk, s = _loop_operands(x, w)  # s: silu(a*x + o), NHWC
    f32 = dict(dtype=torch.float32, device=dev)
    # the partial counts the kernel is held to: it refuses other sizes
    chunks, tiles = tap_chunks(h, wd), fused_tiles(h, wd)
    tap_part = torch.empty((n, chunks, cin), **f32) if emit_tap else None
    tap = torch.empty((n, cin), **f32) if emit_tap else None
    mom_part = torch.empty((2, n, tiles, cout), **f32) if emit_moments else None
    ysum = torch.empty((n, cout), **f32) if emit_moments else None
    ysq = torch.empty((n, cout), **f32) if emit_moments else None
    _rows, cols = pixel_tile(h, wd)
    _launch(_by_dtype(name, x), x, x.data_ptr(), a.data_ptr(), o.data_ptr(), wk.data_ptr(),
            _ptr(bias), _ptr(residual), y.data_ptr(), s.data_ptr(), _ptr(tap_part), _ptr(tap),
            _ptr(mom_part), _ptr(ysum), _ptr(ysq), n, cin, cout, h, wd, cols, chunks, tiles)
    return y, tap, (ysum, ysq) if emit_moments else None


def conv3x3(x: torch.Tensor, w: torch.Tensor,
            bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """conv3x3(x) + bias from the ``conv3x3`` kernel (``_f32`` on fp32 x; see
    :func:`conv3x3_reference`); ``w`` OIHW, handed to the kernel as
    :func:`weight_hwio` (:func:`weight_kmajor_split` at fp32)."""
    name = "conv3x3"
    if _on_cpu(x, name):
        return conv3x3_reference(x, w, bias)
    n, cin, h, wd = _check_x(name, x)
    _check_weight(name, w, x)
    cout = w.shape[0]
    _check_rule(name, x, cout)
    if bias is not None:
        _check_vec(name, "bias", bias, (cout,), x.device)
    y = torch.empty((n, cout, h, wd), dtype=x.dtype, device=x.device)
    wk, s = _loop_operands(x, w)  # s: x, NHWC
    _rows, cols = pixel_tile(h, wd)
    _launch(_by_dtype(name, x), x, x.data_ptr(), wk.data_ptr(), _ptr(bias), y.data_ptr(),
            s.data_ptr(), n, cin, cout, h, wd, cols)
    return y


def conv_dw(x: torch.Tensor, a: torch.Tensor, o: torch.Tensor,
            dy: torch.Tensor) -> torch.Tensor:
    """dW (Cout, Cin, 3, 3) fp32 from the ``conv3x3_dw`` kernel (``_f32`` on
    fp32 x; see :func:`conv_dw_reference`)."""
    name = "conv3x3_dw"
    if _on_cpu(x, name):
        return conv_dw_reference(x, a, o, dy)
    n, cin, h, wd = _check_x(name, x)
    if dy.dim() != 4:
        raise ValueError(f"{name}: dy must be NCHW, got shape {tuple(dy.shape)}")
    cout = dy.shape[1]
    dev = x.device
    _check_act(name, "dy", dy, (n, cout, h, wd), dev, x.dtype)
    _check_rule(name, x, cout)
    _check_vec(name, "a", a, (n, cin), dev)
    _check_vec(name, "o", o, (n, cin), dev)
    dw = torch.empty((cout, cin, 3, 3), dtype=torch.float32, device=dev)
    if x.dtype == torch.float32:
        splits = dw_splits(n, cin, cout, h, wd, f32=True)
        s = torch.empty((n, cin, h, wd), dtype=x.dtype, device=dev)  # silu(a*x + o), NCHW
        dy_split = torch.empty((2, n, cout, h, wd), dtype=x.dtype, device=dev)
        # each split's dW, added in order of the split by the kernel's second pass
        dw_part = (torch.empty((splits, cout, cin, 3, 3), dtype=torch.float32, device=dev)
                   if splits > 1 else None)
        _launch(_by_dtype(name, x), x, x.data_ptr(), a.data_ptr(), o.data_ptr(), dy.data_ptr(),
                s.data_ptr(), dy_split.data_ptr(), _ptr(dw_part), dw.data_ptr(), n, cin, cout, h,
                wd, splits)
    else:
        with torch.cuda.device(dev):
            splits = dw_splits(n, cin, cout, h, wd, functools.partial(dw_max_clusters, wd))
        s = torch.empty((n, h, wd, cin), dtype=x.dtype, device=dev)  # silu(a*x + o), NHWC
        _launch(name, x, x.data_ptr(), a.data_ptr(), o.data_ptr(), dy.data_ptr(), s.data_ptr(),
                dw.data_ptr(), n, cin, cout, h, wd, splits)
    return dw


# --------------------------------------------------------------------------- #
# The op: GroupNorm statistics, the fused forward, and the JAX VJP
# --------------------------------------------------------------------------- #
class _FusedGnSiluConv(torch.autograd.Function):
    """conv3x3(silu(group_norm(x))) + bias (+ residual) with the JAX custom
    VJP (pallas_resnet.py:550-628). Outputs y, then the tap and the two
    moments (None when not asked for; non-differentiable)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w, bias, residual, num_groups, eps, emit_tap,
                emit_moments):
        x = x.contiguous()
        _n, _c, h, wd = x.shape
        sums, sqs = gnk.fwd_reduce(x)
        mean, rstd = gnk._group_stats(sums, sqs, h * wd, num_groups, eps)
        a, o = gnk._affine_coeffs(mean, rstd, gamma, beta, num_groups)
        y, tap, moments = fused_fwd(x, a, o, w, bias, residual, emit_tap, emit_moments)
        ctx.save_for_backward(x, gamma, beta, mean, rstd, a, o, w)
        ctx.num_groups = num_groups
        ctx.has_residual = residual is not None
        ysum, ysq = moments if moments is not None else (None, None)
        ctx.mark_non_differentiable(*(t for t in (tap, ysum, ysq) if t is not None))
        return y, tap, ysum, ysq

    @staticmethod
    def backward(ctx, g_y, _g_tap, _g_sum, _g_sq):
        x, gamma, beta, mean, rstd, a, o, w = ctx.saved_tensors
        g_y = g_y.to(x.dtype).contiguous()
        ds = conv3x3(g_y, flipped_weight(w))
        db = g_y.float().sum(dim=(0, 2, 3))
        dw = conv_dw(x, a, o, g_y)
        dx, dgamma, dbeta = gnk._bwd((x, gamma, beta, mean, rstd, a, o), ctx.num_groups,
                                     True, ds)
        d_residual = g_y if ctx.has_residual else None
        return (dx, dgamma, dbeta, dw.to(w.dtype), db, d_residual,
                None, None, None, None)


def gn_silu_conv3x3(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    *,
    num_groups: int = 32,
    eps: float = 1e-6,
    residual: Optional[torch.Tensor] = None,
    emit_tap: bool = False,
    emit_moments: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """``conv3x3(silu(group_norm(x)), weight) + bias [+ residual]`` through
    the kernels, differentiable (JAX ``gn_silu_conv3x3``).

    x (N, Cin, H, W) in the compute dtype; gamma, beta (Cin,); weight the
    OIHW (Cout, Cin, 3, 3) conv weight, cast to x's dtype; bias (Cout,),
    added in fp32; residual (N, Cout, H, W). Returns ``(y, tap, moments)``:
    the tap the per-sample fp32 (N, Cin) sum |z| of the GroupNorm output
    (divide by H*W, or by N*H*W for the batch mean), the moments the
    per-sample fp32 (N, Cout) sum y and sum y^2; both detached, None unless
    asked for."""
    y, tap, ysum, ysq = _FusedGnSiluConv.apply(
        x, gamma.float(), beta.float(), weight.to(x.dtype), bias.float(),
        residual, int(num_groups), float(eps), bool(emit_tap), bool(emit_moments))
    return y, tap, (ysum, ysq) if emit_moments else None


def mean_abs_from_tap(tap: torch.Tensor, hw: int) -> torch.Tensor:
    """``mean_abs_activation_per_channel`` (C,) from the kernel's per-sample
    (N, C) sum |z|, weighted by the installed batch-validity mask
    (``ops.stats.tap_mask``) like every other tap (JAX vae.py:558-572)."""
    m = mask_for(tap)
    if m is None:
        return tap.sum(dim=0) / float(tap.shape[0] * hw)
    return (tap * m[:, None]).sum(dim=0) / (mask_count(m) * float(hw))


__all__ = [
    "BF16_KERNELS",
    "KERNELS",
    "build",
    "conv3x3",
    "conv3x3_reference",
    "conv_dw",
    "conv_dw_reference",
    "dw_f32_smem_bytes",
    "dw_f32_window",
    "dw_grid",
    "dw_max_clusters",
    "dw_splits",
    "dw_unit",
    "dw_units",
    "eligible",
    "flipped_weight",
    "fused_fwd",
    "fused_fwd_reference",
    "fused_tiles",
    "gn_silu_conv3x3",
    "launches",
    "mean_abs_from_tap",
    "tap_chunks",
    "tf32_split",
    "weight_hwio",
    "weight_kmajor_split",
]
