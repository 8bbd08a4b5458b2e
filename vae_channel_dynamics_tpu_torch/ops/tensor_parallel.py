"""Channels sharded over a ``tensor`` group of ranks: the column- and
row-parallel convs and linears, and the channel collectives between them.

Counterpart of what GSPMD writes for the JAX package under
``parallel.tensor`` (JAX ``parallel/zero.py``, ``_channel_axis``): JAX
annotates each parameter's channel axis as sharded over the mesh's
``tensor`` axis and lets the partitioner derive the activation gathers and
partial sums. The port runs one process a card and has no partitioner, so
each collective is written here, in the style of ``ops/spatial_conv.py``.

Layout. A rank of a tensor group of T ranks holds block ``index`` of every
sharded parameter along the axis ``_channel_axis`` picks on its JAX layout
(``parallel/zero.py::zero_axis``): a conv's output channels (O), or its
input channels (I) where T does not divide O (the decoder's ``conv_out``,
O = 3); a linear's output features; a GroupNorm's γ and β. Between layers
an activation is either *sharded* (the rank's block of its channels, C/T)
or *whole* (every channel, the same on every rank of the group). A layer
tells the two apart by the channel count it is given, and:

* a column-parallel conv or linear (its O block) gathers a sharded input's
  channels and computes its O block: a sharded output (:func:`column_conv`,
  :func:`column_linear`);
* a row-parallel conv (its I block) computes on its input's block, and the
  partial outputs are summed over the group: a whole output
  (:func:`row_conv`);
* a conv whose weight T shards on no axis gathers its input and computes
  the whole output on every rank;
* GroupNorm and SiLU run on the block (T divides the group count, so every
  group lies whole on one rank), as do the residual adds and the
  nearest-neighbour upsampling.

Gradients. A whole tensor's gradient is whole on every rank; a sharded
tensor's gradient is its block's. So the gather a column conv makes is
adjoint to a reduce-scatter of the partial input gradient that the rank's O
block gives, a column conv of a whole input all-reduces that partial
gradient, the row-parallel sum is adjoint to the identity (every rank reads
the same whole output), and a gather before a replicated op is adjoint to
taking the rank's block. Attention's queries and keys are gathered with the
reduce-scatter adjoint (:func:`gather_channels` ``partial_grads``): every
rank forms the same logits, but the gradient of the probabilities that its
block of V gives is partial.

Memory. A column-parallel conv or linear saves the rank's *local* input
block for the backward and gathers it again there, so the activations a
rank keeps are about 1/T of one card's; the gathered input lives only
while its product runs. In fp32 with cuDNN's TF32 off a column conv's
forward runs in slices of ``FP32_CONV_SLICE`` output channels: at some
output blocks cuDNN's own choice asks for a workspace of up to 39 GB.

:func:`tensor_scope` installs the group for the forward and its backward,
as ``spatial_conv_scope`` does; ``collectives`` counts every collective
issued here (forward and backward), by kind.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

# collectives issued in this process, by kind; the step's count is the
# difference across it
collectives: Dict[str, int] = {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 0}


@dataclasses.dataclass(frozen=True)
class TensorGroup:
    """A tensor group of ``size`` ranks: its process group and this rank's
    channel block (``index``); ``replicas`` is the process group of the
    ranks that hold the same block of other images or rows (the data and
    spatial ranks of this tensor index; None: the whole world)."""

    group: Any
    size: int
    index: int
    replicas: Any = None

    @classmethod
    def of(cls, axis) -> Optional["TensorGroup"]:
        """The tensor group of a ``parallel.DataAxis``; None without one
        (no axis, or ``tensor`` 1)."""
        if axis is None or axis.tensor <= 1:
            return None
        return cls(group=axis.tensor_group, size=axis.tensor, index=axis.tensor_rank,
                   replicas=axis.replica_group)

    def block(self, n: int) -> Tuple[int, int]:
        """(start, length) of this rank's block of ``n`` channels, in
        ``torch.chunk``'s layout (T divides every sharded axis)."""
        c = -(-n // self.size)
        start = min(self.index * c, n)
        return start, min(c, n - start)


_ACTIVE: Optional[TensorGroup] = None


@contextlib.contextmanager
def tensor_scope(tp: Optional[TensorGroup]):
    """Install ``tp`` while the block runs. None installs nothing, so
    callers can wrap unconditionally."""
    global _ACTIVE
    prev = _ACTIVE
    if tp is not None:
        _ACTIVE = tp
    try:
        yield
    finally:
        _ACTIVE = prev


def active_tensor_group() -> Optional[TensorGroup]:
    """The group installed by :func:`tensor_scope`, or None."""
    return _ACTIVE


def channel_block(x: torch.Tensor, dim: int, tp: TensorGroup) -> torch.Tensor:
    """This rank's block of a whole tensor's channels (axis ``dim``), a view."""
    start, length = tp.block(x.shape[dim])
    return x.narrow(dim, start, length)


# --------------------------------------------------------------------------- #
# The collectives
# --------------------------------------------------------------------------- #
def _all_gather(t: torch.Tensor, dim: int, tp: TensorGroup) -> torch.Tensor:
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(tp.size)]
    dist.all_gather(parts, t, group=tp.group)
    collectives["all_gather"] += 1
    return torch.cat(parts, dim=dim)


def _reduce_scatter(t: torch.Tensor, dim: int, tp: TensorGroup) -> torch.Tensor:
    parts = [p.contiguous() for p in t.chunk(tp.size, dim=dim)]
    out = torch.empty_like(parts[tp.index])
    dist.reduce_scatter(out, parts, group=tp.group)
    collectives["reduce_scatter"] += 1
    return out


def _all_reduce(t: torch.Tensor, tp: TensorGroup) -> torch.Tensor:
    out = t.contiguous().clone()
    dist.all_reduce(out, group=tp.group)
    collectives["all_reduce"] += 1
    return out


class _GatherChannels(torch.autograd.Function):
    """Every rank's block along ``dim``, in rank order. The adjoint takes
    this rank's block of a whole gradient, or reduce-scatters a partial one
    (``partial_grads``)."""

    @staticmethod
    def forward(ctx, x, dim: int, partial_grads: bool, tp: TensorGroup):
        ctx.dim, ctx.partial, ctx.tp = dim, partial_grads, tp
        return _all_gather(x, dim, tp)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            return _reduce_scatter(g, ctx.dim, ctx.tp), None, None, None
        return channel_block(g, ctx.dim, ctx.tp).contiguous(), None, None, None


class _SumPartials(torch.autograd.Function):
    """The sum over the group of every rank's partial tensor, whole on
    every rank; the adjoint passes the (whole) gradient to each partial."""

    @staticmethod
    def forward(ctx, x, tp: TensorGroup):
        return _all_reduce(x, tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ToBlock(torch.autograd.Function):
    """This rank's block of a whole tensor; the adjoint all-gathers the
    blocks' gradients, so the whole tensor's gradient is whole."""

    @staticmethod
    def forward(ctx, x, dim: int, tp: TensorGroup):
        ctx.dim, ctx.tp = dim, tp
        return channel_block(x, dim, tp).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.tp), None, None


def gather_channels(x: torch.Tensor, dim: int, tp: TensorGroup,
                    partial_grads: bool = False) -> torch.Tensor:
    """The whole tensor from every rank's block along ``dim``
    (differentiable; see the module docstring for ``partial_grads``)."""
    return _GatherChannels.apply(x, dim, partial_grads, tp)


def sum_partials(x: torch.Tensor, tp: TensorGroup) -> torch.Tensor:
    """The group's sum of ``x``, each rank's a partial (differentiable)."""
    return _SumPartials.apply(x, tp)


def to_block(x: torch.Tensor, dim: int, tp: TensorGroup) -> torch.Tensor:
    """This rank's block of the whole ``x`` along ``dim`` (differentiable)."""
    return _ToBlock.apply(x, dim, tp)


# --------------------------------------------------------------------------- #
# Column- and row-parallel layers
# --------------------------------------------------------------------------- #
def _conv_padding(pad: Tuple[int, int, int, int]):
    """(the zero pad to apply first, the conv's own (H, W) padding) for a
    pad ``(left, right, top, bottom)``: a symmetric one is the conv's own,
    as the model's convs take it off a tensor group (the same cuDNN
    algorithms and workspace, and no padded copy), else it is applied
    first."""
    left, right, top, bottom = pad
    if left == right and top == bottom:
        return (0, 0, 0, 0), (top, left)
    return tuple(pad), (0, 0)


def _padded(x: torch.Tensor, pad: Tuple[int, int, int, int]) -> torch.Tensor:
    return F.pad(x, pad) if any(pad) else x


# cuDNN's heuristic for an fp32 conv with TF32 off picks, at some of a
# tensor rank's output blocks (128 outputs of 128-512 input channels at
# 64-128 px, 256 of 512 at 32 px), an algorithm with a 4.7-39 GB workspace
# that runs up to 6x slower than blocks of 64 outputs do
# (``chip_smoke.conv_workspace_main``, PERF.md); such a forward runs in
# slices of FP32_CONV_SLICE output channels.
FP32_CONV_SLICE = 64


def sliced_conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                  stride: int, padding, size: int) -> torch.Tensor:
    """``F.conv2d`` in slices of ``size`` output channels, concatenated."""
    return torch.cat([F.conv2d(x, weight[i:i + size],
                               None if bias is None else bias[i:i + size], stride, padding)
                      for i in range(0, weight.shape[0], size)], dim=1)


def _conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
            stride: int, padding) -> torch.Tensor:
    """A column conv's forward: in FP32_CONV_SLICE slices where cuDNN runs
    fp32 without TF32, else one ``F.conv2d``."""
    if (x.is_cuda and x.dtype == torch.float32 and not torch.backends.cudnn.allow_tf32
            and weight.shape[0] > FP32_CONV_SLICE):
        return sliced_conv2d(x, weight, bias, stride, padding, FP32_CONV_SLICE)
    return F.conv2d(x, weight, bias, stride, padding)


class _ColumnConv(torch.autograd.Function):
    """``conv2d(pad(gather(x)), w, b, stride)`` with w the rank's O block.
    Saves the local ``x`` and gathers it again in the backward; the input
    gradient is reduce-scattered (``gathered``) or all-reduced (a whole
    input)."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride: int, pad, gathered: bool, tp: TensorGroup):
        xf = _all_gather(x, 1, tp) if gathered else x
        first, own = _conv_padding(pad)
        y = _conv2d(_padded(xf, first), weight, bias, stride, own)
        ctx.save_for_backward(x, weight)
        ctx.stride, ctx.pad, ctx.gathered, ctx.tp = stride, pad, gathered, tp
        ctx.has_bias = bias is not None
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        tp = ctx.tp
        xf = _all_gather(x, 1, tp) if ctx.gathered else x
        first, own = _conv_padding(ctx.pad)
        left, _right, top, _bottom = first
        want_x, want_w, want_b = ctx.needs_input_grad[:3]
        dx, dw, db = torch.ops.aten.convolution_backward(
            g.contiguous(), _padded(xf, first), weight,
            [weight.shape[0]] if ctx.has_bias else None, [ctx.stride] * 2, list(own),
            [1, 1], False, [0, 0], 1, [want_x, want_w, want_b])
        if want_x:
            if any(first):
                dx = dx.narrow(2, top, xf.shape[2]).narrow(3, left, xf.shape[3])
            dx = _reduce_scatter(dx, 1, tp) if ctx.gathered else _all_reduce(dx, tp)
        return dx, dw, db if ctx.has_bias else None, None, None, None, None


class _ColumnLinear(torch.autograd.Function):
    """``linear(gather(x), w, b)`` over the last axis, w the rank's block of
    output features; saves the local ``x`` as :class:`_ColumnConv` does."""

    @staticmethod
    def forward(ctx, x, weight, bias, gathered: bool, tp: TensorGroup):
        xf = _all_gather(x, -1, tp) if gathered else x
        ctx.save_for_backward(x, weight)
        ctx.gathered, ctx.tp, ctx.has_bias = gathered, tp, bias is not None
        return F.linear(xf, weight, bias)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        tp = ctx.tp
        want_x, want_w, want_b = ctx.needs_input_grad[:3]
        dx = dw = db = None
        if want_x:
            dx = g.matmul(weight)
            dx = _reduce_scatter(dx, -1, tp) if ctx.gathered else _all_reduce(dx, tp)
        if want_w:
            xf = _all_gather(x, -1, tp) if ctx.gathered else x
            dw = g.reshape(-1, g.shape[-1]).t().matmul(xf.reshape(-1, xf.shape[-1]))
        if want_b and ctx.has_bias:
            db = g.reshape(-1, g.shape[-1]).sum(0)
        return dx, dw, db, None, None


def column_conv(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                stride: int, pad: Tuple[int, int, int, int], in_channels: int,
                tp: TensorGroup) -> torch.Tensor:
    """NCHW conv of a sharded or whole ``x`` (``in_channels`` whole) by the
    rank's O block ``weight``: the rank's block of the output channels.
    ``pad`` is the zero pad ``(left, right, top, bottom)``."""
    return _ColumnConv.apply(x, weight, bias, stride, tuple(pad),
                             x.shape[1] != in_channels, tp)


def column_linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                  in_features: int, tp: TensorGroup) -> torch.Tensor:
    """Linear map of a sharded or whole ``(..., in)`` ``x`` by the rank's
    block of output features: the rank's block of the output's."""
    return _ColumnLinear.apply(x, weight, bias, x.shape[-1] != in_features, tp)


def row_conv(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
             stride: int, pad: Tuple[int, int, int, int], in_channels: int,
             tp: TensorGroup) -> torch.Tensor:
    """NCHW conv by the rank's I block ``weight``: the partial outputs of
    the ranks' input blocks summed over the group (in fp32, then cast back:
    a partial rounded to bf16 would add its rounding T times), then the
    (whole) bias; a whole ``x`` is cut to its block first."""
    if x.shape[1] == in_channels:
        x = to_block(x, 1, tp)
    first, own = _conv_padding(tuple(pad))
    part = F.conv2d(_padded(x, first), weight, None, stride, own)
    y = sum_partials(part.float(), tp)
    if bias is not None:
        y = y + bias.float().reshape(1, -1, 1, 1)
    return y.to(part.dtype)


def replicated_input(x: torch.Tensor, dim: int, channels: int, tp: TensorGroup
                     ) -> torch.Tensor:
    """``x`` whole along ``dim`` (gathered when it is a block), for a layer
    that every rank computes whole."""
    return x if x.shape[dim] == channels else gather_channels(x, dim, tp)


# --------------------------------------------------------------------------- #
# The taps' running sums
# --------------------------------------------------------------------------- #
def _tap_length(model, key: str) -> int:
    """The whole channel count of a per-channel tap ``<layer>.<point>.<metric>``."""
    layer, point, _metric = key.rsplit(".", 2)
    return model.get_submodule(layer).tap_channels(point)


def whole_taps(acc: Dict[str, torch.Tensor], model) -> Dict[str, torch.Tensor]:
    """The taps' running sums whole: each per-channel block all-gathered
    over the model's tensor group (one collective a tapped layer and
    metric); ``acc`` itself for a model that no tensor group shards."""
    tp: Optional[TensorGroup] = getattr(model, "tensor", None)
    if tp is None:
        return acc
    from ..parallel.zero import gather_chunks

    return {k: gather_chunks(v, 0, _tap_length(model, k), tp.size, tp.group)
            if v.dim() == 1 else v for k, v in acc.items()}


def tap_blocks(acc: Dict[str, torch.Tensor], model) -> Dict[str, torch.Tensor]:
    """The rank's blocks of whole running sums (the inverse of
    :func:`whole_taps`)."""
    tp: Optional[TensorGroup] = getattr(model, "tensor", None)
    if tp is None:
        return acc
    return {k: channel_block(v, 0, tp) if v.dim() == 1 else v for k, v in acc.items()}


__all__ = [
    "TensorGroup",
    "active_tensor_group",
    "channel_block",
    "collectives",
    "column_conv",
    "column_linear",
    "gather_channels",
    "replicated_input",
    "row_conv",
    "sum_partials",
    "tap_blocks",
    "tensor_scope",
    "to_block",
    "whole_taps",
]
