"""Image rows (H) sharded over a ``spatial`` group of ranks: the manual
halo-exchange convolution, and the collectives the model's other layers
take across row shards.

Counterpart of ``vae_channel_dynamics_tpu/ops/spatial_conv.py``. JAX shards
rows over the mesh's ``spatial`` axis and either lets GSPMD insert the halo
exchanges (``parallel.spatial_conv: gspmd``) or writes them by hand under
``shard_map`` (``shard_map``). The port runs one process a card and has no
partitioner, so both values run the manual exchange written here
(``parallel.mesh.spatial_conv_choice``).

Each rank of a spatial group of S ranks holds rows ``[s*h, (s+1)*h)`` of
every activation (``h = H / S``, :func:`row_block`). :func:`halo_conv`
receives L rows from the previous shard and R rows from the next, then
runs the plain local ``F.conv2d`` with no H padding and the caller's W
padding. The edge shards receive zeros, which is the global conv's zero
padding. The halo arithmetic is JAX's (docstring there): a conv of kernel
kh, stride s and H padding (pt, pb) takes ``L = pt`` and ``R = kh - s -
pt``. The model's NCHW geometries:

==========================================================  =========
conv                                                        (L, R)
==========================================================  =========
3x3, stride 1, pad 1                                        (1, 1)
3x3, stride 2 after ``Downsample2D``'s (0, 1) pad           (0, 1)
1x1                                                         (0, 0)
``Upsample2D``'s 3x3 after the local nearest-2x             (1, 1) on
                                                            the
                                                            upsampled
                                                            rows
==========================================================  =========

The exchange is an ``autograd.Function`` (:class:`_HaloExchange`): its
backward sends each received halo's gradient back to its owner, which adds
it to its rows. Every rank issues the same point-to-point operations in
one ``batch_isend_irecv`` (NCCL and gloo both take it), so no order of the
exchanges can deadlock. :func:`all_reduce_sum` (the GroupNorm statistics,
whose adjoint is the same all-reduce) and :func:`gather_rows` (attention's
K and V, whose adjoint is a reduce-scatter) are the other two.

:func:`spatial_conv_scope` installs the spatial group for the forward (and
its backward), as JAX's installs the mesh while it traces; nothing here
does anything without one, so a model outside the scope runs as before.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class SpatialGroup:
    """A spatial group of ``size`` ranks: its process group, this rank's
    block of rows (``index``) and the global ranks holding the rows above
    (``prev``) and below (``next``), None at an edge."""

    group: Any
    size: int
    index: int
    prev: Optional[int]
    next: Optional[int]

    @classmethod
    def of(cls, axis) -> Optional["SpatialGroup"]:
        """The spatial group of a ``parallel.DataAxis``; None without one
        (no axis, or ``spatial`` 1)."""
        if axis is None or axis.spatial <= 1:
            return None
        # spatial neighbours are a tensor group apart (tensor is innermost)
        s, rank, step = axis.spatial_rank, axis.rank, axis.tensor
        return cls(group=axis.spatial_group, size=axis.spatial, index=s,
                   prev=rank - step if s > 0 else None,
                   next=rank + step if s < axis.spatial - 1 else None)


_ACTIVE: Optional[SpatialGroup] = None


@contextlib.contextmanager
def spatial_conv_scope(group: Optional[SpatialGroup]):
    """Install ``group`` while the block runs. None installs nothing, so
    callers can wrap unconditionally."""
    global _ACTIVE
    prev = _ACTIVE
    if group is not None:
        _ACTIVE = group
    try:
        yield
    finally:
        _ACTIVE = prev


def active_spatial_group() -> Optional[SpatialGroup]:
    """The group installed by :func:`spatial_conv_scope`, or None."""
    return _ACTIVE


def row_block(x: torch.Tensor, sp: Optional[SpatialGroup], dim: int = 2) -> torch.Tensor:
    """This rank's block of the rows (axis ``dim``) of a whole tensor; the
    tensor itself without a group."""
    if sp is None:
        return x
    rows = x.shape[dim]
    if rows % sp.size != 0:
        raise ValueError(
            f"spatial_conv: H={rows} not divisible by the {sp.size}-way spatial axis"
        )
    h = rows // sp.size
    return x.narrow(dim, sp.index * h, h)


def halo_widths(kh: int, stride: int, pad: Tuple[int, int], h: int, H: int, S: int
                ) -> Tuple[int, int]:
    """Left/right halo row counts, with the divisibility checks that make
    one program valid on every shard (JAX ``_halo_widths``, its messages)."""
    pt, pb = pad
    L, R = pt, kh - stride - pt
    if R < 0:
        raise ValueError(
            f"spatial_conv: unsupported conv geometry kh={kh} stride={stride} "
            f"pad={pad} (negative right halo {R})"
        )
    if L > h or R > h:
        raise ValueError(
            f"spatial_conv: halo ({L},{R}) exceeds the {h} local rows "
            f"(H={H} over spatial={S}) — lower parallel.spatial or raise "
            "the resolution"
        )
    if (h + L + R - kh) % stride != 0:
        raise ValueError(
            f"spatial_conv: local rows {h} not stride-aligned for "
            f"kh={kh} stride={stride} pad={pad}"
        )
    ho = (h + L + R - kh) // stride + 1
    H_out = (H + pt + pb - kh) // stride + 1
    if ho * S != H_out:
        raise ValueError(
            f"spatial_conv: global output rows {H_out} do not shard evenly "
            f"({S} shards x {ho} local rows) for H={H} kh={kh} "
            f"stride={stride} pad={pad} — choose parallel.spatial so every "
            "resolution level divides evenly"
        )
    return L, R


def _swap(sends: List[Tuple[torch.Tensor, Optional[int]]],
          recvs: List[Tuple[torch.Tensor, Optional[int]]], group) -> None:
    """Send and receive the given blocks in one batch of point-to-point
    operations (peers are global ranks; None skips the entry), then wait."""
    ops = [dist.P2POp(dist.isend, t, peer, group) for t, peer in sends if peer is not None]
    ops += [dist.P2POp(dist.irecv, t, peer, group) for t, peer in recvs if peer is not None]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()


def _rows(x: torch.Tensor, start: int, count: int) -> torch.Tensor:
    return x.narrow(2, start, count).contiguous()


class _HaloExchange(torch.autograd.Function):
    """NCHW ``x`` with L rows of the previous shard above it and R rows of
    the next below it (zeros at the edges); the backward returns each
    halo's gradient to its owner."""

    @staticmethod
    def forward(ctx, x, L: int, R: int, sp: SpatialGroup):
        b, c, h, w = x.shape
        top = x.new_zeros((b, c, L, w))
        bottom = x.new_zeros((b, c, R, w))
        sends = []
        if L:
            sends.append((_rows(x, h - L, L), sp.next))
        if R:
            sends.append((_rows(x, 0, R), sp.prev))
        _swap(sends, [(top, sp.prev if L else None), (bottom, sp.next if R else None)],
              sp.group)
        ctx.L, ctx.R, ctx.sp = L, R, sp
        return torch.cat([top, x, bottom], dim=2)

    @staticmethod
    def backward(ctx, g):
        L, R, sp = ctx.L, ctx.R, ctx.sp
        b, c, rows, w = g.shape
        h = rows - L - R
        dx = g.narrow(2, L, h).contiguous()
        # the gradient of this rank's last L rows, from the next shard's top
        # halo, and of its first R rows, from the previous shard's bottom one
        from_next = g.new_zeros((b, c, L, w))
        from_prev = g.new_zeros((b, c, R, w))
        sends = []
        if L:
            sends.append((_rows(g, 0, L), sp.prev))
        if R:
            sends.append((_rows(g, L + h, R), sp.next))
        _swap(sends, [(from_next, sp.next if L else None),
                      (from_prev, sp.prev if R else None)], sp.group)
        if L and sp.next is not None:
            dx.narrow(2, h - L, L).add_(from_next)
        if R and sp.prev is not None:
            dx.narrow(2, 0, R).add_(from_prev)
        return dx, None, None, None


def halo_rows(x: torch.Tensor, kh: int, stride: int, padding: Tuple[int, int, int, int],
              sp: SpatialGroup) -> Tuple[torch.Tensor, Tuple[int, int, int, int]]:
    """(``x`` with its halo rows from the neighbouring shards, the zero pad
    left to apply): the H pad becomes the halos (:func:`halo_widths`), the W
    pad stays. Under a tensor axis each rank exchanges the halos of its own
    channel block, before the conv gathers the channels: T times fewer
    bytes a rank than exchanging the gathered channels."""
    left, right, top, bottom = padding
    h = x.shape[2]
    L, R = halo_widths(kh, stride, (top, bottom), h, h * sp.size, sp.size)
    xp = _HaloExchange.apply(x, L, R, sp) if L or R else x
    return xp, (left, right, 0, 0)


def halo_conv(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
              stride: int, padding: Tuple[int, int, int, int],
              sp: SpatialGroup) -> torch.Tensor:
    """NCHW/OIHW ``F.conv2d`` with H sharded over ``sp``: the same function
    on each rank's rows as the global conv's rows. ``padding`` is the
    global zero pad ``(left, right, top, bottom)``; W keeps its pad and H
    takes the halos (:func:`halo_widths`)."""
    xp, (left, right, _, _) = halo_rows(x, weight.shape[2], stride, padding, sp)
    if left or right:
        xp = F.pad(xp, (left, right, 0, 0))
    return F.conv2d(xp, weight, bias, stride)


class _AllReduceSum(torch.autograd.Function):
    """The sum over the group; its adjoint is the same sum of the
    gradients."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=ctx.group)
        return out, None


def all_reduce_sum(t: torch.Tensor, sp: SpatialGroup) -> torch.Tensor:
    """``t`` summed over the spatial group (differentiable)."""
    return _AllReduceSum.apply(t, sp.group)


class _GatherRows(torch.autograd.Function):
    """The group's blocks concatenated along ``dim`` in rank order; the
    adjoint reduce-scatters the gradient back to the blocks' owners."""

    @staticmethod
    def forward(ctx, t, dim: int, sp: SpatialGroup):
        ctx.dim, ctx.sp = dim, sp
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(sp.size)]
        dist.all_gather(parts, t, group=sp.group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        sp = ctx.sp
        parts = [p.contiguous() for p in g.chunk(sp.size, dim=ctx.dim)]
        out = torch.empty_like(parts[sp.index])
        dist.reduce_scatter(out, parts, group=sp.group)
        return out, None, None


def gather_rows(t: torch.Tensor, dim: int, sp: SpatialGroup) -> torch.Tensor:
    """Every shard's rows of ``t`` along ``dim``, in order: the whole
    tensor on every rank (differentiable)."""
    return _GatherRows.apply(t, dim, sp)


__all__ = [
    "SpatialGroup",
    "active_spatial_group",
    "all_reduce_sum",
    "gather_rows",
    "halo_conv",
    "halo_rows",
    "halo_widths",
    "row_block",
    "spatial_conv_scope",
]
