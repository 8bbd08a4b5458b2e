"""ZeRO over the ``data`` axis: ``parallel.shard_optimizer`` (ZeRO-1),
``parallel.shard_ema`` and ``parallel.shard_params`` (ZeRO-3).

Counterpart of ``vae_channel_dynamics_tpu/parallel/zero.py``. JAX states
the layout as shardings and lets GSPMD write the collectives; here each
rank keeps a slice of every sharded leaf and the collectives are explicit:

* ``shard_optimizer``: the optimizer state (AdamW's moments, Adafactor's
  statistics, the accumulation buffer) keeps each rank's slice. DDP
  all-reduces the gradient; each rank updates its slice of every parameter
  from its slice of that gradient, then the slices are all-gathered
  (:meth:`ZeroLayout.sync_params`, one collective a step);
* ``shard_ema``: the EMA copy keeps each rank's slice, blended from the
  same slice of the parameters: no collective in the step;
* ``shard_params``: FSDP2 ``fully_shard`` on the model's blocks
  (:func:`fully_shard_model`); the parameters, their gradients, the
  optimizer state and the EMA all keep the parameter's shard.

Under a spatial axis (``parallel.spatial`` > 1) every leaf shards over the
data group only and the ranks of a spatial group hold replicas (JAX
``parallel/zero.py``): ZeRO-1 and the EMA slice by the data rank and gather
over the data group, and FSDP2 runs on a 2-D mesh that replicates over
``spatial`` and shards over ``data`` (HSDP).

A leaf's slice is along the axis ``_best_axis`` (the largest axis that the
world size divides) picks on the leaf's JAX layout (:func:`zero_axis`), in
``torch.chunk``'s blocks. A leaf with no such axis stays
whole on every rank under ZeRO-1 and the EMA; FSDP2 takes no uneven shard
off dimension 0, so under ZeRO-3 it is ``Shard(0)`` with uneven blocks.

Adafactor's factored second moment takes means over a parameter's two
largest axes. Where a rank holds a slice of the axis a mean runs over, its
mean is of its slice only, so the means and the update's block RMS are
reduced across ranks (:meth:`ZeroLayout.axis_mean`, :meth:`norms`); GSPMD
does the same for JAX without being asked.

Under a tensor axis (``parallel.tensor`` = T > 1) every parameter is
first cut to the rank's block along ``_channel_axis`` of its JAX layout
(:func:`tensor_axis`; ``AutoencoderKL.shard_tensor_``), and the moments and
the EMA keep the same blocks (JAX ``state_shardings``). The ZeRO flags then
slice a *remaining* axis over the data group (JAX ``_combined_spec``:
``_best_axis`` of the whole shape with the tensor axis taken), and FSDP2
shards the rank's blocks over the data group (HSDP with a spatial axis).
Whole leaves are gathered over the data group, then over the tensor
group; the gradient norm adds a sharded leaf's squares over both and
counts a leaf the tensor axis leaves whole (the decoder's ``conv_out``
bias, O = 3) once. Adafactor's factored means and block RMS read the whole
shape the same way.

:func:`replicate_leaf` and :meth:`ZeroLayout.gather` are collectives: every
rank calls them, in the same order. They stand in for JAX's
``make_replicate_leaf_fn`` and ``make_gather_fn``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .mesh import DataAxis


def _best_axis(shape, size: int, taken=()) -> Optional[int]:
    """Largest axis divisible by ``size`` (ties prefer the LAST such axis:
    conv kernels are HWIO, so equal I/O sizes shard the output-channel
    axis, keeping the layout aligned with the parameter's contiguous minor
    dimension); ``taken`` axes are excluded. None if no axis qualifies.

    This is the ZeRO (data-axis) choice: the sharding is pure memory
    relief, so the biggest axis gives the best balance."""
    best = None
    for i, d in enumerate(shape):
        if i in taken:
            continue
        if d >= size and d % size == 0:
            if best is None or d >= shape[best]:
                best = i
    return best


def _channel_axis(shape, size: int) -> Optional[int]:
    """The LAST axis divisible by ``size``; None if no axis qualifies.

    This is the tensor-parallel choice, and unlike ``_best_axis`` it is a
    semantic contract rather than a balance heuristic: conv HWIO kernels
    take O (the contiguous minor dim, so each shard is one block of output
    channels), falling back to I when O doesn't divide (e.g. conv_out's
    O=3); γ/β/bias vectors take their only axis. 'Largest' would instead
    put down-projection convs (I > O, e.g. the decoder's 512→256) on the
    input-channel axis — the opposite layout from the documented one."""
    for i in range(len(shape) - 1, -1, -1):
        d = shape[i]
        if d >= size and d % size == 0:
            return i
    return None


def jax_axes(ndim: int) -> Tuple[int, ...]:
    """The port's axis of each axis of the JAX layout of a parameter: conv
    kernels are OIHW here and HWIO there, dense kernels (out, in) here and
    (in, out) there, vectors the same."""
    return {4: (2, 3, 1, 0), 2: (1, 0)}.get(ndim, tuple(range(ndim)))


def zero_axis(shape: Sequence[int], world: int, choose=_best_axis,
              taken: Optional[int] = None) -> Optional[int]:
    """The axis of a port parameter that ``choose`` (``_best_axis``, or
    ``_channel_axis``) picks on its JAX layout, so that both packages slice
    the same axis: an SDXL 3x3 conv with as many inputs as outputs is cut
    into blocks of output channels, not of input channels. ``taken`` (a
    port axis, the tensor axis) is left out of ``_best_axis``'s choice."""
    order = jax_axes(len(shape))
    jshape = tuple(shape[i] for i in order)
    if taken is None:
        a = choose(jshape, world)
    else:
        a = choose(jshape, world, taken=(order.index(taken),))
    return None if a is None else order[a]


def tensor_axis(shape: Sequence[int], tensor: int) -> Optional[int]:
    """The port axis a tensor axis of ``tensor`` ranks cuts a parameter of
    whole shape ``shape`` along (JAX ``_channel_axis``); None at 1 or where
    no axis divides."""
    return None if tensor <= 1 else zero_axis(shape, tensor, _channel_axis)


@dataclasses.dataclass(frozen=True)
class TensorShard:
    """A parameter that holds a tensor rank's block: the port axis it was
    cut along, that axis's whole length, and the ``ops.tensor_parallel
    .TensorGroup``."""

    axis: int
    length: int
    tp: Any


def chunk_span(n: int, rank: int, world: int) -> Tuple[int, int]:
    """(start, length) of ``rank``'s block of ``n`` entries in
    ``torch.chunk``'s layout (blocks of ceil(n / world), the last ones
    shorter or empty), which is FSDP2's and DTensor's ``Shard``."""
    c = -(-n // world)
    start = min(rank * c, n)
    return start, min(c, n - start)


def local_chunk(t: torch.Tensor, axis: Optional[int], rank: int, world: int) -> torch.Tensor:
    """``rank``'s block of ``t`` along ``axis`` (a view); ``t`` itself when
    ``axis`` is None."""
    if axis is None:
        return t
    start, length = chunk_span(t.shape[axis], rank, world)
    return t.narrow(axis, start, length)


def gather_chunks(local: torch.Tensor, axis: Optional[int], full_len: int,
                  world: int, group=None) -> torch.Tensor:
    """The whole tensor from every rank's block along ``axis`` (a
    collective over ``group``, the whole world by default); ``local``
    itself when ``axis`` is None."""
    if axis is None:
        return local
    c = -(-full_len // world)
    moved = local.movedim(axis, 0)
    if moved.shape[0] < c:
        pad = moved.new_zeros((c - moved.shape[0],) + tuple(moved.shape[1:]))
        moved = torch.cat([moved, pad])
    parts = [torch.empty_like(moved) for _ in range(world)]
    dist.all_gather(parts, moved.contiguous(), group=group)
    return torch.cat(parts)[:full_len].movedim(0, axis).contiguous()


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if _is_dtensor(t) else t


def shard_placement(t: torch.Tensor):
    """(mesh dim, ``Shard`` placement) of an FSDP2 parameter: its one
    ``Shard`` (after HSDP's ``Replicate`` on a spatial mesh)."""
    from torch.distributed.tensor import Shard

    for i, placement in enumerate(t.placements):
        if isinstance(placement, Shard):
            return i, placement
    raise ValueError(f"no Shard placement in {t.placements}")


def replicate_leaf(t: torch.Tensor) -> torch.Tensor:
    """The whole value of a parameter: an FSDP2 shard is all-gathered, a
    tensor rank's block (``tensor_shard``) all-gathered over its tensor
    group (collectives every rank calls); anything else passes through."""
    shard: Optional[TensorShard] = getattr(t, "tensor_shard", None)
    t = t.detach()
    if _is_dtensor(t):
        t = t.full_tensor()
    if shard is not None:
        t = gather_chunks(t, shard.axis, shard.length, shard.tp.size, shard.tp.group)
    return t


@torch.no_grad()
def write_leaf(param: torch.Tensor, value: torch.Tensor) -> None:
    """Write the whole ``value`` into ``param``: its own block of it where
    ``param`` is a tensor rank's block, an FSDP2 shard, or both."""
    shard: Optional[TensorShard] = getattr(param, "tensor_shard", None)
    if shard is not None:
        value = local_chunk(value, shard.axis, shard.tp.index, shard.tp.size)
    if _is_dtensor(param):
        mesh_dim, placement = shard_placement(param)
        mesh = param.device_mesh
        local = param.to_local()
        local.copy_(local_chunk(value.to(local.device), placement.dim,
                                mesh.get_local_rank(mesh_dim), mesh.size(mesh_dim)))
    else:
        param.copy_(value.to(param.device))


def _removed(axis: Optional[int], dim: int) -> Optional[int]:
    """``axis`` of a tensor once ``dim`` is reduced away (None when the
    slice was along ``dim``: the reduced leaf is whole)."""
    if axis is None or axis == dim:
        return None
    return axis - (axis > dim)


def fsdp_blocks(model: nn.Module) -> List[nn.Module]:
    """The model's blocks that FSDP2 shards one at a time: each down and up
    block and each mid block; the root holds the rest."""
    blocks: List[nn.Module] = []
    for coder in (model.encoder, model.decoder):
        blocks.extend(getattr(coder, "down_blocks", []))
        blocks.append(coder.mid_block)
        blocks.extend(getattr(coder, "up_blocks", []))
    return blocks


_HSDP_MESHES: Dict[tuple, object] = {}


def fsdp_mesh(axis: DataAxis):
    """The mesh FSDP2 takes: the data mesh (the data ranks of this rank's
    spatial and tensor ranks), or on a spatial mesh a 2-D one that
    replicates over ``spatial`` (its dim 0) and shards over ``data`` (HSDP;
    made once a process, a collective the first time)."""
    if axis.spatial == 1:
        return axis.mesh if axis.tensor == 1 else axis.mesh["data"]
    key = (str(axis.device), axis.world, axis.spatial, axis.tensor)
    if key not in _HSDP_MESHES:
        from torch.distributed.device_mesh import DeviceMesh

        # rank r = (d S + s) T + t: one (spatial, data) mesh a tensor index
        ranks = torch.arange(axis.world).reshape(axis.data_world, axis.spatial,
                                                 axis.tensor).permute(2, 1, 0).contiguous()
        mesh = DeviceMesh(axis.device.type, ranks,
                          mesh_dim_names=("tensor", "replicate", "shard"))
        _HSDP_MESHES[key] = mesh["replicate", "shard"]
    return _HSDP_MESHES[key]


def _shards_of(model: nn.Module) -> Dict[str, TensorShard]:
    return {n: p.tensor_shard for n, p in model.named_parameters()
            if getattr(p, "tensor_shard", None) is not None}


def whole_shape(p: torch.Tensor) -> Tuple[int, ...]:
    """A parameter's whole shape: a tensor rank's block's axis at its whole
    length (an FSDP2 shard's shape is already its whole one)."""
    shape = list(p.shape)
    shard: Optional[TensorShard] = getattr(p, "tensor_shard", None)
    if shard is not None:
        shape[shard.axis] = shard.length
    return tuple(shape)


def fully_shard_model(model: nn.Module, axis: DataAxis) -> nn.Module:
    """ZeRO-3: ``fully_shard`` each block, then the root. Each parameter is
    ``Shard(_best_axis)`` of its whole shape (with the tensor axis taken
    under a tensor axis), or ``Shard(0)`` (uneven) where the data axis
    divides no axis; on a spatial mesh each spatial group holds replicas.
    Under a tensor axis FSDP2 shards the rank's blocks over its data ranks,
    and each new parameter keeps its ``tensor_shard``."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    shards = _shards_of(model)
    taken = {id(p): shards[n].axis for n, p in model.named_parameters() if n in shards}
    whole = {id(p): whole_shape(p) for p in model.parameters()}

    def placement(p: nn.Parameter):
        a = zero_axis(whole.get(id(p), tuple(p.shape)), axis.data_world,
                      taken=taken.get(id(p)))
        return Shard(0 if a is None else a)

    mesh = fsdp_mesh(axis)
    for block in fsdp_blocks(model):
        fully_shard(block, mesh=mesh, shard_placement_fn=placement)
    fully_shard(model, mesh=mesh, shard_placement_fn=placement)
    for n, p in model.named_parameters():
        if n in shards:
            p.tensor_shard = shards[n]
    return model


class ZeroLayout:
    """Which slice of each parameter's state this rank keeps, and the
    collectives over those slices.

    ``opt_axes[i]`` is the axis of parameter ``i``'s optimizer state (and
    of the gradient and parameter slices the update reads) over the data
    group, ``ema_axes[i]`` its EMA's; None keeps the leaf whole over it.
    Under ``fsdp`` both are the parameter's own shard axis. ``t_axes[i]``
    is the axis a tensor axis cut the parameter along (None: whole over
    the tensor group); the data slices are of that block, whose shape is
    ``full_shapes[i]``, and ``whole_shapes[i]`` is the parameter's whole
    shape."""

    def __init__(self, axis: DataAxis, model: nn.Module, shard_optimizer: bool,
                 shard_ema: bool, fsdp: bool):
        self.axis = axis
        # the slices follow the data axis; a spatial group holds replicas
        self.rank, self.world = axis.data_rank, axis.data_world
        self.group = axis.data_group
        self.fsdp = fsdp
        params = dict(model.named_parameters())
        shards = [getattr(p, "tensor_shard", None) for p in params.values()]
        self.tp = next((sh.tp for sh in shards if sh is not None), None)
        self.t_axes = [None if sh is None else sh.axis for sh in shards]
        self.whole_shapes = [whole_shape(p) for p in params.values()]
        self.full_shapes = [tuple(p.shape) for p in params.values()]
        if self.tp is not None:
            # the rank's blocks (an FSDP2 shard's shape is the whole one)
            self.full_shapes = [
                s if a is None else s[:a] + (self.tp.block(s[a])[1],) + s[a + 1:]
                for s, a in zip(self.whole_shapes, self.t_axes)]
        self._masks: Dict[Tuple, torch.Tensor] = {}
        if fsdp:
            own = [shard_placement(p)[1].dim if _is_dtensor(p) else None
                   for p in params.values()]
            self.opt_axes = list(own)
            self.ema_axes = list(own)
        else:
            best = [zero_axis(s, self.world, taken=a)
                    for s, a in zip(self.whole_shapes, self.t_axes)]
            self.opt_axes = best if shard_optimizer else [None] * len(best)
            self.ema_axes = best if shard_ema else [None] * len(best)

    # ---------------- slices ---------------- #
    def _view(self, t: torch.Tensor, axis: Optional[int]) -> torch.Tensor:
        if self.fsdp:
            return _local(t)
        return local_chunk(t, axis, self.rank, self.world)

    def opt_params(self, model: nn.Module) -> Dict[str, torch.Tensor]:
        """The slices of the parameters the optimizer updates in place."""
        return {n: self._view(p.detach(), a)
                for (n, p), a in zip(model.named_parameters(), self.opt_axes)}

    def opt_grads(self, model: nn.Module) -> Dict[str, torch.Tensor]:
        out = {}
        for (n, p), a in zip(model.named_parameters(), self.opt_axes):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            out[n] = self._view(g, a)
        return out

    def ema_views(self, model: nn.Module) -> Dict[str, torch.Tensor]:
        return {n: self._view(p.detach(), a)
                for (n, p), a in zip(model.named_parameters(), self.ema_axes)}

    @torch.no_grad()
    def sync_params(self, model: nn.Module) -> None:
        """ZeRO-1: all-gather the parameter slices each rank updated, in one
        collective (every sharded slice has the same size on every rank)."""
        if self.fsdp:
            return
        sharded = [(p.detach(), a) for p, a in zip(model.parameters(), self.opt_axes)
                   if a is not None]
        if not sharded or self.world == 1:
            return
        views = [[local_chunk(p, a, r, self.world) for p, a in sharded]
                 for r in range(self.world)]
        flat = torch.cat([v.reshape(-1) for v in views[self.rank]])
        parts = [torch.empty_like(flat) for _ in range(self.world)]
        dist.all_gather(parts, flat, group=self.group)
        for r in range(self.world):
            if r == self.rank:
                continue
            srcs, off = [], 0
            for v in views[r]:
                srcs.append(parts[r][off:off + v.numel()].view(v.shape))
                off += v.numel()
            torch._foreach_copy_(views[r], srcs)

    # ---------------- reductions over slices ---------------- #
    def sharded(self, i: int) -> bool:
        return self.opt_axes[i] is not None and self.world > 1

    def axis_mean(self, i: int, t: torch.Tensor, dim: int, param_dim: int) -> torch.Tensor:
        """The mean of ``t`` over ``dim`` (the parameter's axis
        ``param_dim``) across every rank's slice when the state of parameter
        ``i`` is sliced along that axis over the data or the tensor group (a
        collective); the local mean otherwise."""
        over_data = self.opt_axes[i] == param_dim
        over_tensor = self.t_axes[i] == param_dim
        if not (over_data or over_tensor):
            return t.mean(dim=dim)
        s = t.sum(dim=dim)
        if over_data:
            dist.all_reduce(s, group=self.group)
        if over_tensor:
            dist.all_reduce(s, group=self.tp.group)
        return s / float(self.whole_shapes[i][param_dim])

    def _summed(self, sq: torch.Tensor, idx: Tuple[int, ...], which: str) -> torch.Tensor:
        """``sq`` with the entries of the leaves sliced over the data group
        (``which`` "data") or the tensor group ("tensor") summed over it."""
        key = (which, idx)
        mask = self._masks.get(key)
        if mask is None:
            # made once: a copy from the host would wait for the device
            sliced = (self.sharded if which == "data"
                      else lambda i: self.t_axes[i] is not None)
            mask = self._masks[key] = torch.tensor(
                [1.0 if sliced(i) else 0.0 for i in idx], device=sq.device)
        shared = sq * mask
        dist.all_reduce(shared, group=self.group if which == "data" else self.tp.group)
        return shared + sq * (1.0 - mask)

    def norms(self, idx: Sequence[int], tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """The L2 norm of each whole tensor from the slices (one collective
        for all of them a group: the data group's, then the tensor
        group's); a leaf whole over a group is counted once."""
        sq = torch.stack(torch._foreach_norm(tensors)).square()
        idx = tuple(idx)
        sq = self._summed(sq, idx, "data")
        if self.tp is not None:
            sq = self._summed(sq, idx, "tensor")
        return list(sq.sqrt().unbind())

    def global_norm(self, tensors: List[torch.Tensor]) -> torch.Tensor:
        """sqrt of the sum of squares of every element of the whole
        tensors, from their slices."""
        return torch.linalg.vector_norm(torch.stack(self.norms(range(len(tensors)),
                                                               tensors)))

    # ---------------- whole leaves ---------------- #
    def _factored(self, field: str, i: int) -> Optional[int]:
        """The parameter axis Adafactor's ``field`` reduces away (None for a
        full-shape field); the factored axes are the whole shape's."""
        from ..training.step import factored_dims

        if field not in ("v_row", "v_col"):
            return None
        d1, d0 = factored_dims(self.whole_shapes[i])
        return d0 if field == "v_row" else d1

    def leaf_axis(self, field: str, i: int) -> Optional[int]:
        """The data slice axis of a state leaf: ``param``, ``ema`` or an
        optimizer field of parameter ``i``."""
        if field == "param":
            return self.opt_axes[i] if self.fsdp else None
        if field == "ema":
            return self.ema_axes[i]
        gone = self._factored(field, i)
        a = self.opt_axes[i]
        return a if gone is None else _removed(a, gone)

    def tensor_leaf_axis(self, field: str, i: int) -> Optional[int]:
        """The tensor-block axis of a state leaf (None: whole over the
        tensor group)."""
        gone = self._factored(field, i)
        return self.t_axes[i] if gone is None else _removed(self.t_axes[i], gone)

    def leaf_shape(self, field: str, i: int, whole: bool = False) -> Tuple[int, ...]:
        """A leaf's shape over the data group: the tensor block's, or with
        ``whole`` the whole leaf's."""
        shape = list(self.whole_shapes[i] if whole else self.full_shapes[i])
        gone = self._factored(field, i)
        if gone is not None:
            del shape[gone]
        return tuple(shape)

    def gather(self, field: str, i: int, local: torch.Tensor) -> torch.Tensor:
        """The whole leaf (collectives when it is sliced): over the data
        group, then over the tensor group."""
        out = _local(local)
        a = self.leaf_axis(field, i)
        if a is not None and (self.world > 1 or _is_dtensor(local)):
            out = gather_chunks(out, a, self.leaf_shape(field, i)[a], self.world, self.group)
        t = self.tensor_leaf_axis(field, i)
        if t is not None:
            out = gather_chunks(out, t, self.leaf_shape(field, i, whole=True)[t],
                                self.tp.size, self.tp.group)
        return out

    def scatter(self, field: str, i: int, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of a whole leaf."""
        t = self.tensor_leaf_axis(field, i)
        if t is not None:
            full = local_chunk(full, t, self.tp.index, self.tp.size)
        return local_chunk(full, self.leaf_axis(field, i), self.rank, self.world)


def state_bytes(state) -> Tuple[int, int]:
    """(bytes of this rank's sliced state leaves, bytes of its whole ones)
    over the parameters, the optimizer state and the EMA."""
    layout: Optional[ZeroLayout] = getattr(state, "layout", None)
    sliced = whole = 0

    def add(field: str, i: int, t: Optional[torch.Tensor]) -> None:
        nonlocal sliced, whole
        if t is None:
            return
        nbytes = _local(t).numel() * t.element_size()
        if layout is not None and layout.leaf_axis(field, i) is not None:
            sliced += nbytes
        else:
            whole += nbytes

    for i, p in enumerate(state.model.parameters()):
        add("param", i, p)
    opt = state.opt_state
    for field in ("mu", "nu", "v_row", "v_col", "v", "acc_grads"):
        for i, t in enumerate(getattr(opt, field, None) or []):
            add(field, i, t)
    for i, t in enumerate((state.ema_params or {}).values()):
        add("ema", i, t)
    return sliced, whole


__all__ = [
    "TensorShard",
    "ZeroLayout",
    "_best_axis",
    "_channel_axis",
    "chunk_span",
    "fsdp_blocks",
    "fsdp_mesh",
    "fully_shard_model",
    "gather_chunks",
    "local_chunk",
    "replicate_leaf",
    "shard_placement",
    "state_bytes",
    "tensor_axis",
    "whole_shape",
    "write_leaf",
    "zero_axis",
]
