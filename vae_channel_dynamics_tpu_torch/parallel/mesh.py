"""The ``data``, ``spatial`` and ``tensor`` axes across GPUs: the process
groups, the mesh and the batch layout.

Counterpart of ``vae_channel_dynamics_tpu/parallel/mesh.py``. The JAX
package runs one SPMD program over a device mesh; the port runs one process
per card, launched by ``torchrun``::

    python -m torch.distributed.run --nproc_per_node N \\
        -m vae_channel_dynamics_tpu_torch.train --config_path <yaml>

:func:`initialize_distributed` reads torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), puts the
process on ``cuda:LOCAL_RANK`` and joins the NCCL group; ``device="cpu"``
joins a gloo group instead (the CPU tests). Without that environment there
is no group and everything runs in one process on one device, as before.

Each rank holds one contiguous block of every global batch
(:func:`local_block`, the JAX ``batch_sharding`` layout), so the pad rows
that :func:`pad_batch_to_multiple` appends land on the last ranks. The
Trainer's loaders read the strided per-rank shards of the data pipeline
instead (``data/pipeline.py``, ``shard_index``/``num_shards``); the union of
the ranks' batch t is the one-process batch t either way.

``parallel.spatial`` = S > 1 lays the ranks out as JAX ``make_mesh`` does:
``data`` outer and ``spatial`` inner, so rank ``r`` is data rank ``r // S``
and spatial rank ``r % S``, and a spatial group is a block of neighbouring
ranks (:func:`with_layout`). Every rank of a spatial group reads the same
images and keeps its block of their rows (``ops/spatial_conv.py``); the
batch, its pad rows and its validity mask follow the data axis only.

``parallel.tensor`` = T > 1 adds JAX's innermost ``tensor`` axis: the mesh
is ``("data", "spatial", "tensor")`` (trivial axes dropped, ``data`` kept),
so rank ``r`` is tensor rank ``r % T``, spatial rank ``(r // T) % S`` and
data rank ``r // (S T)``, and a tensor group is a block of T neighbouring
ranks. Every rank of a tensor group reads the same images and rows and
keeps its block of every sharded parameter's channels
(``ops/tensor_parallel.py``). T must divide 32, the SDXL GroupNorm's group
count, so that every group lies whole on one rank; JAX accepts any T that
divides the device count.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"
TENSOR_AXIS = "tensor"
# the GroupNorm group count a tensor axis must divide
TENSOR_GROUPS = 32

_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass
class DataAxis:
    """This process's place on the mesh: its rank, the world size, its
    device and the ``DeviceMesh``: 1-D named ``data``, else named
    ``("data", "spatial", "tensor")`` without the trivial ones.
    ``data_group`` is the process group of the ranks that hold the same
    rows and channels of other images (None: the whole world, at
    ``spatial`` and ``tensor`` 1); ``spatial_group`` that of the ranks that
    hold the rows of the same images (None at ``spatial`` 1);
    ``tensor_group`` that of the ranks that hold the channels of the same
    rows (None at ``tensor`` 1); ``replica_group`` that of the ranks that
    hold the same channel block, over which the gradient is summed (None:
    the whole world, at ``tensor`` 1)."""

    rank: int
    world: int
    local_rank: int
    device: torch.device
    mesh: Any
    # whether this process started the group (and so ends it in shutdown)
    owned: bool = True
    spatial: int = 1
    data_group: Any = None
    spatial_group: Any = None
    tensor: int = 1
    tensor_group: Any = None
    replica_group: Any = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def data_world(self) -> int:
        """The number of batch shards: the world over ``spatial`` x
        ``tensor``."""
        return self.world // (self.spatial * self.tensor)

    @property
    def data_rank(self) -> int:
        return self.rank // (self.spatial * self.tensor)

    @property
    def spatial_rank(self) -> int:
        return (self.rank // self.tensor) % self.spatial

    @property
    def tensor_rank(self) -> int:
        return self.rank % self.tensor

    @property
    def replica_world(self) -> int:
        """The ranks that hold this rank's channel block: the world over
        ``tensor``."""
        return self.world // self.tensor

    @property
    def backend(self) -> str:
        return dist.get_backend()


def refuse_unported_axes(parallel: Optional[Dict[str, Any]]) -> None:
    """``parallel.slices`` (the TPU pod's DCN axis) has no counterpart on a
    GPU host. The data, spatial and tensor axes are ported, and
    ``spatial_conv`` takes both of JAX's values (:func:`spatial_conv_choice`),
    with or without a tensor axis."""
    parallel = parallel or {}
    if int(parallel.get("slices") or 1) > 1:
        raise NotImplementedError(
            "parallel.slices > 1: the multi-slice DCN axis is a TPU pod layout "
            "(ROADMAP Q1, Do not port); launch one process per card with torchrun"
        )


def spatial_conv_choice(parallel: Optional[Dict[str, Any]]) -> str:
    """``parallel.spatial_conv``, checked as JAX ``make_mesh`` checks it.
    Both values run the port's one manual halo exchange
    (``ops/spatial_conv.py``): the key exists in JAX to route around XLA's
    partitioner, which the port does not have."""
    value = (parallel or {}).get("spatial_conv", "gspmd") or "gspmd"
    if value not in ("gspmd", "shard_map"):
        raise ValueError(
            f"parallel.spatial_conv must be 'gspmd' or 'shard_map', got {value!r}"
        )
    return value


def launched_by_torchrun() -> bool:
    return all(k in os.environ for k in _ENV)


def initialize_distributed(device: Any = "cuda") -> Optional[DataAxis]:
    """Join the process group torchrun describes and return this process's
    :class:`DataAxis`; None when the process was not launched by torchrun.

    ``device`` ``cuda`` puts the process on ``cuda:LOCAL_RANK`` (set before
    the group starts) with the NCCL backend; ``cpu`` uses gloo. Anything
    that keeps the group from starting raises: no rank carries on alone."""
    if not launched_by_torchrun():
        return None
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ["LOCAL_RANK"])
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("torchrun launched a cuda rank but torch.cuda.is_available() "
                               "is false; pass --device cpu for gloo on the CPU")
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {local_rank} but only "
                               f"{torch.cuda.device_count()} visible cards")
        if not dist.is_nccl_available():
            raise RuntimeError("this torch build has no NCCL backend")
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif kind == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"unsupported device {device!r} for the data axis")
    owned = not dist.is_initialized()
    if owned:
        kwargs = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(
            backend, init_method=f"tcp://{os.environ['MASTER_ADDR']}:"
                                 f"{os.environ['MASTER_PORT']}",
            rank=rank, world_size=world, **kwargs)
    axis = make_mesh(dev, rank=rank, world=world, local_rank=local_rank)
    axis.owned = owned
    logger.info("process group up: rank %d of %d on %s (%s)", rank, world, dev, backend)
    return axis


def check_tensor(tensor: int) -> int:
    """``parallel.tensor`` checked: at least 1, and a divisor of
    :data:`TENSOR_GROUPS`, so that the GroupNorm groups of a rank's channel
    block are whole (JAX accepts any T that divides the device count)."""
    tensor = 1 if tensor is None else int(tensor)
    if tensor < 1:
        raise ValueError(f"parallel.tensor must be >= 1, got {tensor}")
    if TENSOR_GROUPS % tensor:
        raise ValueError(
            f"parallel.tensor={tensor} must divide {TENSOR_GROUPS}, the GroupNorm group "
            "count, so that every group lies whole on one rank's channel block"
        )
    return tensor


def make_mesh(device: torch.device, rank: Optional[int] = None, world: Optional[int] = None,
              local_rank: int = 0, spatial: int = 1, tensor: int = 1) -> DataAxis:
    """The ``DeviceMesh`` over every rank of the group: 1-D named ``data``
    at ``spatial`` and ``tensor`` 1, else ``("data", "spatial", "tensor")``
    of shape (world / (S T), S, T) without its trivial axes, with its
    process groups (a collective: every rank calls it)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size() if world is None else world
    rank = dist.get_rank() if rank is None else rank
    spatial = int(spatial or 1)
    if spatial < 1:
        raise ValueError(f"parallel.spatial must be >= 1, got {spatial}")
    tensor = check_tensor(tensor)
    if world % (spatial * tensor) != 0:
        raise ValueError(
            f"{world} devices not divisible by slices=1 x spatial={spatial} x tensor={tensor}"
        )
    if spatial == 1 and tensor == 1:
        mesh = init_device_mesh(device.type, (world,), mesh_dim_names=(DATA_AXIS,))
        return DataAxis(rank=rank, world=world, local_rank=local_rank, device=device,
                        mesh=mesh)
    dims = [(DATA_AXIS, world // (spatial * tensor)), (SPATIAL_AXIS, spatial),
            (TENSOR_AXIS, tensor)]
    dims = [(n, k) for n, k in dims if n == DATA_AXIS or k > 1]
    mesh = init_device_mesh(device.type, tuple(k for _, k in dims),
                            mesh_dim_names=tuple(n for n, _ in dims))
    replicas = None
    if tensor > 1:
        # the ranks of each tensor index (every rank creates every group)
        for t in range(tensor):
            g = dist.new_group(list(range(t, world, tensor)))
            if t == rank % tensor:
                replicas = g
    return DataAxis(rank=rank, world=world, local_rank=local_rank, device=device, mesh=mesh,
                    spatial=spatial, data_group=mesh.get_group(DATA_AXIS),
                    spatial_group=mesh.get_group(SPATIAL_AXIS) if spatial > 1 else None,
                    tensor=tensor,
                    tensor_group=mesh.get_group(TENSOR_AXIS) if tensor > 1 else None,
                    replica_group=replicas)


_LAYOUTS: Dict[Tuple[str, int, int, int], DataAxis] = {}


def with_layout(axis: Optional[DataAxis], spatial: int = 1,
                tensor: int = 1) -> Optional[DataAxis]:
    """``axis`` laid out with ``spatial`` ranks a spatial group and
    ``tensor`` ranks a tensor group (the mesh and its groups, made once a
    process for each layout; a collective the first time). Without a group
    (``axis`` None) only 1 and 1 run: one device does not divide into
    shards."""
    spatial, tensor = int(spatial or 1), check_tensor(tensor)
    if axis is None:
        if spatial > 1 or tensor > 1:
            raise ValueError(
                f"1 devices not divisible by slices=1 x spatial={spatial} x tensor={tensor}: "
                "launch one process per card with torchrun"
            )
        return None
    if axis.spatial == spatial and axis.tensor == tensor:
        return axis
    key = (str(axis.device), axis.world, spatial, tensor)
    if key not in _LAYOUTS:
        _LAYOUTS[key] = make_mesh(axis.device, rank=axis.rank, world=axis.world,
                                  local_rank=axis.local_rank, spatial=spatial, tensor=tensor)
    out = dataclasses.replace(_LAYOUTS[key], owned=axis.owned)
    logger.info("mesh: %d data x %d spatial x %d tensor ranks (rank %d: data rank %d, rows "
                "block %d, channel block %d)", out.data_world, spatial, tensor, out.rank,
                out.data_rank, out.spatial_rank, out.tensor_rank)
    return out


def mesh_shape(axis: Optional[DataAxis]) -> Dict[str, int]:
    """The mesh's axes as JAX names them in its warnings: ``data`` always,
    ``spatial`` and ``tensor`` when above 1."""
    if axis is None:
        return {DATA_AXIS: 1}
    out = {DATA_AXIS: axis.data_world}
    if axis.spatial > 1:
        out[SPATIAL_AXIS] = axis.spatial
    if axis.tensor > 1:
        out[TENSOR_AXIS] = axis.tensor
    return out


def shutdown(axis: Optional[DataAxis]) -> None:
    """Leave the process group this process started (after a barrier, so
    no rank tears down a collective another is still in); a group an
    in-process caller started stays up."""
    if axis is not None and axis.owned and dist.is_initialized():
        dist.barrier()
        _LAYOUTS.clear()
        dist.destroy_process_group()


def data_axis_size(axis: Optional[DataAxis]) -> int:
    """Number of batch shards: the world size over ``spatial`` x
    ``tensor``, 1 without a group."""
    return 1 if axis is None else axis.data_world


def pad_batch_to_multiple(
    batch: Dict[str, np.ndarray], multiple: int
) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Pad the batch's leading axis up to a multiple of ``multiple`` by
    repeating the last row; returns (padded batch, validity mask). The mask
    weights the losses, the metrics and the taps, so the pad rows carry no
    weight. The JAX package's function, copied."""
    n = next(iter(batch.values())).shape[0]
    padded_n = ((n + multiple - 1) // multiple) * multiple
    mask = np.zeros(padded_n, np.float32)
    mask[:n] = 1.0
    if padded_n == n:
        return batch, mask
    out = {}
    for k, v in batch.items():
        pad = np.repeat(v[-1:], padded_n - n, axis=0)
        out[k] = np.concatenate([v, pad], axis=0)
    return out, mask


Rows = Union[np.ndarray, torch.Tensor]


def block_rows(n: int, rank: int, world: int) -> slice:
    """The contiguous rows of ``n`` that ``rank`` holds (``n`` a multiple
    of ``world``)."""
    if n % world:
        raise ValueError(f"{n} rows do not split into {world} equal blocks; pad them first "
                         "(pad_batch_to_multiple)")
    per = n // world
    return slice(rank * per, (rank + 1) * per)


def local_block(batch: Union[Rows, Dict[str, Rows]], rank: int, world: int):
    """``rank``'s contiguous block of a global batch (an array, or a dict of
    arrays with one leading batch axis): the JAX ``batch_sharding`` layout,
    in place of ``make_global_array``."""
    if isinstance(batch, dict):
        n = next(iter(batch.values())).shape[0]
        rows = block_rows(n, rank, world)
        return {k: v[rows] for k, v in batch.items()}
    return batch[block_rows(batch.shape[0], rank, world)]


def all_gather_rows(t: torch.Tensor, world: int, group: Any = None) -> torch.Tensor:
    """The ranks' equal-sized ``t`` stacked along a new leading axis:
    (world, *t.shape), over ``group`` (the whole world by default)."""
    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


__all__ = [
    "DATA_AXIS",
    "SPATIAL_AXIS",
    "TENSOR_AXIS",
    "TENSOR_GROUPS",
    "DataAxis",
    "all_gather_rows",
    "block_rows",
    "check_tensor",
    "data_axis_size",
    "initialize_distributed",
    "launched_by_torchrun",
    "local_block",
    "make_mesh",
    "mesh_shape",
    "pad_batch_to_multiple",
    "refuse_unported_axes",
    "shutdown",
    "spatial_conv_choice",
    "with_layout",
]
