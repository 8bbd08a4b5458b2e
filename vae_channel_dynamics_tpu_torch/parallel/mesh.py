"""The ``data`` axis across GPUs: the process group, the mesh and the batch
layout.

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

_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass
class DataAxis:
    """This process's place on the data axis: its rank, the world size, its
    device and the 1-D ``DeviceMesh`` named ``data``."""

    rank: int
    world: int
    local_rank: int
    device: torch.device
    mesh: Any
    # whether this process started the group (and so ends it in shutdown)
    owned: bool = True

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def backend(self) -> str:
        return dist.get_backend()


def refuse_unported_axes(parallel: Optional[Dict[str, Any]]) -> None:
    """``parallel.spatial`` and ``parallel.tensor`` above 1 are the next
    slice of the multi-GPU work; ``parallel.slices`` (the TPU pod's DCN
    axis) has no counterpart on a GPU host."""
    parallel = parallel or {}
    for axis in ("spatial", "tensor"):
        if int(parallel.get(axis) or 1) > 1:
            raise NotImplementedError(
                f"parallel.{axis} > 1 is not ported to PyTorch yet (ROADMAP Q1, "
                "Spatial and tensor parallelism); the data axis is: launch one "
                "process per card with torchrun"
            )
    if int(parallel.get("slices") or 1) > 1:
        raise NotImplementedError(
            "parallel.slices > 1: the multi-slice DCN axis is a TPU pod layout "
            "(ROADMAP Q1, Do not port); launch one process per card with torchrun"
        )


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


def make_mesh(device: torch.device, rank: Optional[int] = None, world: Optional[int] = None,
              local_rank: int = 0) -> DataAxis:
    """The 1-D ``DeviceMesh`` named ``data`` over every rank of the group."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size() if world is None else world
    rank = dist.get_rank() if rank is None else rank
    mesh = init_device_mesh(device.type, (world,), mesh_dim_names=(DATA_AXIS,))
    return DataAxis(rank=rank, world=world, local_rank=local_rank, device=device, mesh=mesh)


def shutdown(axis: Optional[DataAxis]) -> None:
    """Leave the process group this process started (after a barrier, so
    no rank tears down a collective another is still in); a group an
    in-process caller started stays up."""
    if axis is not None and axis.owned and dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def data_axis_size(axis: Optional[DataAxis]) -> int:
    """Number of batch shards: the world size, 1 without a group."""
    return 1 if axis is None else axis.world


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


def all_gather_rows(t: torch.Tensor, world: int) -> torch.Tensor:
    """The ranks' equal-sized ``t`` stacked along a new leading axis:
    (world, *t.shape)."""
    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t.contiguous())
    return torch.stack(parts)


__all__ = [
    "DATA_AXIS",
    "DataAxis",
    "all_gather_rows",
    "block_rows",
    "data_axis_size",
    "initialize_distributed",
    "launched_by_torchrun",
    "local_block",
    "make_mesh",
    "pad_batch_to_multiple",
    "refuse_unported_axes",
    "shutdown",
]
