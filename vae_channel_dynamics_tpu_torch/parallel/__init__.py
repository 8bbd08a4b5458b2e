"""More than one GPU over a ``data`` axis: the process group and the batch
layout (``mesh.py``), and ZeRO-1/EMA/ZeRO-3 (``zero.py``)."""

from .mesh import (
    DataAxis,
    data_axis_size,
    initialize_distributed,
    local_block,
    make_mesh,
    pad_batch_to_multiple,
    refuse_unported_axes,
)

__all__ = [
    "DataAxis",
    "data_axis_size",
    "initialize_distributed",
    "local_block",
    "make_mesh",
    "pad_batch_to_multiple",
    "refuse_unported_axes",
]
