"""Per-channel activation statistics, computed on the device.

Counterpart of ``vae_channel_dynamics_tpu/ops/stats.py``: the same five
metrics with the same semantics, for the port's layouts. A 4-D activation is
NCHW (channel axis 1); any other rank keeps its channel last, as the
attention projections' ``(B, N, C)`` do in both packages. Every statistic is
taken in fp32 on a detached tensor: the taps observe the forward and are no
part of the loss, so they hold no autograd graph.

- ``mean_abs_activation_per_channel``: |x| averaged over batch and spatial
  positions, shape (C,);
- ``mean_activation``: the scalar mean;
- ``std_activation``: the scalar unbiased (ddof=1) std;
- ``zero_fraction_per_channel``: the fraction of |x| < 1e-8 per channel;
- ``full_activation_map``: the raw tensor, NCHW already, so returned as is.

Batch-validity masking: the train step installs the step's (B,) 0/1 mask
with :func:`tap_mask` around the forward (and its backward), and every
metric but the full map then reduces over the valid rows only, so
remainder-batch pad duplicates carry zero weight. JAX reads the mask while it
traces; PyTorch runs eagerly, so the context manager simply has to be open
while the model runs.

Across ranks (``parallel/``) the means are over the global batch, as JAX
takes them on global arrays: the train step passes the global valid count,
so each rank's value of a linear metric is its share of the global mean,
and the step adds the shares over the ranks (:data:`SUMMED_METRICS`).
``std_activation`` is not linear: with ``reduce`` it adds its sums over the
ranks itself, so every rank gets the global value.

Under a spatial group (``ops/spatial_conv.py``) each rank holds a block of
every activation's rows, and with a mask installed each linear metric is
this rank's share of the whole image's mean (divided by the group's size
too), which the step adds over every rank; ``std_activation`` counts the
whole image, and ``full_activation_map`` gathers its rows over the group.

Under a tensor group (``ops/tensor_parallel.py``) an activation is the
rank's block of its channels or whole on every rank, which
:func:`channel_stats` tells apart by the layer's channel count. A
per-channel metric is the rank's block of the vector either way (cut from
the whole vector for a whole tensor), so the train step's running sums stay
blocks on the device, summed over the data and spatial ranks only, and are
gathered whole at the monitor's interval (``tracking/monitor.py``). A
scalar metric summed over the ranks is 1/T of the rank's value, so that the
sum over the tensor ranks is the one-card value whether the rank held a
block or the whole; ``std_activation`` adds a block's sums over every rank
and a whole tensor's over the ranks of its tensor index; the full map is
gathered whole.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from .spatial_conv import active_spatial_group
from .tensor_parallel import active_tensor_group, channel_block, gather_channels

_TAP_MASK: Optional[torch.Tensor] = None
_TAP_COUNT: Optional[torch.Tensor] = None
_TAP_REDUCE = False

# the metrics whose per-rank values, taken with the global count, add up
# over the ranks to the global value
SUMMED_METRICS = frozenset({"mean_abs_activation_per_channel", "mean_activation",
                            "zero_fraction_per_channel"})


@contextlib.contextmanager
def tap_mask(mask: Optional[torch.Tensor], count: Optional[torch.Tensor] = None,
             reduce: bool = False):
    """Install a (B,)-shaped 0/1 validity mask for the tap metrics while the
    block runs; the previous mask comes back afterwards. ``count`` is the
    valid rows of the global batch (a 0-d device tensor; the mask's own sum
    by default); ``reduce`` has ``std_activation`` add its sums over the
    ranks of the process group."""
    global _TAP_MASK, _TAP_COUNT, _TAP_REDUCE
    prev = _TAP_MASK, _TAP_COUNT, _TAP_REDUCE
    _TAP_MASK, _TAP_COUNT, _TAP_REDUCE = mask, count, reduce
    try:
        yield
    finally:
        _TAP_MASK, _TAP_COUNT, _TAP_REDUCE = prev


def mask_for(x: torch.Tensor) -> Optional[torch.Tensor]:
    """The installed mask as fp32 when it matches ``x``'s leading (batch)
    dim; None otherwise. Public so that producers of per-sample sums outside
    this module (the GroupNorm kernel's |z| tap) weight them the same way."""
    m = _TAP_MASK
    if m is None or x.dim() < 2 or m.dim() != 1 or x.shape[0] != m.shape[0]:
        return None
    return m.to(device=x.device, dtype=torch.float32)


def mask_count(m: torch.Tensor) -> torch.Tensor:
    """The number of valid rows a masked mean divides by: the global count
    when one is installed, else the mask's sum (at least 1)."""
    count = m.sum() if _TAP_COUNT is None else _TAP_COUNT.to(m.device)
    return count.clamp_min(1.0)


def _row_shards() -> int:
    """How many row shards a spatial position of a tapped tensor is one of:
    the installed spatial group's size, else 1."""
    sp = active_spatial_group()
    return 1 if sp is None else sp.size


def _channel_dim(x: torch.Tensor) -> int:
    return 1 if x.dim() == 4 else x.dim() - 1


def _per_sample_channel_mean(v: torch.Tensor) -> torch.Tensor:
    """Mean over every axis but batch and channel: (B, C)."""
    cdim = _channel_dim(v)
    dims = tuple(d for d in range(1, v.dim()) if d != cdim)
    return v.mean(dim=dims) if dims else v


def _masked_channel_mean(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    per_sample = _per_sample_channel_mean(v)
    return (per_sample * m[:, None]).sum(dim=0) / (mask_count(m) * _row_shards())


def _channel_mean(v: torch.Tensor) -> torch.Tensor:
    cdim = _channel_dim(v)
    return v.mean(dim=tuple(d for d in range(v.dim()) if d != cdim))


def mean_abs_activation_per_channel(x: torch.Tensor) -> torch.Tensor:
    xf = x.detach().float().abs()
    m = mask_for(x)
    return _channel_mean(xf) if m is None else _masked_channel_mean(xf, m)


def mean_activation(x: torch.Tensor) -> torch.Tensor:
    xf = x.detach().float()
    m = mask_for(x)
    if m is None:
        return xf.mean()
    per_sample = xf.mean(dim=tuple(range(1, x.dim())))
    return (per_sample * m).sum() / (mask_count(m) * _row_shards())


def std_activation(x: torch.Tensor, channel_shards: int = 1, group=None) -> torch.Tensor:
    """``channel_shards``: how many channel blocks ``x`` is one of; the
    sums are added over ``group`` (the whole world by default)."""
    xf = x.detach().float()
    m = mask_for(x)
    if m is None:
        return xf.std(correction=1)
    # masked unbiased std over every element of the valid samples, in two
    # passes: E[x^2] - E[x]^2 cancels in fp32 when |mean| dominates the std
    per_elem = math.prod(x.shape[1:]) * _row_shards() * channel_shards
    w = m.reshape((-1,) + (1,) * (x.dim() - 1))
    n = (m.sum() if _TAP_COUNT is None else _TAP_COUNT.to(m.device)) * float(per_elem)
    total = (xf * w).sum()
    if _TAP_REDUCE:
        dist.all_reduce(total, group=group)
    mean = total / n.clamp_min(1.0)
    dev = ((xf - mean).square() * w).sum()
    if _TAP_REDUCE:
        dist.all_reduce(dev, group=group)
    var = dev / (n - 1.0).clamp_min(1.0)
    return var.sqrt()


def zero_fraction_per_channel(x: torch.Tensor, tol: float = 1e-8) -> torch.Tensor:
    xf = (x.detach().float().abs() < tol).float()
    m = mask_for(x)
    return _channel_mean(xf) if m is None else _masked_channel_mean(xf, m)


def full_activation_map(x: torch.Tensor) -> torch.Tensor:
    """The raw activation, detached. The JAX package transposes its NHWC
    tensor to NCHW here; the port's tensor is NCHW already. Under a spatial
    group the rows of every shard, in order (a collective)."""
    x = x.detach()
    sp = active_spatial_group()
    if sp is None:
        return x
    parts = [torch.empty_like(x) for _ in range(sp.size)]
    dist.all_gather(parts, x.contiguous(), group=sp.group)
    # NCHW rows, or the tokens of a (B, N, C) tensor
    return torch.cat(parts, dim=2 if x.dim() == 4 else 1)


METRIC_FNS = {
    "mean_abs_activation_per_channel": mean_abs_activation_per_channel,
    "mean_activation": mean_activation,
    "std_activation": std_activation,
    "zero_fraction_per_channel": zero_fraction_per_channel,
    "full_activation_map": full_activation_map,
}


def channel_stats(x: torch.Tensor, metrics: Tuple[str, ...],
                  channels: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The requested metrics of one activation tensor; unknown names are
    skipped, as in the JAX package. ``channels`` is the layer's whole
    channel count, which tells a tensor group's block from a whole tensor
    (module docstring)."""
    tp = active_tensor_group() if channels is not None else None
    sharded = tp is not None and x.shape[_channel_dim(x)] != channels
    out: Dict[str, torch.Tensor] = {}
    for name in metrics:
        fn = METRIC_FNS.get(name)
        if fn is None:
            continue
        if tp is None:
            out[name] = fn(x)
        elif name == "std_activation":
            out[name] = (std_activation(x, tp.size) if sharded
                         else std_activation(x, group=tp.replicas))
        elif name == "full_activation_map":
            value = fn(x)
            out[name] = gather_channels(value, _channel_dim(value), tp) if sharded else value
        else:
            value = fn(x)
            if value.dim() == 1 and not sharded:
                value = channel_block(value, 0, tp)
            elif value.dim() == 0 and _TAP_REDUCE:
                value = value / float(tp.size)
            out[name] = value
    return out


__all__ = [
    "METRIC_FNS",
    "SUMMED_METRICS",
    "channel_stats",
    "full_activation_map",
    "mask_count",
    "mask_for",
    "mean_abs_activation_per_channel",
    "mean_activation",
    "std_activation",
    "tap_mask",
    "zero_fraction_per_channel",
]
