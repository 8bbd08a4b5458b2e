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
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Tuple

import torch

_TAP_MASK: Optional[torch.Tensor] = None


@contextlib.contextmanager
def tap_mask(mask: Optional[torch.Tensor]):
    """Install a (B,)-shaped 0/1 validity mask for the tap metrics while the
    block runs; the previous mask comes back afterwards."""
    global _TAP_MASK
    prev = _TAP_MASK
    _TAP_MASK = mask
    try:
        yield
    finally:
        _TAP_MASK = prev


def mask_for(x: torch.Tensor) -> Optional[torch.Tensor]:
    """The installed mask as fp32 when it matches ``x``'s leading (batch)
    dim; None otherwise. Public so that producers of per-sample sums outside
    this module (the GroupNorm kernel's |z| tap) weight them the same way."""
    m = _TAP_MASK
    if m is None or x.dim() < 2 or m.dim() != 1 or x.shape[0] != m.shape[0]:
        return None
    return m.to(device=x.device, dtype=torch.float32)


def _channel_dim(x: torch.Tensor) -> int:
    return 1 if x.dim() == 4 else x.dim() - 1


def _per_sample_channel_mean(v: torch.Tensor) -> torch.Tensor:
    """Mean over every axis but batch and channel: (B, C)."""
    cdim = _channel_dim(v)
    dims = tuple(d for d in range(1, v.dim()) if d != cdim)
    return v.mean(dim=dims) if dims else v


def _masked_channel_mean(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    per_sample = _per_sample_channel_mean(v)
    return (per_sample * m[:, None]).sum(dim=0) / m.sum().clamp_min(1.0)


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
    return (per_sample * m).sum() / m.sum().clamp_min(1.0)


def std_activation(x: torch.Tensor) -> torch.Tensor:
    xf = x.detach().float()
    m = mask_for(x)
    if m is None:
        return xf.std(correction=1)
    # masked unbiased std over every element of the valid samples, in two
    # passes: E[x^2] - E[x]^2 cancels in fp32 when |mean| dominates the std
    per_elem = math.prod(x.shape[1:])
    w = m.reshape((-1,) + (1,) * (x.dim() - 1))
    n = m.sum() * float(per_elem)
    mean = (xf * w).sum() / n.clamp_min(1.0)
    var = ((xf - mean).square() * w).sum() / (n - 1.0).clamp_min(1.0)
    return var.sqrt()


def zero_fraction_per_channel(x: torch.Tensor, tol: float = 1e-8) -> torch.Tensor:
    xf = (x.detach().float().abs() < tol).float()
    m = mask_for(x)
    return _channel_mean(xf) if m is None else _masked_channel_mean(xf, m)


def full_activation_map(x: torch.Tensor) -> torch.Tensor:
    """The raw activation, detached. The JAX package transposes its NHWC
    tensor to NCHW here; the port's tensor is NCHW already."""
    return x.detach()


METRIC_FNS = {
    "mean_abs_activation_per_channel": mean_abs_activation_per_channel,
    "mean_activation": mean_activation,
    "std_activation": std_activation,
    "zero_fraction_per_channel": zero_fraction_per_channel,
    "full_activation_map": full_activation_map,
}


def channel_stats(x: torch.Tensor, metrics: Tuple[str, ...]) -> Dict[str, torch.Tensor]:
    """The requested metrics of one activation tensor; unknown names are
    skipped, as in the JAX package."""
    out: Dict[str, torch.Tensor] = {}
    for name in metrics:
        fn = METRIC_FNS.get(name)
        if fn is not None:
            out[name] = fn(x)
    return out


__all__ = [
    "METRIC_FNS",
    "channel_stats",
    "full_activation_map",
    "mask_for",
    "mean_abs_activation_per_channel",
    "mean_activation",
    "std_activation",
    "tap_mask",
    "zero_fraction_per_channel",
]
