"""Dotted torch names for the port's model.

Counterpart of the part of ``vae_channel_dynamics_tpu/utils/naming.py`` that
the control loop needs. The JAX package maps the reference's torch names
onto its Flax pytree; the port's module paths already are those names
(``encoder.down_blocks.0.resnets.0.norm1``), so only the optional ``vae.``
prefix has to go.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..models.vae import GroupNorm


def strip_vae_prefix(name: str) -> str:
    return name[4:] if name.startswith("vae.") else name


def groupnorm_channel_map(model: nn.Module) -> Dict[str, Tuple[str, int]]:
    """Monitor layer IDs to GroupNorm scale parameters: for each GroupNorm
    ``<mod>``, both ``<mod>.output`` and ``vae.<mod>.output`` map to
    ``(<mod>.weight, num_channels)`` (JAX naming.py:208-224)."""
    mapping: Dict[str, Tuple[str, int]] = {}
    for mod_name, module in model.named_modules():
        if not isinstance(module, GroupNorm):
            continue
        # the whole layer's channels (a tensor rank holds a block of them)
        entry = (f"{mod_name}.weight", int(module.channels))
        mapping[f"{mod_name}.output"] = entry
        if not mod_name.startswith("vae."):
            mapping[f"vae.{mod_name}.output"] = entry
    return mapping


def get_param(model: nn.Module, torch_param_name: str) -> Optional[nn.Parameter]:
    """The parameter under a torch name, with or without ``vae.``; None
    when there is none (the reference logs and skips such names)."""
    return dict(model.named_parameters()).get(strip_vae_prefix(torch_param_name))


@torch.no_grad()
def set_param(model: nn.Module, torch_param_name: str, value) -> None:
    """Copy ``value`` into the named parameter in place."""
    param = get_param(model, torch_param_name)
    if param is None:
        raise KeyError(f"Parameter not found: {torch_param_name}")
    param.copy_(torch.as_tensor(value, dtype=param.dtype))


__all__ = ["get_param", "groupnorm_channel_map", "set_param", "strip_vae_prefix"]
