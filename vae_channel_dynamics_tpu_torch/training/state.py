"""Train state: the model's fp32 master parameters, the optimizer state, the
step counter, and the on-device activation-statistics accumulator.

Counterpart of ``vae_channel_dynamics_tpu/training/state.py``. JAX's state is
an immutable pytree that each step replaces; here the step updates this
object in place (parameters, optimizer moments, accumulators), which keeps
one copy of each on the device. The stats accumulator lives on the device
and reaches the host only at the monitor's interval, so the hot loop never
synchronises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    opt_state: object
    step: int = 0
    # {stat_key: running sum of per-forward values} and the forward count,
    # both on the device
    stats_acc: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    stats_count: Optional[torch.Tensor] = None
    # exponential moving average of the parameters (training.ema_decay > 0),
    # by parameter name; None when disabled
    ema_params: Optional[Dict[str, torch.Tensor]] = None

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The fp32 master parameters by torch name."""
        return dict(self.model.named_parameters())

    @classmethod
    def create(cls, model: nn.Module, tx, stats_acc=None, ema: bool = False) -> "TrainState":
        device = next(model.parameters()).device
        params = dict(model.named_parameters())
        return cls(
            model=model,
            opt_state=tx.init(params),
            step=0,
            stats_acc=dict(stats_acc or {}),
            stats_count=torch.zeros((), dtype=torch.float32, device=device),
            ema_params=(
                {k: p.detach().clone() for k, p in params.items()} if ema else None
            ),
        )

    def reset_stats(self) -> "TrainState":
        """Zero the accumulators and the count (at the monitor's interval)."""
        for v in self.stats_acc.values():
            v.zero_()
        self.stats_count.zero_()
        return self
