"""Dead-weight tracker: percentage of near-zero parameter entries.

Counterpart of ``vae_channel_dynamics_tpu/tracking/deadneuron.py``. Each
interval it takes the parameters of the model's Conv2d, Linear and GroupNorm
modules and computes, per parameter, the percentage of entries that are
"dead" under one of three policies:

- ``threshold``        |w| < threshold
- ``percent_of_mean``  |w| < mean_percentage * mean(|w|), with an all-zero
                       special case when mean(|w|) < 1e-9
- ``both``             the logical AND of the two

All percentages are computed on the device and reach the host in one copy.
``percent_history[name]`` appends ``(step, pct)``; ``weights_history[name]``
keeps only the latest raw snapshot of the configured parameters.
"""

from __future__ import annotations

import logging
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..models.vae import Conv2d, GroupNorm, Linear
from ..parallel.zero import replicate_leaf
from ..utils import naming

logger = logging.getLogger(__name__)

TARGET_KINDS = ("conv", "dense", "groupnorm")
_KINDS = ((Conv2d, "conv"), (Linear, "dense"), (GroupNorm, "groupnorm"))


def _pct_threshold(w: torch.Tensor, threshold: float) -> torch.Tensor:
    wf = w.detach().float().abs()
    return (wf < threshold).float().mean() * 100.0


def _pct_percent_of_mean(w: torch.Tensor, mean_percentage: float) -> torch.Tensor:
    wf = w.detach().float().abs()
    mean_abs = wf.mean()
    adaptive = (wf < mean_percentage * mean_abs).float().mean() * 100.0
    degenerate = torch.where((wf < 1e-9).all(), 100.0, 0.0).to(wf.device)
    return torch.where(mean_abs.abs() < 1e-9, degenerate, adaptive)


def _pct_both(w: torch.Tensor, threshold: float, mean_percentage: float) -> torch.Tensor:
    wf = w.detach().float().abs()
    fixed = wf < threshold
    mean_abs = wf.mean()
    adaptive = torch.where(mean_abs.abs() < 1e-9, wf < 1e-9, wf < mean_percentage * mean_abs)
    return (fixed & adaptive).float().mean() * 100.0


def _module_kind(module: nn.Module) -> str:
    for cls, kind in _KINDS:
        if isinstance(module, cls):
            return kind
    return "other"


class DeadNeuronTracker:
    def __init__(
        self,
        target_layer_kinds: Sequence[str] = TARGET_KINDS,
        target_layer_names_for_raw_weights: Sequence[str] = (),
        threshold: float = 1e-8,
        mean_percentage: float = 0.01,
        dead_type: str = "threshold",
    ):
        self.threshold = float(threshold)
        self.mean_percentage = float(mean_percentage)
        self.target_layer_kinds = tuple(target_layer_kinds)
        self.target_layer_names_for_raw_weights = list(target_layer_names_for_raw_weights)
        if dead_type not in ("threshold", "percent_of_mean", "both"):
            logger.warning("Unknown dead_type: %s. Percentages will be 0.", dead_type)
            dead_type = "noop"
        self.dead_type = dead_type

        self.weights_history: Dict[str, List[np.ndarray]] = defaultdict(list)
        self.percent_history: Dict[str, List[Tuple[int, float]]] = defaultdict(list)

    def _target_params(self, model: nn.Module) -> Dict[str, torch.Tensor]:
        out = {}
        for mod_name, module in model.named_modules():
            if _module_kind(module) not in self.target_layer_kinds:
                continue
            for leaf_name, leaf in module.named_parameters(recurse=False):
                out[f"{mod_name}.{leaf_name}"] = leaf
        return out

    def _percent(self, w: torch.Tensor) -> torch.Tensor:
        if self.dead_type == "threshold":
            return _pct_threshold(w, self.threshold)
        if self.dead_type == "percent_of_mean":
            return _pct_percent_of_mean(w, self.mean_percentage)
        if self.dead_type == "both":
            return _pct_both(w, self.threshold, self.mean_percentage)
        return torch.zeros((), device=w.device)

    @torch.no_grad()
    def track_dead_neurons(self, model: nn.Module, global_step: int) -> None:
        """Compute every percentage on the device, fetch them in one copy,
        append them to the histories, and snapshot the configured raw
        weights."""
        targets = self._target_params(model)
        if not targets:
            logger.warning("DeadNeuronTracker: no target parameters found.")
            return
        # FSDP2 shards are read whole (a collective every rank reaches)
        pcts = torch.stack([self._percent(replicate_leaf(w))
                            for w in targets.values()]).cpu().tolist()
        for name, pct in zip(targets, pcts):
            self.percent_history[name].append((global_step, float(pct)))

        for name in self.target_layer_names_for_raw_weights:
            leaf = naming.get_param(model, name)
            if leaf is None:
                logger.debug("Raw-weight target not found: %s", name)
                continue
            # replace-not-append: only the latest snapshot survives
            self.weights_history[name] = [replicate_leaf(leaf).float().cpu().numpy()]


__all__ = ["DeadNeuronTracker"]
