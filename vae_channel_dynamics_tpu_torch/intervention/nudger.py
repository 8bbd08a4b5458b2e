"""Intervention handler: "nudge" the GroupNorm scales of inactive channels.

Counterpart of ``vae_channel_dynamics_tpu/intervention/nudger.py``. At its
interval, for each classified layer, strategy ``gentle_nudge_groupnorm_scale``
sets ``gamma[idx] = min(gamma[idx] * nudge_factor, max_scale_value)`` and
``reset_groupnorm_scale`` sets 1.0, with the same interval gating (no
intervention at step 0, and ``intervention_interval: 1`` intervenes at every
non-zero step).

The JAX handler returns a new params pytree and leaves the optimizer state
alone. Here the nudge is applied in place to the torch parameter under
``torch.no_grad()``, and the optimizer moments are likewise left as they
are. The new values are computed on the host in fp32 exactly as the JAX
handler computes them, so both packages set the same bits.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..parallel.zero import replicate_leaf, write_leaf
from ..utils import naming

logger = logging.getLogger(__name__)


class InterventionHandler:
    def __init__(self, config: Dict[str, Any]):
        self.config = config or {}
        self.strategy = self.config.get("strategy", "none")
        self.nudge_factor = float(self.config.get("nudge_factor", 1.1))
        self.max_scale_value = float(self.config.get("max_scale_value", 2.0))
        self.num_nudges_applied = 0
        logger.info("InterventionHandler initialized (strategy: %s)", self.strategy)

    def _interval_due(self, global_step: int) -> bool:
        interval = int(self.config.get("intervention_interval", 200))
        if global_step == 0 or global_step % interval != 0:
            # interval==1 intervenes every non-zero step
            return interval == 1 and global_step > 0
        return True

    def _nudged_scale(
        self, gamma: np.ndarray, indices: Sequence[int]
    ) -> Tuple[np.ndarray, int]:
        new = gamma.copy()
        applied = 0
        for idx in indices:
            if 0 <= idx < gamma.size:
                if self.strategy == "gentle_nudge_groupnorm_scale":
                    new[idx] = min(float(gamma[idx]) * self.nudge_factor, self.max_scale_value)
                else:  # reset_groupnorm_scale
                    new[idx] = 1.0
                applied += 1
            else:
                logger.warning("Inactive index %d out of bounds (size %d)", idx, gamma.size)
        return new, applied

    @torch.no_grad()
    def intervene(
        self,
        model: nn.Module,
        classification_results: Dict[str, Any],
        global_step: int,
    ) -> nn.Module:
        """Apply the nudges to ``model``'s GroupNorm scales in place and
        return it; ``num_nudges_applied`` reports the count of this call."""
        if not self.config.get("enabled", False) or self.strategy == "none":
            return model
        if not self._interval_due(global_step):
            return model
        logger.info("Intervention at step %d (strategy '%s')", global_step, self.strategy)
        if not classification_results:
            logger.info("Step %d: no regions classified, skipping intervention.", global_step)
            return model
        if self.strategy not in ("gentle_nudge_groupnorm_scale", "reset_groupnorm_scale"):
            logger.warning("Unknown intervention strategy: %s", self.strategy)
            return model

        self.num_nudges_applied = 0
        for layer_key, data in classification_results.items():
            param_name = data.get("param_name_scale")
            indices = data.get("inactive_channel_indices")
            if not param_name or indices is None:
                logger.warning("Missing param_name_scale/indices for '%s'. Skipping.",
                               layer_key)
                continue
            gamma = naming.get_param(model, param_name)
            if gamma is None:
                logger.warning("Could not retrieve scale parameter '%s'. Skipping.",
                               param_name)
                continue
            # an FSDP2 shard of gamma is gathered whole and written back as
            # this rank's block (parallel/zero.py): every rank nudges alike
            nudged, applied = self._nudged_scale(
                replicate_leaf(gamma).float().cpu().numpy(), indices)
            if applied:
                write_leaf(gamma, torch.from_numpy(nudged.astype(np.float32)))
                self.num_nudges_applied += applied
        if self.num_nudges_applied > 0:
            logger.info("Applied '%s' to %d channel scales at step %d.",
                        self.strategy, self.num_nudges_applied, global_step)
        return model


__all__ = ["InterventionHandler"]
