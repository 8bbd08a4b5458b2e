"""Inactive-channel classifier over monitored GroupNorm activations.

Counterpart of ``vae_channel_dynamics_tpu/classification/classifier.py``
(ported rather than reused: the JAX module imports jax through its naming
helpers). For each configured layer it thresholds the per-channel
mean-|activation| vector of the monitor's interval data and returns, per
flagged layer, ``{param_name_scale, inactive_channel_indices, metric_used,
threshold_value, values_of_inactive_channels}``. The GroupNorm map comes from
the model and registers both plain and ``vae.``-prefixed monitor IDs; a
lookup retries after stripping the first scope prefix.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
from torch import nn

from ..utils.naming import groupnorm_channel_map

logger = logging.getLogger(__name__)


class RegionClassifier:
    def __init__(self, model: Optional[nn.Module], config: Dict[str, Any]):
        self.config = config or {}
        self.method = self.config.get("method", "threshold_groupnorm_activity")
        self.threshold = float(self.config.get("threshold", 1e-3))
        self.target_metric_key = self.config.get(
            "target_metric_key", "mean_abs_activation_per_channel"
        )
        self.layers_to_classify: List[str] = self.config.get("layers_to_classify", [])
        self._layer_to_param_map: Dict[str, Tuple[str, int]] = (
            groupnorm_channel_map(model) if model is not None else {}
        )
        logger.info(
            "RegionClassifier initialised (method=%s, thr=%s, metric=%s, map_size=%d)",
            self.method, self.threshold, self.target_metric_key,
            len(self._layer_to_param_map),
        )
        if not self._layer_to_param_map:
            logger.warning("RegionClassifier: no GroupNorm layers found / mapped.")

    def _lookup_param_info(self, layer_id: str) -> Optional[Tuple[str, int]]:
        info = self._layer_to_param_map.get(layer_id)
        if info is not None:
            return info
        if "." in layer_id:
            return self._layer_to_param_map.get(layer_id.split(".", 1)[1])
        return None

    def classify(
        self, tracked_data_for_step: Dict[str, Any], global_step: int
    ) -> Dict[str, Any]:
        if not self.config.get("enabled", False):
            return {}
        results: Dict[str, Any] = {}
        if self.method != "threshold_groupnorm_activity":
            logger.warning("Unknown classification method: %s", self.method)
            return results
        if not tracked_data_for_step:
            return results

        for layer_id, metrics in tracked_data_for_step.items():
            if self.layers_to_classify and layer_id not in self.layers_to_classify:
                continue
            vals = metrics.get(self.target_metric_key)
            if vals is None:
                continue
            vals = np.asarray(vals)
            if vals.ndim != 1:
                continue
            info = self._lookup_param_info(layer_id)
            if info is None:
                logger.debug("%s: no GN mapping found - skipped.", layer_id)
                continue
            param_name_scale, num_ch = info
            if vals.shape[0] != num_ch:
                logger.warning(
                    "%s: channel mismatch (%d vs %d) - skipped.",
                    layer_id, vals.shape[0], num_ch,
                )
                continue
            inactive = np.where(vals < self.threshold)[0]
            if inactive.size == 0:
                continue
            results[layer_id] = {
                "param_name_scale": param_name_scale,
                "inactive_channel_indices": inactive.tolist(),
                "metric_used": self.target_metric_key,
                "threshold_value": self.threshold,
                "values_of_inactive_channels": vals[inactive].tolist(),
            }
            logger.info(
                "Step %d: %s -> %d inactive channels (param %s)",
                global_step, layer_id, inactive.size, param_name_scale,
            )
        logger.info("Classification complete - %d layer(s) flagged.", len(results))
        return results


__all__ = ["RegionClassifier"]
