"""Activity monitor: per-channel activation statistics without host syncs.

Counterpart of ``vae_channel_dynamics_tpu/tracking/monitor.py``. The model's
capture taps return statistics from every training forward; the train step
keeps their running sums on the device (``TrainState.stats_acc``), and they
reach the host only at the track interval, in one copy. The interval value
of a metric is the mean of its per-forward values; full activation maps are
not accumulated, but kept from the interval step's own forward. The wandb
key schema and the CSV record schema are the JAX package's (and the
reference's).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models.vae import CaptureTable, Conv2d, GroupNorm, Linear
from ..utils.naming import strip_vae_prefix

logger = logging.getLogger(__name__)

_KNOWN_METRICS = (
    "mean_abs_activation_per_channel",
    "mean_activation",
    "std_activation",
    "zero_fraction_per_channel",
    "full_activation_map",
)
_PER_CHANNEL_METRICS = ("mean_abs_activation_per_channel", "zero_fraction_per_channel")


class MapSummary:
    """Eviction placeholder for a full activation map
    (``tracking.max_map_history``): the statistics the CSV export emits for
    maps, at none of the memory."""

    __slots__ = ("shape", "stats")

    def __init__(self, arr):
        a = np.asarray(arr)
        self.shape = tuple(a.shape)
        a32 = a.astype(np.float32)
        self.stats = {
            "mean": float(np.mean(a32)),
            "std": float(np.std(a32)),
            "min": float(np.min(a32)),
            "max": float(np.max(a32)),
        }


def _tap_channels(module: nn.Module, point: str, tp=None) -> int:
    """The channel count of a tap module's input or output: the whole
    layer's, or the length of a tensor rank's block of it under ``tp``."""
    if not isinstance(module, (Conv2d, Linear, GroupNorm)):
        raise ValueError(f"{type(module).__name__} has no activation taps")
    n = module.tap_channels(point)
    return n if tp is None else tp.block(n)[1]


class ActivityMonitor:
    """Parses the ``tracking`` config into capture tables and owns the
    aggregation: the training loop installs ``scalar_capture_table`` on the
    model for ordinary steps and ``map_capture_table`` on interval steps,
    passes :meth:`accumulate` to the train step, and calls :meth:`step` at
    each interval."""

    def __init__(self, tracking_config: Dict[str, Any]):
        self.config = tracking_config or {}
        self.enabled = bool(self.config.get("enabled", False))
        self.track_interval = int(self.config.get("track_interval", 100))
        self.processed_data_by_step: Dict[int, Dict[str, Dict[str, Any]]] = {}
        # how many intervals keep their full maps in host memory; 0 keeps all
        self.max_map_history = int(self.config.get("max_map_history", 0))

        # stat_key ("<norm_name>.<point>.<metric>") -> (layer_identifier, metric)
        self.key_to_identifier: Dict[str, Tuple[str, str]] = {}
        scalar_specs: Dict[Tuple[str, str], set] = {}
        map_specs: Dict[Tuple[str, str], set] = {}

        for layer_conf in self.config.get("target_layers", []):
            name = layer_conf.get("name")
            if not name:
                logger.warning("Skipping a target_layer entry with no name.")
                continue
            point = layer_conf.get("capture_point", "output")
            if point not in ("input", "output"):
                logger.warning("Unknown capture_point '%s' for %s; skipping", point, name)
                continue
            metrics = layer_conf.get("metrics", ["mean_abs_activation_per_channel"])
            norm_name = strip_vae_prefix(name)
            identifier = f"{name}.{point}"
            for metric in metrics:
                if metric not in _KNOWN_METRICS:
                    logger.warning("Unknown metric '%s' requested.", metric)
                    continue
                key = f"{norm_name}.{point}.{metric}"
                self.key_to_identifier[key] = (identifier, metric)
                bucket = map_specs if metric == "full_activation_map" else scalar_specs
                bucket.setdefault((norm_name, point), set()).add(metric)

        self._scalar_table: CaptureTable = tuple(
            (n, p, tuple(sorted(ms))) for (n, p), ms in sorted(scalar_specs.items())
        )
        self._map_table: CaptureTable = tuple(
            (n, p, tuple(sorted(ms))) for (n, p), ms in sorted(map_specs.items())
        )
        if self.enabled:
            logger.info(
                "ActivityMonitor: %d scalar tap(s), %d map tap(s), interval %d",
                len(self._scalar_table), len(self._map_table), self.track_interval,
            )
        else:
            logger.info("ActivityMonitor is disabled in config.")

    # ------------------------------------------------------------------ #
    @property
    def scalar_capture_table(self) -> CaptureTable:
        return self._scalar_table if self.enabled else ()

    @property
    def map_capture_table(self) -> CaptureTable:
        """Capture table for interval steps: scalar taps + full maps."""
        if not self.enabled:
            return ()
        merged: Dict[Tuple[str, str], set] = {}
        for n, p, ms in self._scalar_table + self._map_table:
            merged.setdefault((n, p), set()).update(ms)
        return tuple((n, p, tuple(sorted(ms))) for (n, p), ms in sorted(merged.items()))

    @property
    def map_keys(self) -> Tuple[str, ...]:
        return tuple(
            k for k, (_ident, metric) in self.key_to_identifier.items()
            if metric == "full_activation_map"
        )

    def init_acc(self, model: nn.Module) -> Dict[str, torch.Tensor]:
        """Zero accumulators of the scalar stats' shapes on the model's
        device: (C,) for the per-channel metrics, with C the tapped module's
        channel count at that point (the length of the rank's block of it on
        a model a tensor group shards: ``ops.tensor_parallel.whole_taps``
        gathers them at the interval), and () for the scalar ones. No
        forward runs (the JAX monitor derives the shapes with eval_shape)."""
        if not self.enabled or not self._scalar_table:
            return {}
        device = next(model.parameters()).device
        modules = dict(model.named_modules())
        acc: Dict[str, torch.Tensor] = {}
        for name, point, metrics in self._scalar_table:
            module = modules.get(name)
            if module is None:
                logger.warning("No module named %s in the model; its taps stay empty", name)
                continue
            for metric in metrics:
                shape = ((_tap_channels(module, point, getattr(model, "tensor", None)),)
                         if metric in _PER_CHANNEL_METRICS else ())
                acc[f"{name}.{point}.{metric}"] = torch.zeros(
                    shape, dtype=torch.float32, device=device)
        return acc

    @staticmethod
    def accumulate(
        acc: Dict[str, torch.Tensor], stats: Dict[str, torch.Tensor]
    ) -> Dict[str, torch.Tensor]:
        """The running-sum update the train step applies each step."""
        return {k: acc[k] + stats[k] for k in acc}

    # ------------------------------------------------------------------ #
    def step(
        self,
        global_step: int,
        stats_acc: Dict[str, Any],
        stats_count: Any,
        maps: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, float]:
        """Aggregate the interval and return the flat wandb-metric dict
        (``tracking/<identifier>/<metric>_overall_mean|_overall_std`` for
        vectors, ``tracking/<identifier>/<metric>`` for scalars). The
        accumulators and the count reach the host in one copy; the caller
        resets the state's accumulators afterwards."""
        if not self.enabled:
            return {}
        keys = list(stats_acc)
        count_t = torch.as_tensor(stats_count, dtype=torch.float32)
        flat = torch.cat(
            [count_t.reshape(1)]
            + [torch.as_tensor(stats_acc[k]).to(count_t.device, torch.float32).reshape(-1)
               for k in keys]
        ).cpu().numpy()
        count = float(flat[0])
        if count <= 0 and not maps:
            return {}

        wandb_metrics: Dict[str, float] = {}
        processed: Dict[str, Dict[str, Any]] = {}

        offset = 1
        for key in keys:
            shape = tuple(torch.as_tensor(stats_acc[key]).shape)
            size = int(np.prod(shape)) if shape else 1
            value = flat[offset:offset + size].reshape(shape)
            offset += size
            ident_metric = self.key_to_identifier.get(key)
            if ident_metric is None:
                continue
            identifier, metric = ident_metric
            agg = np.asarray(value, np.float64) / max(count, 1.0)
            processed.setdefault(identifier, {})[metric] = (
                agg.astype(np.float32) if agg.ndim else float(agg)
            )
            prefix = f"tracking/{identifier}/{metric}"
            if "mean_abs_activation_per_channel" in metric or agg.ndim == 1:
                wandb_metrics[f"{prefix}_overall_mean"] = float(np.mean(agg))
                wandb_metrics[f"{prefix}_overall_std"] = float(np.std(agg))
            else:
                wandb_metrics[prefix] = float(agg)

        for key, value in (maps or {}).items():
            ident_metric = self.key_to_identifier.get(key)
            if ident_metric is None:
                continue
            identifier, metric = ident_metric
            arr = torch.as_tensor(value).detach().float().cpu().numpy()
            processed.setdefault(identifier, {})[metric] = arr
            prefix = f"tracking/{identifier}/{metric}"
            wandb_metrics[f"{prefix}_mean"] = float(np.mean(arr))
            wandb_metrics[f"{prefix}_std"] = float(np.std(arr))

        if processed:
            self.processed_data_by_step[global_step] = processed
            logger.info("ActivityMonitor processed data for step %d.", global_step)
            self._evict_old_maps()
        return wandb_metrics

    def get_data_for_step(self, global_step: int) -> Dict[str, Any]:
        return self.processed_data_by_step.get(global_step, {})

    def _evict_old_maps(self) -> None:
        """Replace full maps older than the newest ``max_map_history``
        intervals with :class:`MapSummary` placeholders."""
        if self.max_map_history <= 0:
            return
        steps_with_maps = sorted(
            step
            for step, data in self.processed_data_by_step.items()
            if any(
                "full_activation_map" in metrics
                and not isinstance(metrics["full_activation_map"], MapSummary)
                for metrics in data.values()
            )
        )
        for step in steps_with_maps[: -self.max_map_history]:
            for metrics in self.processed_data_by_step[step].values():
                value = metrics.get("full_activation_map")
                if value is not None and not isinstance(value, MapSummary):
                    metrics["full_activation_map"] = MapSummary(value)

    # ------------------------------------------------------------------ #
    def export_all_processed_data_to_records(self) -> List[Dict[str, Any]]:
        """Long-format records for tracked_activation_stats.csv, in the JAX
        package's (and the reference's) column and metric_type schema."""
        records: List[Dict[str, Any]] = []
        summary_fns = (("mean", np.mean), ("std", np.std), ("min", np.min), ("max", np.max))
        for global_step, step_data in self.processed_data_by_step.items():
            for identifier, metrics in step_data.items():
                for metric, value in metrics.items():
                    base = {
                        "global_step": global_step,
                        "layer_identifier": identifier,
                        "original_metric_name": metric,
                    }
                    if isinstance(value, MapSummary):
                        records.append({**base, "metric_type": "full_map_shape",
                                        "metric_value": str(value.shape)})
                        for stat, _fn in summary_fns:
                            records.append({**base, "metric_type": f"full_map_{stat}",
                                            "metric_value": value.stats[stat]})
                        continue
                    arr = np.asarray(value)
                    if arr.ndim == 0:
                        records.append({**base, "metric_type": "scalar",
                                        "metric_value": float(arr)})
                    elif metric == "full_activation_map":
                        records.append({**base, "metric_type": "full_map_shape",
                                        "metric_value": str(tuple(arr.shape))})
                        for stat, fn in summary_fns:
                            records.append({**base, "metric_type": f"full_map_{stat}",
                                            "metric_value": float(fn(arr.astype(np.float32)))})
                    elif "mean_abs_activation_per_channel" in metric:
                        for stat, fn in summary_fns:
                            records.append({**base,
                                            "metric_type": f"per_channel_overall_{stat}",
                                            "metric_value": float(fn(arr))})
                    else:
                        records.append({**base, "metric_type": "array_mean",
                                        "metric_value": float(np.mean(arr))})
                        records.append({**base, "metric_type": "array_std",
                                        "metric_value": float(np.std(arr))})
        return records


__all__ = ["ActivityMonitor", "MapSummary"]
