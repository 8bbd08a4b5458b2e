"""Host-side matplotlib plotters for the training artifacts.

The port's copy of ``vae_channel_dynamics_tpu/utils/plotting.py``, with the
same file names and the same data in each figure:

- :class:`DeadNeuronPlotter`: the dead-percentage line plot of the top-N
  layers with ``dead_neuron_percentage_history.{png,csv}``, and per-layer
  weight snapshots (a 4-D kernel as a bar per output channel of mean |w|,
  ``filter_magnitudes_<layer>.png``; a 2-D one as an image of |w|,
  ``heatmap_<layer>.png``);
- :class:`ActivityPlotter`: metric-evolution lines read back from
  ``tracked_activation_stats.csv``
  (``activation_evo_<metric>_<type>.png``);
- :func:`plot_dead_vs_nudge`: the inactive-channel line over the nudged-scale
  bars of ``intervention_history.csv``.

matplotlib is imported at the call, with the Agg backend, and is not
needed to import this module: where it does not import (the H100
machine has none), each plot logs one warning that names matplotlib and is
skipped, and the run goes on. The CSV a plot reads or writes is written
either way. :func:`dead_history_series`, :func:`activity_series` and
:func:`filter_magnitudes` give the series the figures plot, without
drawing.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import pandas as pd

logger = logging.getLogger(__name__)


def pyplot(what: str):
    """``matplotlib.pyplot`` on the Agg backend, or None (with one warning
    naming matplotlib and ``what``) where matplotlib does not import."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        logger.warning("matplotlib is not importable (%s): %s is not drawn", e, what)
        return None
    return plt


def _save(plt, fig, path: str) -> None:
    try:
        fig.savefig(path, bbox_inches="tight")
        logger.info("Plot saved to %s", path)
    except Exception as e:  # noqa: BLE001 — a plot never fails the run
        logger.error("Failed to save plot to %s: %s", path, e)
    finally:
        plt.close(fig)


def _integer_steps(ax) -> None:
    import matplotlib.ticker as ticker

    ax.xaxis.set_major_locator(ticker.MaxNLocator(nbins=20, integer=True, min_n_ticks=5))


# --------------------------------------------------------------------------- #
# What each figure plots
# --------------------------------------------------------------------------- #
def dead_history_frame(percent_history: Dict[str, List[Tuple[int, float]]]) -> pd.DataFrame:
    """The dead-weight history as ``step, layer, percentage`` rows."""
    return pd.DataFrame([{"step": step, "layer": layer, "percentage": pct}
                         for layer, hist in (percent_history or {}).items()
                         for step, pct in hist])


def dead_history_series(df: pd.DataFrame, top_n: int) -> Dict[str, pd.DataFrame]:
    """{layer: its rows by step} for the ``top_n`` layers of the largest
    peak percentage, in that order."""
    per_layer_max = df.groupby("layer")["percentage"].max()
    top = per_layer_max.sort_values(ascending=False).head(top_n).index.tolist()
    return {layer: df[df["layer"] == layer].sort_values("step") for layer in top}


def activity_series(csv_path: str, target_metric_substring: str, target_metric_type: str,
                    layers_to_include: Optional[List[str]] = None,
                    max_layers_to_plot: int = 15) -> Dict[str, pd.DataFrame]:
    """{layer: its rows by step} of the activation-stats CSV for one
    metric and metric type (the JAX plotter's filters); empty when nothing
    matches."""
    if not os.path.exists(csv_path):
        logger.error("CSV not found: %s", csv_path)
        return {}
    df = pd.read_csv(csv_path)
    required = {"original_metric_name", "metric_type", "metric_value", "global_step",
                "layer_identifier"}
    if df.empty or not required.issubset(df.columns):
        logger.warning("CSV %s empty or missing columns", csv_path)
        return {}
    sub = df[df["original_metric_name"].astype(str).str.contains(
        target_metric_substring, case=False, na=False)
        & (df["metric_type"].astype(str) == target_metric_type)].copy()
    sub["metric_value"] = pd.to_numeric(sub["metric_value"], errors="coerce")
    sub = sub.dropna(subset=["metric_value"])
    if sub.empty:
        logger.warning("No rows matched metric filters; skipping plot.")
        return {}
    layers = sub["layer_identifier"].unique().tolist()
    if layers_to_include:
        filtered = [name for name in layers if any(s in name for s in layers_to_include)]
        layers = filtered or layers
    if len(layers) > max_layers_to_plot:
        maxima = sub[sub["layer_identifier"].isin(layers)].groupby(
            "layer_identifier")["metric_value"].max()
        layers = maxima.nlargest(max_layers_to_plot).index.tolist()
    return {layer: sub[sub["layer_identifier"] == layer].sort_values("global_step")
            for layer in layers}


def activity_plot_name(target_metric_substring: str, target_metric_type: str) -> str:
    return (f"activation_evo_{target_metric_substring.split('_')[0]}"
            f"_{target_metric_type.split('_')[-1]}.png").lower()


def filter_magnitudes(w: np.ndarray) -> np.ndarray:
    """A 4-D OIHW kernel's mean |w| per output channel (the bars)."""
    return np.mean(np.abs(w), axis=(1, 2, 3))


# --------------------------------------------------------------------------- #
# The plotters
# --------------------------------------------------------------------------- #
class DeadNeuronPlotter:
    def __init__(self, top_n_layers: int = 10, threshold: float = 1e-5,
                 output_dir: Optional[str] = None):
        self.top_n_layers = top_n_layers
        self.threshold = threshold
        self.output_dir = output_dir or "."
        os.makedirs(self.output_dir, exist_ok=True)

    def plot_all(self, percent_history: Dict[str, List[Tuple[int, float]]],
                 weights_history: Dict[str, List[np.ndarray]]) -> None:
        self.plot_history(
            percent_history,
            os.path.join(self.output_dir, "dead_neuron_percentage_history.png"),
            os.path.join(self.output_dir, "dead_neuron_percentage_history.csv"),
        )
        for layer_name in (weights_history or {}):
            self.plot_heatmap(weights_history, layer_name)

    def plot_history(self, percent_history: Dict[str, List[Tuple[int, float]]],
                     save_path: str, csv_path: str, xlabel: str = "Global Step") -> None:
        """The CSV always; the figure where matplotlib imports."""
        df = dead_history_frame(percent_history)
        if df.empty:
            logger.warning("No dead-weight history; skipping plot.")
            return
        df.to_csv(csv_path, index=False)
        plt = pyplot(os.path.basename(save_path))
        if plt is None:
            return
        fig, ax = plt.subplots(figsize=(17, 8))
        for layer, sub in dead_history_series(df, self.top_n_layers).items():
            ax.plot(sub["step"], sub["percentage"], label=layer, marker=".", linestyle="-")
        ax.set_xlabel(xlabel)
        ax.set_ylabel(f"% of weights < {self.threshold:.1e}")
        ax.set_title("Dead Neuron Weights Percentage Over Time (Tracked Parameters)")
        _integer_steps(ax)
        ax.legend(bbox_to_anchor=(1.02, 1), loc="upper left", fontsize="small")
        ax.grid(True, linestyle="--", alpha=0.6)
        plt.tight_layout(rect=[0, 0, 0.83, 1])
        _save(plt, fig, save_path)

    def plot_heatmap(self, weights_history: Dict[str, List[np.ndarray]],
                     layer_name: str) -> None:
        history = (weights_history or {}).get(layer_name)
        if not history:
            logger.warning("No weight snapshot for %s", layer_name)
            return
        w = np.asarray(history[0])
        safe = layer_name.replace(".", "_")
        if w.ndim not in (2, 4):
            logger.info("Skipping heatmap for %s (ndim=%d)", layer_name, w.ndim)
            return
        name = f"filter_magnitudes_{safe}.png" if w.ndim == 4 else f"heatmap_{safe}.png"
        plt = pyplot(name)
        if plt is None:
            return
        if w.ndim == 4:  # OIHW: per-output-channel magnitude bars
            mags = filter_magnitudes(w)
            fig, ax = plt.subplots(figsize=(10, max(5, len(mags) * 0.2)))
            ax.bar(range(len(mags)), mags, color="skyblue")
            ax.set_xlabel("Output Channel Index")
            ax.set_ylabel("Mean Abs Weight per Output Channel")
            ax.set_title(f"Filter Weight Magnitudes - Last Tracked Step - {layer_name}")
        else:
            fig, ax = plt.subplots(figsize=(10, 8))
            im = ax.imshow(np.abs(w), cmap="viridis", aspect="auto", interpolation="nearest")
            plt.colorbar(im, ax=ax, label="Absolute Weight Value")
            ax.set_xlabel("Input Features")
            ax.set_ylabel("Output Features")
            ax.set_title(f"Weight Heatmap - Last Tracked Step - {layer_name}")
        plt.tight_layout()
        _save(plt, fig, os.path.join(self.output_dir, name))


class ActivityPlotter:
    def __init__(self, output_dir: str):
        self.output_dir = output_dir or "."
        os.makedirs(self.output_dir, exist_ok=True)

    def plot_activation_stats_evolution(
        self,
        csv_path: str,
        target_metric_substring: str = "mean_abs_activation_per_channel",
        target_metric_type: str = "per_channel_overall_mean",
        layers_to_include: Optional[List[str]] = None,
        max_layers_to_plot: int = 15,
    ) -> None:
        series = activity_series(csv_path, target_metric_substring, target_metric_type,
                                 layers_to_include, max_layers_to_plot)
        if not series:
            return
        name = activity_plot_name(target_metric_substring, target_metric_type)
        plt = pyplot(name)
        if plt is None:
            return
        fig, ax = plt.subplots(figsize=(17, 8))
        for layer, d in series.items():
            ax.plot(d["global_step"], d["metric_value"], label=layer, marker=".",
                    linestyle="-")
        ax.set_xlabel("Global Step")
        ax.set_ylabel(f"Value: '{target_metric_substring}' ({target_metric_type})")
        ax.set_title(f"Evolution of '{target_metric_substring}' ({target_metric_type})")
        _integer_steps(ax)
        ax.legend(bbox_to_anchor=(1.02, 1), loc="upper left", fontsize="small")
        ax.grid(True, linestyle="--", alpha=0.6)
        plt.tight_layout(rect=[0, 0, 0.83, 1])
        _save(plt, fig, os.path.join(self.output_dir, name))


def plot_dead_vs_nudge(csv_path: str, out_png: str, nudge_factor: float = 1.05,
                       bar_scale: float = 0.5) -> None:
    """Inactive-channel curve vs. nudged-scale bars from the headerless
    ``step,inactive,nudged`` intervention_history.csv."""
    if not os.path.exists(csv_path):
        logger.warning("No intervention history at %s", csv_path)
        return
    plt = pyplot(os.path.basename(out_png))
    if plt is None:
        return
    df = pd.read_csv(csv_path, names=["step", "inactive", "nudged"])
    fig = plt.figure(figsize=(9, 4))
    plt.plot(df["step"], df["inactive"], label="# inactive channels", linewidth=2)
    plt.bar(df["step"], df["nudged"] * bar_scale, width=1.0, alpha=0.25,
            label=f"# scales nudged x{bar_scale:.1f}")
    plt.xlabel("Step")
    plt.ylabel("Count")
    plt.title(f"Dead-channel decay (nudge_factor = {nudge_factor})")
    plt.legend()
    plt.tight_layout()
    _save(plt, fig, out_png)


__all__ = [
    "ActivityPlotter",
    "DeadNeuronPlotter",
    "activity_plot_name",
    "activity_series",
    "dead_history_series",
    "filter_magnitudes",
    "plot_dead_vs_nudge",
    "pyplot",
]
