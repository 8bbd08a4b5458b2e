"""Compare two training runs (e.g. baseline vs. nudge): reconstruction
quality and channel-dynamics differences between a plain fine-tune and an
intervention run. The port of ``vae_channel_dynamics_tpu/tools/compare_runs.py``.

Usage:
    python -m vae_channel_dynamics_tpu_torch.tools.compare_runs \\
        --baseline results/<baseline_run> --treatment results/<nudge_run> \\
        [--output comparison.md]

Reads each run's metrics.jsonl, eval_metrics.txt (if evaluation was run
against its final_model) and intervention history, and writes a
side-by-side markdown table, and ``<output>_activity.png``, the JAX
tool's overlay of both runs' tracked per-channel activation means; where
matplotlib does not import, a warning says that the plot is not drawn.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import Any, Dict, Optional

logger = logging.getLogger(__name__)


def _final_metrics(run_dir: str) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    path = os.path.join(run_dir, "metrics.jsonl")
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                for key in (
                    "train_loss_step", "rec_loss", "kl_loss",
                    "validation/avg_total_loss",
                    "validation/avg_reconstruction_loss",
                    "validation/avg_kl_divergence",
                ):
                    if key in rec:
                        out[key] = rec[key]
    eval_txt = os.path.join(run_dir, "final_model", "eval_results_test", "eval_metrics.txt")
    if os.path.exists(eval_txt):
        with open(eval_txt) as f:
            for line in f:
                if ":" in line:
                    k, _, v = line.partition(":")
                    try:
                        out[f"eval/{k.strip()}"] = float(v)
                    except ValueError:
                        pass
    hist = os.path.join(run_dir, "intervention_history.csv")
    if os.path.exists(hist):
        with open(hist) as f:
            rows = [r.split(",") for r in f.read().strip().splitlines() if r]
        out["interventions"] = len(rows)
        out["total_nudges"] = sum(int(r[2]) for r in rows)
    return out


def _fmt(v: Optional[Any]) -> str:
    if v is None:
        return "—"
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def compare(baseline_dir: str, treatment_dir: str) -> str:
    base = _final_metrics(baseline_dir)
    treat = _final_metrics(treatment_dir)
    keys = [
        ("train_loss_step", "final train loss"),
        ("rec_loss", "final rec loss"),
        ("kl_loss", "final KL loss"),
        ("validation/avg_reconstruction_loss", "val rec loss (sum-conv)"),
        ("validation/avg_kl_divergence", "val KL"),
        ("eval/Average MSE", "eval MSE"),
        ("eval/Average KL", "eval KL"),
        ("eval/Average PSNR", "eval PSNR (dB)"),
        ("eval/Average SSIM", "eval SSIM"),
        ("interventions", "intervention events"),
        ("total_nudges", "total scales nudged"),
    ]
    lines = [
        "# Run comparison",
        "",
        f"- baseline:  `{baseline_dir}`",
        f"- treatment: `{treatment_dir}`",
        "",
        "| Metric | Baseline | Treatment | Δ |",
        "|---|---|---|---|",
    ]
    for key, label in keys:
        b, t = base.get(key), treat.get(key)
        if b is None and t is None:
            continue
        delta = (f"{t - b:+.6g}" if isinstance(b, (int, float)) and isinstance(t, (int, float))
                 else "—")
        lines.append(f"| {label} | {_fmt(b)} | {_fmt(t)} | {delta} |")
    return "\n".join(lines) + "\n"


def plot_activation_comparison(baseline_dir: str, treatment_dir: str, out_png: str) -> None:
    """Overlay the per-channel mean-|act| trajectories of both runs."""
    import pandas as pd

    from ..utils.plotting import pyplot

    plt = pyplot(os.path.basename(out_png))
    if plt is None:
        return
    fig, ax = plt.subplots(figsize=(12, 6))
    plotted = False
    for run_dir, style, label in ((baseline_dir, "--", "baseline"),
                                  (treatment_dir, "-", "treatment")):
        csv = os.path.join(run_dir, "tracked_activation_stats.csv")
        if not os.path.exists(csv):
            continue
        df = pd.read_csv(csv)
        sub = df[df["metric_type"] == "per_channel_overall_mean"]
        for layer, g in sub.groupby("layer_identifier"):
            g = g.sort_values("global_step")
            ax.plot(g["global_step"], g["metric_value"], style, label=f"{label}: {layer}",
                    marker=".")
            plotted = True
    if not plotted:
        plt.close(fig)
        return
    ax.set_xlabel("Global Step")
    ax.set_ylabel("mean |activation| per channel (overall mean)")
    ax.set_title("Channel activity: baseline vs treatment")
    ax.legend(fontsize="small")
    ax.grid(True, linestyle="--", alpha=0.5)
    plt.tight_layout()
    fig.savefig(out_png, bbox_inches="tight")
    plt.close(fig)
    logger.info("Comparison plot saved to %s", out_png)


def main(argv=None) -> int:
    from ..utils.logging_utils import setup_logging

    setup_logging()
    parser = argparse.ArgumentParser(description="Compare two run directories.")
    parser.add_argument("--baseline", required=True)
    parser.add_argument("--treatment", required=True)
    parser.add_argument("--output", default="comparison.md")
    args = parser.parse_args(argv)
    report = compare(args.baseline, args.treatment)
    with open(args.output, "w") as f:
        f.write(report)
    plot_activation_comparison(args.baseline, args.treatment,
                               os.path.splitext(args.output)[0] + "_activity.png")
    print(report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
