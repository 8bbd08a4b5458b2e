"""Run-report generator: summarize a training run directory into markdown.
The port of ``vae_channel_dynamics_tpu/tools/report.py``.

Usage:
    python -m vae_channel_dynamics_tpu_torch.tools.report --run_dir results/<run>

Reads the artifacts a run of either package's Trainer produces
(metrics.jsonl, tracked_activation_stats CSV, intervention_history.csv,
dead_neuron_percentage_history.csv, eval_metrics.txt if present) and
writes ``report.md`` with loss curves summary, channel-suppression trends,
and intervention activity — the "what happened in this experiment" digest
the reference leaves to wandb.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)


def _load_jsonl(path: str) -> List[Dict[str, Any]]:
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    pass
    return out


def _fmt(v: Optional[float], spec: str = ".4e") -> str:
    return format(v, spec) if v is not None else "—"


def generate_report(run_dir: str) -> str:
    lines: List[str] = [f"# Run report: `{os.path.basename(run_dir)}`", ""]

    # --- training metrics ---
    records = _load_jsonl(os.path.join(run_dir, "metrics.jsonl"))
    train = [r for r in records if "train_loss_step" in r]
    vals = [r for r in records if "validation/avg_total_loss" in r]
    if train:
        first, last = train[0], train[-1]
        lines += [
            "## Training",
            "",
            f"- steps logged: {len(train)} (step {first['step']} → {last['step']})",
            f"- loss: {_fmt(first.get('train_loss_step'))} → "
            f"{_fmt(last.get('train_loss_step'))}",
            f"- rec loss: {_fmt(first.get('rec_loss'))} → {_fmt(last.get('rec_loss'))}",
            f"- kl loss: {_fmt(first.get('kl_loss'))} → {_fmt(last.get('kl_loss'))}",
            "",
        ]
    if vals:
        last_val = vals[-1]
        lines += [
            "## Validation (final)",
            "",
            f"- total: {_fmt(last_val.get('validation/avg_total_loss'))}",
            f"- reconstruction: "
            f"{_fmt(last_val.get('validation/avg_reconstruction_loss'))}",
            f"- KL: {_fmt(last_val.get('validation/avg_kl_divergence'))}",
            "",
        ]

    # --- channel suppression (activation stats) ---
    stats_csv = os.path.join(run_dir, "tracked_activation_stats.csv")
    if os.path.exists(stats_csv):
        import pandas as pd

        df = pd.read_csv(stats_csv)
        sub = df[df["metric_type"] == "per_channel_overall_mean"]
        if not sub.empty:
            lines += ["## Per-channel activation (mean |act|, overall mean)", ""]
            for layer, g in sub.groupby("layer_identifier"):
                g = g.sort_values("global_step")
                lines.append(
                    f"- `{layer}`: {g['metric_value'].iloc[0]:.4f} → "
                    f"{g['metric_value'].iloc[-1]:.4f} "
                    f"({len(g)} interval(s))"
                )
            lines.append("")

    # --- interventions ---
    hist_csv = os.path.join(run_dir, "intervention_history.csv")
    if os.path.exists(hist_csv):
        rows = [
            line.split(",")
            for line in open(hist_csv).read().strip().splitlines()
            if line
        ]
        total_nudges = sum(int(r[2]) for r in rows)
        lines += [
            "## Interventions",
            "",
            f"- events: {len(rows)}, total scales nudged: {total_nudges}",
        ]
        for r in rows[-5:]:
            lines.append(
                f"  - step {r[0]}: {r[1]} inactive channel(s), {r[2]} nudged"
            )
        lines.append("")

    # --- dead weights ---
    dn_csv = os.path.join(run_dir, "dead_neuron_percentage_history.csv")
    if os.path.exists(dn_csv):
        import pandas as pd

        df = pd.read_csv(dn_csv)
        worst = (
            df.groupby("layer")["percentage"].max().sort_values(ascending=False)
        )
        nonzero = worst[worst > 0]
        lines += [
            "## Dead weights",
            "",
            f"- parameters tracked: {worst.size}; with any dead entries: "
            f"{nonzero.size}",
        ]
        for layer, pct in nonzero.head(5).items():
            lines.append(f"  - `{layer}`: peak {pct:.2f}%")
        lines.append("")

    # --- eval results if present ---
    for sub in sorted(os.listdir(run_dir)) if os.path.isdir(run_dir) else []:
        eval_txt = os.path.join(run_dir, sub, "eval_results_test",
                                "eval_metrics.txt")
        if os.path.exists(eval_txt):
            lines += [f"## Evaluation ({sub})", "", "```",
                      open(eval_txt).read().strip(), "```", ""]

    artifacts = [
        f for f in sorted(os.listdir(run_dir))
        if f.endswith((".png", ".csv", ".jsonl", ".yaml"))
    ]
    lines += ["## Artifacts", ""] + [f"- `{a}`" for a in artifacts]
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    from ..utils.logging_utils import setup_logging

    setup_logging()
    parser = argparse.ArgumentParser(description="Summarize a run directory.")
    parser.add_argument("--run_dir", required=True)
    parser.add_argument("--output", default=None,
                        help="Defaults to <run_dir>/report.md")
    args = parser.parse_args(argv)
    report = generate_report(args.run_dir)
    out = args.output or os.path.join(args.run_dir, "report.md")
    with open(out, "w") as f:
        f.write(report)
    logger.info("Report written to %s", out)
    print(report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
