"""Experiment-tracking adapters behind ``logging.report_to``.

The port's own copy of ``vae_channel_dynamics_tpu/utils/reporting.py``, with
the same degradation: no ``wandb`` or no ``tensorboardX`` gives
``metrics.jsonl``.

The reference logs to wandb and/or tensorboard via Accelerate
(src/train.py:113-144, :331-338). Here each backend is an adapter with a
``log(metrics, step)`` / ``finish()`` interface:

- ``wandb``        used when the package is importable; otherwise degrades
                   to the JSONL adapter with a warning (configs carrying
                   ``report_to: "wandb"`` must run unchanged offline)
- ``tensorboard``  tensorboardX SummaryWriter into the run's logging dir
- ``jsonl``        append-only ``metrics.jsonl`` in the run dir (always a
                   safe fallback; machine-readable)
- ``none``         drop everything
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)


class Reporter:
    def log(self, metrics: Dict[str, Any], step: int) -> None:  # pragma: no cover
        raise NotImplementedError

    def log_artifact(
        self, path: str, name: str, artifact_type: str = "dataset"
    ) -> None:
        """Upload a run artifact file. Only backends with artifact stores
        (wandb; src/train.py:427-432) act on this — others no-op, since the
        file already lives in the run directory."""

    def finish(self) -> None:
        pass


class NullReporter(Reporter):
    def log(self, metrics: Dict[str, Any], step: int) -> None:
        pass


class JsonlReporter(Reporter):
    def __init__(self, output_dir: str, filename: str = "metrics.jsonl"):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, filename)
        self._fh = open(self.path, "a")

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        record = {"step": int(step)}
        for k, v in metrics.items():
            try:
                record[k] = float(v)
            except (TypeError, ValueError):
                record[k] = str(v)
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()

    def finish(self) -> None:
        self._fh.close()


class TensorBoardReporter(Reporter):
    def __init__(self, logging_dir: str):
        from tensorboardX import SummaryWriter

        self.writer = SummaryWriter(logging_dir)

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        for k, v in metrics.items():
            try:
                self.writer.add_scalar(k, float(v), int(step))
            except (TypeError, ValueError):
                pass

    def finish(self) -> None:
        self.writer.close()


class WandbReporter(Reporter):
    def __init__(self, project, run_name, config, output_dir, entity):
        import wandb

        self._wandb = wandb
        wandb.init(
            project=project, name=run_name, config=config, dir=output_dir,
            entity=entity,
        )

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        self._wandb.log(metrics, step=step)

    def log_artifact(
        self, path: str, name: str, artifact_type: str = "dataset"
    ) -> None:
        """wandb Artifact upload (reference: src/train.py:427-432 uploads
        tracked_activation_stats.csv the same way)."""
        try:
            artifact = self._wandb.Artifact(name, type=artifact_type)
            artifact.add_file(path)
            self._wandb.log_artifact(artifact)
            logger.info("Uploaded artifact %s (%s)", name, path)
        except Exception as e:  # noqa: BLE001 — artifact upload best-effort
            logger.warning("Artifact upload failed for %s: %s", path, e)

    def finish(self) -> None:
        self._wandb.finish()


class MultiReporter(Reporter):
    def __init__(self, reporters: List[Reporter]):
        self.reporters = reporters

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        for r in self.reporters:
            r.log(metrics, step)

    def log_artifact(
        self, path: str, name: str, artifact_type: str = "dataset"
    ) -> None:
        for r in self.reporters:
            r.log_artifact(path, name, artifact_type)

    def finish(self) -> None:
        for r in self.reporters:
            r.finish()


def build_reporter(
    report_to: str,
    output_dir: str,
    logging_dir: str,
    project_name: str,
    run_name: str,
    config: Optional[Dict[str, Any]] = None,
    entity: Optional[str] = None,
    is_main_process: bool = True,
) -> Reporter:
    if not is_main_process or report_to in (None, "none"):
        return NullReporter()
    reporters: List[Reporter] = []
    if report_to in ("wandb", "all"):
        try:
            reporters.append(
                WandbReporter(project_name, run_name, config, output_dir, entity)
            )
            logger.info("W&B reporter initialized (entity: %s)", entity or "default")
        except Exception as e:  # noqa: BLE001 — wandb absent or init failure
            logger.warning(
                "W&B unavailable (%s); falling back to metrics.jsonl", e
            )
            reporters.append(JsonlReporter(output_dir))
    if report_to in ("tensorboard", "all"):
        try:
            reporters.append(TensorBoardReporter(logging_dir))
        except Exception as e:  # noqa: BLE001
            logger.warning("TensorBoard unavailable (%s); using JSONL", e)
            reporters.append(JsonlReporter(output_dir))
    if report_to == "jsonl" or not reporters:
        reporters.append(JsonlReporter(output_dir))
    if len(reporters) == 1:
        return reporters[0]
    return MultiReporter(reporters)
