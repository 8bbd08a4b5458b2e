"""Process-wide logging setup (reference: src/utils/logging_utils.py:6-25).

The port's own copy of ``vae_channel_dynamics_tpu/utils/logging_utils.py``."""

from __future__ import annotations

import logging
import sys
from typing import Optional


def setup_logging(log_level: int = logging.INFO, log_file: Optional[str] = None,
                  rank: int = 0) -> None:
    """Configure root logging to stdout with an optional file handler.
    Across ranks only rank 0 logs at ``log_level``; every other rank logs
    its warnings and errors, each line tagged with its rank."""
    handlers: list = [logging.StreamHandler(sys.stdout)]
    if log_file:
        handlers.append(logging.FileHandler(log_file))
    tag = f"[rank {rank}] " if rank else ""
    logging.basicConfig(
        level=log_level if rank == 0 else max(log_level, logging.WARNING),
        format=f"%(asctime)s - {tag}%(name)s - %(levelname)s - %(message)s",
        handlers=handlers,
        force=True,
    )
