"""Process-wide logging setup (reference: src/utils/logging_utils.py:6-25).

The port's own copy of ``vae_channel_dynamics_tpu/utils/logging_utils.py``."""

from __future__ import annotations

import logging
import sys
from typing import Optional


def setup_logging(log_level: int = logging.INFO, log_file: Optional[str] = None) -> None:
    """Configure root logging to stdout with an optional file handler."""
    handlers: list = [logging.StreamHandler(sys.stdout)]
    if log_file:
        handlers.append(logging.FileHandler(log_file))
    logging.basicConfig(
        level=log_level,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s",
        handlers=handlers,
        force=True,
    )
