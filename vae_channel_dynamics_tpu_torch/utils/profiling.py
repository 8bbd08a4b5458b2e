"""Profiling harness: a torch.profiler trace over a step window, and step
timing. The port of ``vae_channel_dynamics_tpu/utils/profiling.py``.

A config section

    profiling:
      enabled: true
      start_step: 10       # first global step to capture
      num_steps: 5         # how many steps to capture
      output_subdir: "profile"

captures a trace of the hot loop with ``torch.profiler`` (CPU ops with
their shapes and FLOPs, and the CUDA kernels when the Trainer runs on a
CUDA device) and writes it as a Chrome trace
(``<output_dir>/<output_subdir>/trace_steps<first>-<last>.pt.trace.json``)
that ``python -m vae_channel_dynamics_tpu_torch.tools.profile_summary``
reads. A CUDA run whose trace holds no device event raises rather than
write an empty trace. ``StepTimer`` keeps an images/sec estimate without
forcing device syncs.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, Optional

import torch

logger = logging.getLogger(__name__)


class TraceCapture:
    """Start/stop a torch.profiler trace over a step window: started by
    the first ``maybe_start(step)`` with ``step >= start_step``, stopped by
    the first ``maybe_stop(step)`` with ``step >= start_step + num_steps``
    or by ``close`` (idempotent), whichever comes first."""

    def __init__(self, config: Dict[str, Any], output_dir: str, device: Any = "cpu"):
        cfg = config or {}
        self.enabled = bool(cfg.get("enabled", False))
        self.start_step = int(cfg.get("start_step", 10))
        self.num_steps = int(cfg.get("num_steps", 5))
        self.trace_dir = os.path.join(output_dir, cfg.get("output_subdir", "profile"))
        self.cuda = torch.device(device).type == "cuda"
        self.trace_path: Optional[str] = None
        self._prof = None
        self._first = -1
        self._last = -1
        self._active = False
        self._done = False

    def maybe_start(self, global_step: int) -> None:
        if not self.enabled or self._done or self._active:
            return
        if global_step >= self.start_step:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.cuda:
                activities.append(ProfilerActivity.CUDA)
                torch.cuda.synchronize()
            os.makedirs(self.trace_dir, exist_ok=True)
            self._prof = profile(activities=activities, record_shapes=True, with_flops=True)
            self._prof.start()
            self._first = self._last = global_step
            self._active = True
            logger.info("Started profiler trace at step %d -> %s", global_step, self.trace_dir)

    def maybe_stop(self, global_step: int) -> None:
        if not self._active:
            return
        self._last = global_step
        if global_step >= self.start_step + self.num_steps:
            self._stop()

    def close(self) -> None:
        if self._active:
            self._stop()

    def _stop(self) -> None:
        from torch.autograd import DeviceType

        prof, self._prof = self._prof, None
        self._active = False
        self._done = True
        if self.cuda:
            torch.cuda.synchronize()
        prof.stop()
        if self.cuda and not any(e.device_type == DeviceType.CUDA for e in prof.events()):
            raise RuntimeError(
                f"the profiler trace of steps {self._first}-{self._last} holds no CUDA "
                "kernel: torch.profiler recorded no device activity on this machine"
            )
        path = os.path.join(self.trace_dir,
                            f"trace_steps{self._first}-{self._last}.pt.trace.json")
        prof.export_chrome_trace(path)
        self.trace_path = path
        logger.info("Stopped profiler trace at step %d -> %s (read it with python -m "
                    "vae_channel_dynamics_tpu_torch.tools.profile_summary --trace_dir %s)",
                    self._last, path, self.trace_dir)


class StepTimer:
    """Rolling wall-clock throughput estimate (dispatch-side)."""

    def __init__(self, window: int = 50):
        self.window = window
        self._t0: Optional[float] = None
        self._count = 0
        self._images = 0
        self.images_per_sec = 0.0

    def update(self, batch_images: int) -> None:
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
            return
        self._count += 1
        self._images += batch_images
        if self._count >= self.window:
            self.images_per_sec = self._images / (now - self._t0)
            self._t0 = now
            self._count = 0
            self._images = 0
