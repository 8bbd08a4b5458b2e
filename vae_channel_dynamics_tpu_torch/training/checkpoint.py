"""Train-state checkpoints with resume, without orbax.

Counterpart of ``vae_channel_dynamics_tpu/training/checkpoint.py``, with the
same directory contract: a checkpoint is a directory (``chkpt-<step>`` or
``final_model``) holding ``state/`` and, when the caller gives the stream
position, ``resume_meta.json`` with the JAX package's keys (``micro_step``,
``global_step``, ``epoch``, ``in_epoch_batches``). ``state/train_state.pt``
is one ``torch.save`` of plain CPU tensors and integers: the fp32 master
parameters by torch name, the AdamW moments and counters, the optimizer
step, the stats accumulators and count, and the EMA parameters. The model
directory that both packages load (``final_model/vae``) is the Trainer's to
write, through ``models/io.py``.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
from typing import Any, Dict, Optional

import torch

from .state import TrainState

logger = logging.getLogger(__name__)

STATE_SUBDIR = "state"
STATE_FILE = "train_state.pt"
RESUME_META = "resume_meta.json"


def _tensors(values, fn):
    return None if values is None else [fn(v) for v in values]


def state_dict_of(state: TrainState, copy=lambda t: t.detach().cpu()) -> Dict[str, Any]:
    """The state as a dict of tensors (each passed through ``copy``) and
    integers."""
    opt = state.opt_state
    return {
        "params": {k: copy(p) for k, p in state.model.named_parameters()},
        "opt": {
            "mu": _tensors(opt.mu, copy),
            "nu": _tensors(opt.nu, copy),
            "count": int(opt.count),
            "mini_step": int(opt.mini_step),
            "acc_grads": _tensors(opt.acc_grads, copy),
        },
        "step": int(state.step),
        "stats_acc": {k: copy(v) for k, v in state.stats_acc.items()},
        "stats_count": copy(state.stats_count),
        "ema_params": (None if state.ema_params is None
                       else {k: copy(v) for k, v in state.ema_params.items()}),
    }


def _write(path: str, payload: Dict[str, Any], meta: Optional[Dict]) -> None:
    target = os.path.join(os.path.abspath(path), STATE_SUBDIR)
    if os.path.exists(target):
        shutil.rmtree(target)
    os.makedirs(target)
    # tmp + rename: a kill mid-write must not leave a truncated state file
    tmp = os.path.join(target, STATE_FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(target, STATE_FILE))
    if meta is not None:
        final = os.path.join(os.path.abspath(path), RESUME_META)
        with open(final + ".tmp", "w") as f:
            json.dump(meta, f)
        os.replace(final + ".tmp", final)
    logger.info("Saved train state to %s", target)


def save_train_state(path: str, state: TrainState, meta: Optional[Dict] = None) -> None:
    """Write ``state`` under ``path``/state (overwriting), and ``meta`` (the
    data-stream position) as ``resume_meta.json`` beside it."""
    _write(path, state_dict_of(state), meta)


class AsyncSaver:
    """Non-blocking checkpoint writes for the hot loop: ``save`` snapshots
    the state on its device (a copy the next steps' in-place updates cannot
    touch), then a writer thread copies the snapshot to the host and writes
    it. One save is in flight at a time; a new ``save`` joins the previous
    one first. Writer errors are raised by the next ``save`` or ``wait``."""

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, path: str, state: TrainState, on_complete=None, meta=None) -> None:
        """``on_complete`` (e.g. pruning) runs in the writer thread after the
        checkpoint lands."""
        self.wait()
        snapshot = state_dict_of(state, copy=lambda t: t.detach().clone())

        def write() -> None:
            try:
                host = _to_cpu(snapshot)
                _write(path, host, meta)
                if on_complete is not None:
                    on_complete()
            except BaseException as e:  # noqa: BLE001 — surfaced by wait()
                self._error = e

        self._thread = threading.Thread(target=write, name="vcd-ckpt-writer", daemon=True)
        self._thread.start()

    def wait(self, reraise: bool = True) -> None:
        """Join the write in flight; ``reraise=False`` keeps a writer error
        stored for the next call (exception-path cleanup)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if reraise and self._error is not None:
            error, self._error = self._error, None
            raise error


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree


def read_resume_meta(path: str) -> Optional[Dict]:
    """The ``resume_meta.json`` of a checkpoint dir, or None when it is
    missing or unreadable (with a warning): resume then derives the stream
    position instead of refusing to start."""
    p = os.path.join(os.path.abspath(path), RESUME_META)
    if not os.path.isfile(p):
        return None
    try:
        with open(p) as f:
            meta = json.load(f)
        for k in ("micro_step", "epoch", "in_epoch_batches"):
            if not isinstance(meta.get(k), int):
                raise ValueError(f"key {k!r} missing or non-integer in {sorted(meta)}")
        return meta
    except (ValueError, OSError) as e:
        logger.warning(
            "Ignoring unreadable resume sidecar %s (%s); falling back to "
            "derived stream position.", p, e,
        )
        return None


@torch.no_grad()
def restore_train_state(path: str, state: TrainState) -> TrainState:
    """Load the checkpoint at ``path`` into ``state`` in place (parameters,
    optimizer, step, stats, EMA; each tensor keeps its device and dtype) and
    return it. The checkpoint must come from a state of the same structure."""
    target = os.path.join(os.path.abspath(path), STATE_SUBDIR, STATE_FILE)
    if not os.path.isfile(target):
        raise FileNotFoundError(f"No checkpoint state at {target}")
    saved = torch.load(target, map_location="cpu", weights_only=True)
    params = dict(state.model.named_parameters())
    if set(saved["params"]) != set(params):
        raise ValueError(f"checkpoint {path} holds other parameters than the model")
    for k, p in params.items():
        p.copy_(saved["params"][k])
    opt = state.opt_state
    for name in ("mu", "nu", "acc_grads"):
        live, kept = getattr(opt, name), saved["opt"][name]
        if (live is None) != (kept is None):
            raise ValueError(f"checkpoint {path}: optimizer {name} does not match "
                             "(gradient accumulation differs?)")
        for dst, src in zip(live or [], kept or []):
            dst.copy_(src)
    opt.count = int(saved["opt"]["count"])
    opt.mini_step = int(saved["opt"]["mini_step"])
    state.step = int(saved["step"])
    if set(saved["stats_acc"]) != set(state.stats_acc):
        raise ValueError(f"checkpoint {path}: stats accumulators do not match the tracking config")
    for k, v in state.stats_acc.items():
        v.copy_(saved["stats_acc"][k])
    state.stats_count.copy_(saved["stats_count"])
    if (state.ema_params is None) != (saved["ema_params"] is None):
        raise ValueError(f"checkpoint {path}: EMA presence differs from training.ema_decay")
    for k, v in (state.ema_params or {}).items():
        v.copy_(saved["ema_params"][k])
    logger.info("Restored train state from %s", target)
    return state


def prune_checkpoints(output_dir: str, prefix: str = "chkpt", keep_last_n: int = 0) -> None:
    """Delete all but the newest ``keep_last_n`` periodic checkpoints; 0
    keeps everything."""
    if keep_last_n <= 0 or not os.path.isdir(output_dir):
        return
    steps = []
    for name in os.listdir(output_dir):
        if name.startswith(prefix + "-"):
            suffix = name.rsplit("-", 1)[-1]
            if suffix.isdigit():
                steps.append(int(suffix))
    for step in sorted(steps)[:-keep_last_n]:
        target = os.path.join(output_dir, f"{prefix}-{step}")
        shutil.rmtree(target, ignore_errors=True)
        logger.info("Pruned old checkpoint %s", target)


def latest_checkpoint(output_dir: str, prefix: str = "chkpt") -> Optional[str]:
    """The highest-step ``<prefix>-<step>`` checkpoint dir of a run that
    holds a ``state/``, or None."""
    if not os.path.isdir(output_dir):
        return None
    best, best_step = None, -1
    for name in os.listdir(output_dir):
        if not name.startswith(prefix + "-"):
            continue
        suffix = name.rsplit("-", 1)[-1]
        if suffix.isdigit() and int(suffix) > best_step:
            candidate = os.path.join(output_dir, name)
            if os.path.isdir(os.path.join(candidate, STATE_SUBDIR)):
                best, best_step = candidate, int(suffix)
    return best


__all__ = [
    "AsyncSaver",
    "latest_checkpoint",
    "prune_checkpoints",
    "read_resume_meta",
    "restore_train_state",
    "save_train_state",
]
