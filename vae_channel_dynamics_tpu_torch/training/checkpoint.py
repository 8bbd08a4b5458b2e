"""Train-state checkpoints with resume, without orbax.

Counterpart of ``vae_channel_dynamics_tpu/training/checkpoint.py``, with the
same directory contract: a checkpoint is a directory (``chkpt-<step>`` or
``final_model``) holding ``state/`` and, when the caller gives the stream
position, ``resume_meta.json`` with the JAX package's keys (``micro_step``,
``global_step``, ``epoch``, ``in_epoch_batches``). ``state/train_state.pt``
is one ``torch.save`` of plain CPU tensors and integers: the fp32 master
parameters by torch name, the optimizer state by field (AdamW's moments, or
Adafactor's row, column and full moments) with its counters, the optimizer
step, the stats accumulators and count, and the EMA parameters. The model
directory that both packages load (``final_model/vae``) is the Trainer's to
write, through ``models/io.py``.

Across ranks the file is the same as one process writes: a state whose
leaves are sliced (``state.layout``, ``parallel/zero.py``) is gathered
whole on every rank (a collective every rank calls), rank 0 writes it, and
a restore copies each rank's slice out of the whole leaves, so a run saved
at one world size resumes at any other. Under a tensor axis the channel
blocks are gathered too, the taps' per-channel running sums included
(``ops/tensor_parallel.py``, ``whole_taps``), so the file is the one-card
file.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import threading
from typing import Any, Dict, Optional

import torch

from ..ops.tensor_parallel import tap_blocks, whole_taps
from ..parallel.zero import write_leaf
from .state import TrainState

logger = logging.getLogger(__name__)

STATE_SUBDIR = "state"
STATE_FILE = "train_state.pt"
RESUME_META = "resume_meta.json"


def _opt_dict(opt, copy, whole) -> Dict[str, Any]:
    """An optimizer state (a dataclass of tensor lists and integers) by
    field, with its kind."""
    out: Dict[str, Any] = {"kind": type(opt).__name__}
    for field in dataclasses.fields(opt):
        value = getattr(opt, field.name)
        if isinstance(value, int):
            out[field.name] = int(value)
        else:
            out[field.name] = None if value is None else [
                None if v is None else copy(whole(field.name, i, v))
                for i, v in enumerate(value)]
    return out


def state_dict_of(state: TrainState, copy=lambda t: t.detach().cpu()) -> Dict[str, Any]:
    """The state as a dict of whole tensors (each passed through ``copy``)
    and integers; sliced leaves are gathered first, on every rank."""
    layout = state.layout

    def whole(field: str, i: int, t: torch.Tensor) -> torch.Tensor:
        return t.detach() if layout is None else layout.gather(field, i, t.detach())

    return {
        "params": {k: copy(whole("param", i, p))
                   for i, (k, p) in enumerate(state.model.named_parameters())},
        "opt": _opt_dict(state.opt_state, copy, whole),
        "step": int(state.step),
        "stats_acc": {k: copy(v) for k, v in whole_taps(state.stats_acc,
                                                        state.model).items()},
        "stats_count": copy(state.stats_count),
        "ema_params": (None if state.ema_params is None
                       else {k: copy(whole("ema", i, v))
                             for i, (k, v) in enumerate(state.ema_params.items())}),
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


def write_state_dict(path: str, payload: Dict[str, Any], meta: Optional[Dict] = None) -> None:
    """Write a :func:`state_dict_of` payload (on any device) as a
    checkpoint under ``path``."""
    _write(path, _to_cpu(payload), meta)


def save_train_state(path: str, state: TrainState, meta: Optional[Dict] = None,
                     write: bool = True) -> None:
    """Write ``state`` under ``path``/state (overwriting), and ``meta`` (the
    data-stream position) as ``resume_meta.json`` beside it. Across ranks
    every rank calls it (the gather) and only the one with ``write``
    writes."""
    payload = state_dict_of(state)
    if write:
        _write(path, payload, meta)


class AsyncSaver:
    """Non-blocking checkpoint writes for the hot loop: ``save`` snapshots
    the state on its device (a copy the next steps' in-place updates cannot
    touch), then a writer thread copies the snapshot to the host and writes
    it. One save is in flight at a time; a new ``save`` joins the previous
    one first. Writer errors are raised by the next ``save`` or ``wait``."""

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, path: str, state: TrainState, on_complete=None, meta=None,
             write: bool = True) -> None:
        """``on_complete`` (e.g. pruning) runs in the writer thread after the
        checkpoint lands. Across ranks every rank calls it (the snapshot
        gathers sliced leaves) and only the one with ``write`` writes."""
        self.wait()
        snapshot = state_dict_of(state, copy=lambda t: t.detach().clone())
        if not write:
            return

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
    layout = state.layout

    def mine(field: str, i: int, full: torch.Tensor) -> torch.Tensor:
        return full if layout is None else layout.scatter(field, i, full)

    params = dict(state.model.named_parameters())
    if set(saved["params"]) != set(params):
        raise ValueError(f"checkpoint {path} holds other parameters than the model")
    for k, p in params.items():
        write_leaf(p, saved["params"][k])
    opt, kept_opt = state.opt_state, saved["opt"]
    kind = kept_opt.get("kind", "OptState")
    if kind != type(opt).__name__:
        raise ValueError(f"checkpoint {path} holds a {kind} optimizer state, the run a "
                         f"{type(opt).__name__} (training.optimizer differs?)")
    for field in dataclasses.fields(opt):
        name = field.name
        live, kept = getattr(opt, name), kept_opt[name]
        if isinstance(live, int):
            setattr(opt, name, int(kept))
            continue
        if name == "acc_grads" and (live is None) != (kept is None):
            # a data-parallel run keeps no accumulator (training/step.py);
            # a save at an update boundary holds an empty one either way
            if int(kept_opt["mini_step"]) != 0:
                raise ValueError(f"checkpoint {path}: saved mid-accumulation by a run "
                                 "that keeps its gradient sum elsewhere")
            for dst in live or []:
                dst.zero_()
            continue
        if (live is None) != (kept is None) or len(live or []) != len(kept or []):
            raise ValueError(f"checkpoint {path}: optimizer {name} does not match "
                             "(gradient accumulation differs?)")
        for i, (dst, src) in enumerate(zip(live or [], kept or [])):
            if (dst is None) != (src is None):
                raise ValueError(f"checkpoint {path}: optimizer {name} is factored "
                                 "otherwise")
            if dst is not None:
                dst.copy_(mine(name, i, src))
    state.step = int(saved["step"])
    if set(saved["stats_acc"]) != set(state.stats_acc):
        raise ValueError(f"checkpoint {path}: stats accumulators do not match the tracking config")
    kept_acc = tap_blocks(saved["stats_acc"], state.model)
    for k, v in state.stats_acc.items():
        v.copy_(kept_acc[k])
    state.stats_count.copy_(saved["stats_count"])
    if (state.ema_params is None) != (saved["ema_params"] is None):
        raise ValueError(f"checkpoint {path}: EMA presence differs from training.ema_decay")
    for i, (k, v) in enumerate((state.ema_params or {}).items()):
        v.copy_(mine("ema", i, saved["ema_params"][k]))
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
    "state_dict_of",
    "write_state_dict",
]
