"""Training orchestration on one device: the port of
``vae_channel_dynamics_tpu/training/loop.py``.

The same loop as the JAX Trainer, with one process driving one device:
epochs over the seeded loader, gradient accumulation, the EMA, the interval
control loop (activity monitor -> classifier -> nudger, the dead-weight
tracker, and their CSVs), periodic and preemption checkpoints with the
``resume_meta.json`` stream position, ``training.stop_after_steps``,
validation through :func:`make_eval_step`, and the final artifacts
(``final_model/`` with ``vae/`` and ``vae_ema/``,
``tracked_activation_stats.csv``, ``dead_neuron_percentage_history.csv``,
``intervention_history.csv``, ``metrics.jsonl``).

The posterior noise of micro-step ``i`` is drawn from a generator seeded
with ``(seed, i)``, so a resumed run draws what the uninterrupted run drew.

Not ported yet, and refused with ``NotImplementedError`` rather than
skipped: ``parallel`` axes above 1 (ROADMAP Q1 item 7), ``logit_lens``
(Q1 item 3), ``profiling`` (Q1 item 8), ``saving.export_stablehlo``, and
``model.kernel_impl: fused`` (ROADMAP Q2, kernels #9-#11). The matplotlib
plots are not drawn; the CSV and JSONL files they read are written.
"""

from __future__ import annotations

import logging
import math
import os
import signal
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import yaml

from ..classification import RegionClassifier
from ..data import Prefetcher, create_dataloader, load_and_preprocess_dataset
from ..intervention import InterventionHandler
from ..models import io as model_io
from ..models.vae import AutoencoderKL, VAEConfig
from ..models.wrapper import resolve_device
from ..tracking import ActivityMonitor, DeadNeuronTracker
from ..utils.config_utils import as_float, as_int
from ..utils.reporting import build_reporter
from .checkpoint import (
    AsyncSaver,
    prune_checkpoints,
    read_resume_meta,
    restore_train_state,
    save_train_state,
)
from .state import TrainState
from .step import build_optimizer, make_eval_step, make_train_step

logger = logging.getLogger(__name__)

ATTENTION_IMPLS = ("auto", "naive", "chunked", "flash")
# model.kernel_impl values ported: the GroupNorm impl of every norm
KERNEL_IMPLS = ("auto", "xla", "pallas")


def resolve_model(model_config: Dict[str, Any], dtype: torch.dtype,
                  device: Any) -> AutoencoderKL:
    """The model ``model.*`` asks for, with fp32 master parameters on
    ``device`` and ``dtype`` compute.

    ``pretrained_vae_name`` naming a local model dir (written by either
    package, or a diffusers checkpoint) loads it; any other name (an HF Hub
    id: the port downloads nothing) warns and initialises ``architecture``
    from ``init_seed``, with the JAX Trainer's warning. ``kernel_impl``: ``auto``/``xla`` the plain GroupNorm,
    ``pallas`` the GroupNorm kernels; ``fused`` (kernels #9-#11) raises.
    ``attention_impl``: ``auto``, ``naive``, ``chunked`` or ``flash``,
    resolved per call as in the JAX model. ``remat``: ``none``/``full``."""
    impl = str(model_config.get("kernel_impl", "auto"))
    if impl == "fused":
        raise NotImplementedError(
            "model.kernel_impl 'fused' (the fused GN+SiLU+conv resnet kernels "
            "#9-#11) is not yet ported to PyTorch (ROADMAP Q2); use 'pallas' "
            "or 'auto'"
        )
    if impl not in KERNEL_IMPLS:
        raise ValueError(f"Unknown model.kernel_impl {impl!r}; expected "
                         "'auto', 'xla', 'pallas' or 'fused'.")
    attn_impl = str(model_config.get("attention_impl", "auto"))
    if attn_impl not in ATTENTION_IMPLS:
        raise ValueError(
            f"Unknown model.attention_impl {attn_impl!r}; expected "
            "'auto', 'naive', 'chunked' or 'flash'."
        )
    remat = model_config.get("remat", False)
    name = model_config.get("pretrained_vae_name", "stabilityai/sdxl-vae")
    arch = model_config.get("architecture", "sdxl")
    state_dict = None
    if name and os.path.isdir(name) and os.path.exists(os.path.join(name, "config.json")):
        cfg, state_dict = model_io.load_model_dir(name)
        logger.info("Loaded VAE weights from local dir: %s", name)
    else:
        presets = {"sdxl": VAEConfig.sdxl, "sd": VAEConfig.sd, "tiny": VAEConfig.tiny}
        if arch not in presets:
            raise ValueError(
                f"Unknown model.architecture {arch!r}; expected one of "
                f"{sorted(presets)} (or point model.pretrained_vae_name at a "
                "local model dir)."
            )
        cfg = presets[arch]()
        if name and not os.path.isdir(name):
            logger.warning(
                "Pretrained VAE '%s' is not a local directory and the HF Hub is "
                "unreachable here; initializing the %s architecture from scratch.",
                name, arch,
            )
    model = AutoencoderKL(cfg, attn_impl=attn_impl, device=device,
                          impl=impl, dtype=dtype, remat=remat)
    if state_dict is None:
        gen = torch.Generator(device=device).manual_seed(
            int(model_config.get("init_seed", 0)))
        model.init_weights(gen)
    else:
        model.load_state_dict(state_dict, strict=True)
    return model


def _refuse_unported(config: Dict[str, Any]) -> None:
    parallel = config.get("parallel", {}) or {}
    for axis in ("spatial", "slices", "tensor"):
        if as_int(parallel.get(axis), 1) > 1:
            raise NotImplementedError(
                f"parallel.{axis} > 1: multi-GPU training is not yet ported to "
                "PyTorch (ROADMAP Q1 item 7)"
            )
    if (config.get("logit_lens", {}) or {}).get("enabled", False):
        raise NotImplementedError(
            "logit_lens.enabled: the logit lens is not yet ported to PyTorch "
            "(ROADMAP Q1 item 3); set it to false"
        )
    if (config.get("profiling", {}) or {}).get("enabled", False):
        raise NotImplementedError(
            "profiling.enabled: trace capture is not yet ported to PyTorch "
            "(ROADMAP Q1 item 8); set it to false"
        )
    if (config.get("saving", {}) or {}).get("export_stablehlo", False):
        raise NotImplementedError(
            "saving.export_stablehlo: deployment export is not yet ported to "
            "PyTorch (ROADMAP Q1 item 6); set it to false"
        )


def _step_seed(seed: int, micro_step: int) -> int:
    """The posterior-noise seed of one micro-step."""
    return int(np.random.SeedSequence([seed, micro_step]).generate_state(1)[0])


class Trainer:
    def __init__(self, config: Dict[str, Any], resume_from: Optional[str] = None,
                 device: Any = "cuda"):
        self.config = config
        self.resume_from = resume_from
        self.device = resolve_device(device)

        self.run_name = config.get("run_name", "vae_run")
        self.output_dir = os.path.join(config.get("output_dir", "./results"), self.run_name)
        self.logging_dir = os.path.join(self.output_dir, "logs")

        self.data_config = config.get("data", {})
        self.training_config = config.get("training", {})
        self.logging_config = config.get("logging", {})
        self.saving_config = config.get("saving", {})

        # dead-weight knobs live at the TOP level (quirk SURVEY.md §5a-2)
        self.threshold_dn = as_float(config.get("threshold"), 1e-8)
        self.mean_percentage_dn = as_float(config.get("mean_percentage"), 0.01)
        self.dead_type_dn = config.get("dead_type", "threshold")

        self.kl_weight = as_float(self.training_config.get("kl_weight"), 1e-6)
        self.mixed_precision = self.training_config.get("mixed_precision", "no")

    # ------------------------------------------------------------------ #
    def train(self) -> Dict[str, Any]:
        config = self.config
        _refuse_unported(config)
        device = self.device
        logger.info("Running experiment: %s on %s", self.run_name, device)
        os.makedirs(self.output_dir, exist_ok=True)
        with open(os.path.join(self.output_dir, "config.yaml"), "w") as f:
            yaml.dump(config, f, default_flow_style=False)

        seed = as_int(config.get("seed"), 0)
        reporter = build_reporter(
            self.logging_config.get("report_to", "tensorboard"), self.output_dir,
            self.logging_dir, config.get("project_name", "vae_project"), self.run_name,
            config=config, entity=self.logging_config.get("entity"),
        )

        # ---------------- model ---------------- #
        if self.mixed_precision == "bf16":
            dtype = torch.bfloat16
        elif self.mixed_precision == "fp16":
            logger.warning("fp16 compute is not supported; using bfloat16 compute.")
            dtype = torch.bfloat16
        else:
            dtype = torch.float32
        model = resolve_model(config.get("model", {}), dtype, device)
        vae_config = model.config

        # ---------------- data ---------------- #
        dc = self.data_config
        resolution = as_int(dc.get("resolution"), 256)
        batch_size = as_int(dc.get("batch_size"), 4)
        num_workers = as_int(dc.get("num_workers"), 0)
        train_dataset = load_and_preprocess_dataset(
            dataset_name=dc.get("dataset_name"),
            dataset_config_name=dc.get("dataset_config_name"),
            image_column=dc.get("image_column", "image"),
            resolution=resolution,
            max_samples=dc.get("max_samples"),
            split=dc.get("train_split_name", "train"),
            streaming=bool(dc.get("streaming", False)),
            seed=seed,
            transfer_dtype=dc.get("transfer_dtype", "float32"),
        )
        train_loader = create_dataloader(train_dataset, batch_size=batch_size,
                                         num_workers=num_workers, shuffle=True, seed=seed)
        val_loader = None
        do_validation = bool(dc.get("do_validation", False))
        if do_validation:
            try:
                val_dataset = load_and_preprocess_dataset(
                    dataset_name=dc.get("validation_dataset_name", dc.get("dataset_name")),
                    dataset_config_name=dc.get("validation_dataset_config_name",
                                               dc.get("dataset_config_name")),
                    image_column=dc.get("image_column", "image"),
                    resolution=resolution,
                    max_samples=dc.get("validation_max_samples"),
                    transfer_dtype=dc.get("transfer_dtype", "float32"),
                    split=dc.get("validation_split_name", "validation"),
                    seed=seed,
                )
                val_loader = create_dataloader(
                    val_dataset,
                    batch_size=as_int(dc.get("validation_batch_size"), batch_size),
                    num_workers=num_workers, shuffle=False, seed=seed,
                )
            except Exception as e:  # noqa: BLE001 — parity: disable on failure
                logger.error("Failed to load validation data: %s. Disabling validation.", e)
                do_validation = False

        # ---------------- schedule / optimizer ---------------- #
        tc = self.training_config
        accum = max(1, as_int(tc.get("gradient_accumulation_steps"), 1))
        try:
            steps_per_epoch = max(1, math.ceil(len(train_dataset) / batch_size / accum))
        except TypeError:  # streaming dataset (train.py:188-192 semantics)
            steps_per_epoch = as_int(tc.get("max_steps_per_epoch_iterable"), 10000)
        num_train_epochs = as_int(tc.get("num_train_epochs"), 1)
        max_train_steps = num_train_epochs * steps_per_epoch
        tx, schedule = build_optimizer(
            learning_rate=as_float(tc.get("learning_rate"), 1e-5),
            warmup_steps=as_int(tc.get("lr_warmup_steps"), 100),
            max_train_steps=max_train_steps,
            adam_beta1=as_float(tc.get("adam_beta1"), 0.9),
            adam_beta2=as_float(tc.get("adam_beta2"), 0.999),
            adam_weight_decay=as_float(tc.get("adam_weight_decay"), 1e-2),
            adam_epsilon=as_float(tc.get("adam_epsilon"), 1e-8),
            max_grad_norm=as_float(tc.get("max_grad_norm"), 1.0),
            gradient_accumulation_steps=accum,
            optimizer=str(tc.get("optimizer", "adamw")).lower(),
            lr_scheduler_type=str(tc.get("lr_scheduler_type", "linear")),
        )

        # ---------------- instrumentation ---------------- #
        monitor = ActivityMonitor(config.get("tracking", {}))
        track_interval = monitor.track_interval if monitor.enabled else 0

        dnt_config = config.get("dead_neuron_tracking", {})
        dead_tracker = None
        dnt_interval = 0
        if dnt_config.get("enabled", False):
            dead_tracker = DeadNeuronTracker(
                target_layer_names_for_raw_weights=dnt_config.get(
                    "target_layer_names_for_raw_weights", []),
                threshold=self.threshold_dn,
                mean_percentage=self.mean_percentage_dn,
                dead_type=self.dead_type_dn,
            )
            dnt_interval = as_int(dnt_config.get("track_interval"), 100)

        classifier_config = config.get("classification", {})
        classifier = (RegionClassifier(model, classifier_config)
                      if classifier_config.get("enabled", False) else None)
        intervention_config = config.get("intervention", {})
        handler = (InterventionHandler(intervention_config)
                   if intervention_config.get("enabled", False) else None)
        intervention_interval = as_int(intervention_config.get("intervention_interval"), 200)

        # ---------------- state and steps ---------------- #
        model.set_capture(monitor.scalar_capture_table)
        ema_decay = as_float(tc.get("ema_decay"), 0.0)
        state = TrainState.create(model, tx, stats_acc=monitor.init_acc(model),
                                  ema=ema_decay > 0.0)
        if self.resume_from:
            state = restore_train_state(self.resume_from, state)
            logger.info("Resumed from %s at step %d", self.resume_from, state.step)
        step_plain = make_train_step(model, tx, self.kl_weight,
                                     stats_accumulate=ActivityMonitor.accumulate,
                                     ema_decay=ema_decay)
        step_maps = None
        if monitor.enabled and monitor.map_keys:
            step_maps = make_train_step(model, tx, self.kl_weight,
                                        stats_accumulate=ActivityMonitor.accumulate,
                                        map_keys=monitor.map_keys, ema_decay=ema_decay)
        eval_step = make_eval_step(model) if do_validation else None

        # ---------------- intervals ---------------- #
        # clamped to >=1: the non-finite loss check rides the logging interval
        log_interval = max(1, as_int(self.logging_config.get("log_interval"), 10))
        save_interval_steps = as_int(self.saving_config.get("save_interval_steps"), 500)
        checkpoint_prefix = self.saving_config.get("checkpoint_dir_prefix", "chkpt")
        keep_last_n = as_int(self.saving_config.get("keep_last_n"), 0)
        validation_epochs = as_int(tc.get("validation_epochs"), 0)
        validation_steps = as_int(tc.get("validation_steps"), 0)
        ckpt_saver = AsyncSaver() if self.saving_config.get("async_save", True) else None

        # ---------------- preemption ---------------- #
        # SIGTERM (and training.stop_after_steps) checkpoint at the next step
        # boundary and leave the loop; `--resume_from auto` continues.
        preempt_flag = {"hit": False}
        stop_after_steps = as_int(tc.get("stop_after_steps"), 0)

        def _on_term(signum, _frame):
            preempt_flag["hit"] = True
            logger.warning("Received signal %d — will checkpoint and exit at the next "
                           "step boundary.", signum)

        try:
            prev_sigterm = signal.signal(signal.SIGTERM, _on_term)
        except ValueError:  # not the main thread (embedded use): no handler
            prev_sigterm = None
        preempted = False
        stop_was_deterministic = False

        # ---------------- loop ---------------- #
        logger.info("***** Running training: %d epochs, %d steps/epoch, batch %d *****",
                    num_train_epochs, steps_per_epoch, batch_size)
        global_step = state.step // accum
        micro_step = state.step
        t_start = time.time()
        images_seen = 0
        noise_gen = torch.Generator(device=device)

        def _prepared_batches(loader, skip=0):
            """Batches with their validity masks, staged to the device ahead
            of consumption. ``skip`` fast-forwards a resumed epoch: by index
            for map-style datasets, by consuming for streaming ones."""
            index_skip = 0
            if skip and not loader.is_iterable:
                index_skip, skip = skip, 0

            def gen():
                emitted = index_skip
                for batch in loader.iter_batches(start_batch=index_skip):
                    if batch is None:
                        continue
                    pixels = batch["pixel_values"]
                    if pixels.ndim != 4 or pixels.shape[0] == 0:
                        continue
                    emitted += 1
                    if emitted <= skip:
                        continue
                    yield {"pixel_values": pixels,
                           "mask": np.ones(pixels.shape[0], np.float32),
                           "n_valid": int(pixels.shape[0])}

            return Prefetcher(gen(), device=device, depth=2)

        metric_keys = ("train_loss_step", "rec_loss", "kl_loss")

        # the stream position: the checkpoint's resume_meta.json, else
        # derived from micro_step (exact for map-style datasets)
        resume_meta = read_resume_meta(self.resume_from) if self.resume_from else None
        if resume_meta is not None and int(resume_meta.get("micro_step", -1)) == micro_step:
            start_epoch = min(int(resume_meta["epoch"]), num_train_epochs)
            resume_skip_batches = int(resume_meta["in_epoch_batches"])
        else:
            if micro_step > 0 and self.resume_from:
                logger.warning(
                    "Checkpoint has no (matching) resume_meta.json sidecar; deriving the "
                    "stream position from micro_step — exact for map-style datasets, "
                    "approximate for streaming ones.")
            try:
                micro_per_epoch = len(train_loader)
            except TypeError:
                micro_per_epoch = steps_per_epoch * accum
            micro_per_epoch = max(1, micro_per_epoch)
            start_epoch = min(micro_step // micro_per_epoch, num_train_epochs)
            resume_skip_batches = micro_step % micro_per_epoch
        if micro_step > 0:
            logger.info("Resume fast-forward: starting at epoch %d, skipping %d "
                        "already-consumed batches.", start_epoch, resume_skip_batches)

        epoch = start_epoch
        in_epoch_micro = resume_skip_batches

        def _resume_meta():
            return {"micro_step": micro_step, "global_step": global_step,
                    "epoch": epoch, "in_epoch_batches": in_epoch_micro}

        try:
            for epoch in range(start_epoch, num_train_epochs):
                epoch_sums = dict.fromkeys(metric_keys, 0.0)
                epoch_count = 0
                pending_metrics: list = []

                def _drain_epoch_metrics():
                    """Fetch the buffered step metrics in one copy; returns
                    the newest as host floats."""
                    nonlocal epoch_count
                    if not pending_metrics:
                        return None
                    keys = list(pending_metrics[0])
                    host = torch.stack([torch.stack([m[k].float() for k in keys])
                                        for m in pending_metrics]).cpu().tolist()
                    pending_metrics.clear()
                    for row in host:
                        for k in metric_keys:
                            epoch_sums[k] += row[keys.index(k)]
                    epoch_count += len(host)
                    return dict(zip(keys, host[-1]))

                train_loader.set_epoch(epoch)
                in_epoch_micro = resume_skip_batches if epoch == start_epoch else 0
                train_batches = _prepared_batches(
                    train_loader, skip=resume_skip_batches if epoch == start_epoch else 0)
                for batch in train_batches:
                    images_seen += batch["n_valid"]
                    micro_step += 1
                    in_epoch_micro += 1
                    is_update = micro_step % accum == 0
                    next_global = global_step + 1 if is_update else global_step
                    want_maps = (step_maps is not None and is_update and track_interval > 0
                                 and next_global % track_interval == 0)
                    noise_gen.manual_seed(_step_seed(seed, micro_step))
                    pixels = {"pixel_values": batch["pixel_values"]}
                    if want_maps:
                        model.set_capture(monitor.map_capture_table)
                        try:
                            state, metrics, maps = step_maps(state, pixels, batch["mask"],
                                                             noise_gen)
                        finally:
                            model.set_capture(monitor.scalar_capture_table)
                    else:
                        state, metrics, maps = step_plain(state, pixels, batch["mask"],
                                                          noise_gen)
                    pending_metrics.append(metrics)
                    if not is_update:
                        continue
                    global_step = next_global
                    # reference parity (src/train.py:310): an intervention
                    # only fires on a step with a fresh classification
                    classification_output: Dict[str, Any] = {}

                    # --- monitor aggregation and classification ---
                    activity_metrics: Dict[str, float] = {}
                    if monitor.enabled and track_interval > 0 and (
                            global_step % track_interval == 0):
                        activity_metrics = monitor.step(global_step, state.stats_acc,
                                                        state.stats_count, maps)
                        state.reset_stats()
                        if classifier is not None:
                            tracked = monitor.get_data_for_step(global_step)
                            classification_output = (
                                classifier.classify(tracked, global_step) if tracked else {})
                            if not classification_output:
                                logger.info("Step %d: Classifier found no inactive channels.",
                                            global_step)

                    # --- intervention ---
                    if (handler is not None and intervention_interval > 0
                            and global_step % intervention_interval == 0):
                        if classification_output:
                            handler.intervene(model, classification_output, global_step)
                            inactive_total = sum(len(v["inactive_channel_indices"])
                                                 for v in classification_output.values())
                            reporter.log({"inactive_channels": inactive_total,
                                          "nudged_scales": handler.num_nudges_applied},
                                         global_step)
                            with open(os.path.join(self.output_dir,
                                                   "intervention_history.csv"), "a") as fh:
                                fh.write(f"{global_step},{inactive_total},"
                                         f"{handler.num_nudges_applied}\n")
                        else:
                            logger.info("Step %d: Intervention due, but no regions classified.",
                                        global_step)

                    # --- logging and divergence check ---
                    if global_step % log_interval == 0:
                        host_metrics = _drain_epoch_metrics()
                        if not np.isfinite(host_metrics["train_loss_step"]):
                            msg = f"Non-finite loss at step {global_step}: {host_metrics}"
                            if bool(tc.get("abort_on_nonfinite", True)):
                                raise FloatingPointError(msg)
                            logger.error(msg)
                        logs = {
                            "train_loss_step": host_metrics["train_loss_step"],
                            "rec_loss": host_metrics["rec_loss"],
                            "kl_loss": host_metrics["kl_loss"],
                            "grad_norm": host_metrics["grad_norm"],
                            # the JAX Trainer's (and the reference's) off-by-one:
                            # the lr of the NEXT update
                            "lr": float(schedule(global_step)),
                            "epoch_current": epoch,
                            **activity_metrics,
                        }
                        reporter.log(logs, global_step)
                        logger.info("step %d loss %.4e lr %.3e (%.1f img/s)", global_step,
                                    logs["train_loss_step"], logs["lr"],
                                    images_seen / max(time.time() - t_start, 1e-6))

                    # --- dead-weight tracking ---
                    if dead_tracker is not None and dnt_interval > 0 and (
                            global_step % dnt_interval == 0):
                        dead_tracker.track_dead_neurons(model, global_step)

                    # --- periodic checkpoint ---
                    if save_interval_steps > 0 and global_step % save_interval_steps == 0:
                        ckpt_path = os.path.join(self.output_dir,
                                                 f"{checkpoint_prefix}-{global_step}")

                        def _prune(out=self.output_dir, pfx=checkpoint_prefix,
                                   n=keep_last_n):
                            prune_checkpoints(out, pfx, n)

                        if ckpt_saver is not None:
                            ckpt_saver.save(ckpt_path, state, on_complete=_prune,
                                            meta=_resume_meta())
                        else:
                            save_train_state(ckpt_path, state, meta=_resume_meta())
                            _prune()

                    # --- preemption-safe exit ---
                    deterministic_stop = stop_after_steps > 0 and global_step >= stop_after_steps
                    if deterministic_stop:
                        preempt_flag["hit"] = True
                    if preempt_flag["hit"]:
                        if ckpt_saver is not None:
                            ckpt_saver.wait()
                        save_train_state(
                            os.path.join(self.output_dir, f"{checkpoint_prefix}-{global_step}"),
                            state, meta=_resume_meta())
                        logger.warning("Preemption checkpoint written at step %d; "
                                       "exiting the training loop.", global_step)
                        preempted = True
                        stop_was_deterministic = deterministic_stop
                        break

                    # --- step-interval validation ---
                    if (do_validation and val_loader is not None and validation_steps > 0
                            and global_step % validation_steps == 0):
                        self._run_validation(eval_step, _prepared_batches(val_loader),
                                             global_step, reporter)
                    if global_step >= max_train_steps:
                        break
                # an early break leaves the prefetch worker parked on a full
                # queue; close() unblocks it
                train_batches.close()

                # --- epoch summary ---
                _drain_epoch_metrics()
                if epoch_count:
                    reporter.log({
                        "train/epoch_avg_loss": epoch_sums["train_loss_step"] / epoch_count,
                        "train/epoch_avg_rec_loss": epoch_sums["rec_loss"] / epoch_count,
                        "train/epoch_avg_kl_loss": epoch_sums["kl_loss"] / epoch_count,
                        "epoch_completed": epoch,
                    }, global_step)
                logger.info("Epoch %d completed.", epoch)

                # --- epoch-interval validation (skipped when preempted) ---
                if (not preempted and do_validation and val_loader is not None
                        and validation_epochs > 0 and (epoch + 1) % validation_epochs == 0
                        and validation_steps <= 0):
                    self._run_validation(eval_step, _prepared_batches(val_loader),
                                         global_step, reporter)
                if preempted:
                    break
                if global_step >= max_train_steps:
                    logger.info("Reached max_train_steps.")
                    break
        finally:
            if prev_sigterm is not None:
                signal.signal(signal.SIGTERM, prev_sigterm)
            if ckpt_saver is not None:
                ckpt_saver.wait(reraise=False)
        if ckpt_saver is not None:
            ckpt_saver.wait()
        elapsed = time.time() - t_start
        logger.info("Training finished: %d steps, %d images in %.1fs (%.1f img/s)",
                    global_step, images_seen, elapsed, images_seen / max(elapsed, 1e-6))

        if preempted and not stop_was_deterministic:
            # a real SIGTERM: the grace window is for the checkpoint already
            # written, not for the finalize
            logger.warning("Preempted: skipping the final-model export (the preemption "
                           "checkpoint at step %d is the resume artifact).", global_step)
            reporter.finish()
            return dict(final_model_dir=None, global_step=global_step,
                        images_per_sec=images_seen / max(elapsed, 1e-6),
                        images_seen=images_seen, preempted=True)

        summary = self._finalize(state, vae_config, monitor, dead_tracker, reporter,
                                 final_meta=_resume_meta())
        summary.update(global_step=global_step,
                       images_per_sec=images_seen / max(elapsed, 1e-6),
                       images_seen=images_seen, preempted=preempted)
        return summary

    # ------------------------------------------------------------------ #
    def _run_validation(self, eval_step, prepared_batches, global_step, reporter
                        ) -> Dict[str, float]:
        """SUM-convention validation (src/train.py:53-97)."""
        logger.info("--- Running Validation for Global Step: %d ---", global_step)
        sums = []
        try:
            for batch in prepared_batches:
                out = eval_step({"pixel_values": batch["pixel_values"]}, batch["mask"])
                sums.append(torch.stack([out["rec_loss_sum"], out["kl_sum"],
                                         out["num_samples"]]).float())
        finally:
            prepared_batches.close()
        rec_sum, kl_sum, n = (torch.stack(sums).sum(0).cpu().tolist()
                              if sums else (0.0, 0.0, 0.0))
        avg_rec = rec_sum / n if n else 0.0
        avg_kl = kl_sum / n if n else 0.0
        avg_total = avg_rec + self.kl_weight * avg_kl
        metrics = {
            "validation/avg_total_loss": avg_total,
            "validation/avg_reconstruction_loss": avg_rec,
            "validation/avg_kl_divergence": avg_kl,
        }
        reporter.log(metrics, global_step)
        logger.info("Validation: total %.4e rec %.4e kl %.4e (%d samples)",
                    avg_total, avg_rec, avg_kl, int(n))
        return metrics

    # ------------------------------------------------------------------ #
    def _finalize(self, state, vae_config, monitor, dead_tracker, reporter,
                  final_meta=None) -> Dict[str, Any]:
        """The final artifacts: final_model/ (a resumable state),
        final_model/vae/ (the model dir both packages load), vae_ema/, the
        activation-stats CSV and the dead-weight history CSV. The JAX
        Trainer's plots are not drawn (ROADMAP Q1 item 4)."""
        import pandas as pd

        summary: Dict[str, Any] = {}
        final_dir = os.path.join(self.output_dir, "final_model")
        os.makedirs(final_dir, exist_ok=True)
        save_train_state(final_dir, state, meta=final_meta)
        vae_dir = os.path.join(final_dir, "vae")
        model_io.save_model_dir(vae_dir, vae_config, dict(state.model.named_parameters()))
        logger.info("Final VAE saved to %s", vae_dir)
        summary["final_model_dir"] = final_dir
        if state.ema_params is not None:
            ema_dir = os.path.join(final_dir, "vae_ema")
            model_io.save_model_dir(ema_dir, vae_config, state.ema_params)
            logger.info("EMA VAE saved to %s", ema_dir)
            summary["ema_model_dir"] = ema_dir

        if monitor.enabled:
            records = monitor.export_all_processed_data_to_records()
            if records:
                activity_csv = os.path.join(self.output_dir, "tracked_activation_stats.csv")
                pd.DataFrame(records).to_csv(activity_csv, index=False)
                logger.info("Saved activation stats to %s", activity_csv)
                summary["activity_csv"] = activity_csv
                art_name = "".join(c if c.isalnum() or c in ("-", "_", ".") else "_"
                                   for c in f"{self.run_name}_activations")
                reporter.log_artifact(activity_csv, art_name, artifact_type="dataset")

        if dead_tracker is not None:
            records = [{"step": step, "layer": layer, "percentage": pct}
                       for layer, hist in dead_tracker.percent_history.items()
                       for step, pct in hist]
            if records:
                pd.DataFrame(records).to_csv(
                    os.path.join(self.output_dir, "dead_neuron_percentage_history.csv"),
                    index=False)
        logger.info("Plots are not drawn by the PyTorch Trainer (ROADMAP Q1 item 4); "
                    "their CSV and JSONL inputs are in %s", self.output_dir)
        reporter.finish()
        return summary


__all__ = ["Trainer", "resolve_model"]
