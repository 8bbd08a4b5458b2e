"""Training orchestration: the port of
``vae_channel_dynamics_tpu/training/loop.py``.

The same loop as the JAX Trainer, with one process driving one device, or
one process per card over the ``data`` axis (launched by torchrun,
``parallel/``):
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
With ``logit_lens.enabled`` the lens runs every ``visualization_interval``
steps on the monitor's data for that step, as in the JAX Trainer, drawn
with PIL (``analysis/logit_lens.py``).

With ``profiling.enabled`` a torch.profiler trace covers the configured
step window (``utils/profiling.py``) and is closed on every exit path.

``saving.export_stablehlo`` (the key keeps its JAX name, since the configs
are shared) writes ``final_model/exported/``: the port writes
``torch.export`` programs there (``tools/export_model.py``), at
``data.resolution``, bf16 under ``mixed_precision`` bf16 or fp16, else fp32,
for the Trainer's device.

Across ranks each rank reads its strided shard of every epoch
(``data.batch_size`` per rank, ``drop_last``), and the model is wrapped in
DDP, or sharded by FSDP2 under ``parallel.shard_params`` (ZeRO-3, not with
``kernel_impl: fused``, whose kernels keep the parameters whole, as in JAX);
``shard_optimizer`` and ``shard_ema`` slice the optimizer state and the EMA
(``parallel/zero.py``). The step reduces the losses and the taps over the
global batch, so every rank runs the monitor, the classifier and the
nudger on the same numbers and nudges the same γ entries. Rank 0 alone
writes the config, the reports, the CSVs, the checkpoints (gathered on
every rank), ``final_model``, the lens and the profile trace.

``parallel.spatial`` = S > 1 shards the images' rows over spatial groups of
S neighbouring ranks (``parallel/mesh.py``, ``ops/spatial_conv.py``): every
rank of a group reads its data rank's shard (the loaders' ``shard_index``
and ``num_shards`` are the data axis's) and keeps its block of the rows;
the train and validation steps run under the spatial scope. The parameters
are replicated over ``spatial``, so checkpoints, exact resume, the control
loop and ``final_model`` are as on the data axis. ``kernel_impl: fused`` on
a spatial mesh runs ``auto`` with JAX's warning: the fused kernels exchange
no halo.

``parallel.tensor`` = T > 1 shards every parameter's channels over tensor
groups of T neighbouring ranks (``parallel/mesh.py``,
``ops/tensor_parallel.py``): the model keeps the rank's blocks
(``AutoencoderKL.shard_tensor_``) before DDP or FSDP2 wraps it over the
ranks of its tensor index, the moments and the EMA keep the same blocks
(``parallel/zero.py``), and the train and validation steps run under the
tensor scope. The monitor gathers the taps' per-channel blocks at its
interval, the nudger reads γ whole and writes its block, the dead-weight
tracker reads whole parameters, and checkpoints and ``final_model`` are
gathered whole, in the one-card format; a resume slices them again. As in
JAX (``loop.py:236-289``), ``kernel_impl: fused`` runs ``auto`` and
``attention_impl: flash`` runs ``auto`` on a tensor mesh, each with JAX's
warning; the GroupNorm kernels (``pallas``) run on the channel blocks.

Refused with ``NotImplementedError`` rather than skipped:
``parallel.slices`` (Do not port). The end-of-run plots
(``utils/plotting.py``) are drawn where matplotlib imports and skipped with
one warning each where it does not.
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

from ..analysis import VAELogitLens
from ..classification import RegionClassifier
from ..data import Prefetcher, create_dataloader, load_and_preprocess_dataset
from ..intervention import InterventionHandler
from ..models import io as model_io
from ..models.vae import AutoencoderKL, VAEConfig
from ..models.wrapper import resolve_device
from ..ops.tensor_parallel import TensorGroup, whole_taps
from ..parallel.mesh import (
    initialize_distributed,
    launched_by_torchrun,
    mesh_shape,
    refuse_unported_axes,
    spatial_conv_choice,
    with_layout,
)
from ..parallel.zero import ZeroLayout, fully_shard_model
from ..tracking import ActivityMonitor, DeadNeuronTracker
from ..utils.config_utils import as_float, as_int
from ..utils.plotting import ActivityPlotter, DeadNeuronPlotter, plot_dead_vs_nudge
from ..utils.profiling import TraceCapture
from ..utils.reporting import build_reporter
from .checkpoint import (
    AsyncSaver,
    prune_checkpoints,
    read_resume_meta,
    restore_train_state,
    save_train_state,
    state_dict_of,
    write_state_dict,
)
from .state import TrainState
from .step import build_optimizer, make_eval_step, make_train_step

logger = logging.getLogger(__name__)

ATTENTION_IMPLS = ("auto", "naive", "chunked", "flash")
# model.kernel_impl values: the impl of every norm and resnet
KERNEL_IMPLS = ("auto", "xla", "pallas", "fused")


def resolve_model(model_config: Dict[str, Any], dtype: torch.dtype,
                  device: Any) -> AutoencoderKL:
    """The model ``model.*`` asks for, with fp32 master parameters on
    ``device`` and ``dtype`` compute.

    ``pretrained_vae_name`` naming a local model dir (written by either
    package, or a diffusers checkpoint) loads it; any other name (an HF Hub
    id: the port downloads nothing) warns and initialises ``architecture``
    from ``init_seed``, with the JAX Trainer's warning. ``kernel_impl``:
    ``auto``/``xla`` the plain GroupNorm, ``pallas`` the GroupNorm kernels,
    ``fused`` the fused resnet kernels where the JAX gate admits a block
    (bf16 compute, up to 32x32) and the plain GroupNorm elsewhere.
    ``attention_impl``: ``auto``, ``naive``, ``chunked`` or ``flash``,
    resolved per call as in the JAX model. ``remat``: ``none``, ``full`` or
    ``conv`` (``models/vae.py``, ``remat_mode``)."""
    impl = str(model_config.get("kernel_impl", "auto"))
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
    refuse_unported_axes(config.get("parallel", {}) or {})


def _wrap_data_parallel(model: AutoencoderKL, axis, parallel: Dict[str, Any]):
    """(the module the step runs forward through, the ZeRO layout or None)
    for this rank: FSDP2 under ``shard_params`` (kept whole, with a
    warning, under ``kernel_impl: fused``: its kernels take whole
    parameters, JAX ``loop.py:477-486``), DDP otherwise, each over the
    ranks of this rank's tensor index. A tensor axis always has a layout:
    the moments and the EMA follow the parameters' blocks."""
    shard_opt = bool(parallel.get("shard_optimizer", False))
    shard_ema = bool(parallel.get("shard_ema", False))
    shard_par = bool(parallel.get("shard_params", False))
    if shard_par and model.impl == "fused":
        logger.warning("parallel.shard_params is incompatible with model.kernel_impl=fused "
                       "across ranks; keeping the params replicated.")
        shard_par = False
    if shard_par:
        fully_shard_model(model, axis)
        forward_module = model
        logger.info("parallel.shard_params: parameters sharded over the %d-way data axis "
                    "(ZeRO-3, FSDP2)", axis.data_world)
    else:
        ids = [axis.device.index] if axis.device.type == "cuda" else None
        forward_module = torch.nn.parallel.DistributedDataParallel(
            model, device_ids=ids, process_group=axis.replica_group)
    layout = None
    if shard_opt or shard_ema or shard_par or axis.tensor > 1:
        layout = ZeroLayout(axis, model, shard_opt, shard_ema, fsdp=shard_par)
        if shard_opt:
            logger.info("parallel.shard_optimizer: optimizer state sharded over the %d-way "
                        "data axis (ZeRO-1)", axis.data_world)
        if shard_ema:
            logger.info("parallel.shard_ema: EMA sharded over the %d-way data axis",
                        axis.data_world)
    return forward_module, layout


def _step_seed(seed: int, micro_step: int) -> int:
    """The posterior-noise seed of one micro-step."""
    return int(np.random.SeedSequence([seed, micro_step]).generate_state(1)[0])


class Trainer:
    def __init__(self, config: Dict[str, Any], resume_from: Optional[str] = None,
                 device: Any = "cuda", axis=None):
        self.config = config
        self.resume_from = resume_from
        if axis is None and launched_by_torchrun():
            axis = initialize_distributed(device)
        # this process's parallel.DataAxis; None runs in one process
        self.axis = axis
        self.device = axis.device if axis is not None else resolve_device(device)
        self.is_main = axis is None or axis.is_main

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
        parallel = config.get("parallel", {}) or {}
        spatial = as_int(parallel.get("spatial"), 1)
        tensor = as_int(parallel.get("tensor"), 1)
        spatial_conv = spatial_conv_choice(parallel)
        self.axis = with_layout(self.axis, spatial, tensor)
        device = self.device
        axis, is_main = self.axis, self.is_main
        # the batch's shards: the data axis (each spatial group reads one)
        world = 1 if axis is None else axis.data_world
        rank = 0 if axis is None else axis.data_rank
        logger.info("Running experiment: %s on %s (rank %d of %d)", self.run_name, device,
                    0 if axis is None else axis.rank, 1 if axis is None else axis.world)
        if spatial > 1:
            logger.info("parallel.spatial: image rows over %d-way spatial groups, %d data "
                        "ranks; parallel.spatial_conv: %s (both values run the manual halo "
                        "exchange, ops/spatial_conv.py)", spatial, world, spatial_conv)
        if tensor > 1:
            logger.info("parallel.tensor: parameters' channels over %d-way tensor groups "
                        "(ops/tensor_parallel.py), %d data ranks", tensor, world)
        os.makedirs(self.output_dir, exist_ok=True)
        if is_main:
            with open(os.path.join(self.output_dir, "config.yaml"), "w") as f:
                yaml.dump(config, f, default_flow_style=False)

        seed = as_int(config.get("seed"), 0)
        reporter = build_reporter(
            self.logging_config.get("report_to", "tensorboard"), self.output_dir,
            self.logging_dir, config.get("project_name", "vae_project"), self.run_name,
            config=config, entity=self.logging_config.get("entity"),
            is_main_process=is_main,
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
        if model.impl == "fused" and (spatial > 1 or tensor > 1):
            # a sharded H axis would need the conv halo exchange, and a
            # sharded C axis the channel gathers, that the fused kernels do
            # not implement (JAX loop.py:238-258)
            logger.warning(
                "model.kernel_impl='fused' only supports pure data-parallel meshes, not "
                "%s — falling back to kernel_impl='auto'.", mesh_shape(axis))
            model.set_impl("auto")
        attn_impls = {m.attn_impl for m in model.modules() if hasattr(m, "attn_impl")}
        if tensor > 1 and "flash" in attn_impls:
            # the flash kernels take q, k and v of one width; JAX's shard_map
            # wrapper partitions data and spatial axes only (JAX loop.py:261-288)
            logger.warning(
                "model.attention_impl='flash' supports data/spatial meshes, not %s — "
                "falling back to attention_impl='auto'.", mesh_shape(axis))
            model.set_attn_impl("auto")
        if tensor > 1:
            model.shard_tensor_(TensorGroup.of(axis))
        self.model = model
        vae_config = model.config
        forward_module, layout = model, None
        if axis is not None:
            forward_module, layout = _wrap_data_parallel(model, axis, parallel)
        elif any(parallel.get(k) for k in ("shard_optimizer", "shard_ema", "shard_params")):
            logger.info("parallel.shard_*: one process, so every leaf stays whole")

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
        # data.batch_size is per rank; each rank reads its strided shard of
        # every epoch, all of the same length (JAX loop.py:309-326)
        train_loader = create_dataloader(train_dataset, batch_size=batch_size,
                                         num_workers=num_workers, shuffle=True, seed=seed,
                                         shard_index=rank, num_shards=world,
                                         drop_last=world > 1)
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
                    shard_index=rank, num_shards=world, drop_last=world > 1,
                )
            except Exception as e:  # noqa: BLE001 — parity: disable on failure
                logger.error("Failed to load validation data: %s. Disabling validation.", e)
                do_validation = False

        # ---------------- schedule / optimizer ---------------- #
        tc = self.training_config
        accum = max(1, as_int(tc.get("gradient_accumulation_steps"), 1))
        try:
            steps_per_epoch = max(1, math.ceil(len(train_dataset) / (batch_size * world)
                                               / accum))
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
            summed_grads=axis is not None,
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
        ll_config = config.get("logit_lens", {}) or {}
        logit_lens = None
        ll_interval = 0
        if ll_config.get("enabled", False) and is_main:
            logit_lens = VAELogitLens(logit_lens_config=ll_config,
                                      main_experiment_output_dir=self.output_dir, seed=seed,
                                      device=device)
            ll_interval = as_int(ll_config.get("visualization_interval"), 1000)

        tracer = TraceCapture(config.get("profiling", {}) if is_main else {},
                              self.output_dir, device)

        # ---------------- state and steps ---------------- #
        model.set_capture(monitor.scalar_capture_table)
        ema_decay = as_float(tc.get("ema_decay"), 0.0)
        state = TrainState.create(model, tx, stats_acc=monitor.init_acc(model),
                                  ema=ema_decay > 0.0, layout=layout)
        if self.resume_from:
            state = restore_train_state(self.resume_from, state)
            logger.info("Resumed from %s at step %d", self.resume_from, state.step)
        step_plain = make_train_step(model, tx, self.kl_weight,
                                     stats_accumulate=ActivityMonitor.accumulate,
                                     ema_decay=ema_decay, axis=axis,
                                     forward_module=forward_module)
        step_maps = None
        if monitor.enabled and monitor.map_keys:
            step_maps = make_train_step(model, tx, self.kl_weight,
                                        stats_accumulate=ActivityMonitor.accumulate,
                                        map_keys=monitor.map_keys, ema_decay=ema_decay,
                                        axis=axis, forward_module=forward_module)
        eval_step = make_eval_step(model, axis) if do_validation else None

        # ---------------- intervals ---------------- #
        # clamped to >=1: the non-finite loss check rides the logging interval
        log_interval = max(1, as_int(self.logging_config.get("log_interval"), 10))
        save_interval_steps = as_int(self.saving_config.get("save_interval_steps"), 500)
        checkpoint_prefix = self.saving_config.get("checkpoint_dir_prefix", "chkpt")
        keep_last_n = as_int(self.saving_config.get("keep_last_n"), 0)
        validation_epochs = as_int(tc.get("validation_epochs"), 0)
        validation_steps = as_int(tc.get("validation_steps"), 0)
        ckpt_saver = AsyncSaver() if self.saving_config.get("async_save", True) else None

        def _agreed(flag: bool) -> bool:
            """Whether any rank raised ``flag`` (a collective; every rank
            calls it at the same step)."""
            if axis is None:
                return flag
            t = torch.tensor([1.0 if flag else 0.0], device=device)
            torch.distributed.all_reduce(t)
            return bool(t.item() > 0)

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
                    images_seen += batch["n_valid"] * world
                    micro_step += 1
                    in_epoch_micro += 1
                    is_update = micro_step % accum == 0
                    next_global = global_step + 1 if is_update else global_step
                    want_maps = (step_maps is not None and is_update and track_interval > 0
                                 and next_global % track_interval == 0)
                    noise_gen.manual_seed(_step_seed(seed, micro_step))
                    pixels = {"pixel_values": batch["pixel_values"]}
                    tracer.maybe_start(next_global)
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
                    tracer.maybe_stop(next_global)
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
                        # a tensor rank's per-channel blocks, gathered whole
                        activity_metrics = monitor.step(
                            global_step, whole_taps(state.stats_acc, model),
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
                            # every rank classified the same reduced stats,
                            # so every rank nudges the same entries
                            handler.intervene(model, classification_output, global_step)
                            inactive_total = sum(len(v["inactive_channel_indices"])
                                                 for v in classification_output.values())
                            reporter.log({"inactive_channels": inactive_total,
                                          "nudged_scales": handler.num_nudges_applied},
                                         global_step)
                            if is_main:
                                with open(os.path.join(self.output_dir,
                                                       "intervention_history.csv"),
                                          "a") as fh:
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

                    # --- logit lens ---
                    if logit_lens is not None and ll_interval > 0 and (
                            global_step % ll_interval == 0):
                        current = monitor.get_data_for_step(global_step)
                        if current:
                            logit_lens.run_logit_lens_with_activations(
                                global_step=global_step,
                                activations_to_process=current,
                                # an empty layers_to_analyze_direct falls
                                # through to target_tracked_metrics (SURVEY.md
                                # §5a-6)
                                layers_to_analyze=(
                                    ll_config.get("layers_to_analyze_direct")
                                    or ll_config.get("target_tracked_metrics", [])),
                                num_batch_samples_to_viz=ll_config.get(
                                    "num_batch_samples_to_viz", 1),
                                projection_type=ll_config.get(
                                    "projection_type", "mini_decoder_single_channel"),
                            )
                        else:
                            logger.warning("LogitLens: No activation data for step %d.",
                                           global_step)

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
                                            meta=_resume_meta(), write=is_main)
                        else:
                            save_train_state(ckpt_path, state, meta=_resume_meta(),
                                             write=is_main)
                            if is_main:
                                _prune()

                    # --- preemption-safe exit ---
                    deterministic_stop = stop_after_steps > 0 and global_step >= stop_after_steps
                    stop_now = deterministic_stop or (axis is None and preempt_flag["hit"])
                    if not stop_now and axis is not None and global_step % log_interval == 0:
                        # a signal reaches the ranks at different steps: they
                        # agree at the logging interval, where the metrics
                        # already cost a host sync
                        stop_now = _agreed(preempt_flag["hit"])
                    if stop_now:
                        if ckpt_saver is not None:
                            ckpt_saver.wait()
                        save_train_state(
                            os.path.join(self.output_dir, f"{checkpoint_prefix}-{global_step}"),
                            state, meta=_resume_meta(), write=is_main)
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
            # a window still open at the end of training is written here,
            # where a trace without device events raises
            tracer.close()
        finally:
            if prev_sigterm is not None:
                signal.signal(signal.SIGTERM, prev_sigterm)
            if ckpt_saver is not None:
                ckpt_saver.wait(reraise=False)
            try:
                tracer.close()
            except Exception:  # noqa: BLE001 — teardown must not mask the loop's error
                logger.exception("Profiler trace close failed")
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
                                 final_meta=_resume_meta(), handler=handler)
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
        total = torch.stack(sums).sum(0) if sums else torch.zeros(3, device=self.device)
        if self.axis is not None:
            torch.distributed.all_reduce(total)
        rec_sum, kl_sum, n = total.cpu().tolist()
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
                  final_meta=None, handler=None) -> Dict[str, Any]:
        """The final artifacts: final_model/ (a resumable state),
        final_model/vae/ (the model dir both packages load), vae_ema/, the
        activation-stats CSV, the dead-weight history CSV, and the JAX
        Trainer's plots (``utils/plotting.py``: the dead-weight history and
        weight snapshots, the activity evolution, dead vs nudge), each
        skipped with a warning where matplotlib does not import."""
        import pandas as pd

        summary: Dict[str, Any] = {}
        final_dir = os.path.join(self.output_dir, "final_model")
        vae_dir = os.path.join(final_dir, "vae")
        summary["final_model_dir"] = final_dir
        # whole on every rank (the gather is a collective), written by rank 0
        whole = state_dict_of(state, copy=lambda t: t)
        if state.ema_params is not None:
            summary["ema_model_dir"] = os.path.join(final_dir, "vae_ema")
        if not self.is_main:
            reporter.finish()
            return summary
        os.makedirs(final_dir, exist_ok=True)
        write_state_dict(final_dir, whole, final_meta)
        model_io.save_model_dir(vae_dir, vae_config, whole["params"])
        logger.info("Final VAE saved to %s", vae_dir)
        if state.ema_params is not None:
            model_io.save_model_dir(summary["ema_model_dir"], vae_config, whole["ema_params"])
            logger.info("EMA VAE saved to %s", summary["ema_model_dir"])

        if (self.config.get("saving", {}) or {}).get("export_stablehlo", False):
            # deployment artifacts next to the model dir: torch.export
            # programs of encode/decode/reconstruct with a symbolic batch.
            # The EMA weights share the programs, since the weights are an
            # argument of them.
            from ..tools.export_model import export_model_dir

            export_dir = os.path.join(final_dir, "exported")
            export_model_dir(
                vae_dir, export_dir,
                resolution=as_int(self.data_config.get("resolution"), 256),
                dtype_name="bf16" if self.mixed_precision in ("bf16", "fp16") else "fp32",
                device=self.device,
            )
            logger.info("torch.export deployment artifacts in %s", export_dir)
            summary["export_dir"] = export_dir

        activity_csv = None
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
            # dead_neuron_percentage_history.csv, and its plot
            DeadNeuronPlotter(threshold=self.threshold_dn, output_dir=self.output_dir).plot_all(
                percent_history=dead_tracker.percent_history,
                weights_history=dead_tracker.weights_history)
        if activity_csv:
            ActivityPlotter(output_dir=os.path.join(self.output_dir, "activity_plots")
                            ).plot_activation_stats_evolution(
                csv_path=activity_csv,
                target_metric_substring="mean_abs_activation_per_channel",
                target_metric_type="per_channel_overall_mean")
        if handler is not None and handler.num_nudges_applied > 0:
            plot_dead_vs_nudge(
                csv_path=os.path.join(self.output_dir, "intervention_history.csv"),
                out_png=os.path.join(self.output_dir, "dead_vs_nudge.png"),
                nudge_factor=handler.nudge_factor)
        reporter.finish()
        return summary


__all__ = ["Trainer", "resolve_model"]
