"""YAML experiment-config loading with single-level ``defaults:`` inheritance.

The port's own copy of ``vae_channel_dynamics_tpu/utils/config_utils.py``
(the port imports nothing of the JAX package): the same loader, coercions
and key schema, so both packages read every ``configs/*.yaml`` alike.

Behavioral contract (reference: src/utils/config_utils.py:9-65): the config
file may contain a ``defaults: [<base_name>]`` list; the FIRST entry names a
base YAML (``<base_name>.yaml``) in the same directory. The base is loaded
first and the experiment config is merged on top with a SHALLOW top-level
``dict.update`` — nested dicts are REPLACED, not deep-merged. All ten
reference ``configs/*.yaml`` files must parse to the same effective config
under these semantics.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Dict, Set

import yaml

logger = logging.getLogger(__name__)


def _read_yaml_dict(path: Path) -> Dict[str, Any]:
    """Parse ``path`` as YAML; an empty document yields ``{}``."""
    with path.open("r") as fh:
        doc = yaml.safe_load(fh)
    if doc is None:
        logger.warning("Empty YAML document at %s; treating as {}", path)
        return {}
    return doc


def load_config(config_path: str) -> Dict[str, Any]:
    """Load a YAML config, resolving one level of ``defaults:`` inheritance.

    If the experiment YAML declares ``defaults: [<name>, ...]``, the first
    entry selects ``<name>.yaml`` next to the experiment file as the base
    layer; the experiment's top-level keys are then laid over it with a
    shallow merge (nested sections replace the base's wholesale — a
    load-bearing quirk, see SURVEY.md §5).

    Args:
        config_path: Path to the experiment YAML.

    Returns:
        The effective configuration dictionary.

    Raises:
        FileNotFoundError: if the config or its base does not exist.
        yaml.YAMLError: on YAML parse errors.
    """
    exp_path = Path(config_path)
    if not exp_path.exists():
        raise FileNotFoundError(f"Configuration file not found: {config_path}")

    overlay = _read_yaml_dict(exp_path)

    defaults = overlay.get("defaults")
    if not isinstance(defaults, list) or not defaults:
        logger.info("Loaded config %s (no defaults layer)", config_path)
        return overlay
    del overlay["defaults"]

    base_path = exp_path.parent / f"{defaults[0]}.yaml"
    logger.info("Resolving defaults layer %s for %s", base_path, config_path)
    if not base_path.exists():
        raise FileNotFoundError(
            f"Base configuration file not found: {base_path}"
        )
    merged = _read_yaml_dict(base_path)
    merged.update(overlay)
    logger.info("Loaded config %s over base %s", config_path, base_path.name)
    return merged


def as_float(value: Any, default: float) -> float:
    """Coerce a config value to float; YAMLs carry numbers as strings
    (e.g. ``learning_rate: "5e-5"`` in experiment_cifar10_test.yaml:22)."""
    if value is None:
        return default
    return float(value)


def as_int(value: Any, default: int) -> int:
    if value is None:
        return default
    return int(value)


# --------------------------------------------------------------------------- #
# Typo detection: the schema ignores unknown keys silently (reference
# behavior — configs carry extra keys like `notes:` freely), which also
# swallows typos like `trasfer_dtype`. warn_unknown_keys logs a warning per
# unrecognized key without changing any behavior.
# --------------------------------------------------------------------------- #
_KNOWN_KEYS: Set[str] = {
    # top level
    "project_name", "run_name", "output_dir", "seed", "threshold",
    "mean_percentage", "dead_type", "defaults", "notes", "description",
    "model", "data", "training", "logging", "saving",
    "dead_neuron_tracking", "tracking", "logit_lens", "classification",
    "intervention", "parallel", "profiling",
}

_KNOWN_SECTION_KEYS: Dict[str, set] = {
    "model": {
        "pretrained_vae_name", "architecture", "init_seed", "kernel_impl",
        "attention_impl", "remat",
    },
    "data": {
        "dataset_name", "dataset_config_name", "image_column", "resolution",
        "max_samples", "batch_size", "num_workers", "do_validation",
        "validation_split_name", "validation_dataset_name",
        "validation_dataset_config_name", "validation_max_samples",
        "validation_batch_size", "train_split_name", "transfer_dtype",
        "streaming", "cache_dir",
    },
    "training": {
        "num_train_epochs", "learning_rate", "adam_beta1", "adam_beta2",
        "adam_weight_decay", "adam_epsilon", "lr_scheduler_type",
        "lr_warmup_steps", "gradient_accumulation_steps", "mixed_precision",
        "max_grad_norm", "kl_weight", "validation_epochs",
        "validation_steps", "max_steps_per_epoch_iterable",
        "abort_on_nonfinite", "ema_decay", "stop_after_steps", "optimizer",
    },
    "logging": {"log_interval", "report_to", "entity"},
    "saving": {
        "save_interval_steps", "save_interval", "checkpoint_dir_prefix",
        "keep_last_n", "async_save", "export_stablehlo",
    },
    "dead_neuron_tracking": {
        "enabled", "track_interval", "target_layer_names_for_raw_weights",
        # present in shipped reference configs but read from the TOP level
        # (quirk SURVEY.md §5a-2) — known, not a typo
        "threshold", "mean_percentage", "dead_type",
    },
    "tracking": {
        "enabled", "track_interval", "target_layers", "max_map_history",
    },
    "logit_lens": {
        "enabled", "visualization_interval", "visualization_output_subdir",
        "target_tracked_metrics", "layers_to_analyze_direct",
        "num_channels_to_viz", "num_batch_samples_to_viz", "colormap",
        "run_mini_decoder_projection", "projection_type",
        "default_num_batch_samples_to_viz",
    },
    "classification": {
        "enabled", "method", "threshold", "target_metric_key",
        "layers_to_classify",
    },
    "intervention": {
        "enabled", "strategy", "nudge_factor", "nudge_value_add",
        "max_scale_value", "intervention_interval",
    },
    "parallel": {
        "spatial", "slices", "shard_optimizer", "shard_ema", "shard_params",
        "tensor", "spatial_conv",
    },
    "profiling": {"enabled", "start_step", "num_steps", "output_subdir"},
}


def warn_unknown_keys(config: Dict[str, Any]) -> list:
    """Log a warning for every unrecognized config key (one level deep into
    the known sections). Returns the list of warned dotted keys. Behavior is
    never changed — unknown keys keep flowing through untouched."""
    unknown = []
    for key in config:
        if key not in _KNOWN_KEYS:
            unknown.append(key)
        section_schema = _KNOWN_SECTION_KEYS.get(key)
        if section_schema and isinstance(config[key], dict):
            for sub in config[key]:
                if sub not in section_schema:
                    unknown.append(f"{key}.{sub}")
    for key in unknown:
        logger.warning(
            "Unrecognized config key '%s' — ignored (typo?)", key
        )
    return unknown
