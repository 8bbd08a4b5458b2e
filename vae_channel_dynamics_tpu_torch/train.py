"""Training CLI of the PyTorch port:

    python -m vae_channel_dynamics_tpu_torch.train --config_path <yaml> \\
        [--resume_from DIR|auto] [--device cuda|cuda:N|cpu]

The counterpart of ``python -m vae_channel_dynamics_tpu.train``: the same
configs, the same run directory, ``--resume_from`` a checkpoint dir
(``chkpt-N`` or ``final_model``) or ``auto`` (the newest ``chkpt-N`` of the
run). It trains on one GPU, ``cuda`` unless ``--device`` says otherwise; a
CUDA device raises when there is no GPU, and nothing falls back to the CPU.

On several GPUs, one process per card through torchrun::

    python -m torch.distributed.run --nproc_per_node N \
        -m vae_channel_dynamics_tpu_torch.train --config_path <yaml>

each rank on ``cuda:LOCAL_RANK`` over NCCL (``--device cpu``: gloo on the
CPU), ``data.batch_size`` images a rank (``parallel/``).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Fine-tune the SDXL VAE with channel-dynamics analysis (PyTorch/CUDA)."
    )
    parser.add_argument("--config_path", type=str, required=True,
                        help="Path to the experiment YAML configuration.")
    parser.add_argument("--resume_from", type=str, default=None,
                        help="Checkpoint directory (chkpt-N or final_model) to resume "
                             "from, or 'auto' for the run's newest chkpt-N.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (default: cuda; pass 'cpu' to "
                             "run on the CPU).")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    from .parallel.mesh import initialize_distributed, shutdown
    from .training.checkpoint import latest_checkpoint
    from .training.loop import Trainer
    from .utils.config_utils import load_config, warn_unknown_keys
    from .utils.logging_utils import setup_logging

    args = parse_args(argv)
    axis = initialize_distributed(args.device)
    setup_logging(rank=0 if axis is None else axis.rank)
    log = logging.getLogger(__name__)
    config = load_config(args.config_path)
    warn_unknown_keys(config)
    resume_from = args.resume_from
    if resume_from == "auto":
        run_dir = os.path.join(config.get("output_dir", "./results"),
                               config.get("run_name", "vae_run"))
        resume_from = latest_checkpoint(
            run_dir, config.get("saving", {}).get("checkpoint_dir_prefix", "chkpt"))
        if resume_from:
            log.info("Auto-resume from %s", resume_from)
        else:
            log.info("Auto-resume: no checkpoint found; starting fresh.")
    summary = Trainer(config, resume_from=resume_from, device=args.device, axis=axis).train()
    log.info("Run summary: %s", summary)
    shutdown(axis)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # noqa: BLE001 — the CLI's boundary: log and fail
        logging.getLogger(__name__).error("Unhandled exception in main", exc_info=True)
        sys.exit(1)
