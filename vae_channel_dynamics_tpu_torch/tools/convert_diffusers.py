"""Validate and normalise a local diffusers AutoencoderKL directory as the
port's model directory, and back. The port of
``vae_channel_dynamics_tpu/tools/convert_diffusers.py``, for local
directories only (nothing is downloaded).

Usage:
    python -m vae_channel_dynamics_tpu_torch.tools.convert_diffusers \\
        --src /path/to/sdxl-vae --dst ./sdxl_vae [--reverse]

The port's model directory is already diffusers-shaped (``models/io.py``):
``config.json`` in the ``AutoencoderKL`` constructor schema plus
``diffusion_pytorch_model.safetensors`` with torch names and layouts. So
the forward direction loads the diffusers directory (its weights under
either file name), checks that they load ``strict=True`` into the
architecture its config describes, and writes the normalised directory
(the full constructor config and the canonical weight file), which
``model.pretrained_vae_name``, the evaluation CLI and the server load.
A model directory written by either package (including older ones with a
``model.safetensors``) goes through the same operation to come out as a
canonical diffusers directory. ``--reverse``, the JAX tool's flag for that
direction, is accepted and changes nothing.
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import Dict, Tuple

import torch

from ..models import io as model_io
from ..models.vae import AutoencoderKL, VAEConfig

logger = logging.getLogger(__name__)


def _load_checked(src: str) -> Tuple[VAEConfig, Dict[str, torch.Tensor]]:
    """The config and weights of ``src``, after a strict load into the
    architecture the config names (a missing, extra or misshapen tensor
    raises)."""
    config, state_dict = model_io.load_model_dir(src)
    model = AutoencoderKL(config, device="meta")
    model.load_state_dict(state_dict, strict=True, assign=True)
    logger.info("Loaded %d tensors from %s", len(state_dict), src)
    return config, state_dict


def convert(src: str, dst: str) -> None:
    """A diffusers AutoencoderKL dir, or a model dir of either package, ->
    the canonical directory both read. The two formats coincide, so the
    import and ``--reverse`` are this one operation."""
    config, state_dict = _load_checked(src)
    model_io.save_model_dir(dst, config, state_dict)
    logger.info("Model dir written to %s", dst)


def main(argv=None) -> int:
    from ..utils.logging_utils import setup_logging

    setup_logging()
    parser = argparse.ArgumentParser(
        description="Convert between diffusers AutoencoderKL dirs and the port's model "
        "dirs (which are diffusers-compatible).")
    parser.add_argument("--src", required=True, help="source model dir")
    parser.add_argument("--dst", required=True, help="output model dir")
    parser.add_argument("--reverse", action="store_true",
                        help="a no-op, kept so that the JAX tool's command lines run: "
                        "the two formats coincide, so both directions are one operation")
    args = parser.parse_args(argv)
    convert(args.src, args.dst)
    return 0


if __name__ == "__main__":
    sys.exit(main())
