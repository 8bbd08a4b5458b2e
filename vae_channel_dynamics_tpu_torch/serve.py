"""Batch inference CLI on PyTorch: ``python -m vae_channel_dynamics_tpu_torch.serve
--checkpoint_path <dir> --input <images-or-dataset> --output <dir> [--device cuda]``.

Counterpart of ``vae_channel_dynamics_tpu/serve.py`` over the port's
wrapper, with the same modes:

- ``reconstruct``  images -> encode -> decode -> PNGs (+ ``serve_metrics.json``
  with the average MSE)
- ``encode``       images -> scaled latents (saved as .npy)
- ``decode``       latents (.npy) -> PNGs

Images come through the JAX package's numpy-only data pipeline
(``vae_channel_dynamics_tpu.data``), which imports no jax. Not ported yet:
``--tile_size``, ``--tile_overlap`` and ``--slicing`` (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

import numpy as np
import torch

logger = logging.getLogger(__name__)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Batch VAE inference (PyTorch).")
    p.add_argument("--checkpoint_path", required=True,
                   help="Dir containing the 'vae' subdirectory (or a model dir).")
    p.add_argument("--input", required=True,
                   help="Image directory, synthetic:// name, or .npy latents.")
    p.add_argument("--output", required=True)
    p.add_argument("--mode", default="reconstruct",
                   choices=["reconstruct", "encode", "decode"])
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_samples", type=int, default=None)
    p.add_argument("--deterministic", default=True,
                   type=lambda x: str(x).lower() == "true",
                   help="Use the posterior mode instead of sampling at encode.")
    p.add_argument("--attention_impl", default="auto",
                   choices=["auto", "naive", "chunked", "flash"],
                   help="Mid-block attention: auto takes the flash kernel "
                        "from 4096 tokens (512px) up when it fits the shape, "
                        "naive below; chunked is online softmax over key "
                        "chunks in plain PyTorch.")
    p.add_argument("--device", default="cuda",
                   help="Torch device; 'cuda' fails when no GPU is visible "
                        "(pass 'cpu' to run on the CPU).")
    return p.parse_args(argv)


def _save_png(arr_hwc: np.ndarray, path: str) -> None:
    from PIL import Image

    img = np.clip((arr_hwc + 1.0) / 2.0, 0.0, 1.0)
    Image.fromarray((img * 255).astype(np.uint8)).save(path)


def main(argv=None) -> int:
    from .data import create_dataloader, load_and_preprocess_dataset
    from .models import SDXLVAEWrapper
    from .models import io as model_io
    from .server import resolve_serving_attention_impl

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    args = parse_args(argv)
    os.makedirs(args.output, exist_ok=True)

    vae_dir = os.path.join(args.checkpoint_path, "vae")
    if not os.path.isdir(vae_dir):
        vae_dir = args.checkpoint_path
    config, state_dict = model_io.load_model_dir(vae_dir)

    # decode mode: the mid-block token count comes from the LATENT geometry,
    # not --resolution (which describes the encode-side resize)
    effective_resolution = args.resolution
    decode_latents = None
    if args.mode == "decode":
        decode_latents = np.load(args.input)
        if decode_latents.ndim == 3:
            decode_latents = decode_latents[None]
        factor = 2 ** (len(config.block_out_channels) - 1)
        effective_resolution = int(decode_latents.shape[1]) * factor
    attn_impl = resolve_serving_attention_impl(
        args.attention_impl, effective_resolution, config, logger=logger,
    )
    wrapper = SDXLVAEWrapper(
        config=config, state_dict=state_dict, dtype=torch.bfloat16,
        attn_impl=attn_impl, device=args.device,
    )

    t0 = time.perf_counter()
    n_processed = 0

    if args.mode == "decode":
        latents = decode_latents
        for start in range(0, latents.shape[0], args.batch_size):
            chunk = torch.from_numpy(
                np.ascontiguousarray(latents[start:start + args.batch_size],
                                     dtype=np.float32))
            imgs = wrapper.decode(chunk).float().cpu().numpy()
            for i, img in enumerate(imgs):
                _save_png(img, os.path.join(args.output, f"decoded_{start+i}.png"))
            n_processed += imgs.shape[0]
    else:
        dataset = load_and_preprocess_dataset(
            args.input, resolution=args.resolution, max_samples=args.max_samples
        )
        loader = create_dataloader(
            dataset, batch_size=args.batch_size, shuffle=False
        )
        mse_sum = 0.0
        for bi, batch in enumerate(loader):
            if batch is None:
                continue
            # fresh seed per batch when sampling — the wrapper's
            # generator=None fallback is a FIXED seed, which would draw the
            # identical noise for every batch
            generator = (
                None if args.deterministic
                else torch.Generator(device=wrapper.device).manual_seed(bi)
            )
            px = np.asarray(batch["pixel_values"], dtype=np.float32)
            pixels = torch.from_numpy(px)
            if args.mode == "encode":
                z = wrapper.encode(
                    pixels, deterministic=args.deterministic,
                    generator=generator,
                ).float().cpu().numpy()
                np.save(os.path.join(args.output, f"latents_{bi:05d}.npy"), z)
                n_processed += z.shape[0]
            else:  # reconstruct
                recon = wrapper.forward(
                    pixels, sample_posterior=not args.deterministic,
                    generator=generator,
                )["reconstruction"].float().cpu().numpy()
                mse_sum += float(np.mean((recon - px) ** 2)) * recon.shape[0]
                for i in range(recon.shape[0]):
                    _save_png(
                        recon[i],
                        os.path.join(args.output, f"recon_{n_processed + i}.png"),
                    )
                n_processed += recon.shape[0]
        if args.mode == "reconstruct" and n_processed:
            avg_mse = mse_sum / n_processed
            with open(os.path.join(args.output, "serve_metrics.json"), "w") as f:
                json.dump({"avg_mse": avg_mse, "num_images": n_processed}, f)
            logger.info("Average reconstruction MSE: %.6f", avg_mse)

    elapsed = time.perf_counter() - t0
    logger.info(
        "Processed %d items in %.1fs (%.1f items/s incl. IO)",
        n_processed, elapsed, n_processed / max(elapsed, 1e-9),
    )
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # noqa: BLE001
        logging.getLogger(__name__).error("Serving failed", exc_info=True)
        sys.exit(1)
