"""Evaluation CLI of the PyTorch port:

    python -m vae_channel_dynamics_tpu_torch.evaluate --config_path <yaml> \\
        --checkpoint_path <dir> [--eval_split test ...] [--device cuda|cpu]

Counterpart of ``python -m vae_channel_dynamics_tpu.evaluate``, with the
same flags (plus ``--device``, default ``cuda``, which raises without a GPU)
and the same artifacts: load ``<checkpoint_path>/vae`` (or a bare model dir,
or a diffusers AutoencoderKL dir), reconstruct deterministically (the
posterior mode), accumulate the dataset-average MSE (per-element mean,
sample-weighted) and KL, PSNR from the global squared error over
[0, 1]-clamped images and the per-image SSIM mean (gaussian k=11,
sigma=1.5), save the first ``--num_samples_to_save`` original and
reconstruction PNG pairs, run the logit lens on the first surviving batch's
captured activations, and write ``eval_metrics.txt`` and
``eval_metrics.json``.

The compute dtype comes from ``training.mixed_precision`` (bf16 for ``bf16``
and ``fp16``, else fp32). Evaluation is forward-only, so ``attention_impl:
auto`` resolves through the serving policy at ``data.resolution``: the flash
forward from 4096 mid-block tokens (512px), bf16 or fp32 by the dtype.
``model.kernel_impl`` picks the GroupNorm as the Trainer's does (``auto``
and ``xla`` plain, ``pallas`` the kernels, ``fused`` the fused resnets the
gate admits); the JAX CLI reads no ``kernel_impl`` and runs ``auto``. The
per-batch sums stay on the device and are copied to the host once a batch.
On a card, TF32 is off while it runs, so fp32 means fp32.

Across ranks (launched by torchrun, ``parallel/``; ``--device cpu`` runs
gloo) every rank reads each global batch of ``batch_size`` x world
images, pads it to a multiple of the world size (``pad_batch_to_multiple``)
and evaluates its contiguous block, as the JAX CLI shards its batch over
its mesh; the masked sums are added over the ranks, and rank 0 gathers the
reconstructions it saves, runs the lens on the first global batch and
writes the same files as one process at that batch size.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

import numpy as np

logger = logging.getLogger(__name__)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Evaluate a trained SDXL VAE (PyTorch/CUDA).")
    parser.add_argument("--config_path", type=str, required=True)
    parser.add_argument(
        "--checkpoint_path", type=str, required=True,
        help="Checkpoint dir containing the 'vae' subdirectory.",
    )
    parser.add_argument("--eval_split", type=str, default="test")
    parser.add_argument("--output_dir", type=str, default=None)
    parser.add_argument("--num_samples_to_save", type=int, default=16)
    parser.add_argument("--max_eval_samples", type=int, default=None,
                        help="Cap the evaluated samples (overrides the "
                             "config's validation_max_samples).")
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument(
        "--enable_logit_lens", default=True,
        type=lambda x: str(x).lower() == "true",
    )
    parser.add_argument(
        "--logit_lens_layers", type=str, nargs="+",
        default=[
            "encoder.down_blocks.0.resnets.0.norm1",
            "encoder.down_blocks.1.resnets.0.conv_shortcut",
        ],
    )
    parser.add_argument("--logit_lens_num_samples", type=int, default=1)
    parser.add_argument(
        "--logit_lens_projection_type", type=str,
        default="mini_decoder_single_channel",
        choices=["mini_decoder_single_channel", "mini_decoder_full_map"],
    )
    parser.add_argument(
        "--logit_lens_mini_decoder_input_channels", type=int, default=None
    )
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to evaluate on (default: cuda; pass 'cpu' "
                             "to run on the CPU).")
    return parser.parse_args(argv)


def _host_float_pixels(x: np.ndarray) -> np.ndarray:
    """uint8 batches (``data.transfer_dtype: uint8``) to [-1, 1] floats."""
    if x.dtype == np.uint8:
        return x.astype(np.float32) / 127.5 - 1.0
    return x


def _to_png(arr_hwc_minus1_1: np.ndarray, path: str) -> None:
    from PIL import Image

    img = np.clip((_host_float_pixels(arr_hwc_minus1_1) + 1.0) / 2.0, 0.0, 1.0)
    Image.fromarray((img * 255).astype(np.uint8)).save(path)


def _activation_grid_png(act_chw: np.ndarray, path: str, nrow: int = 8) -> None:
    """Per-channel maps tiled into one grid image, min-max normalised over
    the whole map (the reference's make_grid(normalize=True))."""
    from PIL import Image

    c, h, w = act_chw.shape
    cols = min(nrow, c)
    rows = (c + cols - 1) // cols
    pad = 2
    grid = np.zeros((rows * (h + pad) + pad, cols * (w + pad) + pad), np.float32)
    lo, hi = float(act_chw.min()), float(act_chw.max())
    norm = (act_chw - lo) / (hi - lo) if hi - lo > 1e-6 else np.zeros_like(act_chw)
    for idx in range(c):
        r, col = divmod(idx, cols)
        y0 = pad + r * (h + pad)
        x0 = pad + col * (w + pad)
        grid[y0:y0 + h, x0:x0 + w] = norm[idx]
    Image.fromarray((grid * 255).astype(np.uint8)).save(path)


def main(argv=None) -> int:
    """CLI entry point; TF32 is off on the card while it runs, and restored
    after, so an in-process caller keeps its own setting."""
    import torch

    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _eval_main(argv)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _eval_main(argv=None) -> int:
    import torch

    from .analysis import VAELogitLens
    from .data import create_dataloader, load_and_preprocess_dataset
    from .models import SDXLVAEWrapper
    from .models import io as model_io
    from .ops.attention import resolve_serving_impl
    from .ops.image_metrics import psnr_from_accumulated, ssim_per_image
    from .parallel.mesh import (
        all_gather_rows,
        initialize_distributed,
        local_block,
        pad_batch_to_multiple,
        shutdown,
    )
    from .training.step import dequantize_pixels
    from .utils.config_utils import as_int, load_config, warn_unknown_keys
    from .utils.logging_utils import setup_logging

    args = parse_args(argv)
    axis = initialize_distributed(args.device)
    world, rank = (1, 0) if axis is None else (axis.world, axis.rank)
    is_main = rank == 0
    setup_logging(rank=rank)
    config = load_config(args.config_path)
    warn_unknown_keys(config)

    if args.output_dir is None:
        args.output_dir = os.path.join(args.checkpoint_path, f"eval_results_{args.eval_split}")
    os.makedirs(args.output_dir, exist_ok=True)
    logger.info("Evaluation results will be saved to: %s", args.output_dir)

    model_load_path = os.path.join(args.checkpoint_path, "vae")
    if not os.path.isdir(model_load_path):
        # a bare model dir (e.g. final_model/vae_ema) works directly
        if os.path.exists(os.path.join(args.checkpoint_path, "config.json")):
            model_load_path = args.checkpoint_path
        else:
            logger.error("VAE model directory not found at: %s", model_load_path)
            return 1
    vae_config, state_dict = model_io.load_model_dir(model_load_path)

    mixed_precision = config.get("training", {}).get("mixed_precision", "no")
    dtype = torch.bfloat16 if mixed_precision in ("bf16", "fp16") else torch.float32
    # forward-only: 'auto' resolves through the serving policy, at the one
    # resolution the dataset below is resized to
    resolution = as_int(config.get("data", {}).get("resolution"), 256)
    ds_factor = 2 ** (len(vae_config.block_out_channels) - 1)
    configured_impl = str(config.get("model", {}).get("attention_impl", "auto"))
    attn_impl = resolve_serving_impl(configured_impl, (resolution // ds_factor) ** 2,
                                     vae_config.block_out_channels[-1])
    if attn_impl == "flash" and configured_impl == "auto":
        logger.info("attention_impl=auto: evaluation is forward-only, using the flash "
                    "kernel (%s).", "bf16" if dtype == torch.bfloat16 else "fp32")
    kernel_impl = str(config.get("model", {}).get("kernel_impl", "auto"))
    wrapper = SDXLVAEWrapper(config=vae_config, state_dict=state_dict, dtype=dtype,
                             attn_impl=attn_impl,
                             device=args.device if axis is None else axis.device,
                             impl=kernel_impl)
    device = wrapper.device

    logit_lens = None
    if args.enable_logit_lens and is_main:
        ll_main = config.get("logit_lens", {})
        logit_lens = VAELogitLens(
            logit_lens_config={
                "visualization_output_subdir": ll_main.get(
                    "visualization_output_subdir", "logit_lens_visualizations_eval"),
                "default_num_channels_to_viz": ll_main.get("num_channels_to_viz", 4),
                "default_num_batch_samples_to_viz": args.logit_lens_num_samples,
                "colormap": ll_main.get("colormap", "viridis"),
            },
            main_experiment_output_dir=args.output_dir,
            seed=as_int(config.get("seed"), 0),
            device=device,
        )

    # ---------------- dataset (split-dependent source) ---------------- #
    dc = config.get("data", {})
    if args.eval_split == dc.get("validation_split_name", "validation"):
        dataset_name = dc.get("validation_dataset_name", dc.get("dataset_name"))
        dataset_config_name = dc.get("validation_dataset_config_name",
                                     dc.get("dataset_config_name"))
        max_samples = dc.get("validation_max_samples")
    else:
        dataset_name = dc.get("dataset_name")
        dataset_config_name = dc.get("dataset_config_name")
        max_samples = None
    if args.max_eval_samples is not None:
        max_samples = args.max_eval_samples
    eval_dataset = load_and_preprocess_dataset(
        dataset_name=dataset_name,
        dataset_config_name=dataset_config_name,
        image_column=dc.get("image_column", "image"),
        resolution=resolution,
        max_samples=max_samples,
        split=args.eval_split,
        seed=as_int(config.get("seed"), 0),
        transfer_dtype=dc.get("transfer_dtype", "float32"),
    )
    batch_size = (args.batch_size if args.batch_size is not None
                  else as_int(dc.get("validation_batch_size"), as_int(dc.get("batch_size"), 4)))
    # every rank reads the global batch and evaluates its block of it
    loader = create_dataloader(eval_dataset, batch_size=batch_size * world,
                               num_workers=as_int(dc.get("num_workers"), 0), shuffle=False)

    @torch.inference_mode()
    def eval_batch(pixels_in: torch.Tensor, mask: torch.Tensor):
        """The reconstruction and the batch's masked sums, on the device:
        [sum of per-sample MSE, sum KL, PSNR SSE, PSNR observations, sum
        SSIM, samples]."""
        out = wrapper.forward(pixels_in, sample_posterior=False)
        recon = out["reconstruction"].float()
        pixels = pixels_in.float()
        per_sample_sq = (recon - pixels).square().mean(dim=(1, 2, 3))
        kl = out["latent_dist"].kl().float()
        recon01 = torch.clamp((recon + 1.0) / 2.0, 0.0, 1.0)
        pixels01 = torch.clamp((pixels + 1.0) / 2.0, 0.0, 1.0)
        ssim_b = ssim_per_image(recon01, pixels01, data_range=1.0)
        n = mask.sum()
        sums = torch.stack([
            (per_sample_sq * mask).sum(), (kl * mask).sum(),
            ((recon01 - pixels01).square() * mask[:, None, None, None]).sum(),
            n * float(recon[0].numel()), (ssim_b * mask).sum(), n,
        ])
        return out["reconstruction"], sums

    total_mse = total_kl = 0.0
    psnr_sse = psnr_obs = 0.0
    ssim_sum = 0.0
    num_eval_samples = 0
    samples_saved = 0

    logger.info("Starting evaluation on '%s' split...", args.eval_split)
    ran_logit_lens = False
    for batch in loader:
        if batch is None:
            continue
        pixels_host = batch["pixel_values"]
        if world > 1:
            padded, mask_host = pad_batch_to_multiple({"x": pixels_host}, world)
            block = local_block(padded["x"], rank, world)
            mask_host = local_block(mask_host, rank, world)
        else:
            block, mask_host = pixels_host, np.ones(pixels_host.shape[0], np.float32)
        recon, sums = eval_batch(dequantize_pixels(torch.from_numpy(block).to(device)),
                                 torch.from_numpy(mask_host).to(device))
        if axis is not None:
            torch.distributed.all_reduce(sums)
        mse_b, kl_b, sse_b, obs_b, ssim_b, n_b = sums.cpu().tolist()
        total_mse += mse_b
        total_kl += kl_b
        psnr_sse += sse_b
        psnr_obs += obs_b
        ssim_sum += ssim_b
        num_eval_samples += int(n_b)

        if samples_saved < args.num_samples_to_save:
            take = min(args.num_samples_to_save - samples_saved, int(n_b))
            if axis is not None:
                # the ranks' blocks, in the global batch's order
                recon = all_gather_rows(recon.contiguous(), world).flatten(0, 1)
            recon_host = recon[:take].float().cpu().numpy()
            for i in range(take):
                if is_main:
                    _to_png(pixels_host[i], os.path.join(
                        args.output_dir, f"sample_{samples_saved}_orig.png"))
                    _to_png(recon_host[i], os.path.join(
                        args.output_dir, f"sample_{samples_saved}_recon.png"))
                samples_saved += 1
        del recon

        # the first SURVIVING batch (batches that collate to None are skipped)
        if not ran_logit_lens and logit_lens is not None:
            ran_logit_lens = True
            logger.info("Running LogitLens on first batch activations...")
            wrapper.add_hooks(args.logit_lens_layers)
            wrapper.forward(dequantize_pixels(torch.from_numpy(pixels_host).to(device)),
                            sample_posterior=False)
            activations = wrapper.get_captured_activations()
            # the reference's quirk, kept (SURVEY.md §5a-14): out_{i}.png,
            # at most 10, written per layer and OVERWRITTEN by the next, so
            # only the last layer's grids survive; the earlier layers' are
            # not drawn, as they would be overwritten unread
            if activations:
                act = activations[list(activations)[-1]]
                for i in range(min(act.shape[0], 10)):
                    _activation_grid_png(act[i], os.path.join(args.output_dir, f"out_{i}.png"))
            logit_lens.run_logit_lens_with_activations(
                global_step=0,
                layers_to_analyze=args.logit_lens_layers,
                num_batch_samples_to_viz=args.logit_lens_num_samples,
                projection_type=args.logit_lens_projection_type,
                activations_to_process=activations,
            )
            wrapper.remove_hooks()
            del activations

    avg_mse = total_mse / num_eval_samples if num_eval_samples else 0.0
    avg_kl = total_kl / num_eval_samples if num_eval_samples else 0.0
    final_psnr = (float(psnr_from_accumulated(psnr_sse, psnr_obs, data_range=1.0))
                  if psnr_obs else float("nan"))
    final_ssim = ssim_sum / num_eval_samples if num_eval_samples else float("nan")

    logger.info("***** Evaluation Results *****")
    logger.info("  Dataset split: %s", args.eval_split)
    logger.info("  Number of samples processed: %d", num_eval_samples)
    logger.info("  Average MSE Loss: %.6f", avg_mse)
    logger.info("  Average KL Divergence: %.6f", avg_kl)
    logger.info("  Average PSNR: %.4f dB", final_psnr)
    logger.info("  Average SSIM: %.4f", final_ssim)
    logger.info("  Saved %d image samples to %s", samples_saved, args.output_dir)

    if not is_main:
        shutdown(axis)
        return 0
    metrics_path = os.path.join(args.output_dir, "eval_metrics.txt")
    with open(metrics_path, "w") as f:
        f.write(f"Evaluation Split: {args.eval_split}\n")
        f.write(f"Checkpoint Path: {args.checkpoint_path}\n")
        f.write(f"Number of Samples Processed: {num_eval_samples}\n")
        f.write(f"Average MSE: {avg_mse}\n")
        f.write(f"Average KL: {avg_kl}\n")
        f.write(f"Average PSNR: {final_psnr}\n")
        f.write(f"Average SSIM: {final_ssim}\n")
    logger.info("Evaluation metrics saved to %s", metrics_path)
    with open(os.path.join(args.output_dir, "eval_metrics.json"), "w") as f:
        json.dump(
            {
                "eval_split": args.eval_split,
                "checkpoint_path": args.checkpoint_path,
                "num_samples": int(num_eval_samples),
                "mse": float(avg_mse),
                "kl": float(avg_kl),
                "psnr": float(final_psnr),
                "ssim": float(final_ssim),
            },
            f,
            indent=2,
        )
    shutdown(axis)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # noqa: BLE001 — the CLI's boundary: log and fail
        logging.getLogger(__name__).error("Unhandled exception during evaluation",
                                          exc_info=True)
        sys.exit(1)
