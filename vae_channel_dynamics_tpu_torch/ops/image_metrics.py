"""Image quality metrics (PSNR, SSIM) in PyTorch.

Counterpart of ``vae_channel_dynamics_tpu/ops/image_metrics.py``, with its
conventions (the reference's torchmetrics ones, src/evaluate.py:176-189):

- PSNR from the GLOBAL accumulated squared error over every observation of
  the run: ``10 * log10(data_range^2 / mse_total)``;
- SSIM after Wang et al. 2004 with an 11x11 gaussian window (sigma 1.5),
  K1 = 0.01, K2 = 0.03, per channel on the valid (unpadded) region and
  averaged per image; the run's value is the sample-weighted mean of the
  per-image values.

Inputs are NHWC in [0, data_range], as in the JAX package. The filter is a
separable depthwise valid-mode gaussian: two ``F.conv2d`` calls with
``groups=C`` in fp32, the plain library path, as the JAX package leaves it to
XLA's conv. On a CUDA tensor those fp32 convs need cuDNN's TF32 off to keep
fp32 accuracy; the evaluation CLI turns it off.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_kernel_1d(kernel_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    half = (kernel_size - 1) / 2.0
    coords = np.arange(kernel_size, dtype=np.float64) - half
    g = np.exp(-(coords**2) / (2.0 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _filter2d_separable(x: torch.Tensor, k1d: torch.Tensor) -> torch.Tensor:
    """Valid-mode gaussian over H and W of an NCHW fp32 tensor, each channel
    alone: a (size, 1) then a (1, size) depthwise conv."""
    c = x.shape[1]
    size = k1d.shape[0]
    kh = k1d.reshape(1, 1, size, 1).expand(c, 1, size, 1)
    kw = k1d.reshape(1, 1, 1, size).expand(c, 1, 1, size)
    return F.conv2d(F.conv2d(x, kh, groups=c), kw, groups=c)


def ssim_per_image(
    pred: torch.Tensor,
    target: torch.Tensor,
    data_range: float = 1.0,
    kernel_size: int = 11,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Per-image SSIM over NHWC tensors in [0, data_range]. Returns (B,)."""
    pred = pred.float().permute(0, 3, 1, 2)
    target = target.float().permute(0, 3, 1, 2)
    kernel = torch.from_numpy(gaussian_kernel_1d(kernel_size, sigma)).to(pred.device)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    mu_p = _filter2d_separable(pred, kernel)
    mu_t = _filter2d_separable(target, kernel)
    mu_pp = _filter2d_separable(pred * pred, kernel)
    mu_tt = _filter2d_separable(target * target, kernel)
    mu_pt = _filter2d_separable(pred * target, kernel)

    sigma_p = mu_pp - mu_p * mu_p
    sigma_t = mu_tt - mu_t * mu_t
    sigma_pt = mu_pt - mu_p * mu_t

    num = (2.0 * mu_p * mu_t + c1) * (2.0 * sigma_pt + c2)
    den = (mu_p * mu_p + mu_t * mu_t + c1) * (sigma_p + sigma_t + c2)
    return (num / den).mean(dim=(1, 2, 3))


def ssim(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    return ssim_per_image(pred, target, data_range).mean()


def psnr_from_accumulated(sum_squared_error, num_observations,
                          data_range: float = 1.0) -> torch.Tensor:
    """Run-level PSNR from the accumulated SSE and element count
    (torchmetrics ``PeakSignalNoiseRatio`` accumulation)."""
    sse = torch.as_tensor(sum_squared_error, dtype=torch.float32)
    obs = torch.as_tensor(num_observations, dtype=torch.float32)
    mse = sse / torch.clamp(obs, min=1.0)
    return 10.0 * torch.log10((data_range**2) / mse)


def psnr(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    sse = torch.sum(torch.square(pred.float() - target.float()))
    return psnr_from_accumulated(sse, float(pred.numel()), data_range)


__all__ = [
    "gaussian_kernel_1d",
    "psnr",
    "psnr_from_accumulated",
    "ssim",
    "ssim_per_image",
]
