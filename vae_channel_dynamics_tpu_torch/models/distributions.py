"""Diagonal Gaussian posterior over latents.

Counterpart of ``vae_channel_dynamics_tpu/models/distributions.py``.
``from_moments`` splits along ``dim`` (-1 for NHWC moments, the JAX
package's layout and the wrapper's public one; 1 for the model's NCHW).
``sample`` draws from an explicit ``torch.Generator``, or takes the standard
normal ``noise`` it is given, so tests can feed both packages the same noise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class DiagonalGaussianDistribution:
    mean: torch.Tensor
    logvar: torch.Tensor

    @classmethod
    def from_moments(
        cls, moments: torch.Tensor, dim: int = -1
    ) -> "DiagonalGaussianDistribution":
        """Split a moments tensor with 2C entries along ``dim`` into
        mean/logvar, clamping logvar to [-30, 20] (diffusers convention)."""
        mean, logvar = torch.chunk(moments, 2, dim=dim)
        return cls(mean=mean, logvar=torch.clamp(logvar, -30.0, 20.0))

    @property
    def std(self) -> torch.Tensor:
        return torch.exp(0.5 * self.logvar.float())

    @property
    def var(self) -> torch.Tensor:
        return torch.exp(self.logvar.float())

    def sample(
        self,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """``mean + std * noise`` in fp32, cast to the mean's dtype. Without
        ``noise``, standard normal noise is drawn from ``generator``."""
        if noise is None:
            noise = torch.randn(
                self.mean.shape, generator=generator, dtype=torch.float32,
                device=self.mean.device,
            )
        elif noise.shape != self.mean.shape:
            raise ValueError(
                f"noise shape {tuple(noise.shape)} != latent shape "
                f"{tuple(self.mean.shape)}"
            )
        noise = noise.to(device=self.mean.device, dtype=torch.float32)
        return (self.mean.float() + self.std * noise).to(self.mean.dtype)

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        """KL(q || N(0, I)) per sample: 0.5 * sum(mu^2 + var - 1 - logvar)
        over all non-batch dims. Returns shape (B,)."""
        mean = self.mean.float()
        logvar = self.logvar.float()
        dims = tuple(range(1, mean.dim()))
        return 0.5 * torch.sum(
            mean.square() + torch.exp(logvar) - 1.0 - logvar, dim=dims
        )
