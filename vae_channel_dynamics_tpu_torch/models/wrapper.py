"""Inference wrapper with the JAX package's ``SDXLVAEWrapper`` API.

Counterpart of ``vae_channel_dynamics_tpu/models/wrapper.py``: ``forward``,
``encode`` (posterior mode or sample, times ``scaling_factor``) and
``decode`` (divided by ``scaling_factor``, clamped to [-1, 1]), taking and
returning NHWC pixels and NHWC latents like the JAX wrapper. The model runs
in NCHW on ``device``; every call runs under ``torch.inference_mode``.

Like the JAX wrapper, a sampling call without a ``generator`` uses a fixed
seed (0), so repeated calls give the same result; pass a generator for
fresh noise. Tiling, slicing and activation hooks are not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch

from .distributions import DiagonalGaussianDistribution
from .vae import AutoencoderKL, VAEConfig


def resolve_device(device: Any) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device raises when
    ``torch.cuda.is_available()`` is false rather than running elsewhere."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but torch.cuda.is_available() "
            "is false; pass device='cpu' to run on the CPU"
        )
    return dev


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class SDXLVAEWrapper:
    def __init__(
        self,
        config: Optional[VAEConfig] = None,
        state_dict: Optional[Mapping[str, torch.Tensor]] = None,
        dtype: torch.dtype = torch.float32,
        seed: int = 0,
        attn_impl: str = "auto",
        device: Any = "cuda",
    ):
        self.config = config or VAEConfig.sdxl()
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.device = resolve_device(device)
        self.scaling_factor = self.config.scaling_factor
        model = AutoencoderKL(self.config, attn_impl=attn_impl, device=self.device)
        if state_dict is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            model.init_weights(gen)
        else:
            model.load_state_dict(state_dict, strict=True)
        model.cast_compute_dtype_(dtype)
        self.model = model.eval().requires_grad_(False)

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return self.model.state_dict()

    def _input(self, x: Any) -> torch.Tensor:
        return _nchw(torch.as_tensor(x, device=self.device))

    def _generator(self, generator: Optional[torch.Generator]) -> torch.Generator:
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        return generator

    def _latent_dist(self, x: torch.Tensor) -> DiagonalGaussianDistribution:
        """Posterior over NHWC latents for NCHW pixels."""
        moments = self.model.quant_conv(self.model.encoder(x))
        return DiagonalGaussianDistribution.from_moments(_nhwc(moments), dim=-1)

    @torch.inference_mode()
    def forward(
        self,
        pixel_values: Any,
        sample_posterior: bool = True,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> Dict[str, Any]:
        """Encode -> sample/mode -> decode. NHWC pixels in [-1, 1]; no
        scaling_factor applied. ``noise`` (NHWC, standard normal) replaces
        the generator's draw when given."""
        dist = self._latent_dist(self._input(pixel_values))
        if sample_posterior:
            latents = dist.sample(
                generator=None if noise is not None else self._generator(generator),
                noise=noise,
            )
        else:
            latents = dist.mode()
        recon = self.model.decode(_nchw(latents))
        return {
            "reconstruction": _nhwc(recon),
            "latent_dist": dist,
            "latents_sampled": latents,
        }

    @torch.inference_mode()
    def encode(
        self,
        pixel_values: Any,
        deterministic: bool = False,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """NHWC pixels in [-1, 1] -> NHWC latents times scaling_factor: the
        posterior mode with ``deterministic=True``, else a sample."""
        dist = self._latent_dist(self._input(pixel_values))
        if deterministic:
            z = dist.mode()
        else:
            z = dist.sample(
                generator=None if noise is not None else self._generator(generator),
                noise=noise,
            )
        return z * self.scaling_factor

    @torch.inference_mode()
    def decode(self, latents: Any) -> torch.Tensor:
        """NHWC scaled latents -> NHWC pixels clamped to [-1, 1]."""
        z = self._input(latents) / self.scaling_factor
        return torch.clamp(_nhwc(self.model.decode(z)), -1.0, 1.0)
