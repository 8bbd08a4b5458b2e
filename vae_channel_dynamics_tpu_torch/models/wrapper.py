"""Inference wrapper with the JAX package's ``SDXLVAEWrapper`` API.

Counterpart of ``vae_channel_dynamics_tpu/models/wrapper.py``: ``forward``,
``encode`` (posterior mode or sample, times ``scaling_factor``) and
``decode`` (divided by ``scaling_factor``, clamped to [-1, 1]), taking and
returning NHWC pixels and NHWC latents like the JAX wrapper. The model runs
in NCHW on ``device``; every call runs under ``torch.inference_mode``.

Like the JAX wrapper, a sampling call without a ``generator`` uses a fixed
seed (0), so repeated calls give the same result; pass a generator for
fresh noise. ``impl`` is the GroupNorm impl (``auto``/``xla`` plain,
``pallas`` the CUDA kernels).

Tiled and sliced inference (diffusers' ``enable_tiling`` and
``enable_slicing``, ``models/tiling.py``) apply to ``encode`` and
``decode``; ``forward`` is the training contract and always runs untiled.
Activation hooks (``add_hooks``) capture ``full_activation_map`` at the
named leaf modules' outputs through the model's capture taps, as the JAX
wrapper's capture tables do.

:func:`forward_with_stats` is the capture forward of the training step (the
JAX package's ``training/step.py::_forward_with_stats``): the model's
forward, with autograd, returning its outputs and the taps' flat stats
dict.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .distributions import DiagonalGaussianDistribution
from .tiling import sliced_apply, tiled_apply
from .vae import AutoencoderKL, TapModule, VAEConfig

logger = logging.getLogger(__name__)


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


def forward_with_stats(
    model: AutoencoderKL,
    pixel_values: torch.Tensor,
    sample_posterior: bool = True,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[Dict[str, Any], Dict[str, torch.Tensor]]:
    """Run ``model`` on NCHW pixels and split off the taps' stats dict
    ``{"<layer>.<point>.<metric>": tensor}``; ``noise`` is NCHW standard
    normal noise that replaces the generator's draw."""
    out = model(pixel_values, sample_posterior=sample_posterior,
                generator=generator, noise=noise)
    return out, out.pop("stats")


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
        impl: str = "auto",
    ):
        self.config = config or VAEConfig.sdxl()
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.impl = impl
        self.device = resolve_device(device)
        self.scaling_factor = self.config.scaling_factor
        model = AutoencoderKL(self.config, attn_impl=attn_impl, device=self.device,
                              impl=impl)
        if state_dict is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            model.init_weights(gen)
        else:
            model.load_state_dict(state_dict, strict=True)
        model.cast_compute_dtype_(dtype)
        self.model = model.eval().requires_grad_(False)
        self._captured: Dict[str, np.ndarray] = {}
        # tiled/sliced inference state, the JAX wrapper's defaults
        self.use_tiling = False
        self.use_slicing = False
        self.tile_sample_min_size = self.config.sample_size
        self.tile_overlap_factor = 0.25

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return self.model.state_dict()

    def replicate(self, device: Any) -> "SDXLVAEWrapper":
        """The same model (weights, dtype, impls, tiling and slicing) on
        ``device``: one replica a card for serving across cards."""
        other = SDXLVAEWrapper(
            config=self.config,
            state_dict={k: v.float() for k, v in self.model.state_dict().items()},
            dtype=self.dtype, attn_impl=self.attn_impl, device=device, impl=self.impl)
        other.use_tiling, other.use_slicing = self.use_tiling, self.use_slicing
        other.tile_sample_min_size = self.tile_sample_min_size
        other.tile_overlap_factor = self.tile_overlap_factor
        return other

    @property
    def spatial_factor(self) -> int:
        """Pixel-to-latent downsample factor (2^(len(block_out_channels)-1))."""
        return 2 ** (len(self.config.block_out_channels) - 1)

    # ------------------------------------------------------------------ #
    # Tiled / sliced inference (diffusers AutoencoderKL API)
    def enable_tiling(self, tile_sample_min_size: Optional[int] = None,
                      tile_overlap_factor: Optional[float] = None) -> None:
        """Encode/decode in overlapping tiles of ``tile_sample_min_size``
        pixels, blended over the overlap: activation memory scales with the
        tile, not the image. Defaults as diffusers': the config's
        sample_size, overlap 0.25."""
        if tile_sample_min_size is not None:
            self.tile_sample_min_size = int(tile_sample_min_size)
        if tile_overlap_factor is not None:
            self.tile_overlap_factor = float(tile_overlap_factor)
        f = self.spatial_factor
        if self.tile_sample_min_size % f:
            raise ValueError(
                f"tile_sample_min_size ({self.tile_sample_min_size}) must be "
                f"divisible by the model's spatial factor {f}"
            )
        if not 0.0 < self.tile_overlap_factor < 1.0:
            raise ValueError("tile_overlap_factor must be in (0, 1)")
        if self._tile_stride() <= 0 or self._tile_stride() >= self.tile_sample_min_size:
            raise ValueError(
                f"tile_overlap_factor {self.tile_overlap_factor} leaves no "
                f"overlap (or no stride) at tile {self.tile_sample_min_size}"
            )
        self.use_tiling = True

    def disable_tiling(self) -> None:
        self.use_tiling = False

    def enable_slicing(self) -> None:
        """Encode/decode one batch element at a time (diffusers
        enable_slicing): batched inference at single-sample activation
        cost."""
        self.use_slicing = True

    def disable_slicing(self) -> None:
        self.use_slicing = False

    def _tile_stride(self) -> int:
        """Pixel-space tile stride, snapped down to the spatial factor so
        the latent grid is exact (diffusers: int(tile * (1 - overlap)))."""
        f = self.spatial_factor
        stride = int(self.tile_sample_min_size * (1.0 - self.tile_overlap_factor))
        return max(stride // f * f, f)

    def _tiled(self, fn, x: torch.Tensor, tile: int, stride: int, num: int,
               den: int) -> torch.Tensor:
        """``fn`` over NHWC ``x``, through the tiling and slicing in force."""
        def one(xs):
            return tiled_apply(fn, xs, tile, stride, num, den) if self.use_tiling else fn(xs)

        return sliced_apply(one, x) if self.use_slicing else one(x)

    # ------------------------------------------------------------------ #
    # Hook-style capture (the JAX wrapper's add_hooks)
    def add_hooks(self, layer_names: List[str]) -> None:
        """Capture full activation maps at the named layers' outputs on the
        next forwards. Names may carry or omit the ``vae.`` prefix. Taps
        exist on the leaf modules (convs, norms, linears); a composite name
        (e.g. ``encoder.mid_block.attentions.0``) or a typo captures
        nothing, and is warned about up front."""
        from ..utils.naming import strip_vae_prefix  # it imports the model

        self.remove_hooks()
        known = {name for name, m in self.model.named_modules() if isinstance(m, TapModule)}
        stripped = [strip_vae_prefix(n) for n in layer_names]
        unknown = [n for n in stripped if n not in known]
        if unknown:
            logger.warning(
                "No capture taps for layer name(s) %s — taps exist on "
                "parametric leaf modules only (e.g. "
                "'encoder.mid_block.attentions.0.group_norm', not the "
                "composite block). These names will capture nothing.",
                unknown,
            )
        self.model.set_capture(tuple((n, "output", ("full_activation_map",)) for n in stripped))
        registered = [n for n in stripped if n in known]
        if registered:
            logger.info("Registered activation capture for: %s", registered)

    def remove_hooks(self) -> None:
        self.model.set_capture(())
        self._captured = {}

    def _store_captured(self) -> None:
        """Move the taps' maps (``<layer>.output.full_activation_map``) to
        the host as NCHW fp32 numpy, keyed by the plain layer name, in the
        order of their keys (the order the JAX wrapper's jitted dict has)."""
        suffix = ".output.full_activation_map"
        for key, value in sorted(self.model._stats.items()):
            if key.endswith(suffix):
                self._captured[key[:-len(suffix)]] = value.float().cpu().numpy()
        self.model._stats.clear()

    def get_captured_activations(self) -> Dict[str, np.ndarray]:
        """Captured activations keyed by plain layer name, NCHW numpy."""
        return self._captured

    def clear_captured_activations(self) -> None:
        self._captured = {}

    def _generator(self, generator: Optional[torch.Generator]) -> torch.Generator:
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        return generator

    def _moments(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC posterior moments (mean, logvar) of NHWC pixels."""
        return _nhwc(self.model.quant_conv(self.model.encoder(_nchw(x))))

    def _decode(self, z: torch.Tensor) -> torch.Tensor:
        """NHWC pixels of unscaled NHWC latents."""
        return _nhwc(self.model.decode(_nchw(z)))

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
        the generator's draw when given. With hooks added, the captured
        maps of this call replace the previous ones."""
        self.model._stats.clear()
        x = torch.as_tensor(pixel_values, device=self.device)
        dist = DiagonalGaussianDistribution.from_moments(self._moments(x), dim=-1)
        if sample_posterior:
            latents = dist.sample(
                generator=None if noise is not None else self._generator(generator),
                noise=noise,
            )
        else:
            latents = dist.mode()
        recon = self._decode(latents)
        if self.model.capture:
            self._store_captured()
        return {
            "reconstruction": recon,
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
        posterior mode with ``deterministic=True``, else a sample. With
        tiling or slicing the moments are computed per tile or sample and
        blended, then split (diffusers tiled_encode)."""
        x = torch.as_tensor(pixel_values, device=self.device)
        moments = self._tiled(self._moments, x, self.tile_sample_min_size, self._tile_stride(),
                              1, self.spatial_factor)
        dist = DiagonalGaussianDistribution.from_moments(moments, dim=-1)
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
        """NHWC scaled latents -> NHWC pixels clamped to [-1, 1]; with
        tiling or slicing decoded per latent tile or sample and blended
        (diffusers tiled_decode), the clamp after assembly."""
        f = self.spatial_factor
        z = torch.as_tensor(latents, device=self.device) / self.scaling_factor
        img = self._tiled(self._decode, z, self.tile_sample_min_size // f, self._tile_stride() // f,
                          f, 1)
        return torch.clamp(img, -1.0, 1.0)
