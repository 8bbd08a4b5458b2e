"""AutoencoderKL with the SDXL-VAE architecture, in PyTorch.

Counterpart of ``vae_channel_dynamics_tpu/models/vae.py``: the same
topology, the same ``VAEConfig``, and parameter names that are the diffusers
torch names ``models/io.py`` writes (``encoder.down_blocks.0.resnets.0.norm1
.weight``, ``decoder.mid_block.attentions.0.to_out.0.bias``, ...), so a saved
model directory loads with ``load_state_dict(strict=True)``. Modules compute
in NCHW; the wrapper (``models/wrapper.py``) keeps the JAX package's NHWC at
its public functions.

Weights and compute dtype:

* Every parameter is created in fp32. That fp32 copy is the master a
  training port will update, and the copy ``save_model_dir`` writes.
* Convolutions and linear layers compute in the dtype of their weights with
  fp32 accumulation, casting their input to it. For bf16 serving,
  :meth:`AutoencoderKL.cast_compute_dtype_` converts every conv and linear
  weight and bias in place to the compute dtype, once, at load: the serving
  wrapper keeps only that compute-dtype copy, since it never updates weights.
* GroupNorm affine parameters stay fp32 in both cases, and the statistics
  are taken in fp32 (``ops/group_norm.py``); the output is cast back to the
  input dtype.

Not in this port yet: capture taps, rematerialisation, the fused-resnet and
spatial-conv branches of the JAX model.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import flash_attention as flash_ops
from ..ops.attention import chunked_attention, naive_attention, resolve_impl
from ..ops.group_norm import group_norm
from .distributions import DiagonalGaussianDistribution


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """Static architecture hyperparameters (diffusers config equivalent)."""

    in_channels: int = 3
    out_channels: int = 3
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4
    norm_num_groups: int = 32
    norm_eps: float = 1e-6
    scaling_factor: float = 0.13025
    sample_size: int = 1024
    mid_block_attention: bool = True

    @classmethod
    def sdxl(cls) -> "VAEConfig":
        return cls()

    @classmethod
    def sd(cls) -> "VAEConfig":
        """Stable Diffusion 1.x/2.x VAE: the SDXL topology with another
        latent scaling factor and nominal sample size."""
        return cls(scaling_factor=0.18215, sample_size=512)

    @classmethod
    def tiny(cls) -> "VAEConfig":
        """A CPU-testable miniature with the same topology."""
        return cls(
            block_out_channels=(16, 32),
            layers_per_block=1,
            norm_num_groups=8,
            sample_size=32,
        )

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "VAEConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in d.items() if k in known}
        # diffusers spells the attention toggle mid_block_add_attention
        if "mid_block_attention" not in d and "mid_block_add_attention" in d:
            kwargs["mid_block_attention"] = bool(d["mid_block_add_attention"])
        if "block_out_channels" in kwargs:
            kwargs["block_out_channels"] = tuple(kwargs["block_out_channels"])
        return cls(**kwargs)


# --------------------------------------------------------------------------- #
# Leaf modules
# --------------------------------------------------------------------------- #
class Conv2d(nn.Module):
    """2-D convolution (OIHW weight) computing in its weight's dtype."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, device=None):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels, kernel_size, kernel_size, device=device))
        self.bias = nn.Parameter(torch.empty(out_channels, device=device))

    def init_weights(self, generator: torch.Generator) -> None:
        """Kaiming-uniform(a=sqrt(5)) on fan_in, as torch's Conv2d and the
        JAX model do: weight and bias uniform in +-1/sqrt(fan_in)."""
        bound = 1.0 / math.sqrt(self.weight[0].numel())
        self.weight.uniform_(-bound, bound, generator=generator)
        self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        return F.conv2d(x.to(w.dtype), w, self.bias, self.stride, self.padding)


class Linear(nn.Module):
    """Linear layer ((out, in) weight) computing in its weight's dtype."""

    def __init__(self, in_features: int, out_features: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=device))
        self.bias = nn.Parameter(torch.empty(out_features, device=device))

    def init_weights(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        self.weight.uniform_(-bound, bound, generator=generator)
        self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        return F.linear(x.to(w.dtype), w, self.bias)


class GroupNorm(nn.Module):
    """GroupNorm with optional fused SiLU; fp32 affine and statistics."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-6,
                 fuse_silu: bool = False, device=None):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.fuse_silu = fuse_silu
        self.weight = nn.Parameter(torch.empty(channels, device=device))
        self.bias = nn.Parameter(torch.empty(channels, device=device))

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm(x, self.weight, self.bias, self.num_groups, self.eps,
                          fuse_silu=self.fuse_silu)


# --------------------------------------------------------------------------- #
# Blocks
# --------------------------------------------------------------------------- #
class ResnetBlock2D(nn.Module):
    """norm1+SiLU -> conv1 -> norm2+SiLU -> conv2, plus the input (through a
    1x1 conv_shortcut when the channel counts differ)."""

    def __init__(self, in_channels: int, out_channels: int, num_groups: int,
                 eps: float, device=None):
        super().__init__()
        self.norm1 = GroupNorm(num_groups, in_channels, eps, fuse_silu=True, device=device)
        self.conv1 = Conv2d(in_channels, out_channels, device=device)
        self.norm2 = GroupNorm(num_groups, out_channels, eps, fuse_silu=True, device=device)
        self.conv2 = Conv2d(out_channels, out_channels, device=device)
        self.conv_shortcut = (
            Conv2d(in_channels, out_channels, 1, padding=0, device=device)
            if in_channels != out_channels else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        h = self.conv2(self.norm2(h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AttentionBlock(nn.Module):
    """Single-head self-attention over spatial positions (diffusers Attention
    in the VAE mid block): group_norm -> q/k/v -> softmax -> to_out ->
    residual. ``attn_impl`` is resolved per call by ``ops.attention
    .resolve_impl``; ``flash`` that the kernel cannot take runs ``chunked``,
    as in the JAX model."""

    def __init__(self, channels: int, num_groups: int, eps: float,
                 attn_impl: str = "auto", device=None):
        super().__init__()
        self.attn_impl = attn_impl
        self.group_norm = GroupNorm(num_groups, channels, eps, device=device)
        self.to_q = Linear(channels, channels, device=device)
        self.to_k = Linear(channels, channels, device=device)
        self.to_v = Linear(channels, channels, device=device)
        self.to_out = nn.ModuleList([Linear(channels, channels, device=device)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        scale = 1.0 / math.sqrt(c)
        impl = resolve_impl(self.attn_impl, hh * ww, c, batch=b)
        if impl == "flash" and not flash_ops.eligible(hh * ww, c):
            impl = "chunked"
        if impl == "flash":
            h = flash_ops.flash_attention(q, k, v, scale=scale, out_dtype=q.dtype)
        elif impl == "chunked":
            h = chunked_attention(q, k, v, scale=scale, out_dtype=q.dtype)
        else:
            h = naive_attention(q, k, v, scale=scale, out_dtype=q.dtype)
        h = self.to_out[0](h)
        return x + h.reshape(b, hh, ww, c).permute(0, 3, 1, 2)


class Downsample2D(nn.Module):
    """Stride-2 conv after an asymmetric (0, 1) pad (diffusers Downsample2D)."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=0, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample2D(nn.Module):
    """Nearest-neighbour 2x upsample, then a 3x3 conv (diffusers Upsample2D).
    The JAX model computes the same function as one input-dilated 4x4 conv;
    the two differ only by float reassociation."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.conv = Conv2d(channels, channels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class DownEncoderBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int,
                 add_downsample: bool, num_groups: int, eps: float, device=None):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if j == 0 else out_channels, out_channels,
                          num_groups, eps, device=device)
            for j in range(num_layers)
        ])
        self.downsamplers = (
            nn.ModuleList([Downsample2D(out_channels, device=device)])
            if add_downsample else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
        return x


class UpDecoderBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_layers: int,
                 add_upsample: bool, num_groups: int, eps: float, device=None):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(in_channels if j == 0 else out_channels, out_channels,
                          num_groups, eps, device=device)
            for j in range(num_layers)
        ])
        self.upsamplers = (
            nn.ModuleList([Upsample2D(out_channels, device=device)])
            if add_upsample else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for resnet in self.resnets:
            x = resnet(x)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x)
        return x


class UNetMidBlock2D(nn.Module):
    def __init__(self, channels: int, num_groups: int, eps: float,
                 use_attention: bool, attn_impl: str, device=None):
        super().__init__()
        self.resnets = nn.ModuleList([
            ResnetBlock2D(channels, channels, num_groups, eps, device=device)
            for _ in range(2)
        ])
        self.attentions = (
            nn.ModuleList([AttentionBlock(channels, num_groups, eps, attn_impl,
                                          device=device)])
            if use_attention else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.resnets[0](x)
        if self.attentions is not None:
            x = self.attentions[0](x)
        return self.resnets[1](x)


class Encoder(nn.Module):
    def __init__(self, config: VAEConfig, attn_impl: str = "auto", device=None):
        super().__init__()
        cfg = config
        boc = cfg.block_out_channels
        g, eps = cfg.norm_num_groups, cfg.norm_eps
        self.conv_in = Conv2d(cfg.in_channels, boc[0], device=device)
        self.down_blocks = nn.ModuleList([
            DownEncoderBlock2D(boc[i - 1] if i > 0 else boc[0], out_ch,
                               cfg.layers_per_block, i < len(boc) - 1, g, eps,
                               device=device)
            for i, out_ch in enumerate(boc)
        ])
        self.mid_block = UNetMidBlock2D(boc[-1], g, eps, cfg.mid_block_attention,
                                        attn_impl, device=device)
        self.conv_norm_out = GroupNorm(g, boc[-1], eps, fuse_silu=True, device=device)
        self.conv_out = Conv2d(boc[-1], 2 * cfg.latent_channels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return self.conv_out(self.conv_norm_out(x))


class Decoder(nn.Module):
    def __init__(self, config: VAEConfig, attn_impl: str = "auto", device=None):
        super().__init__()
        cfg = config
        rboc = tuple(reversed(cfg.block_out_channels))
        g, eps = cfg.norm_num_groups, cfg.norm_eps
        self.conv_in = Conv2d(cfg.latent_channels, rboc[0], device=device)
        self.mid_block = UNetMidBlock2D(rboc[0], g, eps, cfg.mid_block_attention,
                                        attn_impl, device=device)
        self.up_blocks = nn.ModuleList([
            UpDecoderBlock2D(rboc[i - 1] if i > 0 else rboc[0], out_ch,
                             cfg.layers_per_block + 1, i < len(rboc) - 1, g, eps,
                             device=device)
            for i, out_ch in enumerate(rboc)
        ])
        self.conv_norm_out = GroupNorm(g, rboc[-1], eps, fuse_silu=True, device=device)
        self.conv_out = Conv2d(rboc[-1], cfg.out_channels, device=device)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        z = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            z = block(z)
        return self.conv_out(self.conv_norm_out(z))


class AutoencoderKL(nn.Module):
    """The full VAE over NCHW tensors. ``forward(pixel_values,
    sample_posterior, generator, noise)`` returns reconstruction, latent_dist
    and latents_sampled (no scaling_factor applied), like the JAX model."""

    def __init__(self, config: Optional[VAEConfig] = None, attn_impl: str = "auto",
                 device=None):
        super().__init__()
        self.config = cfg = config or VAEConfig.sdxl()
        self.encoder = Encoder(cfg, attn_impl, device=device)
        self.decoder = Decoder(cfg, attn_impl, device=device)
        self.quant_conv = Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1,
                                 padding=0, device=device)
        self.post_quant_conv = Conv2d(cfg.latent_channels, cfg.latent_channels, 1,
                                      padding=0, device=device)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded initialisation: torch's defaults for convs and linears,
        ones/zeros for GroupNorm (the JAX model's initialisers)."""
        for module in self.modules():
            if isinstance(module, (Conv2d, Linear, GroupNorm)):
                module.init_weights(generator)

    def cast_compute_dtype_(self, dtype: torch.dtype) -> "AutoencoderKL":
        """Convert conv and linear parameters in place to ``dtype``;
        GroupNorm parameters stay fp32."""
        for module in self.modules():
            if isinstance(module, (Conv2d, Linear)):
                module.to(dtype)
        return self

    def encode(self, x: torch.Tensor) -> DiagonalGaussianDistribution:
        return DiagonalGaussianDistribution.from_moments(
            self.quant_conv(self.encoder(x)), dim=1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))

    def forward(
        self,
        pixel_values: torch.Tensor,
        sample_posterior: bool = True,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> Dict[str, Any]:
        latent_dist = self.encode(pixel_values)
        if sample_posterior:
            latents = latent_dist.sample(generator=generator, noise=noise)
        else:
            latents = latent_dist.mode()
        return {
            "reconstruction": self.decode(latents),
            "latent_dist": latent_dist,
            "latents_sampled": latents,
        }
