"""AutoencoderKL with the SDXL-VAE architecture, in PyTorch.

Counterpart of ``vae_channel_dynamics_tpu/models/vae.py``: the same
topology, the same ``VAEConfig``, and parameter names that are the diffusers
torch names ``models/io.py`` writes (``encoder.down_blocks.0.resnets.0.norm1
.weight``, ``decoder.mid_block.attentions.0.to_out.0.bias``, ...), so a saved
model directory loads with ``load_state_dict(strict=True)``. Modules compute
in NCHW; the wrapper (``models/wrapper.py``) keeps the JAX package's NHWC at
its public functions.

Weights and compute dtype:

* Every parameter is created in fp32. That fp32 copy is the master the
  training step updates, and the copy ``save_model_dir`` writes.
* Training: ``AutoencoderKL(dtype=torch.bfloat16)`` sets a compute dtype on
  every conv and linear layer. Each casts its input and its fp32 weight and
  bias to that dtype at use, as the JAX model's ``kernel.astype(self.dtype)``
  does (JAX ``models/vae.py:259-267``), and autograd carries the gradient
  back to the fp32 master.
* Serving: with no compute dtype, a layer computes in its weights' dtype;
  :meth:`AutoencoderKL.cast_compute_dtype_` converts every conv and linear
  weight and bias in place, once, at load, since a server never updates
  weights.
* GroupNorm affine parameters stay fp32 in both cases, and the statistics
  are taken in fp32 (``ops/group_norm.py``); the output is cast back to the
  input dtype. ``impl`` selects the plain GroupNorm (``auto``/``xla``) or
  the CUDA kernels (``pallas``).

Capture taps (JAX ``models/vae.py:149-177``): ``capture`` is a table of
``(layer_name, capture_point, metrics)`` entries, ``layer_name`` being the
module's path in this model (the diffusers name without ``vae.``). Conv2d
and Linear tap their input and output, GroupNorm its input and its output,
at exactly the JAX model's sites, and ``forward`` returns the values as a
flat ``"stats"`` dict ``{"<layer>.<point>.<metric>": tensor}``. An empty
table taps nothing.

Rematerialisation (``remat``, JAX ``_resnet_remat_cls``): ``"none"``/False
keeps every activation for the backward; ``"full"``/True wraps each
``ResnetBlock2D`` in ``torch.utils.checkpoint`` (non-reentrant), so only a
block's input is kept and its body runs again in the backward. The JAX model
remats only the resnets, so the attention blocks are never recomputed. The
recompute reports no taps: the forward's values stand.

Not in this port yet: ``remat: conv`` and ``offload``, the fused-resnet and
spatial-conv branches of the JAX model.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import flash_attention as flash_ops
from ..ops.attention import chunked_attention, naive_attention, resolve_impl
from ..ops import group_norm_kernel
from ..ops.group_norm import group_norm, silu
from ..ops.stats import channel_stats
from .distributions import DiagonalGaussianDistribution

# (layer_name, capture_point, metrics), layer_name without the "vae." prefix
CaptureSpec = Tuple[str, str, Tuple[str, ...]]
CaptureTable = Tuple[CaptureSpec, ...]


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
class TapModule(nn.Module):
    """A module with activation taps. :meth:`AutoencoderKL.set_capture`
    gives it its ``full_name`` (its path in the model), the capture specs
    that name it, and the model's stats dict, where the taps of one forward
    put their values."""

    full_name: str = ""

    def __init__(self) -> None:
        super().__init__()
        self._specs: Dict[str, Tuple[CaptureSpec, ...]] = {}
        self._sink: Optional[Dict[str, torch.Tensor]] = None

    def _specs_for(self, point: str) -> Tuple[CaptureSpec, ...]:
        return self._specs.get(point, ())

    def emit(self, key: str, value: torch.Tensor) -> None:
        if self._sink is not None:
            self._sink[key] = value

    def tap(self, x: torch.Tensor, point: str) -> None:
        if self._sink is None:
            return
        for layer_name, pt, metrics in self._specs_for(point):
            for metric, value in channel_stats(x, tuple(metrics)).items():
                self.emit(f"{layer_name}.{pt}.{metric}", value)


class Conv2d(TapModule):
    """2-D convolution (OIHW weight) with input and output taps.

    ``padding`` is symmetric (an int) or an explicit ``(left, right, top,
    bottom)`` zero pad applied after the input tap, so that the tap sees the
    unpadded input as in the JAX model. The conv computes in
    ``compute_dtype`` when set, else in its weight's dtype."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: Union[int, Tuple[int, int, int, int]] = 1,
                 device=None):
        super().__init__()
        self.stride = stride
        self.pad = padding if isinstance(padding, tuple) else None
        self.padding = 0 if self.pad is not None else padding
        self.compute_dtype: Optional[torch.dtype] = None
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
        self.tap(x, "input")
        dt = self.compute_dtype or self.weight.dtype
        x = x.to(dt)
        if self.pad is not None:
            x = F.pad(x, self.pad)
        y = F.conv2d(x, self.weight.to(dt), self.bias.to(dt), self.stride, self.padding)
        self.tap(y, "output")
        return y


class Linear(TapModule):
    """Linear layer ((out, in) weight) with input and output taps, computing
    in ``compute_dtype`` when set, else in its weight's dtype."""

    def __init__(self, in_features: int, out_features: int, device=None):
        super().__init__()
        self.compute_dtype: Optional[torch.dtype] = None
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=device))
        self.bias = nn.Parameter(torch.empty(out_features, device=device))

    def init_weights(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        self.weight.uniform_(-bound, bound, generator=generator)
        self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self.tap(x, "input")
        dt = self.compute_dtype or self.weight.dtype
        y = F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))
        self.tap(y, "output")
        return y


class GroupNorm(TapModule):
    """GroupNorm with optional fused SiLU; fp32 affine and statistics.

    Three branches, as the JAX ``VGroupNorm`` (JAX ``models/vae.py:
    318-362``): with no output tap, the norm and SiLU in one op; with
    ``impl="pallas"`` and only ``mean_abs_activation_per_channel`` output
    taps, the kernel's own |z| side output, SiLU still fused; otherwise the
    norm, the tap on its output, then a separate SiLU."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-6,
                 fuse_silu: bool = False, impl: str = "auto", device=None):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.fuse_silu = fuse_silu
        self.impl = impl
        self.weight = nn.Parameter(torch.empty(channels, device=device))
        self.bias = nn.Parameter(torch.empty(channels, device=device))

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def _kernel_stats_ok(self, x: torch.Tensor, out_specs) -> bool:
        if self.impl != "pallas" or not out_specs:
            return False
        if any(set(m) != {"mean_abs_activation_per_channel"} for _, _, m in out_specs):
            return False
        return group_norm_kernel.eligible(x, self.num_groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self.tap(x, "input")
        out_specs = self._specs_for("output")
        if self.fuse_silu and not out_specs:
            return group_norm(x, self.weight, self.bias, self.num_groups, self.eps,
                              fuse_silu=True, impl=self.impl)
        if self._kernel_stats_ok(x, out_specs):
            y, mean_abs = group_norm_kernel.group_norm_silu_with_stats(
                x, self.weight, self.bias, self.num_groups, self.eps,
                fuse_silu=self.fuse_silu,
            )
            self.emit(f"{self.full_name}.output.mean_abs_activation_per_channel",
                      mean_abs)
            return y
        y = group_norm(x, self.weight, self.bias, self.num_groups, self.eps,
                       fuse_silu=False, impl=self.impl)
        self.tap(y, "output")
        return silu(y) if self.fuse_silu else y


# --------------------------------------------------------------------------- #
# Blocks
# --------------------------------------------------------------------------- #
def remat_enabled(remat: Any) -> bool:
    """Whether a ``model.remat`` value rematerialises the resnets:
    False/``"none"`` no, True/``"full"`` yes. ``"conv"`` (save only the conv
    outputs) and ``"offload"`` are not ported yet and raise."""
    if not remat or remat == "none":
        return False
    if remat is True or remat == "full":
        return True
    if remat in ("conv", "offload"):
        raise NotImplementedError(
            f"model.remat {remat!r} is not yet ported to PyTorch (ROADMAP Q1 "
            "item 1); use 'none' or 'full'"
        )
    raise ValueError(
        f"remat must be one of False/'none'/True/'full'/'conv'/'offload', got {remat!r}"
    )


class ResnetBlock2D(nn.Module):
    """norm1+SiLU -> conv1 -> norm2+SiLU -> conv2, plus the input (through a
    1x1 conv_shortcut when the channel counts differ). With ``remat`` set
    and autograd recording, the body runs under ``torch.utils.checkpoint``."""

    remat: bool = False

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

    def _body(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        h = self.conv2(self.norm2(h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h

    def _recompute(self, x: torch.Tensor) -> torch.Tensor:
        """The body with every tap muted: the backward's recompute must not
        write into the stats dict the forward already reported to."""
        taps = [(m, m._sink) for m in self.modules() if isinstance(m, TapModule)]
        for m, _sink in taps:
            m._sink = None
        try:
            return self._body(x)
        finally:
            for m, sink in taps:
                m._sink = sink

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.remat and torch.is_grad_enabled()):
            return self._body(x)
        ran = []

        def run(inp: torch.Tensor) -> torch.Tensor:
            if ran:
                return self._recompute(inp)
            ran.append(True)
            return self._body(inp)

        # the body draws no random numbers, so no RNG state is stashed
        return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


class AttentionBlock(nn.Module):
    """Single-head self-attention over spatial positions (diffusers Attention
    in the VAE mid block): group_norm -> q/k/v -> softmax -> to_out ->
    residual. ``attn_impl`` is resolved per call by ``ops.attention
    .resolve_impl``; ``flash`` that the kernels cannot take runs ``chunked``,
    as in the JAX model. ``flash`` is differentiable: with autograd recording
    it runs the LSE forward and the backward kernels
    (``ops/flash_attention.py``)."""

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
        self.conv = Conv2d(channels, channels, 3, stride=2, padding=(0, 1, 0, 1),
                           device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


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
    and latents_sampled (no scaling_factor applied), like the JAX model, and
    the taps' values under ``"stats"``.

    ``impl`` is the GroupNorm impl of every norm, ``dtype`` the compute dtype
    of every conv and linear layer (None: their weights' dtype), ``capture``
    the tap table, ``remat`` the resnets' rematerialisation
    (:func:`remat_enabled`); :meth:`set_impl`, :meth:`set_compute_dtype`,
    :meth:`set_capture` and :meth:`set_remat` change them on a built model."""

    def __init__(self, config: Optional[VAEConfig] = None, attn_impl: str = "auto",
                 device=None, impl: str = "auto", dtype: Optional[torch.dtype] = None,
                 capture: CaptureTable = (), remat: Any = False):
        super().__init__()
        self.config = cfg = config or VAEConfig.sdxl()
        self.encoder = Encoder(cfg, attn_impl, device=device)
        self.decoder = Decoder(cfg, attn_impl, device=device)
        self.quant_conv = Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1,
                                 padding=0, device=device)
        self.post_quant_conv = Conv2d(cfg.latent_channels, cfg.latent_channels, 1,
                                      padding=0, device=device)
        self._stats: Dict[str, torch.Tensor] = {}
        self.set_impl(impl)
        self.set_compute_dtype(dtype)
        self.set_capture(capture)
        self.set_remat(remat)

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

    def set_impl(self, impl: str) -> "AutoencoderKL":
        """The GroupNorm impl of every norm (``ops.group_norm``)."""
        self.impl = impl
        for module in self.modules():
            if isinstance(module, GroupNorm):
                module.impl = impl
        return self

    def set_compute_dtype(self, dtype: Optional[torch.dtype]) -> "AutoencoderKL":
        """The dtype every conv and linear layer computes in; the fp32
        parameters are cast at use. None computes in the weights' dtype."""
        self.dtype = dtype
        for module in self.modules():
            if isinstance(module, (Conv2d, Linear)):
                module.compute_dtype = dtype
        return self

    def set_remat(self, remat: Any) -> "AutoencoderKL":
        """Rematerialise every ``ResnetBlock2D`` (``"full"``) or none."""
        self.remat = remat
        flag = remat_enabled(remat)
        for module in self.modules():
            if isinstance(module, ResnetBlock2D):
                module.remat = flag
        return self

    def set_capture(self, capture: CaptureTable) -> "AutoencoderKL":
        """Install a capture table: each tap module gets the specs that name
        it by its path in this model."""
        self.capture = tuple((n, p, tuple(m)) for n, p, m in capture)
        for name, module in self.named_modules():
            if isinstance(module, TapModule):
                module.full_name = name
                module._sink = self._stats
                module._specs = {
                    point: tuple(s for s in self.capture if s[0] == name and s[1] == point)
                    for point in ("input", "output")
                }
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
        self._stats.clear()
        latent_dist = self.encode(pixel_values)
        if sample_posterior:
            latents = latent_dist.sample(generator=generator, noise=noise)
        else:
            latents = latent_dist.mode()
        reconstruction = self.decode(latents)
        stats = dict(self._stats)
        self._stats.clear()
        return {
            "reconstruction": reconstruction,
            "latent_dist": latent_dist,
            "latents_sampled": latents,
            "stats": stats,
        }
