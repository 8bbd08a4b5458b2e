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
  input dtype. ``impl`` selects the plain GroupNorm (``auto``/``xla``), the
  CUDA GroupNorm kernels (``pallas``), or the fused resnet kernels
  (``fused``): each ``ResnetBlock2D`` that the gate admits runs its two
  norm+SiLU+conv pairs as ``ops.fused_resnet.gn_silu_conv3x3``, and every
  other norm runs the plain GroupNorm, as in the JAX model.

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
block's input is kept and its body runs again in the backward; ``"conv"``
keeps the conv outputs (JAX ``save_only_these_names("conv_out")``): each
conv's input, a GroupNorm+SiLU output, is left out of the saved tensors and
computed again from the norm's input when the backward reads it. The JAX
model remats only the resnets, so the attention blocks are never
recomputed. The recompute reports no taps: the forward's values stand.

Image rows sharded over a spatial group (``parallel.spatial``, JAX's
spatial-conv branch): under ``ops.spatial_conv.spatial_conv_scope`` every
conv exchanges its halo rows with the neighbouring shards
(``halo_conv``), every GroupNorm sums its statistics over the shards, and
the attention block keeps its local queries against every shard's keys and
values (``gather_rows``). Under ``remat: full`` a rank must run the same
collectives in the recompute as every other rank, so there the
checkpoint's early stop is off and the whole body runs again. The fused
resnet kernels exchange no halo: the gate refuses a block under the scope.

Channels sharded over a tensor group (``parallel.tensor``, JAX's GSPMD
channel sharding): :meth:`AutoencoderKL.shard_tensor_` keeps each rank's
block of every parameter ``_channel_axis`` shards (``models/io.py``'s
``tensor_blocks``), and under ``ops.tensor_parallel.tensor_scope`` each
conv and linear runs column- or row-parallel by the axis its weight was
cut on, each GroupNorm runs on the rank's channel block (its groups whole,
the kernels' eligibility judged on the whole layer), the attention block
gathers Q and K over channels and keeps V and its output sharded, and the
encoder's moments are gathered whole before the posterior. A layer tells
a block from a whole tensor by its channel count. Under a spatial and a
tensor axis together a conv exchanges the halo rows of its channel block,
then gathers the channels. The fused resnet kernels take whole channels:
the gate refuses a block under a tensor group.

Not in this port: ``remat: offload`` (not to be ported).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from ..ops import flash_attention as flash_ops
from ..ops import fused_resnet
from ..ops.attention import chunked_attention, naive_attention, resolve_impl
from ..ops import group_norm_kernel
from ..ops.group_norm import group_norm, silu
from ..ops import tensor_parallel as tpar
from ..ops.spatial_conv import active_spatial_group, gather_rows, halo_conv, halo_rows
from ..ops.stats import channel_stats
from ..ops.tensor_parallel import TensorGroup, active_tensor_group
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

    def tap_channels(self, point: str) -> int:
        """The whole layer's channel count at a capture point."""
        raise NotImplementedError

    def emit(self, key: str, value: torch.Tensor) -> None:
        if self._sink is not None:
            self._sink[key] = value

    def tap(self, x: torch.Tensor, point: str) -> None:
        if self._sink is None:
            return
        for layer_name, pt, metrics in self._specs_for(point):
            for metric, value in channel_stats(x, tuple(metrics),
                                               self.tap_channels(point)).items():
                self.emit(f"{layer_name}.{pt}.{metric}", value)


class Conv2d(TapModule):
    """2-D convolution (OIHW weight) with input and output taps.

    ``padding`` is symmetric (an int) or an explicit ``(left, right, top,
    bottom)`` zero pad applied after the input tap, so that the tap sees the
    unpadded input as in the JAX model. The conv computes in
    ``compute_dtype`` when set, else in its weight's dtype. Under a spatial
    group it is :func:`ops.spatial_conv.halo_conv` on this rank's rows;
    under a tensor group it is column-parallel (``tensor_axis`` 0, the
    weight's O block), row-parallel (1, its I block) or whole on every rank
    (None)."""

    tensor_axis: Optional[int] = None

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: Union[int, Tuple[int, int, int, int]] = 1,
                 device=None):
        super().__init__()
        self.in_channels, self.out_channels = in_channels, out_channels
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

    def tap_channels(self, point: str) -> int:
        return self.in_channels if point == "input" else self.out_channels

    def _tensor_parallel(self, x: torch.Tensor, dt: torch.dtype, tp: TensorGroup
                         ) -> torch.Tensor:
        pad = self.pad if self.pad is not None else (self.padding,) * 4
        sp = active_spatial_group()
        if sp is not None:
            # each rank's channel block exchanges its halo rows first
            x, pad = halo_rows(x, self.weight.shape[2], self.stride, pad, sp)
        w, b = self.weight.to(dt), self.bias.to(dt)
        if self.tensor_axis == 0:
            return tpar.column_conv(x, w, b, self.stride, pad, self.in_channels, tp)
        if self.tensor_axis == 1:
            return tpar.row_conv(x, w, b, self.stride, pad, self.in_channels, tp)
        x = tpar.replicated_input(x, 1, self.in_channels, tp)
        return F.conv2d(F.pad(x, pad) if any(pad) else x, w, b, self.stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self.tap(x, "input")
        dt = self.compute_dtype or self.weight.dtype
        x = x.to(dt)
        sp = active_spatial_group()
        tp = active_tensor_group()
        if tp is not None:
            y = self._tensor_parallel(x, dt, tp)
        elif sp is not None:
            pad = self.pad if self.pad is not None else (self.padding,) * 4
            y = halo_conv(x, self.weight.to(dt), self.bias.to(dt), self.stride, pad, sp)
        else:
            if self.pad is not None:
                x = F.pad(x, self.pad)
            y = F.conv2d(x, self.weight.to(dt), self.bias.to(dt), self.stride, self.padding)
        self.tap(y, "output")
        return y


class Linear(TapModule):
    """Linear layer ((out, in) weight) with input and output taps, computing
    in ``compute_dtype`` when set, else in its weight's dtype. Under a
    tensor group it is column-parallel (``tensor_axis`` 0) or whole on every
    rank (None), over the last axis: the model's linears are square, so an
    axis T divides is always the output's."""

    tensor_axis: Optional[int] = None

    def __init__(self, in_features: int, out_features: int, device=None):
        super().__init__()
        self.in_channels, self.out_channels = in_features, out_features
        self.compute_dtype: Optional[torch.dtype] = None
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=device))
        self.bias = nn.Parameter(torch.empty(out_features, device=device))

    def init_weights(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        self.weight.uniform_(-bound, bound, generator=generator)
        self.bias.uniform_(-bound, bound, generator=generator)

    def tap_channels(self, point: str) -> int:
        return self.in_channels if point == "input" else self.out_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self.tap(x, "input")
        dt = self.compute_dtype or self.weight.dtype
        x, w, b = x.to(dt), self.weight.to(dt), self.bias.to(dt)
        tp = active_tensor_group()
        if tp is None:
            y = F.linear(x, w, b)
        elif self.tensor_axis == 0:
            y = tpar.column_linear(x, w, b, self.in_channels, tp)
        else:
            y = F.linear(tpar.replicated_input(x, -1, self.in_channels, tp), w, b)
        self.tap(y, "output")
        return y


class GroupNorm(TapModule):
    """GroupNorm with optional fused SiLU; fp32 affine and statistics.

    Three branches, as the JAX ``VGroupNorm`` (JAX ``models/vae.py:
    318-362``): with no output tap, the norm and SiLU in one op; with
    ``impl="pallas"`` and only ``mean_abs_activation_per_channel`` output
    taps, the kernel's own |z| side output, SiLU still fused; otherwise the
    norm, the tap on its output, then a separate SiLU.

    Under a tensor group the norm runs on the rank's channel block with its
    ``num_groups / T`` whole groups; the kernels' eligibility is judged on
    the whole layer, so the same layers take the kernels as on one card."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-6,
                 fuse_silu: bool = False, impl: str = "auto", device=None):
        super().__init__()
        self.channels = channels
        self.num_groups = num_groups
        self.eps = eps
        self.fuse_silu = fuse_silu
        self.impl = impl
        self.weight = nn.Parameter(torch.empty(channels, device=device))
        self.bias = nn.Parameter(torch.empty(channels, device=device))

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def tap_channels(self, point: str) -> int:
        return self.channels

    def _kernel_stats_ok(self, x: torch.Tensor, out_specs, shards: int = 1) -> bool:
        if self.impl != "pallas" or not out_specs:
            return False
        if any(set(m) != {"mean_abs_activation_per_channel"} for _, _, m in out_specs):
            return False
        return group_norm_kernel.eligible(x, self.num_groups // shards, shards)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tp = active_tensor_group()
        shards = 1
        if tp is not None:
            if self.num_groups % tp.size:
                raise ValueError(f"{self.full_name}: {self.num_groups} GroupNorm groups do not "
                                 f"split over {tp.size} tensor ranks")
            if x.shape[1] == self.channels:
                x = tpar.to_block(x, 1, tp)
            shards = tp.size
        groups = self.num_groups // shards
        self.tap(x, "input")
        out_specs = self._specs_for("output")
        if self.fuse_silu and not out_specs:
            return group_norm(x, self.weight, self.bias, groups, self.eps,
                              fuse_silu=True, impl=self.impl, shards=shards)
        if self._kernel_stats_ok(x, out_specs, shards):
            y, mean_abs = group_norm_kernel.group_norm_silu_with_stats(
                x, self.weight, self.bias, groups, self.eps,
                fuse_silu=self.fuse_silu,
            )
            self.emit(f"{self.full_name}.output.mean_abs_activation_per_channel",
                      mean_abs)
            return y
        y = group_norm(x, self.weight, self.bias, groups, self.eps,
                       fuse_silu=False, impl=self.impl, shards=shards)
        self.tap(y, "output")
        return silu(y) if self.fuse_silu else y


# --------------------------------------------------------------------------- #
# Blocks
# --------------------------------------------------------------------------- #
def remat_mode(remat: Any) -> str:
    """The resnets' rematerialisation a ``model.remat`` value asks for:
    False/``"none"`` -> ``"none"``, True/``"full"`` -> ``"full"``,
    ``"conv"`` -> ``"conv"``. ``"offload"`` is not to be ported and
    raises."""
    if not remat or remat == "none":
        return "none"
    if remat is True or remat == "full":
        return "full"
    if remat == "conv":
        return "conv"
    if remat == "offload":
        raise NotImplementedError(
            "model.remat 'offload' is not carried by the PyTorch port (ROADMAP "
            "Q1, Do not port); use 'none', 'full' or 'conv'"
        )
    raise ValueError(
        f"remat must be one of False/'none'/True/'full'/'conv'/'offload', got {remat!r}"
    )


# the gn-output metric the fused kernel emits as a side output
_FUSED_TAP_METRICS = frozenset({"mean_abs_activation_per_channel"})
# what ResnetBlock2D's fused path materialises, so taps on it still see it
_FUSED_MATERIALISED = frozenset({
    ("norm1", "input"), ("norm2", "input"), ("conv1", "output"),
    ("conv_shortcut", "input"), ("conv_shortcut", "output"),
})

# Blocks that ran with impl="fused" in this process, by the path the gate
# chose: a block sent to the unfused path is counted, never hidden. The
# recompute under remat is not counted again.
fused_blocks: Dict[str, int] = {"fused": 0, "unfused": 0}


class ResnetBlock2D(nn.Module):
    """norm1+SiLU -> conv1 -> norm2+SiLU -> conv2, plus the input (through a
    1x1 conv_shortcut when the channel counts differ). With ``remat``
    (:func:`remat_mode`) and autograd recording, ``"full"`` runs the body
    under ``torch.utils.checkpoint`` and ``"conv"`` keeps the conv outputs
    and computes each conv's input again in the backward
    (:meth:`_conv_of_norm`).

    ``impl="fused"`` (JAX ``models/vae.py:427-613``): where :meth:`_fused_ok`
    admits the block, each norm+SiLU+conv pair is one
    ``ops.fused_resnet.gn_silu_conv3x3`` (the residual added in the second's
    epilogue), and the norms' ``mean_abs_activation_per_channel`` output
    taps come from the kernel's |z| side output; otherwise the block runs
    unfused, with plain norms."""

    _remat: str = "none"
    impl: str = "auto"
    # fuse only up to 32x32, the JAX model's measured TPU crossover (JAX
    # vae.py:523-531), kept so that both packages fuse the same blocks
    _FUSED_MAX_HW = 1024

    def __init__(self, in_channels: int, out_channels: int, num_groups: int,
                 eps: float, device=None):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.norm1 = GroupNorm(num_groups, in_channels, eps, fuse_silu=True, device=device)
        self.conv1 = Conv2d(in_channels, out_channels, device=device)
        self.norm2 = GroupNorm(num_groups, out_channels, eps, fuse_silu=True, device=device)
        self.conv2 = Conv2d(out_channels, out_channels, device=device)
        self.conv_shortcut = (
            Conv2d(in_channels, out_channels, 1, padding=0, device=device)
            if in_channels != out_channels else None
        )
        # the model's capture specs under this block, set by set_capture
        self.full_name = ""
        self._captures: CaptureTable = ()

    @property
    def remat(self) -> str:
        return self._remat

    @remat.setter
    def remat(self, value: Any) -> None:
        # every assignment goes through remat_mode, so a bool or an unknown
        # value never reaches forward as a mode
        self._remat = remat_mode(value)

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.conv1.compute_dtype or self.conv1.weight.dtype

    def _fused_captures_ok(self) -> bool:
        """Every capture under this block targets a tensor the fused path
        materialises, or is a norm-output metric the kernel emits (JAX
        vae.py:497-521)."""
        prefix = f"{self.full_name}."
        for layer, point, metrics in self._captures:
            sub = layer[len(prefix):]
            if (sub, point) in _FUSED_MATERIALISED:
                continue
            if sub in ("norm1", "norm2") and point == "output" and (
                    set(metrics) <= _FUSED_TAP_METRICS):
                continue
            return False
        return True

    def _fused_ok(self, x: torch.Tensor) -> bool:
        """The JAX gate (vae.py:533-548): impl fused, bf16 compute, H*W up
        to _FUSED_MAX_HW, both convs eligible, every capture servable."""
        if self.impl != "fused" or self.compute_dtype != torch.bfloat16:
            return False
        if active_spatial_group() is not None or active_tensor_group() is not None:
            # the fused kernels' convs exchange no halo rows and take whole
            # channels
            return False
        n, _c, h, w = x.shape
        if h * w > self._FUSED_MAX_HW:
            return False
        cout = self.conv1.weight.shape[0]
        return (fused_resnet.eligible(x, cout, self.num_groups)
                and fused_resnet.eligible((n, cout, h, w), cout, self.num_groups)
                and self._fused_captures_ok())

    @staticmethod
    def _pair(norm: GroupNorm, conv: Conv2d, x: torch.Tensor) -> torch.Tensor:
        return conv(norm(x))

    def _body(self, x: torch.Tensor, pair=None) -> torch.Tensor:
        """The unfused block; ``pair(norm, conv, x)`` applies each norm and
        conv pair (:meth:`_conv_of_norm` under ``remat: conv``)."""
        pair = pair or self._pair
        h = pair(self.norm1, self.conv1, x)
        h = pair(self.norm2, self.conv2, h)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h

    def _fused_pair(self, x, norm: GroupNorm, conv: Conv2d, residual=None) -> torch.Tensor:
        """conv(silu(norm(x))) (+ residual) through the fused kernels; the
        norm's mean |z| output tap from the kernel's side output, weighted by
        the tap mask, emitted through the norm (so a muted recompute emits
        nothing)."""
        emit = bool(norm._specs_for("output"))
        y, tap, _moments = fused_resnet.gn_silu_conv3x3(
            x, norm.weight, norm.bias, conv.weight, conv.bias, num_groups=self.num_groups,
            eps=self.eps, residual=residual, emit_tap=emit)
        if tap is not None:
            norm.emit(f"{norm.full_name}.output.mean_abs_activation_per_channel",
                      fused_resnet.mean_abs_from_tap(tap, x.shape[2] * x.shape[3]))
        return y

    def _fused_body(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        self.norm1.tap(x, "input")
        h = self._fused_pair(x, self.norm1, self.conv1)
        residual = self.conv_shortcut(x) if self.conv_shortcut is not None else x
        self.conv1.tap(h, "output")
        self.norm2.tap(h, "input")
        return self._fused_pair(h, self.norm2, self.conv2, residual.to(self.compute_dtype))

    def _conv_of_norm(self, norm: GroupNorm, conv: Conv2d, x: torch.Tensor) -> torch.Tensor:
        """conv(norm(x)) for ``remat: conv``: the conv's saved input, the
        GroupNorm+SiLU output, is packed as a recipe that computes it again
        from ``x`` (taps muted) when the backward unpacks it. ``x`` is kept
        anyway (the norm saves it), so the norm's output costs no memory
        between the forward and the backward, and no conv runs twice. The
        norm's own saved tensors stay: the kernels' keep ``x`` and their
        statistics, the plain version its fp32 intermediates."""
        dtype = conv.compute_dtype or conv.weight.dtype
        a = norm(x).to(dtype)

        def again() -> torch.Tensor:
            with torch.no_grad():
                return self._recompute(lambda inp: norm(inp).to(dtype), x)

        # the hooks outlive the forward in the graph: they must not hold ``a``
        key = (a.data_ptr(), a.shape, a.dtype)

        def pack(t: torch.Tensor):
            return again if (t.data_ptr(), t.shape, t.dtype) == key else t

        def unpack(saved):
            return saved() if callable(saved) else saved

        with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
            return conv(a)

    def _recompute(self, body, x: torch.Tensor) -> torch.Tensor:
        """The body with every tap muted: the backward's recompute must not
        write into the stats dict the forward already reported to."""
        taps = [(m, m._sink) for m in self.modules() if isinstance(m, TapModule)]
        for m, _sink in taps:
            m._sink = None
        try:
            return body(x)
        finally:
            for m, sink in taps:
                m._sink = sink

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        body, fused = self._body, False
        if self.impl == "fused":
            fused = self._fused_ok(x)
            fused_blocks["fused" if fused else "unfused"] += 1
            if fused:
                body = self._fused_body
        if self.remat == "none" or not torch.is_grad_enabled():
            return body(x)
        if self.remat == "conv":
            # the fused kernels never materialise the norms and SiLUs, and the
            # fused op keeps only what its backward reads, so a fused body has
            # nothing to drop (JAX _resnet_remat_cls)
            return body(x) if fused else self._body(x, self._conv_of_norm)
        ran = []

        def run(inp: torch.Tensor) -> torch.Tensor:
            if ran:
                return self._recompute(body, inp)
            ran.append(True)
            return body(inp)

        # the body draws no random numbers, so no RNG state is stashed
        if active_spatial_group() is None and active_tensor_group() is None:
            return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)
        # the recompute must run every collective the forward ran, on every
        # rank: no early stop
        with set_checkpoint_early_stop(False):
            return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


class AttentionBlock(nn.Module):
    """Single-head self-attention over spatial positions (diffusers Attention
    in the VAE mid block): group_norm -> q/k/v -> softmax -> to_out ->
    residual. ``attn_impl`` is resolved per call by ``ops.attention
    .resolve_impl``; ``flash`` at a shape the JAX kernels refuse runs
    ``chunked``, as in the JAX model, and at a head wider than the CUDA
    kernels' 1024 channels raises (``flash_attention.refuse_wider_heads``).
    ``flash`` is differentiable: with autograd recording it runs the LSE
    forward and the backward kernels
    (``ops/flash_attention.py``). Under a spatial group the queries are this
    rank's rows and K and V every shard's, gathered in order (JAX's
    sequence parallelism, for every impl); the policy reads the whole
    image's token count. Under a tensor group q, k and v are the rank's
    channel blocks (column-parallel): Q and K are gathered over channels
    (at 1024px N = 16384, so an all-reduce of partial logits would move
    N^2 fp32 a image, 1 GB, where Q and K are N x C each) while V and the
    output stay blocks, P V of a block of V being that block of the output;
    ``flash`` raises there, since its kernels take q, k and v of one width
    (the Trainer resolves it to ``auto`` first, with JAX's warning)."""

    def __init__(self, channels: int, num_groups: int, eps: float,
                 attn_impl: str = "auto", device=None):
        super().__init__()
        self.channels = channels
        self.attn_impl = attn_impl
        self.group_norm = GroupNorm(num_groups, channels, eps, device=device)
        self.to_q = Linear(channels, channels, device=device)
        self.to_k = Linear(channels, channels, device=device)
        self.to_v = Linear(channels, channels, device=device)
        self.to_out = nn.ModuleList([Linear(channels, channels, device=device)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.channels
        h = self.group_norm(x)
        b, c_local, hh, ww = h.shape
        h = h.permute(0, 2, 3, 1).reshape(b, hh * ww, c_local)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        scale = 1.0 / math.sqrt(c)
        tp = active_tensor_group()
        if tp is not None:
            q = tpar.gather_channels(q, -1, tp, partial_grads=True)
            k = tpar.gather_channels(k, -1, tp, partial_grads=True)
        sp = active_spatial_group()
        if sp is not None:
            k, v = gather_rows(k, 1, sp), gather_rows(v, 1, sp)
        impl = resolve_impl(self.attn_impl, k.shape[1], c, batch=b)
        if impl == "flash" and tp is not None:
            # the flash kernels take q, k and v of one width; the Trainer
            # resolves flash to auto on a tensor mesh, with JAX's warning
            raise ValueError("attention_impl 'flash' does not run under a tensor group "
                             "(its kernels take q, k and v of one width); use 'auto'")
        if impl == "flash" and not (flash_ops.eligible(hh * ww, c)
                                    and flash_ops.eligible(k.shape[1], c)):
            # a shape the JAX kernels refuse runs chunked, as the JAX block
            # does; a head past the CUDA kernels' 1024 channels, which the
            # JAX kernels take, raises and names its ROADMAP item
            flash_ops.refuse_wider_heads(hh * ww, c, k.shape[1])
            impl = "chunked"
        if impl == "flash":
            h = flash_ops.flash_attention(q, k, v, scale=scale, out_dtype=q.dtype)
        elif impl == "chunked":
            h = chunked_attention(q, k, v, scale=scale, out_dtype=q.dtype)
        else:
            h = naive_attention(q, k, v, scale=scale, out_dtype=q.dtype)
        h = self.to_out[0](h)
        return x + h.reshape(b, hh, ww, h.shape[-1]).permute(0, 3, 1, 2)


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

    ``impl`` is the GroupNorm impl of every norm and resnet (``fused``: the
    resnets' fused kernels, plain norms elsewhere), ``dtype`` the compute
    dtype of every conv and linear layer and so of the resnets' fused path
    (None: their weights' dtype), ``capture``
    the tap table, ``remat`` the resnets' rematerialisation
    (:func:`remat_mode`); :meth:`set_impl`, :meth:`set_compute_dtype`,
    :meth:`set_capture` and :meth:`set_remat` change them on a built model.
    :meth:`shard_tensor_` keeps a tensor rank's channel blocks (``tensor``
    is then its group)."""

    tensor: Optional[TensorGroup] = None

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
        """The impl of every norm (``ops.group_norm``) and resnet."""
        self.impl = impl
        for module in self.modules():
            if isinstance(module, (GroupNorm, ResnetBlock2D)):
                module.impl = impl
        return self

    def set_attn_impl(self, attn_impl: str) -> "AutoencoderKL":
        """The attention impl of every attention block."""
        for module in self.modules():
            if isinstance(module, AttentionBlock):
                module.attn_impl = attn_impl
        return self

    @torch.no_grad()
    def shard_tensor_(self, tp: TensorGroup) -> "AutoencoderKL":
        """Keep this rank's block of every parameter ``_channel_axis`` shards
        over ``tp``'s ``size`` ranks (``models/io.py``'s ``tensor_blocks``),
        in place, and set each conv's and linear's ``tensor_axis``. Each
        sharded parameter carries ``tensor_shard`` (its axis and whole
        length, and ``tp``), which ``parallel/zero.py`` reads to gather it
        whole and to write its block."""
        from ..parallel.zero import TensorShard, tensor_axis
        from .io import tensor_blocks

        if self.tensor is not None:
            raise ValueError("the model is sharded over a tensor group already")
        blocks = tensor_blocks(dict(self.named_parameters()), tp.index, tp.size)
        for prefix, module in self.named_modules():
            for name, p in list(module.named_parameters(recurse=False)):
                a = tensor_axis(tuple(p.shape), tp.size)
                if isinstance(module, (Conv2d, Linear)) and name == "weight":
                    module.tensor_axis = a
                if a is None:
                    continue
                block = nn.Parameter(blocks[f"{prefix}.{name}" if prefix else name].clone(),
                                     requires_grad=p.requires_grad)
                block.tensor_shard = TensorShard(a, p.shape[a], tp)
                setattr(module, name, block)
        self.tensor = tp
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
        """Rematerialise every ``ResnetBlock2D`` (``"full"``), keep their
        conv outputs (``"conv"``), or neither."""
        self.remat = remat
        mode = remat_mode(remat)
        for module in self.modules():
            if isinstance(module, ResnetBlock2D):
                module.remat = mode
        return self

    def set_capture(self, capture: CaptureTable) -> "AutoencoderKL":
        """Install a capture table: each tap module gets the specs that name
        it by its path in this model, each resnet the specs under it (its
        fused gate reads them)."""
        self.capture = tuple((n, p, tuple(m)) for n, p, m in capture)
        for name, module in self.named_modules():
            if isinstance(module, TapModule):
                module.full_name = name
                module._sink = self._stats
                module._specs = {
                    point: tuple(s for s in self.capture if s[0] == name and s[1] == point)
                    for point in ("input", "output")
                }
            elif isinstance(module, ResnetBlock2D):
                module.full_name = name
                module._captures = tuple(s for s in self.capture
                                         if s[0].startswith(f"{name}."))
        return self

    def encode(self, x: torch.Tensor) -> DiagonalGaussianDistribution:
        moments = self.quant_conv(self.encoder(x))
        tp = active_tensor_group()
        if tp is not None:
            # the posterior reads every moment: whole on every rank
            moments = tpar.replicated_input(moments, 1, 2 * self.config.latent_channels, tp)
        return DiagonalGaussianDistribution.from_moments(moments, dim=1)

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
