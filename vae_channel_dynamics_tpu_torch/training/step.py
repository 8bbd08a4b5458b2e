"""The train and eval steps, in PyTorch.

Counterpart of ``vae_channel_dynamics_tpu/training/step.py``. The loss
contract is the same: per-element-mean MSE on fp32 casts plus ``kl_weight``
times the mean per-sample KL, both masked by the batch-validity mask so that
remainder-batch pad rows carry no weight; validation uses SUM-convention
losses.

The optimizer is optax's, written out so that the port's trajectory is the
JAX package's step for step (``build_optimizer``):

* ``clip_by_global_norm``: the gradient is scaled by ``max_norm / norm``
  only when ``norm >= max_norm``. This is not
  ``torch.nn.utils.clip_grad_norm_``, which divides by ``norm + 1e-6``;
* ``adamw``: ``mu_hat / (sqrt(nu_hat) + eps)`` plus the decoupled weight
  decay ``wd * param``, times ``-lr(count)`` with the count of updates
  applied before this one, so the first update takes ``lr(0)`` as torch's
  LambdaLR does;
* ``adafactor``: optax 0.2.6's ``adafactor(learning_rate=schedule,
  weight_decay_rate=wd or None)`` with its defaults: factored second
  moments over a parameter's two largest axes when both have at least 128
  entries (a full moment otherwise), decay ``1 - (count + 1) ** -0.8``,
  ``eps`` 1e-30 added to the squared gradient, each update clipped to a
  block RMS of 1, times ``lr(count)``, times the parameter's RMS (at least
  1e-3), plus ``wd * param`` after the learning rate (so the decay is not
  scaled by it), no momentum;
* ``MultiSteps`` gradient accumulation: the running mean of k micro-step
  gradients goes through the clip and the optimizer on every k-th
  micro-step, and the schedule's count advances only then.

PyTorch runs eagerly, so there is no jit: a step runs the forward under the
tap mask, the backward, the update in place on the fp32 master parameters
(``torch._foreach`` ops), the stats accumulation and the EMA blend, and it
never waits for the device: the learning rate and the accumulation counter
are host integers, and every metric stays a 0-d device tensor until the
caller reads it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..models.wrapper import forward_with_stats
from ..ops.spatial_conv import SpatialGroup, gather_rows, row_block, spatial_conv_scope
from ..ops.stats import tap_mask
from ..ops.tensor_parallel import TensorGroup, tensor_scope
from ..parallel.mesh import all_gather_rows
from .state import TrainState

logger = logging.getLogger(__name__)

Schedule = Callable[[int], float]


def linear_warmup_decay_schedule(
    base_lr: float, warmup_steps: int, max_train_steps: int
) -> Schedule:
    """Linear warmup then linear decay to zero: the reference's LambdaLR."""

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return base_lr * count / max(1.0, float(warmup_steps))
        progress = (count - warmup_steps) / max(1.0, float(max_train_steps - warmup_steps))
        return base_lr * max(0.0, 1.0 - min(1.0, progress))

    return schedule


def make_lr_schedule(
    lr_scheduler_type: str,
    base_lr: float,
    warmup_steps: int,
    max_train_steps: int,
) -> Schedule:
    """``linear`` (the default), ``constant``, ``constant_with_warmup`` or
    ``cosine`` (linear warmup, then a half cosine to zero), as the JAX
    package's ``make_lr_schedule``; an unknown name warns and falls back to
    linear. A schedule maps the count of applied updates to a float."""
    name = (lr_scheduler_type or "linear").strip().lower()
    if name == "linear":
        return linear_warmup_decay_schedule(base_lr, warmup_steps, max_train_steps)
    if name == "constant":
        return lambda count: float(base_lr)
    if name == "constant_with_warmup":

        def constant_warmup(count: int) -> float:
            if count < warmup_steps:
                return base_lr * count / max(1.0, float(warmup_steps))
            return float(base_lr)

        return constant_warmup
    if name == "cosine":

        def cosine(count: int) -> float:
            if count < warmup_steps:
                return base_lr * count / max(1.0, float(warmup_steps))
            progress = (count - warmup_steps) / max(1.0, float(max_train_steps - warmup_steps))
            progress = min(1.0, max(0.0, progress))
            return base_lr * 0.5 * (1.0 + math.cos(math.pi * progress))

        return cosine
    logger.warning(
        "Unknown training.lr_scheduler_type %r — falling back to the linear "
        "warmup/decay schedule",
        lr_scheduler_type,
    )
    return linear_warmup_decay_schedule(base_lr, warmup_steps, max_train_steps)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, as optax.global_norm."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


@dataclasses.dataclass
class OptState:
    """AdamW's state. Every optimizer state keeps ``count``, ``mini_step``
    and ``acc_grads`` under these names; its other fields are lists of
    tensors (or of None), one entry a parameter (``training/checkpoint.py``
    saves them by field)."""

    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    # updates applied so far: Adam's bias-correction count and the
    # schedule's count
    count: int = 0
    # gradient accumulation (k > 1): micro-steps taken since the last update
    # and the running mean of their gradients
    mini_step: int = 0
    acc_grads: Optional[List[torch.Tensor]] = None


@dataclasses.dataclass
class FactoredState:
    """Adafactor's state (optax ``FactoredState``): per parameter, the row
    and column moments of a factored parameter (None otherwise) and the full
    moment of an unfactored one (None otherwise)."""

    v_row: List[Optional[torch.Tensor]]
    v_col: List[Optional[torch.Tensor]]
    v: List[Optional[torch.Tensor]]
    count: int = 0
    mini_step: int = 0
    acc_grads: Optional[List[torch.Tensor]] = None


class _Optimizer:
    """Global-norm clipping and the optimizer, wrapped in
    ``optax.MultiSteps`` when ``every_k > 1``; parameters and gradients are
    dicts keyed by parameter name, updated in place."""

    def __init__(self, schedule: Schedule, max_grad_norm: float, every_k: int = 1,
                 summed_grads: bool = False):
        self.schedule = schedule
        self.max_grad_norm = max_grad_norm
        self.every_k = max(1, int(every_k))
        # the data-parallel step sums the micro-steps' gradients in the
        # parameters' .grad (DDP's no_sync) and reads them on the k-th
        # (update_summed): the state then holds no accumulator
        self.summed_grads = bool(summed_grads)
        # parallel/zero.py's ZeroLayout when each rank updates slices of the
        # parameters: whole shapes, and the reductions over the slices
        self.shards = None

    def _acc_grads(self, ps: List[torch.Tensor]) -> Optional[List[torch.Tensor]]:
        if self.every_k == 1 or self.summed_grads:
            return None
        return [torch.zeros_like(p) for p in ps]

    def _shape(self, i: int, p: torch.Tensor) -> Tuple[int, ...]:
        return tuple(p.shape) if self.shards is None else self.shards.whole_shapes[i]

    def _norms(self, ts: List[torch.Tensor]) -> List[torch.Tensor]:
        if self.shards is None:
            return list(torch._foreach_norm(ts))
        return self.shards.norms(range(len(ts)), ts)

    def _clip(self, g: List[torch.Tensor]) -> List[torch.Tensor]:
        if self.max_grad_norm and self.max_grad_norm > 0:
            norm = (global_norm(g) if self.shards is None
                    else self.shards.global_norm(g))
            scale = torch.where(norm < self.max_grad_norm, torch.ones_like(norm),
                                self.max_grad_norm / norm)
            g = torch._foreach_mul(g, scale)
        return g

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: OptState,
               params: Dict[str, torch.Tensor]) -> bool:
        """Apply one micro-step; returns whether the parameters were updated
        (always with ``every_k == 1``; on every k-th micro-step otherwise)."""
        g = [grads[name] for name in params]
        if self.every_k > 1:
            # the Welford mean of optax.MultiSteps: acc + (g - acc) / (n + 1)
            delta = torch._foreach_sub(g, state.acc_grads)
            torch._foreach_div_(delta, float(state.mini_step + 1))
            torch._foreach_add_(state.acc_grads, delta)
            if state.mini_step < self.every_k - 1:
                state.mini_step += 1
                return False
            g = state.acc_grads
        self._apply(self._clip(g), state, [p.detach() for p in params.values()])
        if self.every_k > 1:
            state.mini_step = 0
            for a in state.acc_grads:
                a.zero_()
        return True

    @torch.no_grad()
    def update_summed(self, grads: Dict[str, torch.Tensor], state,
                      params: Dict[str, torch.Tensor]) -> bool:
        """One micro-step where the gradient accumulates outside the state
        (DDP's ``no_sync``): ``grads`` is the sum of the micro-steps' since
        the last update, read on every k-th micro-step only."""
        if state.mini_step < self.every_k - 1:
            state.mini_step += 1
            return False
        g = [grads[name] for name in params]
        if self.every_k > 1:
            g = torch._foreach_div(g, float(self.every_k))
        self._apply(self._clip(g), state, [p.detach() for p in params.values()])
        state.mini_step = 0
        return True


class AdamW(_Optimizer):
    """``optax.chain(clip_by_global_norm, adamw)``, in ``MultiSteps`` when
    ``every_k > 1``."""

    def __init__(self, schedule: Schedule, b1: float, b2: float, eps: float,
                 weight_decay: float, max_grad_norm: float, every_k: int = 1,
                 summed_grads: bool = False):
        super().__init__(schedule, max_grad_norm, every_k, summed_grads)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay

    def init(self, params: Dict[str, torch.Tensor]) -> OptState:
        ps = [p.detach() for p in params.values()]
        return OptState(mu=[torch.zeros_like(p) for p in ps],
                        nu=[torch.zeros_like(p) for p in ps], acc_grads=self._acc_grads(ps))

    def _apply(self, g: List[torch.Tensor], state: OptState, ps: List[torch.Tensor]) -> None:
        lr = self.schedule(state.count)
        state.count += 1
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, g, alpha=1.0 - b1)
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_addcmul_(state.nu, g, g, value=1.0 - b2)
        denom = torch._foreach_div(state.nu, 1.0 - b2 ** state.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(state.mu, 1.0 - b1 ** state.count)
        torch._foreach_div_(upd, denom)
        if self.weight_decay:
            torch._foreach_add_(upd, ps, alpha=self.weight_decay)
        torch._foreach_add_(ps, upd, alpha=-lr)


# optax 0.2.6's adafactor defaults (module docstring); no config key sets them
_MIN_DIM_SIZE_TO_FACTOR = 128
_DECAY_RATE = 0.8
_EPS = 1e-30
_CLIPPING_THRESHOLD = 1.0
_MIN_SCALE = 1e-3


def factored_dims(shape: Sequence[int]) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims``: the second largest and the largest axis
    (of equal sizes the later counts as the larger, as numpy's argsort of a
    short shape orders them), or None when the second largest is below 128
    entries. The port's OIHW and (out, in) weights pick the same two axes as
    JAX's HWIO and (in, out) ones, in the other order; the factored
    estimate, a product of their two means over the mean of all, is the
    same either way."""
    if len(shape) < 2:
        return None
    order = sorted(range(len(shape)), key=lambda i: shape[i])
    if shape[order[-2]] < _MIN_DIM_SIZE_TO_FACTOR:
        return None
    return order[-2], order[-1]


class Adafactor(_Optimizer):
    """``optax.chain(clip_by_global_norm, adafactor)`` with optax 0.2.6's
    defaults (module docstring), in ``MultiSteps`` when ``every_k > 1``."""

    def __init__(self, schedule: Schedule, weight_decay: float, max_grad_norm: float,
                 every_k: int = 1, summed_grads: bool = False):
        super().__init__(schedule, max_grad_norm, every_k, summed_grads)
        self.weight_decay = weight_decay

    def init(self, params: Dict[str, torch.Tensor]) -> FactoredState:
        ps = [p.detach() for p in params.values()]
        v_row, v_col, v = [], [], []
        for i, p in enumerate(ps):
            dims = factored_dims(self._shape(i, p))
            if dims is None:
                v_row.append(None)
                v_col.append(None)
                v.append(torch.zeros_like(p))
            else:
                d1, d0 = dims
                v_row.append(torch.zeros_like(p.select(d0, 0)))
                v_col.append(torch.zeros_like(p.select(d1, 0)))
                v.append(None)
        return FactoredState(v_row=v_row, v_col=v_col, v=v, acc_grads=self._acc_grads(ps))

    def _apply(self, g: List[torch.Tensor], state: FactoredState,
               ps: List[torch.Tensor]) -> None:
        f32 = np.float32
        # optax's decay, in fp32: 1 - (count + 1) ** -0.8
        decay = f32(1.0) - f32(state.count + 1) ** f32(-_DECAY_RATE)
        keep, take = float(decay), float(f32(1.0) - decay)
        lr = self.schedule(state.count)
        state.count += 1
        sq = torch._foreach_mul(g, g)
        torch._foreach_add_(sq, _EPS)
        full = [i for i, v in enumerate(state.v) if v is not None]
        upd: List[Optional[torch.Tensor]] = [None] * len(g)
        if full:
            vs = [state.v[i] for i in full]
            torch._foreach_mul_(vs, keep)
            torch._foreach_add_(vs, torch._foreach_mul([sq[i] for i in full], take))
            rs = torch._foreach_rsqrt(vs)
            for i, u in zip(full, torch._foreach_mul([g[i] for i in full], rs)):
                upd[i] = u
        shards = self.shards
        for i, v_row in enumerate(state.v_row):
            if v_row is None:
                continue
            d1, d0 = factored_dims(self._shape(i, g[i]))
            v_col = state.v_col[i]
            r1 = d1 - 1 if d1 > d0 else d1
            if shards is None:
                row, col = sq[i].mean(dim=d0), sq[i].mean(dim=d1)
            else:
                # a rank holding a slice of the axis a mean runs over adds
                # its sums to the other ranks'
                row = shards.axis_mean(i, sq[i], d0, d0)
                col = shards.axis_mean(i, sq[i], d1, d1)
            v_row.mul_(keep).add_(row * take)
            v_col.mul_(keep).add_(col * take)
            row_col_mean = (v_row.mean(dim=r1, keepdim=True) if shards is None
                            else shards.axis_mean(i, v_row, r1, d1).unsqueeze(r1))
            row_factor = (v_row / row_col_mean).rsqrt()
            upd[i] = g[i] * row_factor.unsqueeze(d0) * v_col.rsqrt().unsqueeze(d1)
        # clip each update to a block RMS of 1, then the learning rate and
        # the parameter's RMS (at least 1e-3); the
        # RMS is the norm over sqrt(numel), a host float: no device copy
        roots = [math.sqrt(math.prod(self._shape(i, p))) for i, p in enumerate(ps)]
        denom = torch._foreach_div(self._norms(upd), roots)
        torch._foreach_div_(denom, _CLIPPING_THRESHOLD)
        torch._foreach_clamp_min_(denom, 1.0)
        p_rms = torch._foreach_div(self._norms(ps), roots)
        torch._foreach_clamp_min_(p_rms, _MIN_SCALE)
        torch._foreach_div_(upd, denom)
        torch._foreach_mul_(upd, lr)
        torch._foreach_mul_(upd, p_rms)
        if self.weight_decay:
            torch._foreach_add_(upd, ps, alpha=self.weight_decay)
        torch._foreach_sub_(ps, upd)


def build_optimizer(
    learning_rate: float,
    warmup_steps: int,
    max_train_steps: int,
    adam_beta1: float = 0.9,
    adam_beta2: float = 0.999,
    adam_weight_decay: float = 1e-2,
    adam_epsilon: float = 1e-8,
    max_grad_norm: float = 1.0,
    gradient_accumulation_steps: int = 1,
    optimizer: str = "adamw",
    lr_scheduler_type: str = "linear",
    summed_grads: bool = False,
) -> Tuple[Union[AdamW, Adafactor], Schedule]:
    """AdamW or Adafactor with global-norm clipping and the learning-rate
    schedule, with optional gradient accumulation; the JAX package's
    ``build_optimizer``. Adafactor ignores the Adam betas and epsilon, and
    takes ``adam_weight_decay`` as its decoupled weight decay rate.
    ``summed_grads`` is for the data-parallel step: the micro-steps'
    gradients sum in the parameters' .grad and the state keeps no
    accumulator."""
    schedule = make_lr_schedule(lr_scheduler_type, learning_rate, warmup_steps,
                                max_train_steps)
    if optimizer == "adafactor":
        return Adafactor(schedule, adam_weight_decay or 0.0, max_grad_norm or 0.0,
                         gradient_accumulation_steps, summed_grads), schedule
    if optimizer != "adamw":
        raise ValueError(
            f"Unknown training.optimizer '{optimizer}' (expected 'adamw' or 'adafactor')"
        )
    tx = AdamW(schedule, adam_beta1, adam_beta2, adam_epsilon, adam_weight_decay,
               max_grad_norm or 0.0, gradient_accumulation_steps, summed_grads)
    return tx, schedule


def _masked_mean(per_sample: torch.Tensor, mask: torch.Tensor,
                 count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The masked sum over ``count`` valid rows (the mask's own sum by
    default; a rank's share of the global mean with the global count)."""
    count = mask.sum() if count is None else count
    return (per_sample * mask).sum() / count.clamp_min(1.0)


def dequantize_pixels(pixel_values: torch.Tensor) -> torch.Tensor:
    """uint8 pixels to [-1, 1] fp32 (v / 127.5 - 1) on their device; float
    pixels pass through."""
    if pixel_values.dtype == torch.uint8:
        return pixel_values.float() / 127.5 - 1.0
    return pixel_values


def _losses(out, pixel_values: torch.Tensor, mask: torch.Tensor,
            count: Optional[torch.Tensor] = None, shards: int = 1):
    """The masked MSE and KL; over ``shards`` row shards each rank's are
    its rows' shares (the mean over every element of the whole image, the
    KL's sum over its latent rows), which add up over the shards."""
    recon = out["reconstruction"].float()
    pixels = pixel_values.float()
    sq = (recon - pixels).square().mean(dim=tuple(range(1, recon.dim())))
    if shards > 1:
        sq = sq / float(shards)
    return (_masked_mean(sq, mask, count),
            _masked_mean(out["latent_dist"].kl(), mask, count))


def default_stats_accumulate(
    acc: Dict[str, torch.Tensor], stats: Dict[str, torch.Tensor]
) -> Dict[str, torch.Tensor]:
    """Running sums of per-forward statistics; the interval mean is sum /
    count."""
    return {k: acc[k] + stats[k] for k in acc} if acc else {}


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _nchw_pixels(batch, device, sp: Optional[SpatialGroup] = None) -> torch.Tensor:
    """The batch's NHWC pixels as NCHW [-1, 1] on ``device``: this rank's
    block of their rows under a spatial group."""
    pixels = torch.as_tensor(batch["pixel_values"]).to(device, non_blocking=True)
    pixels = row_block(pixels, sp, dim=1)
    return dequantize_pixels(pixels).permute(0, 3, 1, 2).contiguous()


def _blend_ema(state: TrainState, params: Dict[str, torch.Tensor], ema_decay: float) -> None:
    ema = list(state.ema_params.values())
    with torch.no_grad():
        torch._foreach_mul_(ema, ema_decay)
        torch._foreach_add_(ema, [params[k].detach() for k in state.ema_params],
                            alpha=1.0 - ema_decay)


def make_train_step(
    model: torch.nn.Module,
    tx: AdamW,
    kl_weight: float,
    stats_accumulate: Optional[Callable] = None,
    map_keys: Tuple[str, ...] = (),
    ema_decay: float = 0.0,
    axis=None,
    forward_module: Optional[torch.nn.Module] = None,
):
    """Build the train step for ``model`` (an ``AutoencoderKL``).

    Returns ``step_fn(state, batch, mask, rng=None, *, noise=None) ->
    (state, metrics, maps)``. ``batch["pixel_values"]`` is NHWC, uint8 or
    float in [-1, 1], best already on the model's device; ``mask`` is the
    (B,) validity mask. The posterior noise is drawn from the
    ``torch.Generator`` ``rng``, or is the NHWC standard-normal ``noise``
    given (tests inject the JAX step's). ``metrics`` holds 0-d device
    tensors; ``maps`` the full activation maps captured under ``map_keys``.

    With ``axis`` (a ``parallel.DataAxis``) the step is this rank's part of
    a step over the ``data`` axis, and over the ``spatial`` axis where it
    has one; without it, the step of one process, which is the same step
    with no collective. ``forward_module`` is
    ``model`` wrapped in DDP (its gradients arrive all-reduced and averaged
    over the ranks) or ``model`` itself under FSDP2 (reduce-scattered and
    averaged). The loss each rank differentiates is its masked sums over
    the GLOBAL valid count, times the world size to undo that average, so
    the gradient is the one-process gradient of the global batch whatever
    each rank's share of valid rows. The tap metrics take the same global
    count (``ops.stats.tap_mask``), and their shares, the losses' and the
    reported metrics' are summed in one collective after the backward;
    ``std_activation`` reduces itself. The gradient norm is the global one
    on every rank, so every rank clips alike. Without ``noise`` the
    posterior noise is this rank's rows of the global draw from ``rng``
    (the loaders' strided shards: local row j is global row
    ``j * world + rank``), so W ranks draw what one process draws at the
    same global batch.

    Over the ``spatial`` axis (S ranks a spatial group) every rank of a
    group gets the same images (``batch``, ``mask`` and ``noise`` of its
    data rank) and keeps its block of their rows and of the latent rows; the
    forward and the backward run under ``ops.spatial_conv
    .spatial_conv_scope``, so the convs exchange halos, the GroupNorms and
    taps sum over the row shards and the attention gathers K and V. The
    MSE and KL each rank differentiates are its rows' shares, the count is
    the data axis's, the gradient all-reduce (DDP or FSDP2) runs over all
    D x S ranks and its 1/(D S) is undone, and the metrics and linear taps
    add up over every rank. The activation maps are gathered over rows,
    then over the data axis.

    Gradient accumulation (``tx.every_k > 1``): one process keeps optax
    ``MultiSteps``' running mean in the state and reports each micro-step's
    own gradient norm, as JAX does. Across ranks the micro-steps before the
    k-th run without the gradient collective (DDP ``no_sync``, FSDP2
    ``set_requires_gradient_sync``), the gradients sum in the parameters'
    .grad and the optimizer (built with ``summed_grads``) takes their mean
    on the k-th (``update_summed``); ``grad_norm`` is then the norm of the
    mean so far, which on the k-th micro-step is the global mean the clip
    reads (before it, this rank's part): a micro-step's own global norm
    would need the collective that ``no_sync`` saves.

    Over the ``tensor`` axis (T ranks a tensor group, ``parallel.tensor``)
    every rank of a group gets the same images and rows and holds its block
    of the channels (``AutoencoderKL.shard_tensor_``); the forward and the
    backward run under ``ops.tensor_parallel.tensor_scope``. The
    reconstruction and the posterior are whole on every rank of the group,
    so the losses are; the gradient all-reduce (DDP or FSDP2) runs over the
    ranks of this rank's tensor index only, and its 1/(D S) is undone. The
    losses and the per-channel tap blocks are summed over those ranks, the
    scalar taps' shares over every rank. The gradient norm adds the sharded
    leaves' squares over the tensor group (``ZeroLayout.norms``), so every
    rank clips as one card does.

    ``state.layout`` (``parallel.zero.ZeroLayout``) gives the slices that
    the optimizer and the EMA update under the ZeRO flags and the tensor
    axis; the slices the optimizer updated are all-gathered after it
    (ZeRO-1)."""
    from ..ops.stats import SUMMED_METRICS

    accumulate = stats_accumulate or default_stats_accumulate
    device = _device_of(model) if axis is None else axis.device
    # the gradient's ranks, and the batch's shards and this rank's shard
    world = 1 if axis is None else axis.replica_world
    data_world, data_rank = (1, 0) if axis is None else (axis.data_world, axis.data_rank)
    data_group = None if axis is None else axis.data_group
    sp = SpatialGroup.of(axis)
    tp = TensorGroup.of(axis)
    shards = 1 if sp is None else sp.size
    summed = axis is not None and tx.every_k > 1
    if summed and not tx.summed_grads:
        raise ValueError("a data-parallel step with gradient accumulation needs the "
                         "optimizer built with summed_grads=True")
    forward_module = forward_module if forward_module is not None else model
    ddp = isinstance(forward_module, torch.nn.parallel.DistributedDataParallel)

    def step_fn(state: TrainState, batch, mask, rng: Optional[torch.Generator] = None,
                *, noise=None):
        if rng is None and noise is None:
            raise ValueError("pass a torch.Generator (rng) or the posterior noise")
        layout = state.layout
        x = _nchw_pixels(batch, device, sp)
        mask_t = torch.as_tensor(mask, dtype=torch.float32).to(device, non_blocking=True)
        if noise is not None:
            noise_t = row_block(torch.as_tensor(noise).to(device), sp, dim=1).permute(0, 3, 1, 2)
        elif axis is not None and axis.world > 1:
            cfg = model.config
            down = 2 ** (len(cfg.block_out_channels) - 1)
            shape = (x.shape[0] * data_world, cfg.latent_channels,
                     x.shape[2] * shards // down, x.shape[3] // down)
            noise_t = row_block(torch.randn(shape, generator=rng, dtype=torch.float32,
                                            device=device)[data_rank::data_world], sp)
        else:
            noise_t = None  # the posterior draws from rng
        # one process reads nothing of the optimizer's state here: the
        # optimizer may be a stand-in that keeps none
        opt = state.opt_state
        if not summed or opt.mini_step == 0:
            for p in state.model.parameters():
                p.grad = None
        count = None
        quiet = contextlib.nullcontext()
        if axis is not None:
            last = not summed or opt.mini_step >= tx.every_k - 1
            count = mask_t.sum()
            dist.all_reduce(count, group=data_group)
            if not ddp:
                forward_module.set_requires_gradient_sync(last)
            elif not last:
                quiet = forward_module.no_sync()
        # the taps weight per-sample contributions by the mask while the
        # forward runs, so pad rows carry zero weight
        with quiet, tap_mask(mask_t, count=count, reduce=axis is not None), \
                spatial_conv_scope(sp), tensor_scope(tp):
            out, stats = forward_with_stats(forward_module, x, True, generator=rng,
                                            noise=noise_t)
            rec_loss, kl_loss = _losses(out, x, mask_t, count, shards)
            loss = rec_loss + kl_weight * kl_loss
            (loss * float(world) if world > 1 else loss).backward()

        maps = {k: stats.pop(k) for k in map_keys if k in stats}
        if axis is not None:
            summed_keys = [k for k in stats if k.rsplit(".", 1)[-1] in SUMMED_METRICS]
            flat = torch.cat([torch.stack([rec_loss, kl_loss]).detach()]
                             + [stats[k].reshape(-1) for k in summed_keys])
            # over the ranks of this tensor index: the losses are whole on
            # every rank of a tensor group, the per-channel taps its blocks
            dist.all_reduce(flat, group=None if tp is None else tp.replicas)
            rec_loss, kl_loss = flat[0], flat[1]
            loss = rec_loss + kl_weight * kl_loss
            off = 2
            for k in summed_keys:
                size = stats[k].numel()
                stats[k] = flat[off:off + size].view(stats[k].shape)
                off += size
            scalars = [k for k in summed_keys if stats[k].dim() == 0]
            if tp is not None and scalars:
                # a scalar tap is each tensor rank's share too
                shares = torch.stack([stats[k] for k in scalars])
                dist.all_reduce(shares, group=tp.group)
                stats.update(zip(scalars, shares.unbind()))
            for k, v in maps.items():
                # the data ranks' rows (each map whole over the image's rows
                # already), back in the one-process batch's order
                rows = all_gather_rows(v, data_world, data_group)
                maps[k] = rows.transpose(0, 1).reshape((-1,) + tuple(v.shape[1:]))

        if layout is None:
            params = dict(state.model.named_parameters())
            grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                     for n, p in params.items()}
            grad_norm = global_norm(list(grads.values()))
        else:
            params = layout.opt_params(state.model)
            grads = layout.opt_grads(state.model)
            grad_norm = layout.global_norm(list(grads.values()))
        if summed:
            grad_norm = grad_norm / float(opt.mini_step + 1)
            applied = tx.update_summed(grads, opt, params)
        else:
            applied = tx.update(grads, opt, params)
        if applied or not summed:
            for p in state.model.parameters():
                p.grad = None
        if applied and layout is not None:
            layout.sync_params(state.model)

        state.stats_acc = accumulate(state.stats_acc, stats)
        state.stats_count += 1.0
        if ema_decay > 0.0 and state.ema_params is not None and applied:
            # blend only on micro-steps where the optimizer applied an update:
            # k-step accumulation would otherwise decay the EMA k times
            views = (layout.ema_views(state.model) if layout is not None
                     else dict(state.model.named_parameters()))
            _blend_ema(state, views, ema_decay)
        state.step += 1
        metrics = {
            "train_loss_step": loss.detach(),
            "rec_loss": rec_loss.detach(),
            "kl_loss": kl_loss.detach(),
            "grad_norm": grad_norm,
        }
        return state, metrics, maps

    return step_fn


def make_eval_step(model: torch.nn.Module, axis=None):
    """Deterministic (posterior mode) forward with SUM-convention losses for
    validation, plus the per-element-mean MSE the evaluation CLI uses.
    Returns ``eval_fn(batch, mask) -> dict`` with an NHWC reconstruction.

    Over a spatial group (``axis`` with ``spatial`` > 1) each rank runs its
    rows of the images under the scope: its sums are its rows' shares, which
    add up over the group, ``num_samples`` counts on the group's first rank
    only, so that a sum over every rank counts each image once, and the
    reconstruction is gathered over the rows, whole on every rank.

    Over a tensor group each rank runs its channel blocks under the scope
    (the model's parameters are its blocks); the outputs are whole on every
    rank of the group, so its sums count on the group's first rank only,
    so that a sum over every rank counts each image once."""
    device = _device_of(model)
    sp = SpatialGroup.of(axis)
    tp = TensorGroup.of(axis)
    counted = 1.0 if tp is None or tp.index == 0 else 0.0

    @torch.no_grad()
    def eval_fn(batch, mask):
        x = _nchw_pixels(batch, device, sp)
        mask_t = torch.as_tensor(mask, dtype=torch.float32).to(device) * counted
        with spatial_conv_scope(sp), tensor_scope(tp):
            out, _stats = forward_with_stats(model, x, sample_posterior=False)
        recon = out["reconstruction"].float()
        per_sample_sq_sum = (recon - x.float()).square().sum(dim=(1, 2, 3))
        kl = out["latent_dist"].kl()
        n_pixel_dims = recon[0].numel() * (1 if sp is None else sp.size)
        reconstruction = out["reconstruction"]
        if sp is not None:
            reconstruction = gather_rows(reconstruction, 2, sp)
        return {
            "rec_loss_sum": (per_sample_sq_sum * mask_t).sum(),
            "kl_sum": (kl * mask_t).sum(),
            "mse_mean_weighted": (per_sample_sq_sum * mask_t).sum() / n_pixel_dims,
            "num_samples": mask_t.sum() if sp is None or sp.index == 0 else mask_t.sum() * 0.0,
            "reconstruction": reconstruction.permute(0, 2, 3, 1),
        }

    return eval_fn


__all__ = [
    "Adafactor",
    "AdamW",
    "FactoredState",
    "OptState",
    "build_optimizer",
    "default_stats_accumulate",
    "dequantize_pixels",
    "factored_dims",
    "global_norm",
    "linear_warmup_decay_schedule",
    "make_eval_step",
    "make_lr_schedule",
    "make_train_step",
]
