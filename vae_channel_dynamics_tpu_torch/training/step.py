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
* ``MultiSteps`` gradient accumulation: the running mean of k micro-step
  gradients goes through the two above on every k-th micro-step, and the
  schedule's count advances only then.

PyTorch runs eagerly, so there is no jit: a step runs the forward under the
tap mask, the backward, the update in place on the fp32 master parameters
(``torch._foreach`` ops), the stats accumulation and the EMA blend, and it
never waits for the device: the learning rate and the accumulation counter
are host integers, and every metric stays a 0-d device tensor until the
caller reads it.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..models.wrapper import forward_with_stats
from ..ops.stats import tap_mask
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
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    # updates applied so far: Adam's bias-correction count and the
    # schedule's count
    count: int = 0
    # gradient accumulation (k > 1): micro-steps taken since the last update
    # and the running mean of their gradients
    mini_step: int = 0
    acc_grads: Optional[List[torch.Tensor]] = None


class AdamW:
    """``optax.chain(clip_by_global_norm, adamw)``, wrapped in
    ``optax.MultiSteps`` when ``every_k > 1``; parameters and gradients are
    dicts keyed by parameter name, updated in place."""

    def __init__(self, schedule: Schedule, b1: float, b2: float, eps: float,
                 weight_decay: float, max_grad_norm: float, every_k: int = 1):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.every_k = max(1, int(every_k))

    def init(self, params: Dict[str, torch.Tensor]) -> OptState:
        ps = [p.detach() for p in params.values()]
        return OptState(
            mu=[torch.zeros_like(p) for p in ps],
            nu=[torch.zeros_like(p) for p in ps],
            acc_grads=[torch.zeros_like(p) for p in ps] if self.every_k > 1 else None,
        )

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
        self._apply(g, state, [p.detach() for p in params.values()])
        if self.every_k > 1:
            state.mini_step = 0
            for a in state.acc_grads:
                a.zero_()
        return True

    def _apply(self, g: List[torch.Tensor], state: OptState, ps: List[torch.Tensor]) -> None:
        if self.max_grad_norm and self.max_grad_norm > 0:
            norm = global_norm(g)
            scale = torch.where(norm < self.max_grad_norm, torch.ones_like(norm),
                                self.max_grad_norm / norm)
            g = torch._foreach_mul(g, scale)
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
) -> Tuple[AdamW, Schedule]:
    """AdamW with global-norm clipping and the learning-rate schedule, with
    optional gradient accumulation; the JAX package's ``build_optimizer``.
    ``adafactor`` is not ported yet."""
    schedule = make_lr_schedule(lr_scheduler_type, learning_rate, warmup_steps,
                                max_train_steps)
    if optimizer == "adafactor":
        raise NotImplementedError(
            "training.optimizer 'adafactor' is not yet ported to PyTorch "
            "(ROADMAP Q1 item 2); use 'adamw'"
        )
    if optimizer != "adamw":
        raise ValueError(
            f"Unknown training.optimizer '{optimizer}' (expected 'adamw' or 'adafactor')"
        )
    tx = AdamW(schedule, adam_beta1, adam_beta2, adam_epsilon, adam_weight_decay,
               max_grad_norm or 0.0, gradient_accumulation_steps)
    return tx, schedule


def _masked_mean(per_sample: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return (per_sample * mask).sum() / mask.sum().clamp_min(1.0)


def dequantize_pixels(pixel_values: torch.Tensor) -> torch.Tensor:
    """uint8 pixels to [-1, 1] fp32 (v / 127.5 - 1) on their device; float
    pixels pass through."""
    if pixel_values.dtype == torch.uint8:
        return pixel_values.float() / 127.5 - 1.0
    return pixel_values


def _losses(out, pixel_values: torch.Tensor, mask: torch.Tensor):
    recon = out["reconstruction"].float()
    pixels = pixel_values.float()
    sq = (recon - pixels).square().mean(dim=tuple(range(1, recon.dim())))
    return _masked_mean(sq, mask), _masked_mean(out["latent_dist"].kl(), mask)


def default_stats_accumulate(
    acc: Dict[str, torch.Tensor], stats: Dict[str, torch.Tensor]
) -> Dict[str, torch.Tensor]:
    """Running sums of per-forward statistics; the interval mean is sum /
    count."""
    return {k: acc[k] + stats[k] for k in acc} if acc else {}


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _nchw_pixels(batch, device) -> torch.Tensor:
    pixels = torch.as_tensor(batch["pixel_values"]).to(device, non_blocking=True)
    return dequantize_pixels(pixels).permute(0, 3, 1, 2).contiguous()


def make_train_step(
    model: torch.nn.Module,
    tx: AdamW,
    kl_weight: float,
    stats_accumulate: Optional[Callable] = None,
    map_keys: Tuple[str, ...] = (),
    ema_decay: float = 0.0,
):
    """Build the train step for ``model`` (an ``AutoencoderKL``).

    Returns ``step_fn(state, batch, mask, rng=None, *, noise=None) ->
    (state, metrics, maps)``. ``batch["pixel_values"]`` is NHWC, uint8 or
    float in [-1, 1], best already on the model's device; ``mask`` is the
    (B,) validity mask. The posterior noise is drawn from the
    ``torch.Generator`` ``rng``, or is the NHWC standard-normal ``noise``
    given (tests inject the JAX step's). ``metrics`` holds 0-d device
    tensors; ``maps`` the full activation maps captured under ``map_keys``.
    """
    accumulate = stats_accumulate or default_stats_accumulate
    device = _device_of(model)

    def step_fn(state: TrainState, batch, mask, rng: Optional[torch.Generator] = None,
                *, noise=None):
        if rng is None and noise is None:
            raise ValueError("pass a torch.Generator (rng) or the posterior noise")
        x = _nchw_pixels(batch, device)
        mask_t = torch.as_tensor(mask, dtype=torch.float32).to(device, non_blocking=True)
        noise_t = (None if noise is None
                   else torch.as_tensor(noise).to(device).permute(0, 3, 1, 2))
        params = dict(state.model.named_parameters())
        for p in params.values():
            p.grad = None
        # the taps weight per-sample contributions by the mask while the
        # forward runs, so pad rows carry zero weight
        with tap_mask(mask_t):
            out, stats = forward_with_stats(state.model, x, True, generator=rng,
                                            noise=noise_t)
            rec_loss, kl_loss = _losses(out, x, mask_t)
            loss = rec_loss + kl_weight * kl_loss
            loss.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        grad_norm = global_norm(list(grads.values()))
        applied = tx.update(grads, state.opt_state, params)
        for p in params.values():
            p.grad = None

        maps = {k: stats[k] for k in map_keys if k in stats}
        scalar_stats = {k: v for k, v in stats.items() if k not in maps}
        state.stats_acc = accumulate(state.stats_acc, scalar_stats)
        state.stats_count += 1.0
        if ema_decay > 0.0 and state.ema_params is not None and applied:
            # blend only on micro-steps where the optimizer applied an update:
            # k-step accumulation would otherwise decay the EMA k times
            ema = list(state.ema_params.values())
            with torch.no_grad():
                torch._foreach_mul_(ema, ema_decay)
                torch._foreach_add_(ema, [params[k].detach() for k in state.ema_params],
                                    alpha=1.0 - ema_decay)
        state.step += 1
        metrics = {
            "train_loss_step": loss.detach(),
            "rec_loss": rec_loss.detach(),
            "kl_loss": kl_loss.detach(),
            "grad_norm": grad_norm,
        }
        return state, metrics, maps

    return step_fn


def make_eval_step(model: torch.nn.Module):
    """Deterministic (posterior mode) forward with SUM-convention losses for
    validation, plus the per-element-mean MSE the evaluation CLI uses.
    Returns ``eval_fn(batch, mask) -> dict`` with an NHWC reconstruction."""
    device = _device_of(model)

    @torch.no_grad()
    def eval_fn(batch, mask):
        x = _nchw_pixels(batch, device)
        mask_t = torch.as_tensor(mask, dtype=torch.float32).to(device)
        out, _stats = forward_with_stats(model, x, sample_posterior=False)
        recon = out["reconstruction"].float()
        per_sample_sq_sum = (recon - x.float()).square().sum(dim=(1, 2, 3))
        kl = out["latent_dist"].kl()
        n_pixel_dims = recon[0].numel()
        return {
            "rec_loss_sum": (per_sample_sq_sum * mask_t).sum(),
            "kl_sum": (kl * mask_t).sum(),
            "mse_mean_weighted": (per_sample_sq_sum * mask_t).sum() / n_pixel_dims,
            "num_samples": mask_t.sum(),
            "reconstruction": out["reconstruction"].permute(0, 2, 3, 1),
        }

    return eval_fn


__all__ = [
    "AdamW",
    "OptState",
    "build_optimizer",
    "default_stats_accumulate",
    "dequantize_pixels",
    "global_norm",
    "linear_warmup_decay_schedule",
    "make_eval_step",
    "make_lr_schedule",
    "make_train_step",
]
