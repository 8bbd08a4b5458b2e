"""The port's train step against the JAX package's ``make_train_step``, on the
CPU.

A 3-step trajectory of the narrow 128-channel model with ``impl="pallas"``
on both sides (the JAX Pallas GroupNorm in interpret mode, the port's plain
versions on CPU tensors), fp32, from the same parameters, the same uint8
batches (dequantized on each side), a mask with one pad row, the monitor's
taps accumulating, and AdamW with a clip below the first gradient norm. The
posterior noise is the JAX step's own draw, ``normal(fold_in(rng, step))``,
injected into the port. Compared per step: loss, rec, kl, grad_norm and lr;
then stats_acc, stats_count and every parameter's delta.

Tolerances, as tests/test_train_trajectory_torch_parity.py: losses rtol
2e-4, grad norms 5e-4, lr 1e-6, parameter deltas 2e-3 of their largest
entry; the accumulated stats rtol 1e-4.

Then, cheaply, the optimizer pieces against optax: the four lr schedules,
clipping that triggers and that does not, k=2 accumulation, the EMA blend
with and without it, and uint8 dequantization.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_taps import NARROW, seeded_pair

from vae_channel_dynamics_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from vae_channel_dynamics_tpu.models.vae import VAEConfig as JaxConfig
from vae_channel_dynamics_tpu.tracking import ActivityMonitor as JaxMonitor
from vae_channel_dynamics_tpu.training import TrainState as JaxTrainState
from vae_channel_dynamics_tpu.training import build_optimizer as jax_build_optimizer
from vae_channel_dynamics_tpu.training import make_eval_step as jax_make_eval_step
from vae_channel_dynamics_tpu.training import make_lr_schedule as jax_make_lr_schedule
from vae_channel_dynamics_tpu.training import make_train_step as jax_make_train_step
from vae_channel_dynamics_tpu.training.step import dequantize_pixels as jax_dequantize
from vae_channel_dynamics_tpu_torch.tracking import ActivityMonitor
from vae_channel_dynamics_tpu_torch.training import (
    TrainState,
    build_optimizer,
    make_eval_step,
    make_lr_schedule,
    make_train_step,
)
from vae_channel_dynamics_tpu_torch.training.step import dequantize_pixels, global_norm

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

N_STEPS, BATCH, RES = 3, 3, 16
LR, WARMUP, MAX_STEPS = 2e-3, 1, 6
WD, EPS, KL_WEIGHT = 0.1, 1e-8, 1e-6
MASK = np.array([1.0, 1.0, 0.0], np.float32)
TRACKING = {
    "enabled": True,
    "track_interval": 3,
    "target_layers": [
        {"name": "vae.encoder.down_blocks.0.resnets.0.norm1", "capture_point": "output",
         "metrics": ["mean_abs_activation_per_channel"]},
        {"name": "vae.decoder.up_blocks.1.resnets.0.norm1", "capture_point": "output",
         "metrics": ["mean_abs_activation_per_channel"]},
        {"name": "vae.encoder.conv_in", "capture_point": "output",
         "metrics": ["mean_activation", "zero_fraction_per_channel"]},
    ],
}


def _batches():
    rng = np.random.default_rng(11)
    return [rng.integers(0, 256, (BATCH, RES, RES, 3), dtype=np.uint8)
            for _ in range(N_STEPS)]


@pytest.fixture(scope="module")
def trajectories():
    model, params = seeded_pair(5, impl="pallas")
    initial = {k: v.detach().clone() for k, v in model.state_dict().items()}
    batches = _batches()
    base_rng = jax.random.PRNGKey(123)
    latent_shape = (BATCH, RES // 2, RES // 2, 4)
    noises = [np.array(jax.random.normal(jax.random.fold_in(base_rng, t), latent_shape,
                                         jnp.float32)) for t in range(N_STEPS)]

    # the port: clip below its first gradient norm, so clipping triggers
    monitor = ActivityMonitor(TRACKING)
    model.set_capture(monitor.scalar_capture_table)
    probe_tx, _ = build_optimizer(0.0, 0, 1, max_grad_norm=0.0)
    probe = TrainState.create(model, probe_tx)
    _s, probe_metrics, _m = make_train_step(model, probe_tx, KL_WEIGHT)(
        probe, {"pixel_values": batches[0]}, MASK, noise=noises[0])
    max_grad_norm = 0.7 * float(probe_metrics["grad_norm"])
    model.load_state_dict(initial)

    tx, sched = build_optimizer(LR, WARMUP, MAX_STEPS, adam_weight_decay=WD,
                                adam_epsilon=EPS, max_grad_norm=max_grad_norm)
    state = TrainState.create(model, tx, stats_acc=monitor.init_acc(model))
    step = make_train_step(model, tx, KL_WEIGHT, stats_accumulate=ActivityMonitor.accumulate)
    t_metrics, t_lrs = [], []
    for t in range(N_STEPS):
        t_lrs.append(sched(t))
        state, metrics, _maps = step(state, {"pixel_values": batches[t]}, MASK,
                                     noise=noises[t])
        t_metrics.append({k: float(v) for k, v in metrics.items()})

    # JAX
    jmonitor = JaxMonitor(TRACKING)
    jmodule = JaxAutoencoderKL(config=JaxConfig(**NARROW), dtype=jnp.float32,
                               impl="pallas", capture=jmonitor.scalar_capture_table)
    jtx, jsched = jax_build_optimizer(LR, WARMUP, MAX_STEPS, adam_weight_decay=WD,
                                      adam_epsilon=EPS, max_grad_norm=max_grad_norm)
    jacc = jmonitor.init_acc(jmodule, params, (BATCH, RES, RES, 3))
    jstate = JaxTrainState.create(params, jtx, stats_acc=jacc)
    jstep = jax_make_train_step(jmodule, jtx, KL_WEIGHT,
                                stats_accumulate=JaxMonitor.accumulate, donate=False)
    j_metrics, j_lrs = [], []
    for t in range(N_STEPS):
        j_lrs.append(float(jsched(t)))
        jstate, metrics, _maps = jstep(jstate, {"pixel_values": batches[t]}, MASK, base_rng)
        j_metrics.append({k: float(v) for k, v in metrics.items()})
    return {
        "initial": initial, "max_grad_norm": max_grad_norm,
        "port": (t_metrics, t_lrs, state), "jax": (j_metrics, j_lrs, jstate),
    }


def test_per_step_metrics_match_jax(trajectories):
    t_metrics, _, _ = trajectories["port"]
    j_metrics, _, _ = trajectories["jax"]
    for t, (tm, jm) in enumerate(zip(t_metrics, j_metrics)):
        for key in ("train_loss_step", "rec_loss", "kl_loss"):
            np.testing.assert_allclose(tm[key], jm[key], rtol=2e-4, err_msg=f"{key} @ {t}")
        np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"], rtol=5e-4,
                                   err_msg=f"grad_norm @ {t}")
    # the trajectory moves, and the clip fired
    assert len({round(m["train_loss_step"], 6) for m in t_metrics}) == N_STEPS
    assert any(m["grad_norm"] > trajectories["max_grad_norm"] for m in t_metrics)


def test_learning_rates_match_jax(trajectories):
    _, t_lrs, _ = trajectories["port"]
    _, j_lrs, _ = trajectories["jax"]
    np.testing.assert_allclose(t_lrs, j_lrs, rtol=1e-6)
    assert t_lrs[0] == 0.0 and max(t_lrs) == pytest.approx(LR)


def test_accumulated_stats_match_jax(trajectories):
    *_, state = trajectories["port"]
    *_, jstate = trajectories["jax"]
    assert set(state.stats_acc) == set(jstate.stats_acc) and state.stats_acc
    for key, want in jstate.stats_acc.items():
        np.testing.assert_allclose(state.stats_acc[key].numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-6, err_msg=key)
    assert float(state.stats_count) == float(jstate.stats_count) == N_STEPS


def test_parameter_deltas_match_jax(trajectories):
    from vae_channel_dynamics_tpu.models.io import flatten_params

    initial = trajectories["initial"]
    *_, state = trajectories["port"]
    *_, jstate = trajectories["jax"]
    j_final = flatten_params(jstate.params)
    t_final = {k: v.detach() for k, v in state.model.state_dict().items()}
    assert set(j_final) == set(t_final)
    moved = 0
    for name, want in j_final.items():
        if name.endswith("to_k.bias"):
            # its gradient is zero by symmetry (softmax ignores a per-row
            # shift) and Adam amplifies the roundoff into noise no two
            # implementations share (tests/test_train_trajectory_torch_parity.py)
            continue
        jd = want.astype(np.float64) - initial[name].double().numpy()
        td = (t_final[name].double() - initial[name].double()).numpy()
        scale = np.abs(jd).max()
        if scale < 1e-12:
            continue
        moved += 1
        err = np.abs(jd - td).max()
        assert err < 2e-3 * scale + 1e-9, f"{name}: {err:.3e} vs scale {scale:.3e}"
    assert moved > 30


# --------------------------------------------------------------------------- #
# The optimizer pieces against optax, on small tensors
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["linear", "cosine", "constant", "constant_with_warmup"])
def test_lr_schedules_match_jax(name):
    warmup, total = 4, 10
    port = make_lr_schedule(name, 1e-3, warmup, total)
    ref = jax_make_lr_schedule(name, 1e-3, warmup, total)
    for count in (0, 1, warmup, warmup + 3, total, total + 5):
        np.testing.assert_allclose(port(count), float(ref(count)), rtol=1e-6, atol=1e-12,
                                   err_msg=f"{name} @ {count}")
    if name in ("linear", "cosine", "constant_with_warmup"):
        # LambdaLR applies lambda(0) to the first step: zero during warmup
        assert port(0) == 0.0


def test_unknown_schedule_warns_and_is_linear(caplog):
    with caplog.at_level(logging.WARNING):
        port = make_lr_schedule("nope", 1e-3, 2, 10)
    assert "nope" in caplog.text
    linear = make_lr_schedule("linear", 1e-3, 2, 10)
    assert [port(c) for c in range(12)] == [linear(c) for c in range(12)]


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((4, 3)) * scale).astype(np.float32),
            "b": (rng.standard_normal(3) * scale).astype(np.float32)}


def _run_both(max_grad_norm, k, n_micro, ema_decay=0.0):
    """n_micro micro-steps of random gradients through the port's optimizer
    and through optax's; the parameters (and the EMA) after each."""
    params0 = _tree(0)
    grads = [_tree(10 + i, scale=2.0) for i in range(n_micro)]
    tx, _ = build_optimizer(1e-2, 2, 20, adam_weight_decay=WD, max_grad_norm=max_grad_norm,
                            gradient_accumulation_steps=k)
    jtx, _ = jax_build_optimizer(1e-2, 2, 20, adam_weight_decay=WD,
                                 max_grad_norm=max_grad_norm, gradient_accumulation_steps=k)
    tparams = {n: torch.from_numpy(v.copy()) for n, v in params0.items()}
    opt_state = tx.init(tparams)
    t_ema = {n: v.clone() for n, v in tparams.items()}
    jparams = {n: jnp.asarray(v) for n, v in params0.items()}
    j_opt = jtx.init(jparams)
    j_ema = dict(jparams)
    out = []
    for g in grads:
        applied = tx.update({n: torch.from_numpy(v) for n, v in g.items()}, opt_state, tparams)
        if ema_decay and applied:
            for n in t_ema:
                t_ema[n] = t_ema[n] * ema_decay + tparams[n] * (1 - ema_decay)
        updates, j_opt = jtx.update({n: jnp.asarray(v) for n, v in g.items()}, j_opt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        if ema_decay:
            blended = {n: j_ema[n] * ema_decay + jparams[n] * (1 - ema_decay) for n in j_ema}
            did_update = getattr(j_opt, "mini_step", 0) == 0
            j_ema = {n: jnp.where(did_update, blended[n], j_ema[n]) for n in j_ema}
        out.append((applied, {n: v.numpy().copy() for n, v in tparams.items()},
                    {n: np.asarray(v) for n, v in jparams.items()},
                    {n: v.numpy().copy() for n, v in t_ema.items()},
                    {n: np.asarray(v) for n, v in j_ema.items()}))
    return grads, out


@pytest.mark.parametrize("clip", [0.5, 100.0])
def test_clipping_matches_optax(clip):
    grads, out = _run_both(clip, 1, 3)
    norms = [float(global_norm([torch.from_numpy(v) for v in g.values()])) for g in grads]
    if clip < 1:
        assert all(n > clip for n in norms)  # it triggers on every step
    else:
        assert all(n < clip for n in norms)
    for _applied, tp, jp, _te, _je in out:
        for n in tp:
            np.testing.assert_allclose(tp[n], jp[n], rtol=1e-5, atol=1e-7, err_msg=n)


def test_gradient_accumulation_matches_optax_multisteps():
    _grads, out = _run_both(0.5, 2, 4)
    assert [applied for applied, *_ in out] == [False, True, False, True]
    for _applied, tp, jp, _te, _je in out:
        for n in tp:
            np.testing.assert_allclose(tp[n], jp[n], rtol=1e-5, atol=1e-7, err_msg=n)


@pytest.mark.parametrize("k", [1, 2])
def test_ema_blends_only_applied_updates(k):
    """The JAX step's EMA rule (training/step.py:358-377): blend on every
    step without accumulation, only on applied micro-steps with it."""
    _grads, out = _run_both(0.5, k, 4, ema_decay=0.9)
    for _applied, _tp, _jp, te, je in out:
        for n in te:
            np.testing.assert_allclose(te[n], je[n], rtol=1e-5, atol=1e-7, err_msg=n)
    # with accumulation, the first micro-step leaves the EMA at the start
    first_ema = out[0][3]
    assert np.array_equal(first_ema["w"], _tree(0)["w"]) == (k == 2)


def test_ema_in_the_train_step():
    """make_train_step's EMA with k=2: unchanged after the first micro-step,
    the blend of the updated parameters after the second."""
    model, _params = seeded_pair(6, impl="xla")
    tx, _ = build_optimizer(1e-3, 0, 10, gradient_accumulation_steps=2)
    state = TrainState.create(model, tx, ema=True)
    start = {k: v.clone() for k, v in state.ema_params.items()}
    step = make_train_step(model, tx, KL_WEIGHT, ema_decay=0.5)
    batch = {"pixel_values": _batches()[0][:1]}
    gen = torch.Generator().manual_seed(0)
    step(state, batch, np.ones(1, np.float32), gen)
    assert all(torch.equal(state.ema_params[k], start[k]) for k in start)
    step(state, batch, np.ones(1, np.float32), gen)
    params = dict(model.named_parameters())
    for k, v in state.ema_params.items():
        torch.testing.assert_close(v, start[k] * 0.5 + params[k].detach() * 0.5)
    assert state.step == 2


def test_eval_step_matches_jax():
    """make_eval_step: SUM-convention losses over the valid rows, the
    per-element-mean MSE, and the NHWC reconstruction (the tiny config, the
    plain GroupNorm on both sides)."""
    from vae_channel_dynamics_tpu.models.io import abstract_params, unflatten_params
    from vae_channel_dynamics_tpu_torch.models import AutoencoderKL, VAEConfig

    model = AutoencoderKL(VAEConfig.tiny())
    model.init_weights(torch.Generator().manual_seed(8))
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    params = unflatten_params(abstract_params(JaxConfig.tiny()), state)
    batch = {"pixel_values": _batches()[0]}
    j_out = jax_make_eval_step(JaxAutoencoderKL(config=JaxConfig.tiny()))(params, batch, MASK)
    t_out = make_eval_step(model)(batch, MASK)
    assert set(t_out) == set(j_out)
    for key in ("rec_loss_sum", "kl_sum", "mse_mean_weighted", "num_samples"):
        np.testing.assert_allclose(float(t_out[key]), float(j_out[key]), rtol=1e-4, err_msg=key)
    np.testing.assert_allclose(t_out["reconstruction"].numpy(),
                               np.asarray(j_out["reconstruction"]), rtol=1e-4, atol=1e-4)


def test_uint8_dequantize_matches_jax():
    x = np.arange(256, dtype=np.uint8).reshape(4, 8, 8, 1)
    got = dequantize_pixels(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_dequantize(jnp.asarray(x))),
                               rtol=0, atol=1e-7)
    assert got.min() == -1.0 and got.max() == 1.0
    f = torch.rand(2, 3)
    assert dequantize_pixels(f) is f

