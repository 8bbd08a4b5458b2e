"""The port's data-parallel train step on two gloo ranks against the JAX
package's ``make_train_step`` on a 2-device CPU mesh.

A global batch of 3 images padded to 4 (``pad_batch_to_multiple``: the pad
row repeats the last image, mask 0), so rank 1 holds the pad row and the
ranks hold 2 and 1 valid rows. Two steps at fp32 of the 128-channel
two-level model (``test_torch_taps.NARROW``, the plain GroupNorm on both
sides; JAX at ``Precision.HIGHEST``, the port with TF32 off), the taps
accumulating (mean |x| per channel, the mean, the zero fraction and the
std, whose global mean needs a collective inside the forward), the EMA,
and a clip that fires. The posterior noise is the JAX step's own draw,
each rank taking its block of it.

Six port variants share one spawn: AdamW and Adafactor, each plain (DDP),
with ``shard_optimizer`` + ``shard_ema`` (ZeRO-1 under DDP), and with
``shard_params`` (FSDP2, the state following the parameter shards). Each is
held to the JAX mesh step of its optimizer: the losses, the grad norm, the
accumulated tap statistics and the parameters and EMA after 2 steps within
1e-5 relative (of each tensor's largest entry); the parameter deltas within
2e-3 of their largest entry, as ``tests/test_torch_train_step.py``. The
ranks end with the same parameter bits. A rank's sliced leaves take at most
0.55 of what they weigh whole, and what it keeps whole is no more than the
layout may keep whole (the parameters under ZeRO-1, the leaves of a
parameter no axis of which divides, Adafactor's factored moments).

A seventh variant takes the two steps as two micro-steps of one update
(AdamW, ``gradient_accumulation_steps`` 2, DDP's ``no_sync`` on the first)
and is held to the port's one-process step: the losses and the parameters
within 1e-5; its grad norm on the update is the norm of the mean of the two
micro-steps' gradients, where one process (as JAX) reports the last
micro-step's own.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_taps import NARROW, seeded_pair
from torch_parallel_ranks import run_ranks

from vae_channel_dynamics_tpu.models.io import flatten_params
from vae_channel_dynamics_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from vae_channel_dynamics_tpu.models.vae import VAEConfig as JaxConfig
from vae_channel_dynamics_tpu.parallel import make_mesh
from vae_channel_dynamics_tpu.parallel.mesh import pad_batch_to_multiple as jax_pad
from vae_channel_dynamics_tpu.parallel.mesh import replicated_sharding
from vae_channel_dynamics_tpu.tracking import ActivityMonitor as JaxMonitor
from vae_channel_dynamics_tpu.training import TrainState as JaxTrainState
from vae_channel_dynamics_tpu.training import build_optimizer as jax_build_optimizer
from vae_channel_dynamics_tpu.training import make_train_step as jax_make_train_step
from vae_channel_dynamics_tpu_torch.parallel import pad_batch_to_multiple
from vae_channel_dynamics_tpu_torch.training import TrainState, build_optimizer
from vae_channel_dynamics_tpu_torch.training.step import make_train_step

STEPS, RES, WORLD = 2, 16, 2
LR, WARMUP, MAX_STEPS, WD, EPS = 1e-3, 1, 6, 0.1, 1.0
KL_WEIGHT, EMA_DECAY = 1e-3, 0.9
TRACKING = {
    "enabled": True,
    "track_interval": 100,
    "target_layers": [
        {"name": "vae.encoder.down_blocks.0.resnets.0.norm1", "capture_point": "output",
         "metrics": ["mean_abs_activation_per_channel"]},
        {"name": "vae.decoder.up_blocks.1.resnets.0.norm2", "capture_point": "output",
         "metrics": ["mean_abs_activation_per_channel", "std_activation"]},
        {"name": "vae.encoder.conv_in", "capture_point": "output",
         "metrics": ["mean_activation", "zero_fraction_per_channel"]},
    ],
}
FLAGS = {"ddp": {}, "zero1": {"shard_optimizer": True, "shard_ema": True},
         "zero3": {"shard_params": True}}
REL = 1e-5


def _global_batches():
    """Three images a step, padded to four: the pad row on rank 1."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(STEPS):
        raw = {"pixel_values": rng.integers(0, 256, (3, RES, RES, 3), dtype=np.uint8)}
        padded, mask = pad_batch_to_multiple(raw, WORLD)
        out.append((padded["pixel_values"], mask))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_step")
    model, params = seeded_pair(5, impl="auto")
    initial = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    np.savez(tmp / "state.npz", **initial)
    batches = _global_batches()
    base_rng = jax.random.PRNGKey(123)
    latent = (4, RES // 2, RES // 2, 4)
    noises = [np.array(jax.random.normal(jax.random.fold_in(base_rng, t), latent, jnp.float32))
              for t in range(STEPS)]
    data = {"mask": batches[0][1]}
    for t in range(STEPS):
        data[f"pixels{t}"] = batches[t][0]
        data[f"noise{t}"] = noises[t]
    np.savez(tmp / "data.npz", **data)

    # a clip below the first gradient norm (the port's one-process step)
    probe_tx, _ = build_optimizer(0.0, 0, 1, max_grad_norm=0.0)
    _s, probe, _m = make_train_step(model, probe_tx, KL_WEIGHT)(
        TrainState.create(model, probe_tx), {"pixel_values": batches[0][0]}, batches[0][1],
        noise=noises[0])
    max_grad_norm = 0.7 * float(probe["grad_norm"])

    # JAX, one mesh step per optimizer
    mesh = make_mesh(n_devices=WORLD)
    jmonitor = JaxMonitor(TRACKING)
    jmodule = JaxAutoencoderKL(config=JaxConfig(**NARROW), dtype=jnp.float32, impl="xla",
                               capture=jmonitor.scalar_capture_table)
    jax_runs = {}
    for opt in ("adamw", "adafactor"):
        jtx, _ = jax_build_optimizer(LR, WARMUP, MAX_STEPS, adam_weight_decay=WD,
                                     adam_epsilon=EPS, max_grad_norm=max_grad_norm,
                                     optimizer=opt)
        jacc = jmonitor.init_acc(jmodule, params, (4, RES, RES, 3))
        # committed like the step's output state, so the second step does
        # not compile again
        jstate = jax.device_put(JaxTrainState.create(params, jtx, stats_acc=jacc, ema=True),
                                replicated_sharding(mesh))
        jstep = jax_make_train_step(jmodule, jtx, KL_WEIGHT, mesh=mesh,
                                    stats_accumulate=JaxMonitor.accumulate, donate=False,
                                    ema_decay=EMA_DECAY)
        metrics = []
        for t in range(STEPS):
            jstate, m, _ = jstep(jstate, {"pixel_values": batches[t][0]}, batches[t][1],
                                 base_rng)
            metrics.append([float(m[k]) for k in ("train_loss_step", "rec_loss", "kl_loss",
                                                  "grad_norm")])
        jax_runs[opt] = {
            "metrics": np.array(metrics),
            "params": flatten_params(jstate.params),
            "ema": flatten_params(jstate.ema_params),
            "stats": {k: np.asarray(v) for k, v in jstate.stats_acc.items()},
        }

    variants = [{"name": f"{opt}_{kind}", "optimizer": opt, "flags": flags}
                for opt in ("adamw", "adafactor") for kind, flags in FLAGS.items()]
    variants.append({"name": "adamw_accum", "optimizer": "adamw", "flags": {}, "accum": 2})
    out = tmp / "port.npz"
    run_ranks("step", {
        "state": str(tmp / "state.npz"), "data": str(tmp / "data.npz"), "out": str(out),
        "variants": variants, "tracking": TRACKING, "steps": STEPS, "lr": LR,
        "warmup": WARMUP, "max_steps": MAX_STEPS, "wd": WD, "eps": EPS,
        "max_grad_norm": max_grad_norm, "kl_weight": KL_WEIGHT, "ema_decay": EMA_DECAY,
    }, str(tmp / "ranks"), world=WORLD, timeout=150)
    port = dict(np.load(out))

    # the accumulating variant's control: the port's one process, k = 2
    def one_process(n_micro):
        ref = copy.deepcopy(model)
        tx, _ = build_optimizer(LR, WARMUP, MAX_STEPS, adam_weight_decay=WD, adam_epsilon=EPS,
                                max_grad_norm=max_grad_norm, gradient_accumulation_steps=2)
        state = TrainState.create(ref, tx, ema=True)
        step = make_train_step(ref, tx, KL_WEIGHT, ema_decay=EMA_DECAY)
        metrics, grads = [], None
        for t in range(STEPS - n_micro, STEPS):
            state, m, _ = step(state, {"pixel_values": batches[t][0]}, batches[t][1],
                               noise=noises[t])
            metrics.append([float(m[k]) for k in ("train_loss_step", "rec_loss", "kl_loss",
                                                  "grad_norm")])
            if grads is None:
                # the first micro-step's gradient: the accumulator's mean of one
                grads = [a.clone() for a in state.opt_state.acc_grads]
        params = {k: v.detach().numpy().copy() for k, v in ref.state_dict().items()}
        return np.array(metrics), params, grads

    accum_metrics, accum_params, first = one_process(STEPS)
    _, _, last = one_process(1)
    mean = torch.linalg.vector_norm(torch.stack(
        [((a + b) / 2).norm() for a, b in zip(first, last)]))
    return {"initial": initial, "jax": jax_runs, "port": port,
            "max_grad_norm": max_grad_norm,
            "accum": {"metrics": accum_metrics, "params": accum_params,
                      "mean_grad_norm": float(mean),
                      "last_grad_norm": float(torch.linalg.vector_norm(torch.stack(
                          [b.norm() for b in last])))}}


VARIANTS = [f"{opt}_{kind}" for opt in ("adamw", "adafactor") for kind in FLAGS]


def _opt(name):
    return name.split("_", 1)[0]


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())
    assert err <= REL * scale, f"{what}: max err {err:.3e} vs {REL} x {scale:.3e}"


@pytest.mark.parametrize("name", VARIANTS)
def test_losses_and_grad_norm_match_jax_mesh(runs, name):
    got = runs["port"][f"{name}/metrics"]
    want = runs["jax"][_opt(name)]["metrics"]
    np.testing.assert_allclose(got, want, rtol=REL, err_msg=name)
    # the clip fired on the first step, and the trajectory moved
    assert want[0, 3] > runs["max_grad_norm"] and want[0, 0] != want[1, 0]


@pytest.mark.parametrize("name", VARIANTS)
def test_tap_statistics_match_jax_mesh(runs, name):
    want = runs["jax"][_opt(name)]["stats"]
    assert len(want) == 5
    for key, value in want.items():
        _close(runs["port"][f"{name}/stats/{key}"], value, f"{name} {key}")


@pytest.mark.parametrize("name", VARIANTS)
def test_parameters_and_ema_match_jax_mesh(runs, name):
    jr = runs["jax"][_opt(name)]
    moved = 0
    for key, want in jr["params"].items():
        if key.endswith("to_k.bias"):
            # zero gradient by symmetry: the update is roundoff, which no two
            # implementations share (tests/test_torch_train_step.py)
            continue
        got = runs["port"][f"{name}/param/{key}"]
        _close(got, want, f"{name} {key}")
        _close(runs["port"][f"{name}/ema/{key}"], jr["ema"][key], f"{name} ema {key}")
        jd = want.astype(np.float64) - runs["initial"][key]
        td = got.astype(np.float64) - runs["initial"][key]
        scale = np.abs(jd).max()
        if scale > 1e-12:
            moved += 1
            assert np.abs(jd - td).max() < 2e-3 * scale + 1e-9, f"{name} {key} delta"
    assert moved > 30
    assert bool(runs["port"][f"{name}/ranks_equal"])


@pytest.mark.parametrize("name", [v for v in VARIANTS if not v.endswith("ddp")])
def test_sliced_state_bytes(runs, name):
    whole = runs["port"][f"{_opt(name)}_ddp/bytes"].sum()
    for sliced, kept, allowance in runs["port"][f"{name}/rank_bytes"]:
        # the leaves a rank keeps whole are those the layout may keep whole
        # (for ZeRO-1 the moments and the EMA are sliced), and its slices
        # weigh at most 0.55 of those leaves whole
        assert kept <= allowance, (name, kept, allowance)
        assert 0 < sliced <= 0.55 * (whole - kept), (name, sliced, kept, whole)


def test_accumulation_across_ranks_matches_one_process(runs):
    got = runs["port"]["adamw_accum/metrics"]
    want = runs["accum"]["metrics"]
    np.testing.assert_allclose(got[:, :3], want[:, :3], rtol=REL)
    for key, value in runs["accum"]["params"].items():
        if key.endswith("to_k.bias"):
            continue
        _close(runs["port"][f"adamw_accum/param/{key}"], value, f"accum {key}")
    assert bool(runs["port"]["adamw_accum/ranks_equal"])
    # the update's grad norm: the mean gradient's across ranks, the last
    # micro-step's own in one process, and the two differ
    mean, last = runs["accum"]["mean_grad_norm"], runs["accum"]["last_grad_norm"]
    assert got[1, 3] == pytest.approx(mean, rel=REL)
    assert want[1, 3] == pytest.approx(last, rel=REL)
    assert abs(mean - last) > 100 * REL * last


def test_pad_rows_match_jax():
    raw = {"pixel_values": np.arange(3 * 2, dtype=np.float32).reshape(3, 2)}
    got, mask = pad_batch_to_multiple(raw, 4)
    want, jmask = jax_pad(raw, 4)
    np.testing.assert_array_equal(got["pixel_values"], want["pixel_values"])
    np.testing.assert_array_equal(mask, jmask)


def test_one_process_step_takes_a_stand_in_optimizer():
    """One process reads nothing of the optimizer's state: a stand-in that
    keeps none and only captures the gradients (as ``chip_smoke.py``'s
    gradient comparisons use) runs through the step."""
    model, _ = seeded_pair(5, impl="auto")

    class GradCapture:
        grads = {}

        def init(self, params):
            return None

        def update(self, grads, opt_state, params):
            self.grads = dict(grads)
            return False

    tx = GradCapture()
    pixels, mask = _global_batches()[0]
    _state, m, _ = make_train_step(model, tx, KL_WEIGHT)(
        TrainState.create(model, tx), {"pixel_values": pixels}, mask,
        torch.Generator().manual_seed(0))
    assert len(tx.grads) == len(list(model.parameters()))
    want = torch.linalg.vector_norm(torch.stack([g.norm() for g in tx.grads.values()]))
    assert float(m["grad_norm"]) == pytest.approx(float(want), rel=1e-6)
