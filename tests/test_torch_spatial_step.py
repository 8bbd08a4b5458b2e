"""The port's train step on a data x spatial layout of four gloo ranks (2
data x 2 spatial) against the JAX package's ``make_train_step`` on
``make_mesh(4, spatial=2)`` (as ``tests/test_spatial_sharding.py`` builds
it).

The inputs are ``tests/test_torch_parallel_step.py``'s: a global batch of 3
images padded to 4 (data rank 1 holds the pad row), two fp32 steps of the
128-channel two-level model (plain GroupNorm on both sides; JAX at
``Precision.HIGHEST``, the port with TF32 off), the taps accumulating
(mean |x| per channel, the mean, the zero fraction, the std), the EMA, a
clip that fires, and the JAX step's own posterior noise, each spatial
group taking its data rank's block and each rank its latent rows. Each
rank holds 8 of the 16 image rows (4 of the 8 at the second level, whose
mid-block attention gathers K and V).

Three port variants share one spawn, each held to the JAX mesh step within
1e-5 of each tensor's largest entry (losses, grad norm, tap statistics,
parameters and EMA after 2 steps; the parameter deltas within 2e-3 of
their largest entry): DDP over the four ranks, ZeRO-1 with the sharded EMA
(the state sliced over the data axis only), and ZeRO-3 (FSDP2 replicating
over ``spatial`` and sharding over ``data``). Every rank ends with the
same parameter bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from test_torch_parallel_step import (EMA_DECAY, EPS, KL_WEIGHT, LR, MAX_STEPS, RES, STEPS,
                                      TRACKING, WARMUP, WD, _close, _global_batches)
from test_torch_taps import NARROW, seeded_pair
from torch_parallel_ranks import run_ranks

from vae_channel_dynamics_tpu.models.io import flatten_params
from vae_channel_dynamics_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from vae_channel_dynamics_tpu.models.vae import VAEConfig as JaxConfig
from vae_channel_dynamics_tpu.parallel import make_mesh
from vae_channel_dynamics_tpu.parallel.mesh import replicated_sharding
from vae_channel_dynamics_tpu.tracking import ActivityMonitor as JaxMonitor
from vae_channel_dynamics_tpu.training import TrainState as JaxTrainState
from vae_channel_dynamics_tpu.training import build_optimizer as jax_build_optimizer
from vae_channel_dynamics_tpu.training import make_train_step as jax_make_train_step
from vae_channel_dynamics_tpu_torch.training import TrainState, build_optimizer
from vae_channel_dynamics_tpu_torch.training.step import make_train_step

WORLD, SPATIAL = 4, 2
REL = 1e-5
FLAGS = {"ddp": {}, "zero1": {"shard_optimizer": True, "shard_ema": True},
         "zero3": {"shard_params": True}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spatial_step")
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

    mesh = make_mesh(WORLD, spatial=SPATIAL)
    assert dict(mesh.shape) == {"data": WORLD // SPATIAL, "spatial": SPATIAL}
    jmonitor = JaxMonitor(TRACKING)
    jmodule = JaxAutoencoderKL(config=JaxConfig(**NARROW), dtype=jnp.float32, impl="xla",
                               capture=jmonitor.scalar_capture_table)
    jtx, _ = jax_build_optimizer(LR, WARMUP, MAX_STEPS, adam_weight_decay=WD, adam_epsilon=EPS,
                                 max_grad_norm=max_grad_norm)
    jacc = jmonitor.init_acc(jmodule, params, (4, RES, RES, 3))
    jstate = jax.device_put(JaxTrainState.create(params, jtx, stats_acc=jacc, ema=True),
                            replicated_sharding(mesh))
    jstep = jax_make_train_step(jmodule, jtx, KL_WEIGHT, mesh=mesh,
                                stats_accumulate=JaxMonitor.accumulate, donate=False,
                                ema_decay=EMA_DECAY)
    metrics = []
    for t in range(STEPS):
        jstate, m, _ = jstep(jstate, {"pixel_values": batches[t][0]}, batches[t][1], base_rng)
        metrics.append([float(m[k]) for k in ("train_loss_step", "rec_loss", "kl_loss",
                                              "grad_norm")])
    jax_run = {"metrics": np.array(metrics), "params": flatten_params(jstate.params),
               "ema": flatten_params(jstate.ema_params),
               "stats": {k: np.asarray(v) for k, v in jstate.stats_acc.items()}}

    variants = [{"name": kind, "optimizer": "adamw", "flags": flags}
                for kind, flags in FLAGS.items()]
    out = tmp / "port.npz"
    run_ranks("step", {
        "state": str(tmp / "state.npz"), "data": str(tmp / "data.npz"), "out": str(out),
        "variants": variants, "tracking": TRACKING, "steps": STEPS, "lr": LR,
        "warmup": WARMUP, "max_steps": MAX_STEPS, "wd": WD, "eps": EPS,
        "max_grad_norm": max_grad_norm, "kl_weight": KL_WEIGHT, "ema_decay": EMA_DECAY,
        "spatial": SPATIAL,
    }, str(tmp / "ranks"), world=WORLD, timeout=150)
    return {"initial": initial, "jax": jax_run, "port": dict(np.load(out)),
            "max_grad_norm": max_grad_norm}


@pytest.mark.parametrize("name", list(FLAGS))
def test_losses_and_grad_norm_match_jax_spatial_mesh(runs, name):
    got = runs["port"][f"{name}/metrics"]
    want = runs["jax"]["metrics"]
    np.testing.assert_allclose(got, want, rtol=REL, err_msg=name)
    assert want[0, 3] > runs["max_grad_norm"] and want[0, 0] != want[1, 0]


@pytest.mark.parametrize("name", list(FLAGS))
def test_tap_statistics_match_jax_spatial_mesh(runs, name):
    want = runs["jax"]["stats"]
    assert len(want) == 5
    for key, value in want.items():
        _close(runs["port"][f"{name}/stats/{key}"], value, f"{name} {key}")


@pytest.mark.parametrize("name", list(FLAGS))
def test_parameters_and_ema_match_jax_spatial_mesh(runs, name):
    jr = runs["jax"]
    moved = 0
    for key, want in jr["params"].items():
        if key.endswith("to_k.bias"):
            # zero gradient by symmetry: the update is roundoff
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


@pytest.mark.parametrize("name", ["zero1", "zero3"])
def test_state_slices_follow_the_data_axis(runs, name):
    """Each rank's sliced leaves weigh about half their whole (2 data ranks,
    whatever the spatial groups)."""
    whole = runs["port"]["ddp/bytes"].sum()
    for sliced, kept, allowance in runs["port"][f"{name}/rank_bytes"]:
        assert kept <= allowance, (name, kept, allowance)
        assert 0.45 * (whole - kept) <= sliced <= 0.55 * (whole - kept), (name, sliced, kept)
