"""The port's train step with the channels sharded over tensor groups of
gloo ranks, against the port's one-process step and the JAX package's
``make_train_step`` on ``make_mesh(4)`` and on ``make_mesh(4, tensor=2)``
(as ``tests/test_tensor_parallel.py`` builds them).

The inputs are ``tests/test_torch_parallel_step.py``'s: a global batch of 3
images padded to 4, two fp32 steps of the 128-channel two-level model
(plain GroupNorm on both sides; JAX at ``Precision.HIGHEST``, the port with
TF32 off), the taps accumulating (mean |x| per channel of a norm and of
the encoder's column-parallel ``conv_in``, the mean, the zero fraction and
the std), the EMA, a clip that fires, and the JAX step's own posterior
noise. Four ranks, in one spawn:

- 2 data x 2 tensor ranks, three variants: DDP over the ranks of each
  tensor index, ZeRO-1 with the sharded EMA (a remaining axis over the data
  ranks, JAX ``_combined_spec``), and ZeRO-3 (FSDP2 over the data ranks on
  the rank's channel blocks);
- 4 tensor ranks (one data rank), DDP.

Each is held to the JAX step on ``make_mesh(4)`` within 1e-5 of each
tensor's largest entry (losses, grad norm, tap statistics gathered whole,
parameters and EMA after 2 steps; the parameter deltas within 2e-3 of their
largest entry), which is tighter than JAX's own test (loss rtol 2e-5,
parameters rtol 2e-3 / atol 2e-5); the DDP variant also to the JAX step on
``make_mesh(4, tensor=2)`` and the 4-tensor variant to the port's one
process, at the same tolerance. Every rank holds 1/T of each leaf the
tensor axis cuts, and its moments and EMA follow (1/D more along a
data-sliced axis); the global gradient norm counts a leaf the tensor axis
leaves whole (the decoder's ``conv_out`` bias, O = 3) once: a planted
gradient of (3, 4, 0) there has norm 5 on every rank, where counting it T
times would give 5 sqrt(T).
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_parallel_step import (EMA_DECAY, EPS, KL_WEIGHT, LR, MAX_STEPS, RES, STEPS,
                                      TRACKING, WARMUP, WD, _global_batches)
from test_torch_taps import NARROW, seeded_pair
from torch_parallel_ranks import run_ranks

from vae_channel_dynamics_tpu.models.io import flatten_params
from vae_channel_dynamics_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from vae_channel_dynamics_tpu.models.vae import VAEConfig as JaxConfig
from vae_channel_dynamics_tpu.parallel import make_mesh
from vae_channel_dynamics_tpu.parallel.mesh import replicated_sharding
from vae_channel_dynamics_tpu.parallel.zero import state_shardings
from vae_channel_dynamics_tpu.tracking import ActivityMonitor as JaxMonitor
from vae_channel_dynamics_tpu.training import TrainState as JaxTrainState
from vae_channel_dynamics_tpu.training import build_optimizer as jax_build_optimizer
from vae_channel_dynamics_tpu.training import make_train_step as jax_make_train_step
from vae_channel_dynamics_tpu_torch.parallel.zero import tensor_axis
from vae_channel_dynamics_tpu_torch.tracking import ActivityMonitor
from vae_channel_dynamics_tpu_torch.training import TrainState, build_optimizer
from vae_channel_dynamics_tpu_torch.training.step import make_train_step

WORLD = 4
REL = 1e-5
DELTA_REL = 2e-3
VARIANTS = {
    "ddp": (2, {}),
    "zero1": (2, {"shard_optimizer": True, "shard_ema": True}),
    "zero3": (2, {"shard_params": True}),
    "tp4": (4, {}),
}
KEYS = ("train_loss_step", "rec_loss", "kl_loss", "grad_norm")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """This process's runs on one intra-op thread, as the ranks' are, beside
    the other test workers (tests/test_torch_flash_bwd_f32.py's
    ``one_thread``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_run(params, batches, max_grad_norm, tensor):
    """Two JAX mesh steps on ``make_mesh(4, tensor=tensor)``: replicated at
    1, the state in ``state_shardings``' tensor layout above."""
    mesh = make_mesh(WORLD, tensor=tensor)
    jmonitor = JaxMonitor(TRACKING)
    jmodule = JaxAutoencoderKL(config=JaxConfig(**NARROW), dtype=jnp.float32, impl="xla",
                               capture=jmonitor.scalar_capture_table)
    jtx, _ = jax_build_optimizer(LR, WARMUP, MAX_STEPS, adam_weight_decay=WD, adam_epsilon=EPS,
                                 max_grad_norm=max_grad_norm)
    jacc = jmonitor.init_acc(jmodule, params, (4, RES, RES, 3))
    jstate = JaxTrainState.create(params, jtx, stats_acc=jacc, ema=True)
    sharding = (state_shardings(mesh, jstate, shard_optimizer=False) if tensor > 1
                else replicated_sharding(mesh))
    jstate = jax.device_put(jstate, sharding)
    jstep = jax_make_train_step(jmodule, jtx, KL_WEIGHT, mesh=mesh,
                                stats_accumulate=JaxMonitor.accumulate, donate=False,
                                ema_decay=EMA_DECAY,
                                state_sharding=sharding if tensor > 1 else None)
    base_rng = jax.random.PRNGKey(123)
    metrics = []
    for t in range(STEPS):
        jstate, m, _ = jstep(jstate, {"pixel_values": batches[t][0]}, batches[t][1], base_rng)
        metrics.append([float(m[k]) for k in KEYS])
    return {"metrics": np.array(metrics), "params": flatten_params(jstate.params),
            "ema": flatten_params(jstate.ema_params),
            "stats": {k: np.asarray(v) for k, v in jstate.stats_acc.items()}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tensor_step")
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

    # a clip below the first gradient norm
    probe_tx, _ = build_optimizer(0.0, 0, 1, max_grad_norm=0.0)
    _s, probe, _m = make_train_step(model, probe_tx, KL_WEIGHT)(
        TrainState.create(model, probe_tx), {"pixel_values": batches[0][0]}, batches[0][1],
        noise=noises[0])
    max_grad_norm = 0.7 * float(probe["grad_norm"])

    # the port's one process, the same two steps
    one = copy.deepcopy(model)
    monitor = ActivityMonitor(TRACKING)
    one.set_capture(monitor.scalar_capture_table)
    tx, _ = build_optimizer(LR, WARMUP, MAX_STEPS, adam_weight_decay=WD, adam_epsilon=EPS,
                            max_grad_norm=max_grad_norm)
    state = TrainState.create(one, tx, stats_acc=monitor.init_acc(one), ema=True)
    step = make_train_step(one, tx, KL_WEIGHT, stats_accumulate=ActivityMonitor.accumulate,
                           ema_decay=EMA_DECAY)
    metrics = []
    for t in range(STEPS):
        state, m, _ = step(state, {"pixel_values": batches[t][0]}, batches[t][1],
                           noise=noises[t])
        metrics.append([float(m[k]) for k in KEYS])
    one_run = {"metrics": np.array(metrics),
               "params": {k: v.detach().numpy().copy() for k, v in one.state_dict().items()},
               "ema": {k: v.numpy().copy() for k, v in state.ema_params.items()},
               "stats": {k: v.numpy().copy() for k, v in state.stats_acc.items()}}

    jax_runs = {t: _jax_run(params, batches, max_grad_norm, t) for t in (1, 2)}

    variants = [{"name": name, "optimizer": "adamw", "flags": flags, "tensor": tensor}
                for name, (tensor, flags) in VARIANTS.items()]
    out = tmp / "port.npz"
    run_ranks("step", {
        "state": str(tmp / "state.npz"), "data": str(tmp / "data.npz"), "out": str(out),
        "variants": variants, "tracking": TRACKING, "steps": STEPS, "lr": LR,
        "warmup": WARMUP, "max_steps": MAX_STEPS, "wd": WD, "eps": EPS,
        "max_grad_norm": max_grad_norm, "kl_weight": KL_WEIGHT, "ema_decay": EMA_DECAY,
    }, str(tmp / "ranks"), world=WORLD, timeout=200)
    return {"initial": initial, "jax": jax_runs, "one": one_run, "port": dict(np.load(out)),
            "max_grad_norm": max_grad_norm}


def _close(got, want, what, rel=REL):
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())
    assert err <= rel * scale, f"{what}: max err {err:.3e} vs {rel} x {scale:.3e}"


# (port variant, reference): every variant against JAX's data mesh, the DDP
# one against JAX's tensor mesh, the 4-tensor one against the port's one
# process
PAIRS = [(name, "jax1") for name in VARIANTS] + [("ddp", "jax2"), ("tp4", "one")]


def _reference(runs, ref):
    return runs["one"] if ref == "one" else runs["jax"][int(ref[-1])]


@pytest.mark.parametrize("name,ref", PAIRS)
def test_losses_and_grad_norm_match(runs, name, ref):
    want = _reference(runs, ref)["metrics"]
    np.testing.assert_allclose(runs["port"][f"{name}/metrics"], want, rtol=REL,
                               err_msg=f"{name} vs {ref}")
    assert want[0, 3] > runs["max_grad_norm"] and want[0, 0] != want[1, 0]


@pytest.mark.parametrize("name,ref", PAIRS)
def test_tap_statistics_match(runs, name, ref):
    want = _reference(runs, ref)["stats"]
    assert len(want) == 5
    for key, value in want.items():
        _close(runs["port"][f"{name}/stats/{key}"], value, f"{name} vs {ref} {key}")


@pytest.mark.parametrize("name,ref", PAIRS)
def test_parameters_and_ema_match(runs, name, ref):
    r = _reference(runs, ref)
    moved = 0
    for key, want in r["params"].items():
        if key.endswith("to_k.bias"):
            # zero gradient by symmetry: the update is roundoff
            continue
        got = runs["port"][f"{name}/param/{key}"]
        _close(got, want, f"{name} vs {ref} {key}")
        _close(runs["port"][f"{name}/ema/{key}"], r["ema"][key], f"{name} vs {ref} ema {key}")
        jd = want.astype(np.float64) - runs["initial"][key]
        td = got.astype(np.float64) - runs["initial"][key]
        scale = np.abs(jd).max()
        if scale > 1e-12:
            moved += 1
            assert np.abs(jd - td).max() < DELTA_REL * scale + 1e-9, f"{name} {key} delta"
    assert moved > 30
    assert bool(runs["port"][f"{name}/ranks_equal"])


@pytest.mark.parametrize("name", list(VARIANTS))
def test_each_rank_holds_its_channel_blocks(runs, name):
    """Every leaf the tensor axis cuts (JAX ``_channel_axis``) is 1/T on
    each rank, its moments and EMA too; the gradient norm counts a whole
    leaf once."""
    tensor = VARIANTS[name][0]
    cut = sum(tensor_axis(v.shape, tensor) is not None for v in runs["initial"].values())
    assert cut >= 40
    blocks = json.loads(str(runs["port"][f"{name}/tensor_blocks"]))
    assert blocks == [[cut, []]] * WORLD, blocks
    np.testing.assert_allclose(runs["port"][f"{name}/planted_norm"], 5.0, rtol=1e-6)
