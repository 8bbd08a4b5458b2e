"""``training.optimizer: adafactor`` in the port against optax 0.2.6's
``adafactor`` (JAX ``training/step.py::build_optimizer``), on the CPU.

- The optimizer alone (global-norm clip, Adafactor, ``MultiSteps``) against
  the JAX package's ``build_optimizer`` on a dict of parameters in each
  package's layout (the port's OIHW and (out, in) against JAX's HWIO and
  (in, out)): factored shapes with unequal and equal largest axes, shapes
  below ``min_dim_size_to_factor``, 1-D; with and without weight decay,
  clipping that triggers, accumulation over k > 1. rtol 1e-5 of each
  tensor's move.
- The factored axes the port picks on its layout are the pair JAX picks on
  its own, and the factored estimate (row moment x column moment over
  their mean) comes out the same.
- A 3-step trajectory of the narrow model through the port's train step and
  the JAX step (the plain GroupNorm on both sides): losses, grad norms and
  parameter deltas, with ``tests/test_torch_train_step.py``'s tolerances.
- The state's bytes, the checkpoint round trip, and an exact resume through
  the Trainer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from optax._src.factorized import FactoredState as JaxFactoredState
from test_torch_taps import NARROW, seeded_pair
from test_torch_trainer import _losses, _resume_cfg

from vae_channel_dynamics_tpu.models.io import flatten_params
from vae_channel_dynamics_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from vae_channel_dynamics_tpu.models.vae import VAEConfig as JaxConfig
from vae_channel_dynamics_tpu.training import TrainState as JaxTrainState
from vae_channel_dynamics_tpu.training import build_optimizer as jax_build_optimizer
from vae_channel_dynamics_tpu.training import make_train_step as jax_make_train_step
from vae_channel_dynamics_tpu_torch.models import AutoencoderKL, VAEConfig
from vae_channel_dynamics_tpu_torch.training import TrainState, build_optimizer, make_train_step
from vae_channel_dynamics_tpu_torch.training.checkpoint import (
    latest_checkpoint,
    restore_train_state,
    save_train_state,
)
from vae_channel_dynamics_tpu_torch.training.loop import Trainer
from vae_channel_dynamics_tpu_torch.training.step import Adafactor, FactoredState, factored_dims

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

# the port's layouts: OIHW convs, (out, in) linears
SHAPES = {
    "conv": (256, 128, 3, 3),      # factored, O > I
    "tie": (128, 128, 3, 3),       # factored, O == I
    "down": (128, 256, 3, 3),      # factored, I > O
    "shortcut": (256, 128, 1, 1),  # factored 1x1
    "linear": (128, 192),          # factored (out, in)
    "narrow": (64, 128, 3, 3),     # second-largest axis below 128: a full moment
    "conv_in": (128, 3, 3, 3),
    "bias": (256,),
}


@pytest.fixture(autouse=True)
def _one_thread():
    """The Trainer runs and the small models issue thousands of small ops: one
    intra-op thread keeps them from contending with the other test workers'
    threads (tests/test_torch_flash_bwd_f32.py's ``one_thread``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def _to_jax(a):
    """The JAX package's layout of a port tensor."""
    if a.ndim == 4:
        return a.transpose(2, 3, 1, 0)
    if a.ndim == 2:
        return a.T
    return a


def _run_both(k, wd, max_grad_norm, n_micro=6):
    rng = np.random.default_rng(7)
    params0 = {n: (rng.standard_normal(s) * 0.05).astype(np.float32) for n, s in SHAPES.items()}
    grads = [{n: rng.standard_normal(s).astype(np.float32) for n, s in SHAPES.items()}
             for _ in range(n_micro)]
    kw = dict(adam_weight_decay=wd, max_grad_norm=max_grad_norm, optimizer="adafactor",
              gradient_accumulation_steps=k)
    tx, _ = build_optimizer(1e-2, 2, 20, **kw)
    jtx, _ = jax_build_optimizer(1e-2, 2, 20, **kw)
    tparams = {n: torch.from_numpy(v.copy()) for n, v in params0.items()}
    state = tx.init(tparams)
    jparams = {n: jnp.asarray(_to_jax(v)) for n, v in params0.items()}
    jstate = jtx.init(jparams)

    @jax.jit
    def jstep(g, opt_state, p):
        upd, opt_state = jtx.update(g, opt_state, p)
        return optax.apply_updates(p, upd), opt_state

    out = []
    for g in grads:
        applied = tx.update({n: torch.from_numpy(v) for n, v in g.items()}, state, tparams)
        jparams, jstate = jstep({n: jnp.asarray(_to_jax(v)) for n, v in g.items()}, jstate,
                                jparams)
        out.append((applied, {n: _to_jax(v.numpy().copy()) for n, v in tparams.items()},
                    {n: np.asarray(v) for n, v in jparams.items()}))
    return params0, state, jstate, out


@pytest.mark.parametrize("k,wd,clip", [(1, 0.1, 0.5), (1, 0.0, 100.0), (2, 0.1, 0.5),
                                       (3, 0.01, 0.0)])
def test_adafactor_matches_optax(k, wd, clip):
    params0, state, _jstate, out = _run_both(k, wd, clip)
    assert isinstance(state, FactoredState)
    assert [applied for applied, *_ in out] == [(i + 1) % k == 0 for i in range(6)]
    assert state.count == 6 // k
    moved = 0
    for _applied, tp, jp in out:
        for n in tp:
            start = _to_jax(params0[n])
            scale = np.abs(jp[n] - start).max()
            err = np.abs(tp[n] - jp[n]).max()
            # a parameter's last bits aside (an ulp of 0.2 is 1.5e-8)
            atol = 2 * np.spacing(np.abs(jp[n]).max())
            assert err <= 1e-5 * scale + atol, f"{n}: {err:.3e} of a move of {scale:.3e}"
            moved += scale > 0
    assert moved >= len(SHAPES) * (6 // k - 1)


def test_weight_decay_is_not_scaled_by_the_learning_rate():
    """At lr 0 (the schedule's first count) only the decay moves a
    parameter: by exactly wd * param."""
    p = {"w": torch.full((4, 4), 2.0)}
    tx, _ = build_optimizer(1e-2, 5, 20, adam_weight_decay=0.1, max_grad_norm=0.0,
                            optimizer="adafactor")
    state = tx.init(p)
    tx.update({"w": torch.ones(4, 4)}, state, p)
    torch.testing.assert_close(p["w"], torch.full((4, 4), 2.0 - 0.2), rtol=0, atol=0)


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_factored_dims_pick_the_axes_jax_picks(name):
    port = SHAPES[name]
    jax_shape = _to_jax(np.empty(port, np.float32)).shape
    # the port axis of each JAX axis
    axis = {4: [3, 2, 1, 0], 2: [1, 0], 1: [0]}[len(port)]
    ours = factored_dims(port)
    theirs = factored_dims(jax_shape)
    assert (ours is None) == (theirs is None) == (name in ("narrow", "conv_in", "bias"))
    if ours is not None:
        assert set(ours) == {axis[a] for a in theirs}
        assert theirs == tuple(int(d) for d in np.argsort(jax_shape)[-2:])


def test_factored_estimate_equals_jax():
    """After the steps, each factored parameter's estimate v_row x v_col /
    mean(v_row) equals JAX's (the two packages keep the moments of the
    same axes under swapped names)."""
    _params0, state, jstate, _out = _run_both(1, 0.0, 0.0)
    inner = next(s for s in jax.tree.leaves(jstate, is_leaf=lambda s: isinstance(
        s, JaxFactoredState)) if isinstance(s, JaxFactoredState))
    assert int(inner.count) == state.count
    for i, name in enumerate(SHAPES):
        if state.v_row[i] is None:
            np.testing.assert_allclose(_to_jax(state.v[i].numpy()), np.asarray(inner.v[name]),
                                       rtol=2e-6, err_msg=name)
            continue
        d1, d0 = factored_dims(SHAPES[name])
        vr, vc = state.v_row[i], state.v_col[i]
        est = (vr / vr.mean(dim=d1 - 1 if d1 > d0 else d1, keepdim=True)).unsqueeze(d0) \
            * vc.unsqueeze(d1)
        jd1, jd0 = factored_dims(_to_jax(np.empty(SHAPES[name])).shape)
        jvr, jvc = np.asarray(inner.v_row[name]), np.asarray(inner.v_col[name])
        jest = (np.expand_dims(jvr / jvr.mean(axis=jd1 - 1 if jd1 > jd0 else jd1,
                                                keepdims=True), jd0)
                * np.expand_dims(jvc, jd1))
        np.testing.assert_allclose(_to_jax(est.numpy()), jest, rtol=2e-6, err_msg=name)


def _state_bytes(state):
    """The bytes of an optimizer state's moments: its tensor lists but the
    accumulated gradients."""
    return sum(t.numel() * t.element_size()
               for name in ("mu", "nu", "v_row", "v_col", "v")
               for t in getattr(state, name, None) or [] if t is not None)


def test_state_bytes_of_the_sdxl_vae():
    model = AutoencoderKL(VAEConfig.sdxl(), device="meta")
    params = dict(model.named_parameters())
    assert sum(p.numel() for p in params.values()) == 83_653_863
    adamw, _ = build_optimizer(1e-4, 0, 10)
    ada, _ = build_optimizer(1e-4, 0, 10, optimizer="adafactor")
    assert _state_bytes(adamw.init(params)) == 2 * 4 * 83_653_863
    state = ada.init(params)
    want = 0
    for p in params.values():
        dims = factored_dims(p.shape)
        want += 4 * (p.numel() if dims is None
                     else p.numel() // p.shape[dims[1]] + p.numel() // p.shape[dims[0]])
    assert _state_bytes(state) == want == 2_020_252


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="adamw' or 'adafactor"):
        build_optimizer(1e-3, 0, 10, optimizer="sgd")
    tx, _ = build_optimizer(1e-3, 0, 10, optimizer="adafactor")
    assert isinstance(tx, Adafactor)


# --------------------------------------------------------------------------- #
# through the train step, the checkpoint and the Trainer
# --------------------------------------------------------------------------- #
N_STEPS, BATCH, RES, LR, WD = 3, 2, 16, 2e-3, 0.1


def test_trajectory_matches_the_jax_step():
    model, params = seeded_pair(9, impl="auto")
    initial = {k: v.detach().clone() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, 256, (BATCH, RES, RES, 3), dtype=np.uint8)
               for _ in range(N_STEPS)]
    mask = np.ones(BATCH, np.float32)
    base_rng = jax.random.PRNGKey(5)
    noises = [np.array(jax.random.normal(jax.random.fold_in(base_rng, t),
                                         (BATCH, RES // 2, RES // 2, 4), jnp.float32))
              for t in range(N_STEPS)]
    kw = dict(adam_weight_decay=WD, max_grad_norm=0.05, optimizer="adafactor")

    tx, _ = build_optimizer(LR, 1, 6, **kw)
    state = TrainState.create(model, tx)
    step = make_train_step(model, tx, 1e-6)
    port = []
    for t in range(N_STEPS):
        state, metrics, _ = step(state, {"pixel_values": batches[t]}, mask, noise=noises[t])
        port.append({k: float(v) for k, v in metrics.items()})

    jtx, _ = jax_build_optimizer(LR, 1, 6, **kw)
    jmodule = JaxAutoencoderKL(config=JaxConfig(**NARROW), dtype=jnp.float32)
    jstate = JaxTrainState.create(params, jtx)
    jstep = jax_make_train_step(jmodule, jtx, 1e-6, donate=False)
    ref = []
    for t in range(N_STEPS):
        jstate, metrics, _ = jstep(jstate, {"pixel_values": batches[t]}, mask, base_rng)
        ref.append({k: float(v) for k, v in metrics.items()})

    for t in range(N_STEPS):
        for key in ("train_loss_step", "rec_loss", "kl_loss"):
            np.testing.assert_allclose(port[t][key], ref[t][key], rtol=2e-4, err_msg=f"{key}@{t}")
        np.testing.assert_allclose(port[t]["grad_norm"], ref[t]["grad_norm"], rtol=5e-4)
        assert ref[t]["grad_norm"] > 0.05  # the clip triggers
    final = flatten_params(jstate.params)
    moved = 0
    for name, want in final.items():
        if name.endswith("to_k.bias"):
            continue  # zero gradient by symmetry: roundoff amplified, as for AdamW
        jd = np.asarray(want, np.float64) - initial[name].double().numpy()
        td = (state.model.state_dict()[name].double() - initial[name].double()).numpy()
        scale = np.abs(jd).max()
        if scale < 1e-12:
            continue
        moved += 1
        err = np.abs(jd - td).max()
        assert err < 2e-3 * scale + 1e-9, f"{name}: {err:.3e} vs scale {scale:.3e}"
    assert moved > 30


@pytest.mark.parametrize("accum", [1, 2])
def test_checkpoint_round_trip_is_exact(tmp_path, accum):
    model = AutoencoderKL(VAEConfig(**NARROW))
    model.init_weights(torch.Generator().manual_seed(1))
    tx, _ = build_optimizer(1e-3, 0, 10, optimizer="adafactor",
                            gradient_accumulation_steps=accum)
    state = TrainState.create(model, tx)
    gen = torch.Generator().manual_seed(2)
    for _ in range(3):
        grads = {n: torch.randn(p.shape, generator=gen) for n, p in model.named_parameters()}
        tx.update(grads, state.opt_state, dict(model.named_parameters()))
    save_train_state(str(tmp_path / "c"), state)

    other = AutoencoderKL(VAEConfig(**NARROW))
    fresh = TrainState.create(other, tx)
    restore_train_state(str(tmp_path / "c"), fresh)
    a, b = state.opt_state, fresh.opt_state
    assert (b.count, b.mini_step) == (a.count, a.mini_step) == (3 // accum, 3 % accum)
    for field in ("v_row", "v_col", "v", "acc_grads"):
        live, kept = getattr(a, field), getattr(b, field)
        assert (live is None) == (kept is None)
        for x, y in zip(live or [], kept or []):
            assert (x is None and y is None) or torch.equal(x, y), field
    assert sum(v is not None for v in a.v_row) > 10  # the narrow model's 128-channel convs

    adamw, _ = build_optimizer(1e-3, 0, 10)
    with pytest.raises(ValueError, match="FactoredState"):
        restore_train_state(str(tmp_path / "c"), TrainState.create(other, adamw))


def test_trainer_resume_equals_the_uninterrupted_run(tmp_path):
    def cfg(name, stop_after=0):
        c = _resume_cfg(tmp_path, name, stop_after)
        c["training"]["optimizer"] = "adafactor"
        return c

    full = Trainer(cfg("full"), device="cpu").train()
    assert full["global_step"] == 6
    Trainer(cfg("resumed", stop_after=4), device="cpu").train()
    ckpt = latest_checkpoint(str(tmp_path / "resumed"))
    assert ckpt.endswith("chkpt-4")
    resumed = Trainer(cfg("resumed"), resume_from=ckpt, device="cpu").train()
    assert resumed["global_step"] == 6
    losses = _losses(tmp_path / "full")
    assert len(losses) == 6 and _losses(tmp_path / "resumed") == losses
    from vae_channel_dynamics_tpu_torch.models import io as model_io

    _, a = model_io.load_model_dir(f"{full['final_model_dir']}/vae")
    _, b = model_io.load_model_dir(f"{resumed['final_model_dir']}/vae")
    assert all(torch.equal(a[k], b[k]) for k in a)
