"""The port's train-state checkpoints, on the CPU: a save/restore round trip
is exact, ``latest_checkpoint`` and ``prune_checkpoints`` pick and delete the
same directories as the JAX package's, the async writer writes what the
synchronous one does, and a model directory written by either package
loads in the other with equal arrays."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_channel_dynamics_tpu.models import io as jio
from vae_channel_dynamics_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from vae_channel_dynamics_tpu.models.vae import VAEConfig as JaxConfig
from vae_channel_dynamics_tpu.training import checkpoint as jckpt
from vae_channel_dynamics_tpu_torch.models import AutoencoderKL, VAEConfig
from vae_channel_dynamics_tpu_torch.models import io as tio
from vae_channel_dynamics_tpu_torch.training import TrainState, build_optimizer
from vae_channel_dynamics_tpu_torch.training import checkpoint as tckpt

TINY = dict(block_out_channels=(16, 32), layers_per_block=1, norm_num_groups=8)


def _state(seed, ema=True, accum=1):
    model = AutoencoderKL(VAEConfig(**TINY))
    model.init_weights(torch.Generator().manual_seed(seed))
    tx, _ = build_optimizer(1e-3, 1, 10, gradient_accumulation_steps=accum)
    acc = {"encoder.conv_in.output.mean_abs_activation_per_channel": torch.zeros(16)}
    state = TrainState.create(model, tx, stats_acc=acc, ema=ema)
    gen = torch.Generator().manual_seed(seed + 100)
    # make every leaf distinct from a fresh state's
    for t in (*state.opt_state.mu, *state.opt_state.nu, *state.stats_acc.values(),
              *(state.opt_state.acc_grads or []), *(state.ema_params or {}).values()):
        t.copy_(torch.randn(t.shape, generator=gen))
    state.opt_state.count, state.opt_state.mini_step, state.step = 7, accum - 1, 9
    state.stats_count.fill_(3.0)
    return state


def _flat(state):
    return tckpt.state_dict_of(state)


def _assert_same(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert a == b


@pytest.mark.parametrize("accum", [1, 3])
def test_round_trip_is_exact(tmp_path, accum):
    saved = _state(0, accum=accum)
    meta = {"micro_step": 9, "global_step": 3, "epoch": 1, "in_epoch_batches": 2}
    tckpt.save_train_state(str(tmp_path / "chkpt-9"), saved, meta=meta)
    assert os.path.isfile(tmp_path / "chkpt-9" / "state" / "train_state.pt")
    restored = tckpt.restore_train_state(str(tmp_path / "chkpt-9"), _state(1, accum=accum))
    _assert_same(_flat(restored), _flat(saved))
    assert tckpt.read_resume_meta(str(tmp_path / "chkpt-9")) == meta
    assert json.loads((tmp_path / "chkpt-9" / "resume_meta.json").read_text()) == meta


def test_restore_refuses_a_different_structure(tmp_path):
    tckpt.save_train_state(str(tmp_path / "c"), _state(0, ema=True))
    with pytest.raises(ValueError, match="EMA"):
        tckpt.restore_train_state(str(tmp_path / "c"), _state(1, ema=False))
    with pytest.raises(FileNotFoundError):
        tckpt.restore_train_state(str(tmp_path / "absent"), _state(1))


def test_async_saver_writes_what_the_sync_path_writes(tmp_path):
    state = _state(2)
    saver = tckpt.AsyncSaver()
    done = []
    saver.save(str(tmp_path / "a"), state, on_complete=lambda: done.append(1),
               meta={"micro_step": 1, "epoch": 0, "in_epoch_batches": 1})
    # the snapshot is taken at save(): a later in-place update is not in it
    want = tckpt.state_dict_of(state, copy=lambda t: t.detach().clone())
    for p in state.model.parameters():
        p.data.add_(1.0)
    saver.wait()
    assert done == [1]
    got = torch.load(tmp_path / "a" / "state" / "train_state.pt", weights_only=True)
    _assert_same(got, want)


def test_unreadable_resume_meta_is_ignored(tmp_path):
    (tmp_path / "c").mkdir()
    (tmp_path / "c" / "resume_meta.json").write_text('{"micro_step": null}')
    assert tckpt.read_resume_meta(str(tmp_path / "c")) is None
    assert tckpt.read_resume_meta(str(tmp_path / "absent")) is None


def _layout(root, names, with_state):
    for name in names:
        os.makedirs(os.path.join(root, name, "state") if with_state(name)
                    else os.path.join(root, name))


@pytest.mark.parametrize("keep", [0, 1, 2, 5])
def test_latest_and_prune_match_jax(tmp_path, keep):
    names = ["chkpt-2", "chkpt-10", "chkpt-7", "chkpt-x", "final_model", "other-3",
             "chkpt-12"]
    for side in ("torch", "jax"):
        # chkpt-12 has no state/: not a checkpoint to resume from
        _layout(str(tmp_path / side), names, lambda n: n != "chkpt-12")
    assert (os.path.basename(tckpt.latest_checkpoint(str(tmp_path / "torch")))
            == os.path.basename(jckpt.latest_checkpoint(str(tmp_path / "jax")))
            == "chkpt-10")
    tckpt.prune_checkpoints(str(tmp_path / "torch"), "chkpt", keep)
    jckpt.prune_checkpoints(str(tmp_path / "jax"), "chkpt", keep)
    assert sorted(os.listdir(tmp_path / "torch")) == sorted(os.listdir(tmp_path / "jax"))
    assert tckpt.latest_checkpoint(str(tmp_path / "none")) is None


def test_port_model_dir_loads_in_jax(tmp_path):
    model = AutoencoderKL(VAEConfig(**TINY))
    model.init_weights(torch.Generator().manual_seed(4))
    tio.save_model_dir(str(tmp_path / "vae"), model.config, dict(model.named_parameters()))
    cfg, params = jio.load_model_dir(str(tmp_path / "vae"))
    assert cfg == JaxConfig(**TINY)
    flat = jio.flatten_params(params)
    state = model.state_dict()
    assert flat.keys() == state.keys()
    for k in flat:
        np.testing.assert_array_equal(flat[k], state[k].numpy())


def test_jax_model_dir_loads_in_the_port(tmp_path):
    module = JaxAutoencoderKL(config=JaxConfig(**TINY))
    params = module.init({"params": jax.random.PRNGKey(5), "sample": jax.random.PRNGKey(6)},
                         jnp.zeros((1, 8, 8, 3)), sample_posterior=False)["params"]
    jio.save_model_dir(str(tmp_path / "vae"), JaxConfig(**TINY), params)
    cfg, state = tio.load_model_dir(str(tmp_path / "vae"))
    assert cfg == VAEConfig(**TINY)
    model = AutoencoderKL(cfg)
    model.load_state_dict(state, strict=True)
    flat = jio.flatten_params(params)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), flat[k])
