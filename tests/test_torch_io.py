"""The PyTorch port's model-directory I/O against the JAX package's and the
``safetensors`` package (which the port does not use: it reads and writes
the format on numpy alone)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

from vae_channel_dynamics_tpu.models import SDXLVAEWrapper as JaxWrapper
from vae_channel_dynamics_tpu.models import VAEConfig as JaxConfig
from vae_channel_dynamics_tpu.models import io as jio
from vae_channel_dynamics_tpu_torch.models import SDXLVAEWrapper, VAEConfig
from vae_channel_dynamics_tpu_torch.models import io as tio

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "golden_eval", "torch_ckpt")
FIXTURE = os.path.join(FIXTURE_DIR, "diffusion_pytorch_model.safetensors")


def test_reader_matches_safetensors_on_the_fixture_checkpoint():
    ours = tio.load_safetensors(FIXTURE)
    theirs = load_file(FIXTURE)
    assert set(ours) == set(theirs) and len(ours) == 248
    for name, arr in theirs.items():
        assert ours[name].dtype == arr.dtype and ours[name].shape == arr.shape
        np.testing.assert_array_equal(ours[name], arr, err_msg=name)


def test_writer_is_read_back_by_safetensors(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {
        "b.f32": rng.standard_normal((3, 5)).astype(np.float32),
        "a.f16": rng.standard_normal((7,)).astype(np.float16),
        "c.i64": np.arange(6, dtype=np.int64).reshape(2, 3),
        "d.u8": np.arange(3, dtype=np.uint8),
        "e.scalar": np.float32(2.5).reshape(()),
    }
    path = str(tmp_path / "t.safetensors")
    tio.save_safetensors(tensors, path)
    theirs = load_file(path)
    ours = tio.load_safetensors(path)
    for name, arr in tensors.items():
        np.testing.assert_array_equal(theirs[name], arr, err_msg=name)
        np.testing.assert_array_equal(ours[name], arr, err_msg=name)
        assert ours[name].dtype == arr.dtype


def test_reader_widens_bf16_to_float32(tmp_path):
    from safetensors.torch import save_file as save_torch

    x = torch.randn(4, 3).to(torch.bfloat16)
    path = str(tmp_path / "bf16.safetensors")
    save_torch({"x": x}, path)
    got = tio.load_safetensors(path)["x"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, x.float().numpy())


def test_port_model_dir_loads_in_the_jax_package(tmp_path):
    tw = SDXLVAEWrapper(VAEConfig.tiny(), seed=3, device="cpu")
    tio.save_model_dir(str(tmp_path), tw.config, tw.state_dict())
    config, params = jio.load_model_dir(str(tmp_path))
    assert config.to_dict() == tw.config.to_dict()
    exported = jio.flatten_params(params)
    sd = tw.state_dict()
    assert set(exported) == set(sd)
    for name, arr in exported.items():
        np.testing.assert_array_equal(arr, sd[name].numpy(), err_msg=name)


def test_jax_model_dir_loads_in_the_port(tmp_path):
    cfg = JaxConfig.tiny()
    jw = JaxWrapper(config=cfg, dtype=jnp.float32, seed=4)
    jio.save_model_dir(str(tmp_path), cfg, jw.params)
    config, sd = tio.load_model_dir(str(tmp_path))
    assert config.to_dict() == cfg.to_dict()
    tw = SDXLVAEWrapper(config, state_dict=sd, device="cpu")  # strict load
    for name, arr in jio.flatten_params(jw.params).items():
        np.testing.assert_array_equal(tw.state_dict()[name].numpy(), arr, err_msg=name)


def test_fixture_checkpoint_loads_strictly():
    config, sd = tio.load_model_dir(FIXTURE_DIR)
    assert config.block_out_channels == (16, 32, 64, 64)
    tw = SDXLVAEWrapper(config, state_dict=sd, device="cpu")
    x = torch.zeros(1, 64, 64, 3)
    assert tw.encode(x, deterministic=True).shape == (1, 8, 8, 4)


def test_config_json_matches_the_jax_writer():
    for cfg in (VAEConfig.sdxl(), VAEConfig.tiny()):
        assert tio.diffusers_config_dict(cfg) == jio.diffusers_config_dict(
            JaxConfig(**cfg.to_dict()))


def test_missing_weights_raise(tmp_path):
    tio.save_model_dir(str(tmp_path), VAEConfig.tiny(),
                       SDXLVAEWrapper(VAEConfig.tiny(), device="cpu").state_dict())
    os.remove(tmp_path / "diffusion_pytorch_model.safetensors")
    with pytest.raises(FileNotFoundError):
        tio.load_model_dir(str(tmp_path))


def test_legacy_weight_name_is_replaced_on_save(tmp_path):
    save_file({"x": np.zeros(1, np.float32)}, str(tmp_path / "model.safetensors"))
    tio.save_model_dir(str(tmp_path), VAEConfig.tiny(),
                       SDXLVAEWrapper(VAEConfig.tiny(), device="cpu").state_dict())
    assert not (tmp_path / "model.safetensors").exists()
