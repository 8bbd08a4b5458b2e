"""Parity of the PyTorch port's models with the JAX package's, on the CPU.

The port's wrapper loads the JAX wrapper's parameters through
``state_dict_from_jax_params`` (``load_state_dict(strict=True)``), and the
same numpy inputs and noise go through both. fp32 throughout (JAX at
Precision.HIGHEST, torch with TF32 off); tolerances as in
tests/test_full_model_torch_parity.py: rtol 1e-4 with atol 1e-5 on
latents and 1e-4 on reconstructions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_channel_dynamics_tpu.models import SDXLVAEWrapper as JaxWrapper
from vae_channel_dynamics_tpu.models import VAEConfig as JaxConfig
from vae_channel_dynamics_tpu.models.distributions import (
    DiagonalGaussianDistribution as JaxDist,
)
from vae_channel_dynamics_tpu.models.io import abstract_params, flatten_params
from vae_channel_dynamics_tpu.utils.naming import iter_torch_named_params
from vae_channel_dynamics_tpu_torch.models import (
    AutoencoderKL,
    DiagonalGaussianDistribution,
    SDXLVAEWrapper,
    VAEConfig,
)
from vae_channel_dynamics_tpu_torch.models.io import state_dict_from_jax_params

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

RTOL = 1e-4
ATOL_LATENT, ATOL_PIXEL = 1e-5, 1e-4

# tests/test_full_model_torch_parity.py's SDXL-shaped miniature: 4 levels,
# conv_shortcut in blocks 1-2 but not 3, attention mid block
SDXL_SHAPED = dict(block_out_channels=(32, 64, 128, 128), layers_per_block=2,
                   norm_num_groups=16, latent_channels=4, sample_size=32)
# 2 levels: at 32px the mid block sees N=256 tokens of C=128, which the flash
# kernel takes
FLASH_SHAPED = dict(block_out_channels=(32, 128), layers_per_block=1,
                    norm_num_groups=8, latent_channels=4, sample_size=32)


def _pair(cfg_kwargs, attn_impl="auto", seed=0):
    jw = JaxWrapper(config=JaxConfig(**cfg_kwargs), dtype=jnp.float32, seed=seed,
                    attn_impl=attn_impl)
    tw = SDXLVAEWrapper(VAEConfig(**cfg_kwargs),
                        state_dict=state_dict_from_jax_params(jw.params),
                        attn_impl=attn_impl, device="cpu")
    return jw, tw


@pytest.fixture(scope="module")
def sdxl_shaped():
    return _pair(SDXL_SHAPED)


def _pixels(seed, b=2, side=32):
    return np.random.default_rng(seed).uniform(-1, 1, (b, side, side, 3)).astype(np.float32)


def _assert_forward_close(j_out, t_out):
    np.testing.assert_allclose(t_out["latent_dist"].mean.numpy(),
                               np.asarray(j_out["latent_dist"].mean),
                               rtol=RTOL, atol=ATOL_LATENT)
    np.testing.assert_allclose(t_out["latent_dist"].logvar.numpy(),
                               np.asarray(j_out["latent_dist"].logvar),
                               rtol=RTOL, atol=ATOL_LATENT)
    np.testing.assert_allclose(t_out["latents_sampled"].numpy(),
                               np.asarray(j_out["latents_sampled"]),
                               rtol=RTOL, atol=ATOL_LATENT)
    np.testing.assert_allclose(t_out["reconstruction"].numpy(),
                               np.asarray(j_out["reconstruction"]),
                               rtol=RTOL, atol=ATOL_PIXEL)


def test_forward_matches_jax(sdxl_shaped):
    jw, tw = sdxl_shaped
    x = _pixels(0)
    j_out = jw.forward(jnp.asarray(x), sample_posterior=False)
    t_out = tw.forward(torch.from_numpy(x), sample_posterior=False)
    _assert_forward_close(j_out, t_out)
    np.testing.assert_allclose(t_out["latent_dist"].kl().numpy(),
                               np.asarray(j_out["latent_dist"].kl()), rtol=RTOL)


def test_sampled_forward_matches_jax_with_its_noise(sdxl_shaped):
    """The JAX model samples ``jax.random.normal(rng, mean.shape)``; the same
    draw, made here and injected as ``noise``, reproduces its sample."""
    jw, tw = sdxl_shaped
    x = _pixels(1)
    rng = jax.random.PRNGKey(3)
    j_out = jw.forward(jnp.asarray(x), sample_posterior=True, rng=rng)
    noise = np.array(jax.random.normal(rng, j_out["latent_dist"].mean.shape,
                                         jnp.float32))
    t_out = tw.forward(torch.from_numpy(x), sample_posterior=True,
                       noise=torch.from_numpy(noise))
    _assert_forward_close(j_out, t_out)


def test_encode_and_decode_match_jax(sdxl_shaped):
    jw, tw = sdxl_shaped
    x = _pixels(2)
    z_j = np.asarray(jw.encode(jnp.asarray(x), deterministic=True))
    z_t = tw.encode(torch.from_numpy(x), deterministic=True)
    np.testing.assert_allclose(z_t.numpy(), z_j, rtol=RTOL, atol=ATOL_LATENT)

    rng = jax.random.PRNGKey(5)
    zs_j = np.asarray(jw.encode(jnp.asarray(x), rng=rng, deterministic=False))
    noise = np.array(jax.random.normal(rng, z_j.shape, jnp.float32))
    zs_t = tw.encode(torch.from_numpy(x), deterministic=False,
                     noise=torch.from_numpy(noise))
    np.testing.assert_allclose(zs_t.numpy(), zs_j, rtol=RTOL, atol=ATOL_LATENT)

    # decode divides by scaling_factor and clamps to [-1, 1]
    latents = (np.random.default_rng(3).standard_normal(z_j.shape) * 4).astype(np.float32)
    d_j = np.asarray(jw.decode(jnp.asarray(latents)))
    d_t = tw.decode(torch.from_numpy(latents))
    np.testing.assert_allclose(d_t.numpy(), d_j, rtol=RTOL, atol=ATOL_PIXEL)
    assert float(d_t.abs().max()) <= 1.0


def test_flash_slice_matches_jax_pallas_interpret():
    """Both models with attn_impl='flash' on a config whose mid block the
    kernels take: the JAX side runs its Pallas kernel in interpret mode, the
    port its plain version (a CPU tensor)."""
    jw, tw = _pair(FLASH_SHAPED, attn_impl="flash", seed=1)
    x = _pixels(4)
    j_out = jw.forward(jnp.asarray(x), sample_posterior=False)
    t_out = tw.forward(torch.from_numpy(x), sample_posterior=False)
    _assert_forward_close(j_out, t_out)


def test_state_dict_from_jax_params_is_the_jax_export():
    """The jax-free conversion equals the JAX package's own torch-layout
    export, name for name, and loads strictly."""
    cfg = JaxConfig.tiny()
    params = JaxWrapper(config=cfg, dtype=jnp.float32, seed=2).params
    converted = state_dict_from_jax_params(params)
    exported = flatten_params(params)
    assert set(converted) == set(exported)
    for name, arr in exported.items():
        np.testing.assert_array_equal(converted[name].numpy(), arr, err_msg=name)
    model = AutoencoderKL(VAEConfig.tiny())
    result = model.load_state_dict(converted, strict=True)
    assert not result.missing_keys and not result.unexpected_keys


def test_sdxl_parameters_match_the_jax_model():
    """Full-width SDXL: 83,653,863 parameters, under the same torch names and
    shapes as the JAX model's (built on the meta device: no memory)."""
    model = AutoencoderKL(VAEConfig.sdxl(), device="meta")
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert sum(int(np.prod(s)) for s in shapes.values()) == 83_653_863
    expected = {}
    for name, leaf in iter_torch_named_params(abstract_params(JaxConfig.sdxl())):
        s = tuple(leaf.shape)
        if len(s) == 4:
            s = (s[3], s[2], s[0], s[1])
        elif len(s) == 2:
            s = (s[1], s[0])
        expected[name] = s
    assert shapes == expected


def test_distribution_matches_jax():
    rng = np.random.default_rng(6)
    moments = (rng.standard_normal((2, 4, 4, 8)) * 10).astype(np.float32)  # hits the clamp
    jd = JaxDist.from_moments(jnp.asarray(moments))
    td = DiagonalGaussianDistribution.from_moments(torch.from_numpy(moments))
    for attr in ("mean", "logvar", "std", "var"):
        np.testing.assert_allclose(getattr(td, attr).numpy(), np.asarray(getattr(jd, attr)),
                                   rtol=RTOL, atol=ATOL_LATENT, err_msg=attr)
    np.testing.assert_allclose(td.mode().numpy(), np.asarray(jd.mode()))
    np.testing.assert_allclose(td.kl().numpy(), np.asarray(jd.kl()), rtol=RTOL)
    key = jax.random.PRNGKey(7)
    noise = np.array(jax.random.normal(key, jd.mean.shape, jnp.float32))
    sample = td.sample(noise=torch.from_numpy(noise))
    np.testing.assert_allclose(sample.numpy(), np.asarray(jd.sample(key)),
                               rtol=RTOL, atol=ATOL_LATENT)
    # NCHW split, as the model uses it, is the same distribution transposed
    tn = DiagonalGaussianDistribution.from_moments(
        torch.from_numpy(moments.transpose(0, 3, 1, 2)), dim=1)
    np.testing.assert_allclose(tn.mean.numpy().transpose(0, 2, 3, 1), td.mean.numpy())
    with pytest.raises(ValueError):
        td.sample(noise=torch.zeros(1, 2, 2, 4))


def test_sampling_is_seeded_by_the_generator():
    td = DiagonalGaussianDistribution.from_moments(torch.zeros(1, 4, 4, 8))
    a = td.sample(generator=torch.Generator().manual_seed(1))
    b = td.sample(generator=torch.Generator().manual_seed(1))
    c = td.sample(generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("name", ["sdxl", "sd", "tiny"])
def test_config_matches_jax(name):
    t_cfg, j_cfg = getattr(VAEConfig, name)(), getattr(JaxConfig, name)()
    assert t_cfg.to_dict() == j_cfg.to_dict()
    assert VAEConfig.from_dict({**t_cfg.to_dict(), "extra": 1}) == t_cfg


def test_bf16_wrapper_keeps_groupnorm_fp32():
    tw = SDXLVAEWrapper(VAEConfig.tiny(), dtype=torch.bfloat16, device="cpu")
    sd = tw.state_dict()
    assert sd["encoder.conv_in.weight"].dtype == torch.bfloat16
    assert sd["encoder.mid_block.attentions.0.to_q.weight"].dtype == torch.bfloat16
    assert sd["encoder.conv_norm_out.weight"].dtype == torch.float32
    out = tw.forward(torch.from_numpy(_pixels(5)), sample_posterior=False)
    assert out["reconstruction"].dtype == torch.bfloat16
    assert torch.isfinite(out["reconstruction"].float()).all()


def test_cuda_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        SDXLVAEWrapper(VAEConfig.tiny(), device="cuda")
