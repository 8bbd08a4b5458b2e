"""The port's capture taps against the JAX model's, on the CPU.

A narrow model (two 128-channel levels, one resnet each, 32 groups) whose
norms the GroupNorm kernels take, with ``impl="pallas"`` on both sides (the
JAX Pallas kernels in interpret mode, the port's plain versions on CPU
tensors), the same parameters, a 16x16 batch of 3 whose last row the tap
mask drops, and a capture table that reaches every tap branch:

- a norm1 output ``mean_abs_activation_per_channel``: the kernel's in-pass
  |z| statistic, SiLU still fused;
- a norm2 output ``std_activation`` and ``zero_fraction_per_channel``: the
  split branch (norm, tap, separate SiLU);
- the ``conv_in`` output and the downsampler conv's (unpadded) input;
- the attention ``to_q`` input, a (B, N, C) tensor;
- one ``full_activation_map``.

The stats dicts must have identical keys and agree at fp32 (JAX at
Precision.HIGHEST, TF32 off): rtol 1e-4 with atol 1e-5, as the port's
model-parity tests; the reconstruction to atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_channel_dynamics_tpu.models.io import abstract_params, unflatten_params
from vae_channel_dynamics_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from vae_channel_dynamics_tpu.models.vae import VAEConfig as JaxConfig
from vae_channel_dynamics_tpu.models.vae import flatten_stats
from vae_channel_dynamics_tpu.ops import stats as jstats
from vae_channel_dynamics_tpu_torch.models import AutoencoderKL, VAEConfig
from vae_channel_dynamics_tpu_torch.models.wrapper import forward_with_stats
from vae_channel_dynamics_tpu_torch.ops import group_norm_kernel as gnk
from vae_channel_dynamics_tpu_torch.ops import stats as tstats

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

RTOL, ATOL = 1e-4, 1e-5
ATOL_PIXEL = 1e-4
NARROW = dict(block_out_channels=(128, 128), layers_per_block=1, norm_num_groups=32)
MEAN_ABS = "mean_abs_activation_per_channel"
CAPTURE = (
    ("encoder.down_blocks.0.resnets.0.norm1", "output", (MEAN_ABS,)),
    ("encoder.down_blocks.0.resnets.0.norm2", "output",
     ("std_activation", "zero_fraction_per_channel")),
    ("encoder.conv_in", "output", (MEAN_ABS, "mean_activation")),
    ("encoder.down_blocks.0.downsamplers.0.conv", "input", (MEAN_ABS,)),
    ("encoder.mid_block.attentions.0.to_q", "input", (MEAN_ABS, "std_activation")),
    ("decoder.up_blocks.1.resnets.0.norm1", "output", ("full_activation_map",)),
)
MASK = np.array([1.0, 1.0, 0.0], np.float32)


def seeded_pair(seed, capture=(), impl="pallas"):
    """A port model with seeded weights (GroupNorm scales and biases drawn
    too, so the affine is not the identity) and the same parameters as a
    JAX params tree."""
    model = AutoencoderKL(VAEConfig(**NARROW), impl=impl, capture=capture)
    gen = torch.Generator().manual_seed(seed)
    model.init_weights(gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 1 and "norm" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    params = unflatten_params(abstract_params(JaxConfig(**NARROW)), state)
    return model, params


@pytest.fixture(scope="module")
def both():
    model, params = seeded_pair(3, CAPTURE)
    x = np.random.default_rng(0).uniform(-1, 1, (3, 16, 16, 3)).astype(np.float32)

    jmodule = JaxAutoencoderKL(config=JaxConfig(**NARROW), dtype=jnp.float32,
                               impl="pallas", capture=CAPTURE)

    @jax.jit
    def jfwd(p, x_, m):
        with jstats.tap_mask(m):
            return jmodule.apply({"params": p}, x_, sample_posterior=False,
                                 mutable=["stats"])

    j_out, mutated = jfwd(params, jnp.asarray(x), jnp.asarray(MASK))
    j_stats = flatten_stats(mutated.get("stats", {}))

    before = dict(gnk.launches)
    with tstats.tap_mask(torch.from_numpy(MASK)):
        t_out, t_stats = forward_with_stats(
            model, torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), sample_posterior=False)
    assert gnk.launches == before  # CPU tensors: the plain versions only
    return j_out, j_stats, t_out, t_stats, model


def test_stat_keys_match_jax(both):
    _j_out, j_stats, _t_out, t_stats, _model = both
    assert set(t_stats) == set(j_stats)
    want = {f"{n}.{p}.{m}" for n, p, ms in CAPTURE for m in ms}
    assert set(t_stats) == want


def test_stat_values_match_jax(both):
    _j_out, j_stats, _t_out, t_stats, _model = both
    for key, want in j_stats.items():
        got = t_stats[key]
        assert not got.requires_grad, key
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL,
                                   err_msg=key)


def test_reconstruction_matches_jax(both):
    j_out, _j_stats, t_out, _t_stats, _model = both
    np.testing.assert_allclose(t_out["reconstruction"].detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(j_out["reconstruction"]), rtol=RTOL,
                               atol=ATOL_PIXEL)
    np.testing.assert_allclose(t_out["latent_dist"].mean.detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(j_out["latent_dist"].mean), rtol=RTOL, atol=ATOL)


def test_norm_taps_take_the_jax_branches(both):
    """norm1 keeps SiLU fused through the kernel's statistic; norm2's
    non-|z| metrics split it; an untapped norm stays fused."""
    *_, model = both
    r0 = model.encoder.down_blocks[0].resnets[0]
    assert r0.norm1._kernel_stats_ok(torch.zeros(1, 128, 8, 8), r0.norm1._specs_for("output"))
    assert not r0.norm2._kernel_stats_ok(torch.zeros(1, 128, 8, 8),
                                         r0.norm2._specs_for("output"))
    assert model.decoder.up_blocks[0].resnets[0].norm1._specs_for("output") == ()


def test_empty_capture_table_taps_nothing():
    model = AutoencoderKL(VAEConfig(**NARROW), impl="pallas")
    model.init_weights(torch.Generator().manual_seed(0))
    out = model(torch.zeros(1, 3, 16, 16), sample_posterior=False)
    assert out["stats"] == {}
    model.set_capture(CAPTURE[:1])
    out = model(torch.zeros(1, 3, 16, 16), sample_posterior=False)
    assert set(out["stats"]) == {f"{CAPTURE[0][0]}.output.{MEAN_ABS}"}
