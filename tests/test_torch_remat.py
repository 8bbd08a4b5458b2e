"""Rematerialisation of the port's resnets (``remat``: none | full), on the
CPU.

``remat: full`` wraps every ``ResnetBlock2D`` in ``torch.utils.checkpoint``:
the backward runs each body again. It must change nothing but memory: the
same loss, the same gradients and the same tap values as ``remat: none`` on
the same weights, batch and noise, and the recompute must leave no tap
values behind. The two runs do the same float operations in the same order,
so they are held to equality. ``conv`` and ``offload`` (JAX
``_resnet_remat_cls``) are not ported and raise.
"""

import numpy as np
import pytest
import torch

from vae_channel_dynamics_tpu_torch.models import AutoencoderKL, VAEConfig
from vae_channel_dynamics_tpu_torch.models.vae import ResnetBlock2D, remat_enabled
from vae_channel_dynamics_tpu_torch.models.wrapper import forward_with_stats
from vae_channel_dynamics_tpu_torch.ops.stats import tap_mask

NARROW = dict(block_out_channels=(128, 128), layers_per_block=1, norm_num_groups=32)
MEAN_ABS = "mean_abs_activation_per_channel"
# taps inside the rematerialised resnets (the kernel-stats branch of norm1,
# the split branch of norm2, a conv output) and one outside them
CAPTURE = (
    ("encoder.down_blocks.0.resnets.0.norm1", "output", (MEAN_ABS,)),
    ("encoder.down_blocks.0.resnets.0.norm2", "output", ("std_activation",)),
    ("decoder.up_blocks.1.resnets.0.conv1", "output", (MEAN_ABS, "mean_activation")),
    ("encoder.conv_in", "output", (MEAN_ABS,)),
)


def _run(remat, impl):
    model = AutoencoderKL(VAEConfig(**NARROW), impl=impl, capture=CAPTURE, remat=remat)
    model.init_weights(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 3, 16, 16)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((2, 4, 8, 8)).astype(np.float32))
    mask = torch.tensor([1.0, 0.0])
    with tap_mask(mask):
        out, stats = forward_with_stats(model, x, True, noise=noise)
        loss = (out["reconstruction"] - x).square().mean() + 1e-3 * out["latent_dist"].kl().mean()
        loss.backward()
    leftover = dict(model._stats)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return loss.detach(), grads, stats, leftover


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_full_remat_matches_no_remat(impl):
    loss0, grads0, stats0, _ = _run("none", impl)
    loss1, grads1, stats1, leftover = _run("full", impl)
    assert torch.equal(loss0, loss1)
    assert grads0.keys() == grads1.keys()
    for name in grads0:
        torch.testing.assert_close(grads1[name], grads0[name], rtol=0, atol=0, msg=name)
    assert stats0.keys() == stats1.keys() and len(stats0) == 5
    for key in stats0:
        torch.testing.assert_close(stats1[key], stats0[key], rtol=0, atol=0, msg=key)
    # the backward's recompute reported nothing
    assert leftover == {}


def test_remat_wraps_every_resnet_and_only_under_autograd():
    model = AutoencoderKL(VAEConfig(**NARROW), remat=True)
    resnets = [m for m in model.modules() if isinstance(m, ResnetBlock2D)]
    assert resnets and all(m.remat for m in resnets)
    assert not any(m.remat for m in model.set_remat("none").modules()
                   if isinstance(m, ResnetBlock2D))
    model.set_remat("full").init_weights(torch.Generator().manual_seed(0))
    x = torch.zeros(1, 3, 16, 16)
    with torch.no_grad():
        a = model(x, sample_posterior=False)["reconstruction"]
    b = model.set_remat("none")(x, sample_posterior=False)["reconstruction"].detach()
    assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["conv", "offload"])
def test_unported_remat_modes_raise(mode):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        AutoencoderKL(VAEConfig.tiny(), remat=mode)


@pytest.mark.parametrize("value,expect", [(False, False), ("none", False), (None, False),
                                          (True, True), ("full", True)])
def test_remat_values(value, expect):
    assert remat_enabled(value) is expect
    with pytest.raises(ValueError):
        remat_enabled("typo")
