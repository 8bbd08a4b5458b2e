"""``remat: conv`` on the card: what the backward launches. Skips without a
GPU. Imports no jax, so on a machine without jax it runs without the
repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_remat_conv_cuda.py -q

Under ``kernel_impl: fused`` the fused op keeps only what its backward
reads, so ``conv`` runs a fused body as ``none`` does: a fused 256-channel
block at 32x32 launches the fused forward (#9) twice a forward and backward
under ``conv`` as under ``none`` (four times under ``full``, whose
checkpoint runs the body again), with the same backward kernels and
bit-equal gradients. An unfused block under ``pallas`` launches the
GroupNorm forward kernels as often as under ``full`` (each conv's input is
computed again in the backward) and runs as many convolutions as under
``none`` (fewer than ``full``).
"""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from vae_channel_dynamics_tpu_torch.models import vae as tvae
from vae_channel_dynamics_tpu_torch.ops import fused_resnet as fr
from vae_channel_dynamics_tpu_torch.ops import group_norm_kernel as gnk

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def _block(device, channels, impl, remat):
    blk = tvae.ResnetBlock2D(channels, channels, 32, 1e-6, device=device)
    gen = torch.Generator(device=device).manual_seed(3)
    with torch.no_grad():
        for m in blk.modules():
            if isinstance(m, (tvae.Conv2d, tvae.GroupNorm)):
                m.init_weights(gen)
            if isinstance(m, tvae.Conv2d):
                m.compute_dtype = torch.bfloat16
            if isinstance(m, tvae.GroupNorm):
                m.impl = impl
    blk.impl, blk.remat = impl, remat
    return blk


class _Convs(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.count += func is torch.ops.aten.convolution.default
        return func(*args, **(kwargs or {}))


def _run(device, channels, impl, remat, hw):
    blk = _block(device, channels, impl, remat)
    gen = torch.Generator(device=device).manual_seed(5)
    x = torch.randn((4, channels, hw, hw), generator=gen, device=device)
    x = x.to(torch.bfloat16).requires_grad_(True)
    before = {**fr.launches, **gnk.launches}
    with _Convs() as convs:
        torch.mean(torch.square(blk(x).float())).backward()
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in {**fr.launches, **gnk.launches}.items()}
    grads = [x.grad] + [p.grad for p in blk.parameters()]
    return launched, convs.count, grads


def test_fused_block_under_conv_launches_the_fused_forward_as_under_none(cuda):
    runs = {remat: _run(cuda, 256, "fused", remat, 32) for remat in ("none", "conv", "full")}
    for remat, (launched, _convs, _grads) in runs.items():
        assert launched["fused_gn_silu_conv3x3"] == (4 if remat == "full" else 2), remat
        assert launched["conv3x3"] == launched["conv3x3_dw"] == 2, remat
    assert all(torch.equal(a, b) for a, b in zip(runs["conv"][2], runs["none"][2]))


def test_unfused_block_under_conv_recomputes_the_norm_kernels(cuda):
    runs = {remat: _run(cuda, 128, "pallas", remat, 64) for remat in ("none", "conv", "full")}
    forward = ("gn_fwd_reduce", "gn_fwd_normalize")
    for name in forward:
        assert runs["conv"][0][name] == runs["full"][0][name] == 2 * runs["none"][0][name] == 4
    assert runs["conv"][1] == runs["none"][1] == 2 < runs["full"][1]
    for name in ("gn_bwd_reduce", "gn_bwd_dx"):
        assert runs["conv"][0][name] == runs["none"][0][name] == 2
