"""Parity of the PyTorch port's ops with the JAX package's, on the CPU.

Inputs come from numpy with a seed and go through both functions. fp32
throughout, JAX at Precision.HIGHEST and torch with TF32 off, so the only
differences are float reassociation: rtol 1e-4 / atol 1e-5, the tolerance of
tests/test_full_model_torch_parity.py. The flash path is the JAX Pallas
kernel in interpret mode (as tests/test_flash_attention.py runs it) against
the port's plain version, which is what the port runs on a CPU tensor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_channel_dynamics_tpu.ops import attention as jattn
from vae_channel_dynamics_tpu.ops import pallas_attention as jflash
from vae_channel_dynamics_tpu.ops.group_norm import _group_norm_xla
from vae_channel_dynamics_tpu_torch.ops import attention as tattn
from vae_channel_dynamics_tpu_torch.ops import flash_attention as tflash
from vae_channel_dynamics_tpu_torch.ops.group_norm import group_norm

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

HIGHEST = jax.lax.Precision.HIGHEST
RTOL, ATOL = 1e-4, 1e-5


def _qkv(b, n, c, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, n, c)).astype(np.float32) for _ in range(3))


@pytest.mark.parametrize("fuse_silu", [False, True])
def test_group_norm_matches_jax(fuse_silu):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 6, 5, 32)).astype(np.float32) * 3.0 + 0.5
    scale = rng.standard_normal(32).astype(np.float32)
    bias = rng.standard_normal(32).astype(np.float32)
    ref = _group_norm_xla(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                          8, 1e-6, fuse_silu)
    out = group_norm(torch.from_numpy(x.transpose(0, 3, 1, 2)), torch.from_numpy(scale),
                     torch.from_numpy(bias), 8, 1e-6, fuse_silu=fuse_silu)
    np.testing.assert_allclose(out.numpy().transpose(0, 2, 3, 1), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


def test_group_norm_keeps_input_dtype_and_refuses_unported_impls():
    x = torch.randn(1, 16, 4, 4, dtype=torch.bfloat16)
    w, b = torch.ones(16), torch.zeros(16)
    assert group_norm(x, w, b, 4, impl="xla").dtype == torch.bfloat16
    # under "fused" a norm outside the fused resnets runs plain, as in JAX
    assert torch.equal(group_norm(x, w, b, 4, fuse_silu=True, impl="fused"),
                       group_norm(x, w, b, 4, fuse_silu=True, impl="xla"))
    # the GroupNorm kernels are ported; 16 channels is a shape they refuse,
    # as the JAX kernels do
    with pytest.raises(RuntimeError, match="ineligible"):
        group_norm(x, w, b, 4, impl="pallas")
    with pytest.raises(ValueError):
        group_norm(x, w, b, 4, impl="typo")


def test_naive_attention_matches_jax():
    q, k, v = _qkv(2, 64, 32, seed=1)
    scale = 1.0 / np.sqrt(32)
    logits = jnp.einsum("bqc,bkc->bqk", q, k, preferred_element_type=jnp.float32,
                        precision=HIGHEST) * scale
    ref = jnp.einsum("bqk,bkc->bqc", jax.nn.softmax(logits, axis=-1), v,
                     precision=HIGHEST)
    out = tattn.naive_attention(*map(torch.from_numpy, (q, k, v)), scale=scale,
                                out_dtype=torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n,chunk", [(64, 16), (50, 16)])  # exact and padded
def test_chunked_attention_matches_jax(n, chunk):
    q, k, v = _qkv(2, n, 32, seed=2)
    scale = 1.0 / np.sqrt(32)
    ref = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  scale=scale, out_dtype=jnp.float32,
                                  precision=HIGHEST, chunk=chunk)
    out = tattn.chunked_attention(*map(torch.from_numpy, (q, k, v)), scale=scale,
                                  out_dtype=torch.float32, chunk=chunk)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_flash_attention_on_cpu_matches_jax_pallas_interpret():
    q, k, v = _qkv(2, 256, 128, seed=3)
    scale = 1.0 / np.sqrt(128)
    ref = jflash.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 scale=scale, out_dtype=jnp.float32, precision=HIGHEST)
    before = dict(tflash.launches)
    out = tflash.flash_attention(*map(torch.from_numpy, (q, k, v)), scale=scale,
                                 out_dtype=torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    # the CPU path is the plain version: no kernel launch is counted
    assert tflash.launches == before


def test_flash_reference_bf16_matches_jax_pallas_interpret():
    """bf16 inputs, compared in fp32: both round the probabilities to bf16
    before the product with v (the JAX kernel unnormalised, the reference
    normalised) and the output to bf16, so they agree to a few bf16 ulps."""
    q, k, v = _qkv(2, 256, 128, seed=4)
    scale = 1.0 / np.sqrt(128)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = jflash.flash_attention(jq, jk, jv, scale=scale, out_dtype=jnp.bfloat16,
                                 precision=jax.lax.Precision.DEFAULT)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out = tflash.flash_attention_reference(tq, tk, tv, scale, torch.bfloat16)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("n,c,expect", [
    (4096, 512, True), (16384, 512, True), (128, 128, True), (256, 384, True),
    (4096, 640, True),    # a cluster of two CTAs in the forwards, five in the backward
    (16384, 1024, True),  # the widest: clusters of two and eight
    (4096, 1152, False),  # past the kernels' 1024 channels
    (4000, 512, False),   # tokens not a multiple of 128
    (4096, 96, False),
])
def test_flash_eligibility(n, c, expect):
    assert tflash.eligible(n, c) is expect


@pytest.mark.parametrize("tokens", [1024, 4096, 16384])
@pytest.mark.parametrize("impl", ["auto", "naive", "chunked", "flash"])
def test_resolvers_match_jax_policy(impl, tokens):
    assert tattn.resolve_serving_impl(impl, tokens, 512) == jattn.resolve_serving_impl(
        impl, tokens, 512)
    for batch in (None, 1, 8):
        assert tattn.resolve_impl(impl, tokens, 512, batch=batch) == jattn.resolve_impl(
            impl, tokens, 512, batch=batch)


def test_resolver_takes_chunked_where_the_kernel_cannot():
    # C=1152 is within the JAX kernel's rule but past the CUDA kernels'
    assert tattn.resolve_serving_impl("auto", 4096, 1152) == "naive"
    assert tattn.resolve_serving_impl("auto", 16384, 1152) == "chunked"
    with pytest.raises(ValueError):
        tattn.resolve_impl("typo", 16)
