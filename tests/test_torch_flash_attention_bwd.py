"""The flash-attention training path of the PyTorch port against the JAX
package's Pallas kernels, on the CPU.

On a CPU tensor the port runs each kernel's plain version: the LSE forward
``flash_attention_fwd_lse_reference`` and the backward
``flash_attention_bwd_reference``, and ``_FlashAttention`` (what
``flash_attention`` runs when autograd records) is built from them. They are
held here against the JAX package's ``_flash_forward(..., with_lse=True)``
and ``_flash_backward`` in Pallas interpret mode (as
tests/test_flash_attention.py runs them), on the same numpy inputs.

Tolerances: fp32 with JAX at Precision.HIGHEST and TF32 off, rtol 1e-5 /
atol 1e-6 as tests/test_flash_attention.py:102 holds the JAX kernels to
their own references (only the summation order differs); bf16 compared in
fp32 as relative L2 error <= 1e-2 (both round P and dS to bf16 before the
products, where exp may differ in its last bit, and round the outputs).
The AttentionBlock gradients go through GroupNorm and three projections
more, so they take the model tests' rtol 1e-4 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_channel_dynamics_tpu.models.io import flatten_params
from vae_channel_dynamics_tpu.models.vae import AttentionBlock as JaxAttentionBlock
from vae_channel_dynamics_tpu.ops import pallas_attention as jflash
from vae_channel_dynamics_tpu_torch.models.vae import AttentionBlock
from vae_channel_dynamics_tpu_torch.ops import flash_attention as tflash

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

HIGHEST = jax.lax.Precision.HIGHEST
RTOL, ATOL = 1e-5, 1e-6
BF16_REL_L2 = 1e-2
SHAPES = [(2, 256, 128), (1, 384, 256)]


def _arrays(shape, seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jax_fwd_bwd(q, k, v, do, scale, dtype, precision):
    """The JAX kernels: (o, lse) from the training forward, then delta as
    ``_flash_bwd`` forms it and (dq, dk, dv) from the backward kernels."""
    jq, jk, jv, jdo = (jnp.asarray(a, dtype) for a in (q, k, v, do))
    o, lse = jflash._flash_forward(jq, jk, jv, scale, dtype, precision, with_lse=True)
    delta = jnp.sum(jdo.astype(jnp.float32) * o.astype(jnp.float32), axis=-1,
                    keepdims=True)
    delta = jnp.broadcast_to(delta, (*delta.shape[:2], jflash.LANE))
    dq, dk, dv = jflash._flash_backward(jq, jk, jv, jdo, lse, delta, scale, precision)
    return o, lse[..., 0], delta[..., 0], (dq, dk, dv)


def _bwd(q, k, v, do, lse, delta, scale):
    """(dq, dk, dv) through the two backward wrappers, as the autograd
    Function calls them (their plain versions on the CPU)."""
    dk, dv = tflash.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale=scale)
    return tflash.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale=scale), dk, dv


@pytest.mark.parametrize("shape", SHAPES)
def test_lse_and_backward_references_match_jax_kernels_fp32(shape):
    q, k, v, do = _arrays(shape, seed=sum(shape))
    scale = 1.0 / np.sqrt(shape[-1])
    jo, jlse, jdelta, jgrads = _jax_fwd_bwd(q, k, v, do, scale, jnp.float32, HIGHEST)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = tflash.flash_attention_fwd_lse(tq, tk, tv, scale=scale, out_dtype=torch.float32)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=RTOL, atol=ATOL)
    delta = (tdo * o).sum(-1)
    np.testing.assert_allclose(delta.numpy(), np.asarray(jdelta), rtol=RTOL, atol=ATOL)
    grads = _bwd(tq, tk, tv, tdo, lse, delta, scale)
    for name, g, jg in zip(("dq", "dk", "dv"), grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=RTOL, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("shape", SHAPES)
def test_lse_and_backward_references_match_jax_kernels_bf16(shape):
    q, k, v, do = _arrays(shape, seed=sum(shape) + 1)
    scale = 1.0 / np.sqrt(shape[-1])
    jo, jlse, _jdelta, jgrads = _jax_fwd_bwd(q, k, v, do, scale, jnp.bfloat16,
                                             jax.lax.Precision.DEFAULT)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do))
    o, lse = tflash.flash_attention_fwd_lse(tq, tk, tv, scale=scale, out_dtype=torch.bfloat16)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert _rel_l2(o.float().numpy(), np.asarray(jo, np.float32)) <= BF16_REL_L2
    # lse is fp32 from bf16 logits on both sides
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-5, atol=1e-5)
    delta = (tdo.float() * o.float()).sum(-1)
    grads = _bwd(tq, tk, tv, tdo, lse, delta, scale)
    for name, g, jg in zip(("dq", "dk", "dv"), grads, jgrads):
        assert g.dtype == torch.bfloat16
        rel = _rel_l2(g.float().numpy(), np.asarray(jg, np.float32))
        assert rel <= BF16_REL_L2, (name, rel)


def test_autograd_function_matches_jax_vjp():
    """``flash_attention`` with inputs that require a gradient runs
    ``_FlashAttention``; its output and gradients against ``jax.vjp`` of the
    JAX ``flash_attention`` (its custom VJP: the Pallas backward kernels)."""
    q, k, v, g = _arrays((2, 256, 128), seed=5)
    scale = 1.0 / np.sqrt(128)
    jout, vjp = jax.vjp(
        lambda a, b, c: jflash.flash_attention(a, b, c, scale=scale, out_dtype=jnp.float32,
                                               precision=HIGHEST),
        *(jnp.asarray(a) for a in (q, k, v)))
    jgrads = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    before = dict(tflash.launches)
    out = tflash.flash_attention(*leaves, scale=scale, out_dtype=torch.float32)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    assert tflash.launches == before  # CPU tensors: the plain versions only
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=RTOL, atol=ATOL)
    for name, t, j in zip(("dq", "dk", "dv"), grads, jgrads):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def test_flash_attention_without_grad_is_the_serving_forward():
    q, k, v = (torch.from_numpy(a) for a in _arrays((1, 128, 128), seed=6, n=3))
    with torch.no_grad():
        out = tflash.flash_attention(q, k, v, scale=0.1, out_dtype=torch.float32)
    assert out.grad_fn is None
    torch.testing.assert_close(out, tflash.flash_attention_reference(q, k, v, 0.1,
                                                                     torch.float32))


def test_attention_block_flash_gradients_match_jax_block():
    """The mid block's attention with ``attn_impl="flash"``: every parameter
    gradient (group_norm, to_q, to_k, to_v, to_out) and the input gradient
    against the JAX block's, fp32, the same weights and inputs."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 16, 16, 128)).astype(np.float32)   # NHWC, N = 256
    g = rng.standard_normal(x.shape).astype(np.float32)
    jblk = JaxAttentionBlock(channels=128, num_groups=32, attn_impl="flash", full_name="mid")
    params = jblk.init(jax.random.PRNGKey(8), jnp.asarray(x))["params"]
    # non-trivial GroupNorm affine, so its gradients are not the identity's
    params["group_norm"] = {
        "scale": jnp.asarray(rng.uniform(0.5, 1.5, 128).astype(np.float32)),
        "bias": jnp.asarray(rng.uniform(-0.2, 0.2, 128).astype(np.float32)),
    }

    def jloss(p, xx):
        return jnp.sum(jblk.apply({"params": p}, xx) * jnp.asarray(g))

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))

    blk = AttentionBlock(128, 32, 1e-6, attn_impl="flash")
    blk.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in flatten_params(params).items()}, strict=True)
    tx = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    out = blk(tx)
    out.backward(torch.from_numpy(g.transpose(0, 3, 1, 2).copy()))
    want = flatten_params(jgp)
    for name, p in blk.named_parameters():
        assert p.grad is not None and p.grad.abs().max() > 0, name
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(tx.grad.numpy().transpose(0, 2, 3, 1), np.asarray(jgx),
                               rtol=1e-4, atol=1e-5)
