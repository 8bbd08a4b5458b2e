"""Flash attention at heads wider than 512 channels, on the CPU against the
JAX package.

The JAX flash kernels take any multiple of 128 channels
(``pallas_attention.eligible``); the port's CUDA kernels take every multiple
of 128 up to 1024 (the forwards on a cluster of two CTAs past 512, the
backward on clusters of up to eight), and past 1024 a CUDA call and the
model's explicit ``flash`` raise naming their ROADMAP item. Here, where
every CUDA kernel runs its plain version:

- ``eligible`` equals the JAX ``eligible`` (no mesh) at every multiple of
  128 channels up to 1024, for the token counts of the JAX flash tests;
- the port's op (forward with its lse, and the backward) at C = 640 and
  1024 against the JAX kernels in Pallas interpret mode, fp32 at
  ``Precision.HIGHEST``: relative L2 1e-5 and lse within 1e-5 of max|lse|,
  the card's fp32 bounds;
- a tiny VAE whose last ``block_out_channels`` entry is 640 (a 256-token
  mid block at 32px) under ``attention_impl: flash``, its weights carried
  from the JAX model by ``flatten_params`` (strict load): the
  reconstruction within rtol 1e-4 and atol 1e-4 of JAX's
  (tests/test_torch_models.py's bounds), and every parameter's gradient of
  a seeded linear loss on the reconstruction within relative L2 1e-4 of
  JAX's (both fp32; the two sum their convolutions and attention in other
  orders), but the attention's key bias, whose gradient the softmax makes
  zero: there both are under 1e-5 of the largest gradient;
- past 1024 channels the model's explicit ``flash`` raises where JAX runs
  its kernel, and a shape the JAX kernels refuse still runs ``chunked``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_channel_dynamics_tpu.models import SDXLVAEWrapper as JaxWrapper
from vae_channel_dynamics_tpu.models import VAEConfig as JaxConfig
from vae_channel_dynamics_tpu.models.io import flatten_params
from vae_channel_dynamics_tpu.ops import pallas_attention as jflash
from vae_channel_dynamics_tpu_torch.models import AutoencoderKL, VAEConfig
from vae_channel_dynamics_tpu_torch.models import vae as tvae
from vae_channel_dynamics_tpu_torch.ops import flash_attention as fa

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

F32_REL_L2 = 1e-5
LSE_MAX_REL = 1e-5
RTOL, ATOL = 1e-4, 1e-4
GRAD_REL_L2 = 1e-4
# the token counts of tests/test_flash_attention.py's eligibility and kernel
# tests, and the model's mid blocks at 256 to 1024px
TOKEN_COUNTS = (100, 128, 144, 256, 384, 1024, 4000, 4096, 16384)
WIDE_VAE = dict(block_out_channels=(32, 640), layers_per_block=1, norm_num_groups=8,
                latent_channels=4, sample_size=32)


@pytest.fixture
def one_thread():
    """One intra-op thread: the model's many small ops, multithreaded under
    several pytest-xdist workers, take longer than on one."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("c", range(128, 1025, 128))
def test_eligible_matches_jax_up_to_1024(c):
    for n in TOKEN_COUNTS:
        assert fa.eligible(n, c) == jflash.eligible(n, c), (n, c)
    assert fa.fwd_cluster_size(c) == (1 if c <= 512 else 2)
    assert fa.bwd_cluster_size(c) == c // 128


def _operands(shape, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) for _ in range(4)]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("c", [640, 1024])
def test_op_matches_jax_kernels_at_wide_heads(c, one_thread):
    """The port's flash op at (1, 256, c), fp32: the LSE forward and the two
    backward entries against JAX ``_flash_forward`` and ``_flash_backward``
    (Pallas, interpret mode), the same operands, lse and delta."""
    q, k, v, do = _operands((1, 256, c), seed=c)
    scale = c ** -0.5
    o, lse = fa.flash_attention_fwd_lse(q, k, v, scale=scale, out_dtype=torch.float32)
    jq, jk, jv, jdo = (jnp.asarray(t.numpy()) for t in (q, k, v, do))
    jo, jlse = jflash._flash_forward(jq, jk, jv, scale, jnp.float32, jax.lax.Precision.HIGHEST,
                                     with_lse=True)
    jlse = np.asarray(jlse)[..., 0]
    assert _rel(o.numpy(), jo) <= F32_REL_L2
    assert np.abs(lse.numpy() - jlse).max() <= LSE_MAX_REL * np.abs(jlse).max()
    delta = (do * o).sum(-1)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale=scale)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale=scale)
    lane = lambda x: jnp.broadcast_to(jnp.asarray(x.numpy())[..., None],  # noqa: E731
                                      (*x.shape, jflash.LANE))
    jgrads = jflash._flash_backward(jq, jk, jv, jdo, lane(lse), lane(delta), scale,
                                    jax.lax.Precision.HIGHEST)
    for name, g, j in zip(("dq", "dk", "dv"), (dq, dk, dv), jgrads):
        assert _rel(g.numpy(), j) <= F32_REL_L2, (name, _rel(g.numpy(), j))


def test_wide_head_vae_matches_jax_under_flash(one_thread):
    """The tiny VAE with a 640-channel mid block: the port (flash on its
    plain versions) and JAX (its Pallas kernels in interpret mode), one set
    of weights, the same pixels; the reconstruction and every parameter's
    gradient."""
    cfg = JaxConfig(**WIDE_VAE)
    jw = JaxWrapper(config=cfg, dtype=jnp.float32, seed=3, attn_impl="flash")
    state = {name: torch.from_numpy(np.array(arr)) for name, arr in
             flatten_params(jw.params).items()}
    model = AutoencoderKL(VAEConfig(**WIDE_VAE), attn_impl="flash", device="cpu")
    result = model.load_state_dict(state, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    assert fa.eligible(16 * 16, 640)  # the mid block's tokens and channels

    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    w = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    module = jw._module()

    def jloss(params):
        out = module.apply({"params": params}, jnp.asarray(x), sample_posterior=False,
                           rng=jax.random.PRNGKey(0), mutable=["stats"])[0]
        return jnp.sum(out["reconstruction"] * w), out["reconstruction"]

    (_, jrec), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jw.params)
    flash_calls = []
    real = fa.flash_attention

    def counted(*a, **kw):
        flash_calls.append(a[0].shape)
        return real(*a, **kw)

    tvae.flash_ops.flash_attention = counted
    try:
        out = model(torch.from_numpy(x).permute(0, 3, 1, 2), sample_posterior=False)
    finally:
        tvae.flash_ops.flash_attention = real
    rec = out["reconstruction"]
    assert flash_calls == [(1, 256, 640), (1, 256, 640)]  # encoder and decoder mid blocks
    np.testing.assert_allclose(rec.detach().permute(0, 2, 3, 1).numpy(), np.asarray(jrec),
                               rtol=RTOL, atol=ATOL)
    (rec * torch.from_numpy(w).permute(0, 3, 1, 2)).sum().backward()
    want = flatten_params(jgrads)
    grads = dict(model.named_parameters())
    assert set(want) == set(grads)
    largest = max(float(np.abs(np.asarray(g)).max()) for g in want.values())
    for name, g in want.items():
        got = grads[name].grad
        assert got is not None, name
        if name.endswith("to_k.bias"):
            # shifts a row's logits by one amount, which the softmax cancels:
            # zero up to rounding in both
            assert max(got.abs().max().item(), float(np.abs(g).max())) <= 1e-5 * largest, name
            continue
        assert _rel(got.numpy(), g) <= GRAD_REL_L2, (name, _rel(got.numpy(), g))


def test_flash_past_1024_channels_raises_and_ineligible_shapes_run_chunked():
    """Past 1024 channels the JAX kernels run and the port's explicit flash
    raises, naming the ROADMAP item; channels that are no multiple of 128
    (which JAX refuses too) run chunked, as the JAX block does."""
    assert jflash.eligible(256, 1152) and not fa.eligible(256, 1152)
    block = tvae.AttentionBlock(1152, 32, 1e-6, attn_impl="flash", device="cpu")
    with torch.no_grad(), pytest.raises(NotImplementedError, match=fa.WIDE_HEADS):
        block(torch.zeros(1, 1152, 16, 16))
    with pytest.raises(NotImplementedError, match=fa.WIDE_HEADS):
        fa.refuse_wider_heads(4096, 1152)
    fa.refuse_wider_heads(4096, 1024)   # the kernels take it
    fa.refuse_wider_heads(100, 1152)    # JAX refuses it too: chunked
    assert not jflash.eligible(256, 96)
    block = tvae.AttentionBlock(96, 32, 1e-6, attn_impl="flash", device="cpu")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for module in block.modules():
            if hasattr(module, "init_weights"):
                module.init_weights(gen)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 96, 16, 16))
                         .astype(np.float32))
    with torch.no_grad():
        flash = block(x)
        block.attn_impl = "chunked"
        chunked = block(x)
    assert torch.equal(flash, chunked)
