"""The hand-written CUDA flash-attention kernels (the serving forward, the
training forward with its log-sum-exp, and the dK/dV and dQ backward)
against their plain PyTorch versions, on the card. Skips without a GPU.
Imports no jax, so on a machine without jax it runs without the
repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_flash_kernel_cuda.py -q

bf16 in and out: the forward kernel rounds the unnormalised probabilities to
bf16 before the product with v and the plain version the normalised ones,
and both round the output, so they agree to a few bf16 ulps: rtol 1.6e-2
(torch's own bf16 default, about 4 ulps) with atol 1e-2 for outputs near 0.
That absolute floor is loose for long sequences, whose outputs shrink like
1/sqrt(N), so the relative L2 error is held to 1e-2 as well: bf16 rounding
gives about 2.5e-3, and a kernel that skips one 64-key tile about 8/sqrt(N),
0.0625 at N=16384.

The backward's dQ, dK and dV are bf16 sums over N fp32 products of bf16
operands, summed in another order than the plain version's matmul, and the
bf16 P and dS may round the other way where exp differs in its last bit:
each is held to max|kernel - plain| <= 2^-6 max|plain| (4 bf16 ulps at the
top of max|plain|'s binade) and a relative L2 error of 1e-2. Leaving one
32-query tile out of dK/dV costs about sqrt(32/N) in relative L2, 0.044 at
N = 16384. The fp32 lse is held to 1e-5 of max|plain|: the kernel sums its
denominator in another order.
"""

import pytest
import torch

from vae_channel_dynamics_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

RTOL, ATOL = 1.6e-2, 1e-2
REL_L2 = 1e-2
GRAD_MAX_REL = 2.0 ** -6
LSE_MAX_REL = 1e-5
KERNELS_TRAINING = ("flash_attention_fwd_lse", "flash_attention_bwd_dkv",
                    "flash_attention_bwd_dq")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


def _qkv(shape, device, seed=0, dtype=torch.bfloat16, n=3):
    gen = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device=device).to(dtype)
                 for _ in range(n))


def _rel(out, ref):
    out, ref = out.float(), ref.float()
    d = out - ref
    return (d.abs().max() / ref.abs().max()).item(), (d.norm() / ref.norm()).item()


SHAPES = [
    (1, 128, 128),      # the smallest eligible shape
    (3, 256, 256),      # a batch that is neither a power of two nor even
    (2, 384, 384),
    (5, 640, 512),
    (4, 4096, 512),     # SDXL mid block at 512px, max_batch 4
    (1, 16384, 512),    # SDXL mid block at 1024px
]


@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain(cuda, shape):
    q, k, v = _qkv(shape, cuda, seed=sum(shape))
    scale = shape[-1] ** -0.5
    before = fa.launches["flash_attention_fwd"]
    out = fa.flash_attention(q, k, v, scale=scale, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert fa.launches["flash_attention_fwd"] == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    ref = fa.flash_attention_reference(q, k, v, scale, torch.bfloat16)
    torch.testing.assert_close(out.float(), ref.float(), rtol=RTOL, atol=ATOL)
    rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
    assert rel <= REL_L2, rel


@pytest.mark.parametrize("shape", SHAPES)
def test_lse_kernel_matches_plain(cuda, shape):
    q, k, v = _qkv(shape, cuda, seed=sum(shape) + 1)
    scale = shape[-1] ** -0.5
    before = dict(fa.launches)
    out, lse = fa.flash_attention_fwd_lse(q, k, v, scale=scale, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert fa.launches["flash_attention_fwd_lse"] == before["flash_attention_fwd_lse"] + 1
    assert fa.launches["flash_attention_fwd"] == before["flash_attention_fwd"]
    assert lse.dtype == torch.float32 and lse.shape == shape[:2]
    ref_out, ref_lse = fa.flash_attention_fwd_lse_reference(q, k, v, scale, torch.bfloat16)
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=RTOL, atol=ATOL)
    assert _rel(lse, ref_lse)[0] <= LSE_MAX_REL


def _bwd(q, k, v, do, lse, delta, scale):
    """(dq, dk, dv) from the dK/dV kernel, then the dQ kernel."""
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale=scale)
    return fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale=scale), dk, dv


@pytest.mark.parametrize("shape", [(1, 128, 128), (3, 256, 256), (2, 384, 384),
                                   (4, 4096, 512)])
def test_backward_kernels_match_plain(cuda, shape):
    q, k, v, do = _qkv(shape, cuda, seed=sum(shape) + 2, n=4)
    scale = shape[-1] ** -0.5
    o, lse = fa.flash_attention_fwd_lse_reference(q, k, v, scale, torch.bfloat16)
    delta = (do.float() * o.float()).sum(-1)
    before = dict(fa.launches)
    grads = _bwd(q, k, v, do, lse, delta, scale)
    torch.cuda.synchronize()
    for name in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
        assert fa.launches[name] == before[name] + 1
    refs = fa.flash_attention_bwd_reference(q, k, v, do, lse, delta, scale)
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        assert g.dtype == torch.bfloat16 and g.shape == q.shape
        max_rel, rel_l2 = _rel(g, r)
        assert max_rel <= GRAD_MAX_REL and rel_l2 <= REL_L2, (name, max_rel, rel_l2)
    # the bound rejects dK/dV with one 32-query tile left out
    _, fk, fv = fa.flash_attention_bwd_reference(
        q[:, 32:], k, v, do[:, 32:], lse[:, 32:], delta[:, 32:], scale)
    for f, r in ((fk, refs[1]), (fv, refs[2])):
        max_rel, rel_l2 = _rel(f, r)
        assert max_rel > GRAD_MAX_REL or rel_l2 > REL_L2


def test_backward_is_deterministic(cuda):
    q, k, v, do = _qkv((2, 1024, 512), cuda, seed=7, n=4)
    o, lse = fa.flash_attention_fwd_lse(q, k, v, scale=512 ** -0.5, out_dtype=torch.bfloat16)
    delta = (do.float() * o.float()).sum(-1)
    first = _bwd(q, k, v, do, lse, delta, 512 ** -0.5)
    second = _bwd(q, k, v, do, lse, delta, 512 ** -0.5)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("shape", [(2, 256, 128), (1, 4096, 512)])
def test_autograd_function_matches_plain_autograd(cuda, shape):
    """Gradients through flash_attention (the LSE forward and the two
    backward kernels) against autograd of the plain forward, all bf16."""
    q, k, v, g = _qkv(shape, cuda, seed=11, n=4)
    scale = shape[-1] ** -0.5

    def grads(fn):
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves)
        return (out.detach(), *torch.autograd.grad(out, leaves, g))

    before = dict(fa.launches)
    got = grads(lambda a, b, c: fa.flash_attention(a, b, c, scale=scale,
                                                   out_dtype=torch.bfloat16))
    torch.cuda.synchronize()
    assert fa.launches["flash_attention_fwd"] == before["flash_attention_fwd"]
    for name in KERNELS_TRAINING:
        assert fa.launches[name] == before[name] + 1, name
    want = grads(lambda a, b, c: fa.flash_attention_reference(a, b, c, scale, torch.bfloat16))
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        max_rel, rel_l2 = _rel(a, b)
        assert max_rel <= 2 * GRAD_MAX_REL and rel_l2 <= 2 * REL_L2, (name, max_rel, rel_l2)


def test_serving_forward_refuses_grad(cuda):
    q, k, v = _qkv((1, 128, 128), cuda)
    q.requires_grad_(True)
    before = dict(fa.launches)
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention_fwd(q, k, v, scale=1.0, out_dtype=torch.bfloat16)
    assert fa.launches == before


def test_kernel_handles_large_logits(cuda):
    """Scaled logits in the hundreds: the running max keeps exp in range."""
    q, k, v = _qkv((2, 256, 128), cuda, seed=1)
    out = fa.flash_attention(q * 8, k * 8, v, scale=1.0, out_dtype=torch.bfloat16)
    ref = fa.flash_attention_reference(q * 8, k * 8, v, 1.0, torch.bfloat16)
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), rtol=RTOL, atol=ATOL)


def test_fp32_input_raises(cuda):
    q, k, v = _qkv((1, 128, 128), cuda, dtype=torch.float32)
    before = dict(fa.launches)
    with pytest.raises(NotImplementedError, match="bf16"):
        fa.flash_attention(q, k, v, scale=1.0, out_dtype=torch.float32)
    assert fa.launches == before


@pytest.mark.parametrize("shape", [(1, 100, 128), (1, 128, 640), (1, 128, 96)])
def test_ineligible_shape_raises(cuda, shape):
    q, k, v = _qkv(shape, cuda)
    with pytest.raises(ValueError, match="not eligible"):
        fa.flash_attention(q, k, v, scale=1.0, out_dtype=torch.bfloat16)


def test_non_contiguous_input_raises(cuda):
    q, k, v = _qkv((1, 128, 256), cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q[:, :, :128], k[:, :, :128], v[:, :, :128], scale=1.0,
                           out_dtype=torch.bfloat16)
