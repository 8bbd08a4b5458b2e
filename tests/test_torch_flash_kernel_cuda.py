"""The hand-written CUDA flash-attention kernel against its plain PyTorch
version, on the card. Skips without a GPU. Imports no jax, so on a machine
without jax it runs without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_flash_kernel_cuda.py -q

bf16 in and out: the kernel rounds the unnormalised probabilities to bf16
before the product with v and the plain version the normalised ones, and
both round the output, so they agree to a few bf16 ulps: rtol 1.6e-2
(torch's own bf16 default, about 4 ulps) with atol 1e-2 for outputs near 0.
That absolute floor is loose for long sequences, whose outputs shrink like
1/sqrt(N), so the relative L2 error is held to 1e-2 as well: bf16 rounding
gives about 2.5e-3, and a kernel that skips one 64-key tile about 8/sqrt(N),
0.0625 at N=16384."""

import pytest
import torch

from vae_channel_dynamics_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

RTOL, ATOL = 1.6e-2, 1e-2
REL_L2 = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


def _qkv(shape, device, seed=0, dtype=torch.bfloat16):
    gen = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen, device=device).to(dtype)
                 for _ in range(3))


@pytest.mark.parametrize("shape", [
    (1, 128, 128),      # the smallest eligible shape
    (3, 256, 256),      # a batch that is neither a power of two nor even
    (2, 384, 384),
    (5, 640, 512),
    (4, 4096, 512),     # SDXL mid block at 512px, max_batch 4
    (1, 16384, 512),    # SDXL mid block at 1024px
])
def test_kernel_matches_plain(cuda, shape):
    q, k, v = _qkv(shape, cuda, seed=sum(shape))
    scale = shape[-1] ** -0.5
    before = fa.launches
    out = fa.flash_attention(q, k, v, scale=scale, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    ref = fa.flash_attention_reference(q, k, v, scale, torch.bfloat16)
    torch.testing.assert_close(out.float(), ref.float(), rtol=RTOL, atol=ATOL)
    rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
    assert rel <= REL_L2, rel


def test_kernel_handles_large_logits(cuda):
    """Scaled logits in the hundreds: the running max keeps exp in range."""
    q, k, v = _qkv((2, 256, 128), cuda, seed=1)
    out = fa.flash_attention(q * 8, k * 8, v, scale=1.0, out_dtype=torch.bfloat16)
    ref = fa.flash_attention_reference(q * 8, k * 8, v, 1.0, torch.bfloat16)
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(), rtol=RTOL, atol=ATOL)


def test_fp32_input_raises(cuda):
    q, k, v = _qkv((1, 128, 128), cuda, dtype=torch.float32)
    before = fa.launches
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
