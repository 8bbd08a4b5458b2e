"""The hand-written CUDA NHWC conv3x3 (kernel #12) against its plain
PyTorch version, on the card. Skips without a GPU. Imports no jax, so on a
machine without jax it runs without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_conv_nhwc_cuda.py -q

y is bf16, one rounding of an fp32 sum that the kernel and the plain
version (fp32 products, TF32 off) take in another order: at most 4 bf16
ulps of max|plain| and a relative L2 error of 1e-2 (bf16 rounding gives
about 1e-4; leaving out one 32-channel chunk of a tap costs more than 7e-2
at these widths).
"""

import math

import pytest
import torch

from vae_channel_dynamics_tpu_torch.ops import conv_nhwc as cn

pytestmark = pytest.mark.cuda

ULPS = 4
REL_L2 = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, cout, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    cin = shape[-1]
    x = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
    w = (torch.randn((3, 3, cin, cout), generator=gen, device=device)
         / math.sqrt(9 * cin)).to(torch.bfloat16)
    b = 0.5 * torch.randn(cout, generator=gen, device=device)
    return x, w, b


def _held(out, ref):
    d = out.float() - ref.float()
    top = ref.float().abs().max().item()
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
    assert d.abs().max().item() <= ULPS * ulp
    assert (d.norm() / ref.float().norm()).item() <= REL_L2


SHAPES = [
    ((1, 1, 1, 32), 64),        # one pixel: every tap but the centre is halo
    ((2, 5, 7, 32), 64),        # H*W below one 128-pixel tile
    ((3, 9, 17, 64), 128),      # tiles that cross image rows
    ((1, 12, 16, 64), 64),
    ((2, 48, 8, 32), 192),      # Cout != Cin
    ((8, 32, 32, 512), 512),    # the bench's shape D
    ((2, 64, 64, 512), 512),    # shape A at batch 2
    ((2, 9, 65, 64), 128),      # W one past the 64-pixel tile width: 1 x 128 tiles
    ((2, 33, 40, 32), 128),     # Cin = 32 (the 64-byte swizzle) over several tiles
    ((1, 3, 3, 96), 64),        # Cin = 96: 32-channel chunks, H*W below one tile
    ((1, 128, 128, 256), 256),  # shape B at batch 1
]


@pytest.mark.parametrize("shape,cout", SHAPES, ids=[f"{s}->{c}" for s, c in SHAPES])
def test_kernel_matches_plain(cuda, shape, cout):
    x, w, b = _inputs(shape, cout, cuda, seed=sum(shape) + cout)
    before = cn.launches["conv3x3_nhwc"]
    y = cn.conv3x3_nhwc(x, w, b)
    torch.cuda.synchronize()
    assert cn.launches["conv3x3_nhwc"] == before + 1
    assert y.dtype == torch.bfloat16 and y.shape == shape[:3] + (cout,)
    _held(y, cn.conv3x3_nhwc_reference(x, w, b))
    _held(cn.conv3x3_nhwc(x, w), cn.conv3x3_nhwc_reference(x, w))


def test_kernel_is_bit_equal_run_to_run(cuda):
    x, w, b = _inputs((4, 33, 29, 128), 128, cuda, seed=1)
    torch.testing.assert_close(cn.conv3x3_nhwc(x, w, b), cn.conv3x3_nhwc(x, w, b),
                               rtol=0, atol=0)


def test_kernel_matches_cudnn(cuda):
    """The library yardstick computes the same function (bf16 conv with
    bias on the channels_last view)."""
    from vae_channel_dynamics_tpu_torch.experiments.conv_bench import cudnn_conv3x3

    x, w, b = _inputs((2, 32, 24, 256), 256, cuda, seed=2)
    _held(cudnn_conv3x3(x, w, b.to(torch.bfloat16)), cn.conv3x3_nhwc_reference(x, w, b))
    _held(cn.conv3x3_nhwc(x, w, b), cudnn_conv3x3(x, w, b.to(torch.bfloat16)))


def test_fp32_input_raises(cuda):
    x, w, b = _inputs((1, 4, 4, 32), 64, cuda)
    before = dict(cn.launches)
    with pytest.raises(NotImplementedError, match="bf16"):
        cn.conv3x3_nhwc(x.float(), w.float(), b)
    assert cn.launches == before


@pytest.mark.parametrize("shape,cout", [((1, 4, 4, 48), 64), ((1, 4, 4, 32), 96)])
def test_ineligible_shape_raises(cuda, shape, cout):
    x, w, b = _inputs(shape, cout, cuda)
    with pytest.raises(ValueError, match="not eligible"):
        cn.conv3x3_nhwc(x, w, b)


def test_non_contiguous_input_raises(cuda):
    x, w, b = _inputs((1, 4, 8, 64), 64, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        cn.conv3x3_nhwc(x[:, :, ::2], w, b)
