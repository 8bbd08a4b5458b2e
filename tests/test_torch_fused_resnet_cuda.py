"""The hand-written CUDA fused-resnet kernels against their plain PyTorch
versions, on the card. Skips without a GPU. Imports no jax, so on a machine
without jax it runs without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_fused_resnet_cuda.py -q

Each of the three kernels (``fused_gn_silu_conv3x3``, ``conv3x3``,
``conv3x3_dw``) gets the same bf16 inputs as its plain version: at the 256px
step's fused shape (16, 512, 32, 32) -> 512, at an asymmetric one
(16, 256, 64, 64) -> 512, and at small odd ones (batch 1, 128 -> 256, H not a
multiple of the pixel rectangle's rows of #9 and #10, W = 48 under 64-column
rectangles). Then the
autograd op against plain autograd of the same function, the fused forward,
#10 and the weight gradient bit-equal run to run, the fused forward refusing
partial buffers of another size than its grid's, and #10's C entry refusing
the shapes its loop does not take.

Bounds. The bf16 outputs (y, ds): kernel and plain round the same fp32 sum,
taken in another order, so at most 4 bf16 ulps of max|plain| and relative L2
at most 1e-2. The fp32 sums (the |z| tap, the moments, dW) at most 1e-3 of
max|plain|: the order of fp32 additions differs. The autograd op: plain
autograd keeps ds in fp32 where the kernels round it to bf16 (as the JAX
VJP does), so every gradient is held to relative L2 1e-2 and 2^-5 of
max|plain|.
"""

import math

import pytest
import torch

from vae_channel_dynamics_tpu_torch.ops import fused_resnet as fr
from vae_channel_dynamics_tpu_torch.ops import group_norm_kernel as gnk
from vae_channel_dynamics_tpu_torch.ops.group_norm import group_norm_reference

pytestmark = pytest.mark.cuda

GROUPS, EPS = 32, 1e-6
BF16 = torch.bfloat16
# (N, Cin, H, W), Cout
SHAPES = [
    ((16, 512, 32, 32), 512),  # the 256px step's fused resnets
    ((16, 256, 64, 64), 512),  # asymmetric channels, two row tiles of 32 columns
    ((1, 128, 16, 16), 256),   # batch 1, 128 -> 256
    ((3, 128, 12, 32), 128),   # H = 12: three 4-row rectangles of 32 columns
    ((2, 256, 6, 48), 128),    # H below one tile, three column tiles
    ((2, 128, 20, 16), 128),   # #9's 8 x 16 pixel rectangle: the last one half outside
]
IDS = [f"{s}->{c}" for s, c in SHAPES]
# conv3x3_dw also at H = 12 under its 4-row units of 32 columns, 128 -> 256
DW_SHAPES = SHAPES + [((2, 128, 12, 32), 256)]
DW_IDS = [f"{s}->{c}" for s, c in DW_SHAPES]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, cout, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    n, cin, h, w = shape
    x = (torch.randn(shape, generator=gen, device=device) * 2.0 + 0.5).to(BF16)
    gamma = 1.0 + 0.1 * torch.randn(cin, generator=gen, device=device)
    beta = 0.1 * torch.randn(cin, generator=gen, device=device)
    wt = (torch.randn((cout, cin, 3, 3), generator=gen, device=device)
          / math.sqrt(9 * cin)).to(BF16)
    bias = 0.1 * torch.randn(cout, generator=gen, device=device)
    res = torch.randn((n, cout, h, w), generator=gen, device=device).to(BF16)
    dy = torch.randn((n, cout, h, w), generator=gen, device=device).to(BF16)
    sums, sqs = gnk.fwd_reduce_reference(x)
    mean, rstd = gnk._group_stats(sums, sqs, h * w, GROUPS, EPS)
    a, o = gnk._affine_coeffs(mean, rstd, gamma, beta, GROUPS)
    return x, gamma, beta, wt, bias, res, dy, a, o


def _assert_bf16(out, ref):
    assert out.dtype == ref.dtype == BF16 and out.shape == ref.shape
    assert torch.isfinite(out.float()).all()
    top = ref.float().abs().max().item()
    d = out.float() - ref.float()
    assert d.abs().max().item() <= 4 * 2.0 ** (math.floor(math.log2(top)) - 7)
    assert (d.norm() / ref.float().norm()).item() <= 1e-2


def _assert_sums(out, ref, rel=1e-3):
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert ((out - ref).abs().max() / ref.abs().max()).item() <= rel


@pytest.mark.parametrize("shape,cout", SHAPES, ids=IDS)
@pytest.mark.parametrize("with_residual", [False, True])
def test_fused_forward_matches_plain(cuda, shape, cout, with_residual):
    x, _g, _b, wt, bias, res, _dy, a, o = _inputs(shape, cout, cuda)
    res = res if with_residual else None
    before = fr.launches["fused_gn_silu_conv3x3"]
    y, tap, (ysum, ysq) = fr.fused_fwd(x, a, o, wt, bias, res, True, True)
    torch.cuda.synchronize()
    assert fr.launches["fused_gn_silu_conv3x3"] == before + 1
    py, ptap, (psum, psq) = fr.fused_fwd_reference(x, a, o, wt, bias, res, True, True)
    _assert_bf16(y, py)
    _assert_sums(tap, ptap)
    _assert_sums(ysum, psum)
    _assert_sums(ysq, psq)
    # without the side outputs: the same y, and no tap or moments
    y2, tap2, mom2 = fr.fused_fwd(x, a, o, wt, bias, res)
    assert tap2 is None and mom2 is None
    assert torch.equal(y2, y)


@pytest.mark.parametrize("shape,cout", SHAPES, ids=IDS)
def test_conv3x3_matches_plain(cuda, shape, cout):
    # the backward's use: dy (N, Cout, H, W) back to Cin channels through the
    # flipped, channel-swapped weight
    _x, _g, _b, wt, _bias, _res, dy, _a, _o = _inputs(shape, cout, cuda, seed=1)
    wf = fr.flipped_weight(wt)
    before = fr.launches["conv3x3"]
    ds = fr.conv3x3(dy, wf)
    torch.cuda.synchronize()
    assert fr.launches["conv3x3"] == before + 1
    _assert_bf16(ds, fr.conv3x3_reference(dy, wf))
    # the forward direction with a bias
    x = _inputs(shape, cout, cuda, seed=5)[0]
    bias = torch.linspace(-1.0, 1.0, wt.shape[0], device=cuda)
    _assert_bf16(fr.conv3x3(x, wt, bias), fr.conv3x3_reference(x, wt, bias))


@pytest.mark.parametrize("shape,cout", SHAPES, ids=IDS)
def test_conv3x3_is_deterministic(cuda, shape, cout):
    """#10 writes each output once, with no atomics: the same bits twice."""
    _x, _g, _b, wt, _bias, _res, dy, _a, _o = _inputs(shape, cout, cuda, seed=7)
    wf = fr.flipped_weight(wt)
    first = fr.conv3x3(dy, wf)
    assert torch.equal(fr.conv3x3(dy, wf), first)


@pytest.mark.parametrize("what,cin,cout,w,cols", [
    ("cin not a multiple of 64", 96, 128, 16, 16),
    ("cout not a multiple of 128", 128, 64, 16, 16),
    ("w not a multiple of 16", 128, 128, 24, 16),
    ("rectangle narrower than 16", 128, 128, 16, 8),
    ("rectangle width not a power of two", 128, 128, 48, 48),
    ("rectangle wider than 128", 128, 128, 256, 256),
])
def test_conv3x3_entry_refuses_what_the_loop_does_not_take(cuda, what, cin, cout, w, cols):
    """The Python checks raise first; the C entry refuses on its own
    (cudaErrorInvalidValue, 1) before any launch."""
    n, h = 1, 8
    x = torch.zeros((n, cin, h, w), device=cuda, dtype=BF16)
    wt = torch.zeros((3, 3, cin, cout), device=cuda, dtype=BF16)
    y = torch.full((n, cout, h, w), 7.0, device=cuda, dtype=BF16)
    s = torch.empty((n, h, w, cin), device=cuda, dtype=BF16)
    rc = fr._fn("conv3x3")(x.data_ptr(), wt.data_ptr(), None, y.data_ptr(), s.data_ptr(), n,
                           cin, cout, h, w, cols, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 1, what
    assert bool((y == 7.0).all()), what  # nothing was written


@pytest.mark.parametrize("shape,cout", DW_SHAPES, ids=DW_IDS)
def test_conv_dw_matches_plain(cuda, shape, cout):
    x, _g, _b, _wt, _bias, _res, dy, a, o = _inputs(shape, cout, cuda, seed=2)
    before = fr.launches["conv3x3_dw"]
    dw = fr.conv_dw(x, a, o, dy)
    torch.cuda.synchronize()
    assert fr.launches["conv3x3_dw"] == before + 1
    ref = fr.conv_dw_reference(x, a, o, dy)
    _assert_sums(dw, ref)
    assert ((dw - ref).norm() / ref.norm()).item() <= 1e-3


@pytest.mark.parametrize("shape,cout", SHAPES[:2], ids=IDS[:2])
def test_fused_forward_is_deterministic(cuda, shape, cout):
    """y, the tap and the moments: per-tile partials added in a fixed order,
    no atomics."""
    x, _g, _b, wt, bias, res, _dy, a, o = _inputs(shape, cout, cuda, seed=4)
    first = fr.fused_fwd(x, a, o, wt, bias, res, True, True)
    for _ in range(3):
        y, tap, (ysum, ysq) = fr.fused_fwd(x, a, o, wt, bias, res, True, True)
        assert torch.equal(y, first[0]) and torch.equal(tap, first[1])
        assert torch.equal(ysum, first[2][0]) and torch.equal(ysq, first[2][1])


def test_fused_rectangle_rows_do_not_divide_h(cuda):
    """H = 20 under #9's 8-row x 16-column pixel rectangle: the last
    rectangle's rows 20-23 lie outside the image, are zero-filled on the way
    in and masked on the way out, and add nothing to the moments."""
    shape, cout = (2, 128, 20, 16), 128
    rows, cols = fr.pixel_tile(20, 16)
    assert (rows, cols) == (8, 16) and 20 % rows
    assert fr.eligible(shape, cout, GROUPS)
    x, _g, _b, wt, bias, res, _dy, a, o = _inputs(shape, cout, cuda, seed=5)
    y, tap, (ysum, ysq) = fr.fused_fwd(x, a, o, wt, bias, res, True, True)
    py, ptap, (psum, psq) = fr.fused_fwd_reference(x, a, o, wt, bias, res, True, True)
    _assert_bf16(y, py)
    for out, ref in ((tap, ptap), (ysum, psum), (ysq, psq)):
        _assert_sums(out, ref)


@pytest.mark.parametrize("helper", ["tap_chunks", "fused_tiles"])
@pytest.mark.parametrize("delta", [-1, 1])
def test_fused_refuses_partials_of_another_size(cuda, monkeypatch, helper, delta):
    """The wrapper sizes #9's tap and moment partials by ``tap_chunks`` and
    ``fused_tiles``; the C entry holds those counts to its own grid, so a
    wrapper whose count drifted is refused before any write, never run over
    a buffer too small."""
    shape, cout = (2, 128, 20, 16), 128
    x, _g, _b, wt, bias, res, _dy, a, o = _inputs(shape, cout, cuda, seed=6)
    count = getattr(fr, helper)
    monkeypatch.setattr(fr, helper, lambda h, w: count(h, w) + delta)
    before = fr.launches["fused_gn_silu_conv3x3"]
    with pytest.raises(RuntimeError, match="launch failed"):
        fr.fused_fwd(x, a, o, wt, bias, res, True, True)
    assert fr.launches["fused_gn_silu_conv3x3"] == before


@pytest.mark.parametrize("shape,cout", SHAPES[:2], ids=IDS[:2])
def test_conv_dw_is_deterministic(cuda, shape, cout):
    x, _g, _b, _wt, _bias, _res, dy, a, o = _inputs(shape, cout, cuda, seed=3)
    first = fr.conv_dw(x, a, o, dy)
    for _ in range(3):
        assert torch.equal(fr.conv_dw(x, a, o, dy), first)


def _plain_op(x, gamma, beta, wt, bias, res):
    """conv3x3(silu(group_norm(x))) + bias + res with the kernels' rounding
    points in the forward (s and w in bf16, fp32 sums, y rounded once)."""
    z = group_norm_reference(x.float(), gamma, beta, GROUPS, EPS, False)
    s = (z *torch.sigmoid(z)).to(BF16).float()
    y = torch.nn.functional.conv2d(s, wt.to(BF16).float(), padding=1)
    y = y + bias[None, :, None, None] + res.float()
    return y.to(BF16)


@pytest.mark.parametrize("shape,cout", [SHAPES[0], SHAPES[2], SHAPES[3]],
                         ids=[IDS[0], IDS[2], IDS[3]])
def test_autograd_op_matches_plain_autograd(cuda, shape, cout):
    x, gamma, beta, wt, bias, res, dy, _a, _o = _inputs(shape, cout, cuda, seed=4)
    wt32 = wt.float()

    def grads(fn):
        leaves = [t.detach().clone().requires_grad_(True)
                  for t in (x, gamma, beta, wt32, bias, res)]
        y = fn(*leaves)
        return [y.detach()] + list(torch.autograd.grad(y, leaves, dy))

    def kernel_op(xx, gg, bb, ww, bi, rr):
        return fr.gn_silu_conv3x3(xx, gg, bb, ww, bi, num_groups=GROUPS, eps=EPS,
                                  residual=rr)[0]

    before = dict(fr.launches)
    got = grads(kernel_op)
    torch.cuda.synchronize()
    assert {k: fr.launches[k] - before[k] for k in fr.KERNELS} == {
        "fused_gn_silu_conv3x3": 1, "conv3x3": 1, "conv3x3_dw": 1}
    want = grads(_plain_op)
    for name, g, p in zip(("y", "x", "gamma", "beta", "w", "bias", "residual"), got, want):
        assert g.dtype == p.dtype and g.shape == p.shape, name
        d = (g.float() - p.float())
        top = p.float().abs().max().item()
        assert d.abs().max().item() <= 2.0 ** -5 * top, name
        assert (d.norm() / p.float().norm()).item() <= 1e-2, name


def test_fp32_input_raises(cuda):
    x, _g, _b, wt, bias, _res, dy, a, o = _inputs(*SHAPES[2], cuda)
    with pytest.raises(NotImplementedError, match="bf16"):
        fr.fused_fwd(x.float(), a, o, wt, bias)
    with pytest.raises(NotImplementedError, match="bf16"):
        fr.conv3x3(dy.float(), fr.flipped_weight(wt))
    with pytest.raises(NotImplementedError, match="bf16"):
        fr.conv_dw(x, a, o, dy.float())


@pytest.mark.parametrize("shape,cout,match", [
    ((2, 96, 8, 16), 128, "multiples of 128"),
    ((2, 128, 8, 24), 128, "multiple of 16"),
    ((2, 128, 7, 16), 128, "no row tile"),
])
def test_ineligible_shape_raises(cuda, shape, cout, match):
    x = torch.zeros(shape, device=cuda, dtype=BF16)
    wt = torch.zeros((cout, shape[1], 3, 3), device=cuda, dtype=BF16)
    assert not fr.eligible(x, cout, 32 if shape[1] % 32 == 0 else 1)
    with pytest.raises(ValueError, match=match):
        fr.conv3x3(x, wt)
