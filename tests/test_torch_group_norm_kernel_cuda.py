"""The hand-written CUDA GroupNorm kernels against their plain PyTorch
versions, on the card. Skips without a GPU. Imports no jax, so on a machine
without jax it runs without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_group_norm_kernel_cuda.py -q

Each of the four kernels gets the same inputs as its plain version, at the
training slice's norm shapes (256px, batch 16: the largest and the smallest)
and at small odd ones, in bf16 and fp32; then the autograd op (forward, the
|z| tap, dx, dgamma, dbeta) against the plain GroupNorm. The normalize
kernel also at batch-1 shapes whose few planes it splits over several blocks
(one with a ragged last split), bit-equal run to run with the tap, and
refusing a split count or partial count that is not its own.

Bounds. Outputs in x's dtype (y, dx): in fp32 the kernels compute what the
plain versions compute, up to the order of fp32 operations and the sigmoid,
so rtol 1e-5 with atol 1e-5 of max|plain|; in bf16 both round the same fp32
value, so 4 bf16 ulps of max|plain| (2^-8 relative each). The fp32 sums (the
reduce outputs, the tap, dgamma, dbeta) are summed in another order: their
max error relative to max|plain| at most 1e-4 in fp32 inputs and 1e-3 in
bf16 (whose products the kernels form in fp32 from the same bf16 values).
"""

import math

import pytest
import torch

from vae_channel_dynamics_tpu_torch.ops import group_norm_kernel as gnk
from vae_channel_dynamics_tpu_torch.ops.group_norm import group_norm, group_norm_reference

pytestmark = pytest.mark.cuda

GROUPS, EPS = 32, 1e-6
SHAPES = [
    (16, 128, 256, 256),  # the largest norm input of the 256px batch-16 step
    (16, 512, 32, 32),    # the mid block
    (3, 256, 8, 8),       # a batch that is neither a power of two nor even
    (2, 384, 4, 6),       # H*W = 24, the smallest multiple of 8 here
]
SUM_REL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, dtype, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    c = shape[1]
    x = (torch.randn(shape, generator=gen, device=device) * 2.0 + 0.5).to(dtype)
    g = torch.randn(shape, generator=gen, device=device).to(dtype)
    scale = 1.0 + 0.1 * torch.randn(c, generator=gen, device=device)
    bias = 0.1 * torch.randn(c, generator=gen, device=device)
    sums, sqs = gnk.fwd_reduce_reference(x)
    mean, rstd = gnk._group_stats(sums, sqs, shape[2] * shape[3], GROUPS, EPS)
    a, b = gnk._affine_coeffs(mean, rstd, scale, bias, GROUPS)
    return x, g, scale, bias, a, b


def _assert_like_x(out, ref, fp32_rtol=1e-5):
    """y or dx: same dtype and shape; the dtype's bound on max abs error
    (``fp32_rtol`` of max|plain| in fp32)."""
    assert out.dtype == ref.dtype and out.shape == ref.shape
    assert torch.isfinite(out.float()).all()
    top = ref.float().abs().max().item()
    err = (out.float() - ref.float()).abs().max().item()
    if ref.dtype == torch.bfloat16:
        bound = 4 * 2.0 ** (math.floor(math.log2(top)) - 7)
    else:
        bound = fp32_rtol * top + 1e-5
    assert err <= bound, (err, bound)


def _assert_sums(out, ref, dtype):
    assert out.dtype == torch.float32 and out.shape == ref.shape
    rel = ((out - ref).abs().max() / ref.abs().max()).item()
    assert rel <= SUM_REL[dtype], rel


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SHAPES)
def test_fwd_reduce_matches_plain(cuda, shape, dtype):
    x, *_ = _inputs(shape, dtype, cuda, 0)
    before = gnk.launches["gn_fwd_reduce"]
    sums, sqs = gnk.fwd_reduce(x)
    torch.cuda.synchronize()
    assert gnk.launches["gn_fwd_reduce"] == before + 1
    ref_s, ref_q = gnk.fwd_reduce_reference(x)
    _assert_sums(sums, ref_s, dtype)
    _assert_sums(sqs, ref_q, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("fuse_silu,with_stats", [(True, True), (True, False), (False, True),
                                                  (False, False)])
def test_fwd_normalize_matches_plain(cuda, shape, dtype, fuse_silu, with_stats):
    x, _g, _s, _b, a, b = _inputs(shape, dtype, cuda, 1)
    before = gnk.launches["gn_fwd_normalize"]
    y, abs_sum = gnk.fwd_normalize(x, a, b, fuse_silu, with_stats)
    torch.cuda.synchronize()
    assert gnk.launches["gn_fwd_normalize"] == before + 1
    ref_y, ref_abs = gnk.fwd_normalize_reference(x, a, b, fuse_silu, with_stats)
    _assert_like_x(y, ref_y)
    if with_stats:
        _assert_sums(abs_sum, ref_abs, dtype)
    else:
        assert abs_sum is None


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("fuse_silu", [True, False])
def test_bwd_reduce_matches_plain(cuda, shape, dtype, fuse_silu):
    x, g, _s, _b, a, b = _inputs(shape, dtype, cuda, 2)
    gsum, gxsum = gnk.bwd_reduce(x, g, a, b, fuse_silu)
    torch.cuda.synchronize()
    ref_g, ref_gx = gnk.bwd_reduce_reference(x, g, a, b, fuse_silu)
    _assert_sums(gsum, ref_g, dtype)
    _assert_sums(gxsum, ref_gx, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("fuse_silu", [True, False])
def test_bwd_dx_matches_plain(cuda, shape, dtype, fuse_silu):
    x, g, _s, _b, a, b = _inputs(shape, dtype, cuda, 3)
    gen = torch.Generator(device=cuda).manual_seed(4)
    cb = 1e-3 * torch.randn(a.shape, generator=gen, device=cuda)
    cc = 0.1 * torch.randn(a.shape, generator=gen, device=cuda)
    dx = gnk.bwd_dx(x, g, a, b, a, cb, cc, fuse_silu)
    torch.cuda.synchronize()
    _assert_like_x(dx, gnk.bwd_dx_reference(x, g, a, b, a, cb, cc, fuse_silu))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SHAPES[:2] + SHAPES[3:])
@pytest.mark.parametrize("fuse_silu", [True, False])
def test_op_matches_plain_group_norm(cuda, shape, dtype, fuse_silu):
    """group_norm(impl='pallas') with its backward against the plain
    GroupNorm's autograd, and the |z| tap against the plain sum."""
    x, g, scale, bias, a, b = _inputs(shape, dtype, cuda, 5)

    def run(fn):
        xr = x.detach().requires_grad_(True)
        sr = scale.detach().requires_grad_(True)
        br = bias.detach().requires_grad_(True)
        y = fn(xr, sr, br)
        return (y.detach(),) + torch.autograd.grad(y, (xr, sr, br), g)

    before = dict(gnk.launches)
    ky, kdx, kds, kdb = run(lambda xr, sr, br: group_norm(xr, sr, br, GROUPS, EPS, fuse_silu,
                                                          impl="pallas"))
    torch.cuda.synchronize()
    # one launch of each kernel per forward and backward
    assert all(gnk.launches[k] == before[k] + 1 for k in gnk.KERNELS)
    py, pdx, pds, pdb = run(lambda xr, sr, br: group_norm_reference(xr, sr, br, GROUPS, EPS,
                                                                     fuse_silu))
    # the op's own fp32 tolerances are the JAX tests': 2e-5 forward, 5e-4
    # gradients (the plain autograd and the folded dx formula round apart)
    _assert_like_x(ky, py, fp32_rtol=2e-5)
    _assert_like_x(kdx, pdx, fp32_rtol=5e-4)
    _assert_sums(kds, pds, dtype)
    _assert_sums(kdb, pdb, dtype)

    _y, tap = gnk.group_norm_silu_with_stats(x, scale, bias, GROUPS, EPS, fuse_silu)
    n, _c, h, w = shape
    ref_tap = gnk.fwd_normalize_reference(x, a, b, fuse_silu, True)[1].sum(0) / (n * h * w)
    _assert_sums(tap, ref_tap, dtype)


def test_launches_are_deterministic(cuda):
    """No atomics: the same input gives the same bits."""
    x, g, _s, _b, a, b = _inputs((4, 128, 64, 64), torch.bfloat16, cuda, 6)
    first = [gnk.fwd_reduce(x), gnk.bwd_reduce(x, g, a, b, True)]
    again = [gnk.fwd_reduce(x), gnk.bwd_reduce(x, g, a, b, True)]
    for u, v in zip(first, again):
        assert all(torch.equal(p, q) for p, q in zip(u, v))


def test_unsupported_inputs_raise(cuda):
    x, g, _s, _b, a, b = _inputs((2, 128, 8, 8), torch.bfloat16, cuda, 7)
    before = dict(gnk.launches)
    with pytest.raises(NotImplementedError, match="bf16 or fp32"):
        gnk.fwd_reduce(x.half())
    with pytest.raises(ValueError, match="contiguous"):
        gnk.fwd_reduce(x.transpose(2, 3))
    with pytest.raises(ValueError, match="multiple of 8"):
        gnk.fwd_reduce(x[:, :, :3, :3].contiguous())
    with pytest.raises(ValueError, match="fp32"):
        gnk.fwd_normalize(x, a.half(), b, True)
    with pytest.raises(ValueError, match="must match x"):
        gnk.bwd_reduce(x, g.float(), a, b, True)
    assert gnk.launches == before


# batch-1 shapes whose B x C planes do not fill the card: gn_fwd_normalize
# splits each over several blocks (8 at (1, 128, 256, 256); 2 at
# (1, 128, 56, 311), whose last split is 8 elements short), or over one where
# a split would hold less than one round of loads ((1, 512, 64, 64))
SPLIT_SHAPES = [(1, 128, 256, 256), (1, 512, 64, 64), (1, 128, 56, 311)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SPLIT_SHAPES)
@pytest.mark.parametrize("fuse_silu", [True, False])
def test_split_normalize_matches_plain_and_repeats(cuda, shape, dtype, fuse_silu):
    x, _g, _s, _b, a, b = _inputs(shape, dtype, cuda, 8)
    before = gnk.launches["gn_fwd_normalize"]
    y, abs_sum = gnk.fwd_normalize(x, a, b, fuse_silu, True)
    y2, abs_sum2 = gnk.fwd_normalize(x, a, b, fuse_silu, True)
    torch.cuda.synchronize()
    assert gnk.launches["gn_fwd_normalize"] == before + 2
    # the tap's partials are added in order of the split: the same bits
    assert torch.equal(y, y2) and torch.equal(abs_sum, abs_sum2)
    ref_y, ref_abs = gnk.fwd_normalize_reference(x, a, b, fuse_silu, True)
    _assert_like_x(y, ref_y)
    _assert_sums(abs_sum, ref_abs, dtype)
    if not fuse_silu:
        # x*a + b as the plain version rounds it, then one cast
        assert torch.equal(y, ref_y)


@pytest.mark.parametrize("drift", ["double", "plus_one"])
@pytest.mark.parametrize("shape", [(1, 128, 256, 256), (4, 128, 64, 64)])
def test_normalize_refuses_another_split_count(cuda, monkeypatch, shape, drift):
    """The C entry holds the wrapper's split count to its own rule (8 and 1
    at these shapes), so a wrapper whose count drifted is refused before any
    write, never run over a partial scratch too small."""
    x, _g, _s, _b, a, b = _inputs(shape, torch.bfloat16, cuda, 9)
    count = gnk.normalize_splits
    monkeypatch.setattr(gnk, "normalize_splits",
                        lambda *args: count(*args) * 2 if drift == "double"
                        else count(*args) + 1)
    before = gnk.launches["gn_fwd_normalize"]
    for with_stats in (False, True):
        with pytest.raises(RuntimeError, match="launch failed"):
            gnk.fwd_normalize(x, a, b, True, with_stats)
    assert gnk.launches["gn_fwd_normalize"] == before


def test_normalize_refuses_another_partial_count(cuda):
    """The partials a plane the caller sized its scratch by must be the split
    count where the tap has partials, and 0 with no scratch elsewhere."""
    shape = (1, 128, 256, 256)
    x, _g, _s, _b, a, b = _inputs(shape, torch.bfloat16, cuda, 10)
    planes, hw = 128, 256 * 256
    splits = gnk.normalize_splits(planes, hw, 2)
    assert splits > 1
    y, abs_sum = torch.empty_like(x), torch.empty(1, 128, device=cuda)
    part = torch.empty(planes, 2 * splits, device=cuda)
    fn = gnk._fn("gn_fwd_normalize")
    stream = torch.cuda.current_stream().cuda_stream
    invalid = 1  # cudaErrorInvalidValue

    def call(tap, scratch, parts, split_count=splits):
        return fn(x.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(),
                  None if tap is None else tap.data_ptr(),
                  None if scratch is None else scratch.data_ptr(),
                  planes, hw, 1, 1, split_count, parts, stream)

    assert call(abs_sum, part, splits - 1) == invalid
    assert call(abs_sum, part, splits + 1) == invalid
    assert call(abs_sum, None, 0) == invalid       # partials with no scratch
    assert call(None, part, splits) == invalid     # a scratch with no tap
    assert call(abs_sum, part, splits, splits + 1) == invalid
    assert call(abs_sum, part, splits) == 0
    torch.cuda.synchronize()
    _assert_sums(abs_sum, gnk.fwd_normalize_reference(x, a, b, True, True)[1],
                 torch.bfloat16)
