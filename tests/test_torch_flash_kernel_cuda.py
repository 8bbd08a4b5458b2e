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
0.0625 at N=16384. The bf16 forward runs on wgmma, two warpgroups each
summing half the channels of the logits; its design's own faults, one
warpgroup's partial logits left out and the last tile's P V (issued after
the loop) left out of O, leave the same bounds.

The fp32 serving forward (the evaluation CLI's fp32 path) takes each fp32
product as three TF32 products (about 2^-22 of the product) and sums them in
another order than the plain version's fp32 matmul (TF32 off): relative L2
1e-5, 0.8e-6 to 2.1e-6 measured, where one dropped 64-key tile costs
8/sqrt(N) and one TF32 product about 4e-4 (tests/test_torch_flash_tf32x3.py).
Its sums have a fixed order, so two runs are bit-equal.

The backward's dQ, dK and dV are bf16 sums over N fp32 products of bf16
operands, summed in another order than the plain version's matmul, and the
bf16 P and dS may round the other way where exp differs in its last bit:
each is held to max|kernel - plain| <= 2^-6 max|plain| (4 bf16 ulps at the
top of max|plain|'s binade) and a relative L2 error of 1e-2. Leaving one
32-query tile out of dK/dV costs about sqrt(32/N) in relative L2, 0.044 at
N = 16384; leaving one rank's 128-channel partial out of the logits' sums
(the backward kernels split the channels over a thread-block cluster of
C / 128 CTAs) costs far more. The fp32 lse is held to 1e-5 of max|plain|:
the kernel sums its denominator in another order.

fp32 training runs the fp32 forward with its lse and the fp32 backward
(3xTF32 on wgmma on the same cluster split, the outputs transposed), P and
dS kept in fp32 until they are split: o, dQ, dK and dV are held to relative
L2 1e-5 of the plain version (TF32 off), about 3e-6 from the split and
sums in another order; each bound rejects one tile left out, the cluster's
last rank left out of the logits' sums, the plain version with TF32 on (one
TF32 product, about 1e-3) and the backward's lo products left out (every
operand rounded to its TF32 hi). Mixed dtypes raise.

Fewer queries than keys (the spatial axis: each rank's N / S rows of the
image against every rank's keys): each kernel at nq = N / 2 and N / 4
against nk = N, bf16 and fp32, under the same bounds, which reject a key
tile left out of the forward and of dQ, a query tile left out of dK/dV and
a rank's partial left out of the logits' sums; two runs are bit-equal; and
a query block's o, lse and dQ at nq < nk are the bits of the same block at
nq == nk, so the query count changes no block's arithmetic.
"""

import ctypes

import pytest
import torch

from chip_smoke import bwd_lo_left_out, bwd_rank_left_out, fwd_last_pv_left_out
from vae_channel_dynamics_tpu_torch.ops import _cuda_build
from vae_channel_dynamics_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

RTOL, ATOL = 1.6e-2, 1e-2
REL_L2 = 1e-2
GRAD_MAX_REL = 2.0 ** -6
LSE_MAX_REL = 1e-5
KERNELS_TRAINING = ("flash_attention_fwd_lse", "flash_attention_bwd_dkv",
                    "flash_attention_bwd_dq")
KERNELS_TRAINING_F32 = tuple(f"{name}_f32" for name in KERNELS_TRAINING)
F32_REL_L2 = 1e-5


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


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("shape", [(2, 384, 128), (1, 640, 256), (3, 384, 384), (1, 384, 512),
                                   (2, 1024, 512)])
def test_forward_every_width_matches_plain(cuda, shape, with_lse):
    """Every width, N = 128 x odd among them: the serving forward, or the
    LSE forward, within the bounds of plain."""
    q, k, v = _qkv(shape, cuda, seed=sum(shape) + 3)
    scale = shape[-1] ** -0.5
    name = "flash_attention_fwd_lse" if with_lse else "flash_attention_fwd"
    before = fa.launches[name]
    if with_lse:
        out, lse = fa.flash_attention_fwd_lse(q, k, v, scale=scale, out_dtype=torch.bfloat16)
    else:
        out = fa.flash_attention_fwd(q, k, v, scale=scale, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert fa.launches[name] == before + 1
    ref_out, ref_lse = fa.flash_attention_fwd_lse_reference(q, k, v, scale, torch.bfloat16)
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=RTOL, atol=ATOL)
    assert _rel(out, ref_out)[1] <= REL_L2
    if with_lse:
        assert _rel(lse, ref_lse)[0] <= LSE_MAX_REL


@pytest.mark.parametrize("c", fa.SUPPORTED_CHANNELS)
def test_forward_is_deterministic(cuda, c):
    """Both bf16 forwards, every width: two runs give the same bits, and the
    serving forward's o is the LSE forward's."""
    q, k, v = _qkv((2, 512, c), cuda, seed=c + 1)
    scale = c ** -0.5
    o1 = fa.flash_attention_fwd(q, k, v, scale=scale, out_dtype=torch.bfloat16)
    o2 = fa.flash_attention_fwd(q, k, v, scale=scale, out_dtype=torch.bfloat16)
    lo1, lse1 = fa.flash_attention_fwd_lse(q, k, v, scale=scale, out_dtype=torch.bfloat16)
    lo2, lse2 = fa.flash_attention_fwd_lse(q, k, v, scale=scale, out_dtype=torch.bfloat16)
    assert torch.equal(o1, o2) and torch.equal(lo1, lo2) and torch.equal(lse1, lse2)
    assert torch.equal(o1, lo1)


@pytest.mark.parametrize("shape", [(4, 4096, 512), (1, 16384, 512), (2, 384, 256)])
def test_forward_bound_rejects_its_design_faults(cuda, shape):
    """The bound that the kernel meets rejects what its new mechanisms could
    get wrong: one warpgroup's partial logits (its half of the channels)
    left out of S, and the last tile's P V left out of O."""
    q, k, v = _qkv(shape, cuda, seed=sum(shape) + 4)
    scale = shape[-1] ** -0.5
    ref = fa.flash_attention_reference(q, k, v, scale, torch.bfloat16)
    out = fa.flash_attention_fwd(q, k, v, scale=scale, out_dtype=torch.bfloat16)
    torch.testing.assert_close(out.float(), ref.float(), rtol=RTOL, atol=ATOL)
    assert _rel(out, ref)[1] <= REL_L2
    c = shape[-1]
    half = fa.flash_attention_reference(q[..., :c // 2].contiguous(), k[..., :c // 2].contiguous(),
                                        v, scale, torch.bfloat16)
    last_pv = fwd_last_pv_left_out(q, k, v, scale)
    for faulty in (half, last_pv):
        close = torch.allclose(faulty.float(), ref.float(), rtol=RTOL, atol=ATOL)
        assert not (close and _rel(faulty, ref)[1] <= REL_L2)


def test_lse_kernel_handles_large_logits(cuda):
    """Scaled logits in the hundreds through the LSE forward: the base-2
    running max keeps 2^x in range, and lse stays within 1e-5 of plain."""
    q, k, v = _qkv((2, 256, 128), cuda, seed=2)
    out, lse = fa.flash_attention_fwd_lse(q * 8, k * 8, v, scale=1.0, out_dtype=torch.bfloat16)
    ref, ref_lse = fa.flash_attention_fwd_lse_reference(q * 8, k * 8, v, 1.0, torch.bfloat16)
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    torch.testing.assert_close(out.float(), ref.float(), rtol=RTOL, atol=ATOL)
    assert _rel(lse, ref_lse)[0] <= LSE_MAX_REL


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
    # and all three with the cluster's last rank left out of the logits' sums
    faulty = bwd_rank_left_out(q, k, v, do, lse, delta, scale, fa.bwd_cluster_size(shape[2]) - 1)
    for f, r in zip(faulty, refs):
        max_rel, rel_l2 = _rel(f, r)
        assert max_rel > GRAD_MAX_REL or rel_l2 > REL_L2


@pytest.mark.parametrize("shape", [(2, 1024, 128), (2, 1024, 256), (1, 1024, 384),
                                   (2, 1024, 512)])
def test_backward_is_deterministic(cuda, shape):
    q, k, v, do = _qkv(shape, cuda, seed=7, n=4)
    scale = shape[-1] ** -0.5
    o, lse = fa.flash_attention_fwd_lse(q, k, v, scale=scale, out_dtype=torch.bfloat16)
    delta = (do.float() * o.float()).sum(-1)
    before = dict(fa.launches)
    first = _bwd(q, k, v, do, lse, delta, scale)
    second = _bwd(q, k, v, do, lse, delta, scale)
    for name in ("flash_attention_bwd_dkv", "flash_attention_bwd_dq"):
        assert fa.launches[name] == before[name] + 2
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("shape", [(4, 8192, 128), (1, 8192, 512)])
def test_backward_over_many_tiles_after_the_arming_repair(cuda, shape):
    """The exchange barriers are armed after push_partials' barrier, which
    every thread passes only after its waits on the tile before: at C = 128
    (a cluster of one) they expect no byte, so arming completes the phase at
    once. Over 128 and 256 tiles at C = 128 and C = 512, three runs are
    bit-equal and within the bound of the plain version."""
    q, k, v, do = _qkv(shape, cuda, seed=11, n=4)
    scale = shape[-1] ** -0.5
    o, lse = fa.flash_attention_fwd_lse(q, k, v, scale=scale, out_dtype=torch.bfloat16)
    delta = (do.float() * o.float()).sum(-1)
    runs = [_bwd(q, k, v, do, lse, delta, scale) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for run in runs[1:] for a, b in zip(runs[0], run))
    refs = fa.flash_attention_bwd_reference(q, k, v, do, lse, delta, scale)
    for name, g, r in zip(("dq", "dk", "dv"), runs[0], refs):
        max_rel, rel_l2 = _rel(g, r)
        assert max_rel <= GRAD_MAX_REL and rel_l2 <= REL_L2, (name, max_rel, rel_l2)


@pytest.mark.parametrize("b, n, c", [(1, 128, 1152), (1, 128, 96), (1, 100, 128),
                                     (1, 64, 128), (0, 128, 128), (70000, 128, 128)])
def test_backward_entries_refuse_other_shapes(cuda, b, n, c):
    """The C entries return cudaErrorInvalidValue (1) for a width, token
    count or batch the kernels do not take, before touching the operands."""
    fa.build_backward()
    lib = _cuda_build.load(fa.BWD_LIBRARY)
    x = torch.zeros(4096, device=cuda, dtype=torch.bfloat16)
    ptr = ctypes.c_void_p(x.data_ptr())
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    dkv = lib.vcd_flash_attention_bwd_dkv_bf16
    dkv.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    dq = lib.vcd_flash_attention_bwd_dq_bf16
    dq.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    # (b, nq, nk, c): the bad count as the queries, as the keys, as both
    for nq, nk in ((n, n), (n, 128), (128, n)):
        assert dkv(*[ptr] * 8, b, nq, nk, c, 1.0, stream) == 1
        assert dq(*[ptr] * 7, b, nq, nk, c, 1.0, stream) == 1
    torch.cuda.synchronize()


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


@pytest.mark.parametrize("shape", SHAPES[:5])
def test_fp32_kernel_matches_plain(cuda, shape):
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _qkv(shape, cuda, seed=sum(shape) + 1, dtype=torch.float32)
    scale = shape[-1] ** -0.5
    before = dict(fa.launches)
    out = fa.flash_attention(q, k, v, scale=scale, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert fa.launches["flash_attention_fwd_f32"] == before["flash_attention_fwd_f32"] + 1
    assert fa.launches["flash_attention_fwd"] == before["flash_attention_fwd"]
    assert out.dtype == torch.float32 and out.shape == q.shape
    ref = fa.flash_attention_reference(q, k, v, scale, torch.float32)
    assert ((out - ref).norm() / ref.norm()).item() <= 1e-5


@pytest.mark.parametrize("c", fa.SUPPORTED_CHANNELS)
def test_fp32_kernel_every_width_bit_equal(cuda, c):
    """Every channel width the kernel takes (each warpgroup's half of C is
    the N of its P V product), two runs bit-equal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _qkv((2, 256, c), cuda, seed=c, dtype=torch.float32)
    scale = c ** -0.5
    out = fa.flash_attention_fwd(q, k, v, scale=scale, out_dtype=torch.float32)
    again = fa.flash_attention_fwd(q, k, v, scale=scale, out_dtype=torch.float32)
    ref = fa.flash_attention_reference(q, k, v, scale, torch.float32)
    assert torch.equal(out, again)
    assert ((out - ref).norm() / ref.norm()).item() <= 1e-5


def test_fp32_kernel_handles_large_logits(cuda):
    """Logits of several hundred: the running max keeps exp in range. Each
    logit is a sum of 128 fp32 products taken in another order than the
    plain matmul's, off by about |s| 2^-24 sqrt(C) (~5e-4 at |s| ~ 700),
    and exp turns that into the probabilities' relative error, so the bound
    here is 1e-4 relative L2 (1.7e-5 measured on an H100)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _qkv((2, 256, 128), cuda, seed=1, dtype=torch.float32)
    out = fa.flash_attention(q * 8, k * 8, v, scale=1.0, out_dtype=torch.float32)
    ref = fa.flash_attention_reference(q * 8, k * 8, v, 1.0, torch.float32)
    assert torch.isfinite(out).all()
    assert ((out - ref).norm() / ref.norm()).item() <= 1e-4


def test_fp32_input_raises(cuda):
    """Mixed dtypes raise at every entry: fp32 q/k/v with a bf16 output, bf16
    q/k/v with an fp32 one, and a backward whose dO is not q's dtype."""
    q, k, v = _qkv((1, 128, 128), cuda, dtype=torch.float32)
    lse = torch.zeros((1, 128), device=cuda)
    before = dict(fa.launches)
    with pytest.raises(NotImplementedError, match="all bf16 or all fp32"):
        fa.flash_attention_fwd(q, k, v, scale=1.0, out_dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="all bf16 or all fp32"):
        fa.flash_attention_fwd_lse(q.bfloat16(), k.bfloat16(), v.bfloat16(), scale=1.0,
                                   out_dtype=torch.float32)
    for entry in (fa.flash_attention_bwd_dkv, fa.flash_attention_bwd_dq):
        with pytest.raises(NotImplementedError, match="all bf16 or all fp32"):
            entry(q, k, v, q.bfloat16(), lse, lse, scale=1.0)
    assert fa.launches == before


def _f32_training(q, k, v, do, scale):
    """o, lse, delta and (dq, dk, dv) from the fp32 kernels."""
    o, lse = fa.flash_attention_fwd_lse(q, k, v, scale=scale, out_dtype=torch.float32)
    delta = (do * o).sum(-1)
    return o, lse, delta, _bwd(q, k, v, do, lse, delta, scale)


@pytest.mark.parametrize("shape", [(1, 128, 128), (3, 256, 256), (2, 384, 384), (2, 384, 512),
                                   (1, 1024, 512), (4, 4096, 512)])
def test_fp32_training_kernels_match_plain(cuda, shape):
    """The fp32 LSE forward and backward against their plain versions (TF32
    off), each bound rejecting a planted fault: one 32-query tile out of
    dK/dV, one 32-key tile out of dQ, the last rank out of the logits' sums,
    one TF32 product (the plain version with TF32 on) and the backward's lo
    products left out (1xTF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do = _qkv(shape, cuda, seed=sum(shape) + 3, dtype=torch.float32, n=4)
    scale = shape[-1] ** -0.5
    before = dict(fa.launches)
    o, lse, delta, grads = _f32_training(q, k, v, do, scale)
    torch.cuda.synchronize()
    assert {n: fa.launches[n] - before[n] for n in fa.launches} == {
        n: int(n in KERNELS_TRAINING_F32) for n in fa.launches}
    po, plse = fa.flash_attention_fwd_lse_reference(q, k, v, scale, torch.float32)
    assert o.dtype == torch.float32 and _rel(o, po)[1] <= F32_REL_L2
    assert _rel(lse, plse)[0] <= LSE_MAX_REL
    refs = fa.flash_attention_bwd_reference(q, k, v, do, lse, delta, scale)
    for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
        assert g.dtype == torch.float32 and g.shape == q.shape
        assert _rel(g, r)[1] <= F32_REL_L2, (name, _rel(g, r))
    _, fk, fv = fa.flash_attention_bwd_reference(
        q[:, 32:], k, v, do[:, 32:], lse[:, 32:], delta[:, 32:], scale)
    fq = fa.flash_attention_bwd_dq_reference(q, k[:, 32:], v[:, 32:], do, lse, delta, scale)
    faults = [(fq, refs[0]), (fk, refs[1]), (fv, refs[2])]
    faults += zip(bwd_rank_left_out(q, k, v, do, lse, delta, scale,
                                    fa.bwd_cluster_size(shape[2]) - 1), refs)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        faults += zip(fa.flash_attention_bwd_reference(q, k, v, do, lse, delta, scale), refs)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    faults += zip(bwd_lo_left_out(q, k, v, do, lse, delta, scale), refs)
    for f, r in faults:
        assert _rel(f, r)[1] > F32_REL_L2


@pytest.mark.parametrize("c", fa.SUPPORTED_CHANNELS)
def test_fp32_training_kernels_are_deterministic(cuda, c):
    """Every width (clusters of one to eight CTAs), two runs bit-equal."""
    q, k, v, do = _qkv((2, 1024, c), cuda, seed=c + 1, dtype=torch.float32, n=4)
    first = _f32_training(q, k, v, do, c ** -0.5)
    second = _f32_training(q, k, v, do, c ** -0.5)
    assert all(torch.equal(a, b) for a, b in zip(first[:3], second[:3]))
    assert all(torch.equal(a, b) for a, b in zip(first[3], second[3]))


def test_fp32_training_handles_large_logits(cuda):
    """Logits of several hundred (q and k times 8, scale 1): lse and the
    gradients stay finite and near plain; exp turns the logits' rounding
    into relative error, so 1e-4 here, as the fp32 forward's own test."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do = _qkv((2, 256, 128), cuda, seed=1, dtype=torch.float32, n=4)
    q, k = q * 8, k * 8
    o, lse, delta, grads = _f32_training(q, k, v, do, 1.0)
    refs = fa.flash_attention_bwd_reference(q, k, v, do, lse, delta, 1.0)
    assert torch.isfinite(lse).all()
    for g, r in zip(grads, refs):
        assert torch.isfinite(g).all() and _rel(g, r)[1] <= 1e-4


@pytest.mark.parametrize("shape", [(2, 256, 128), (1, 4096, 512)])
def test_fp32_autograd_function_matches_plain_autograd(cuda, shape):
    """Gradients through flash_attention at fp32 (the three fp32 kernels)
    against autograd of the plain forward, TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, g = _qkv(shape, cuda, seed=12, dtype=torch.float32, n=4)
    scale = shape[-1] ** -0.5

    def grads(fn):
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves)
        return (out.detach(), *torch.autograd.grad(out, leaves, g))

    before = dict(fa.launches)
    got = grads(lambda a, b, c: fa.flash_attention(a, b, c, scale=scale,
                                                   out_dtype=torch.float32))
    torch.cuda.synchronize()
    assert {n: fa.launches[n] - before[n] for n in fa.launches} == {
        n: int(n in KERNELS_TRAINING_F32) for n in fa.launches}
    want = grads(lambda a, b, c: fa.flash_attention_reference(a, b, c, scale, torch.float32))
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        assert _rel(a, b)[1] <= F32_REL_L2, (name, _rel(a, b))


@pytest.mark.parametrize("b, n, c", [(1, 128, 1152), (1, 128, 96), (1, 100, 128),
                                     (1, 64, 128), (0, 128, 128), (70000, 128, 128)])
def test_fp32_backward_entries_refuse_other_shapes(cuda, b, n, c):
    """The fp32 backward's C entries return cudaErrorInvalidValue (1) for a
    width, token count or batch they do not take."""
    fa.build_backward_f32()
    lib = _cuda_build.load(fa.BWD_F32_LIBRARY)
    x = torch.zeros(4096, device=cuda)
    ptr = ctypes.c_void_p(x.data_ptr())
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    dkv = lib.vcd_flash_attention_bwd_dkv_f32
    dkv.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    dq = lib.vcd_flash_attention_bwd_dq_f32
    dq.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    # (b, nq, nk, c): the bad count as the queries, as the keys, as both
    for nq, nk in ((n, n), (n, 128), (128, n)):
        assert dkv(*[ptr] * 8, b, nq, nk, c, 1.0, stream) == 1
        assert dq(*[ptr] * 7, b, nq, nk, c, 1.0, stream) == 1
    torch.cuda.synchronize()


@pytest.mark.parametrize("shape", [(1, 100, 128), (1, 128, 200), (1, 128, 96)])
def test_ineligible_shape_raises(cuda, shape):
    q, k, v = _qkv(shape, cuda)
    with pytest.raises(ValueError, match="not eligible"):
        fa.flash_attention(q, k, v, scale=1.0, out_dtype=torch.bfloat16)


def test_non_contiguous_input_raises(cuda):
    q, k, v = _qkv((1, 128, 256), cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q[:, :, :128], k[:, :, :128], v[:, :, :128], scale=1.0,
                           out_dtype=torch.bfloat16)


# (B, nq, nk, C): a spatial group of 2 and of 4 over N = 4096 keys, and a
# cluster of one at C = 128
SPLIT_SHAPES = [(1, 2048, 4096, 512), (1, 1024, 4096, 512), (2, 256, 1024, 128)]


def _split_operands(shape, device, dtype, seed):
    b, nq, nk, c = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    q, do = (torch.randn((b, nq, c), generator=gen, device=device).to(dtype) for _ in range(2))
    k, v = (torch.randn((b, nk, c), generator=gen, device=device).to(dtype) for _ in range(2))
    return q, k, v, do


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", SPLIT_SHAPES)
def test_fewer_queries_than_keys_match_plain(cuda, shape, dtype):
    """Each changed kernel (the serving and LSE forwards, dK/dV, dQ) at nq <
    nk against its plain version, launched once a call, bit-equal run to
    run; each bound rejects its planted faults."""
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = dtype == torch.float32
    q, k, v, do = _split_operands(shape, cuda, dtype, seed=sum(shape))
    scale = shape[-1] ** -0.5
    before = dict(fa.launches)
    runs = []
    for _ in range(2):
        o, lse = fa.flash_attention_fwd_lse(q, k, v, scale=scale, out_dtype=dtype)
        serving = fa.flash_attention_fwd(q, k, v, scale=scale, out_dtype=dtype)
        delta = (do.float() * o.float()).sum(-1)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale=scale)
        dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale=scale)
        runs.append((o, lse, serving, dq, dk, dv))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    suffix = "_f32" if f32 else ""
    for name in ("flash_attention_fwd_lse", "flash_attention_fwd", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq"):
        assert fa.launches[name + suffix] == before[name + suffix] + 2, name
    o, lse, serving, dq, dk, dv = runs[0]
    assert o.shape == q.shape and lse.shape == q.shape[:2] and dk.shape == k.shape
    assert torch.equal(serving, o)
    po, plse = fa.flash_attention_fwd_lse_reference(q, k, v, scale, dtype)
    # the backward's plain version on the kernel's own lse and delta
    pdq, pdk, pdv = fa.flash_attention_bwd_reference(q, k, v, do, lse, delta, scale)
    fs = 64
    dropped = fa.flash_attention_reference(q, k[:, :-fs].contiguous(), v[:, :-fs].contiguous(),
                                           scale, dtype)
    _, tile_dk, tile_dv = fa.flash_attention_bwd_reference(
        q[:, 32:], k, v, do[:, 32:], lse[:, 32:], delta[:, 32:], scale)
    key_dq = fa.flash_attention_bwd_dq_reference(q, k[:, fs:], v[:, fs:], do, lse, delta, scale)
    rank_dq, rank_dk, rank_dv = bwd_rank_left_out(q, k, v, do, lse, delta, scale,
                                                  fa.bwd_cluster_size(shape[-1]) - 1)

    def within(got, ref):
        max_rel, rel_l2 = _rel(got, ref)
        return rel_l2 <= (F32_REL_L2 if f32 else REL_L2) and (f32 or max_rel <= GRAD_MAX_REL)

    assert _rel(lse, plse)[0] <= LSE_MAX_REL
    for name, got, ref, faults in (
            ("o", o, po, [dropped]),
            ("dq", dq, pdq, [key_dq, rank_dq]),
            ("dk", dk, pdk, [tile_dk, rank_dk]),
            ("dv", dv, pdv, [tile_dv, rank_dv])):
        assert within(got, ref), (name, _rel(got, ref))
        for i, fault in enumerate(faults):
            assert not within(fault, ref), (name, i, _rel(fault, ref))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", [(1, 4096, 512), (2, 1024, 128)])
def test_query_blocks_do_not_depend_on_the_query_count(cuda, shape, dtype):
    """o, lse and dQ of the first N / 2 and N / 4 queries against all N keys
    are the bits of the same rows at nq == nk: the query extent sets the
    grid and nothing else."""
    torch.backends.cuda.matmul.allow_tf32 = False
    b, n, c = shape
    q, k, v, do = (t.to(dtype) for t in _qkv(shape, cuda, seed=n + c, dtype=torch.float32, n=4))
    scale = c ** -0.5
    o, lse = fa.flash_attention_fwd_lse(q, k, v, scale=scale, out_dtype=dtype)
    delta = (do.float() * o.float()).sum(-1)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale=scale)
    for nq in (n // 2, n // 4):
        qs, dos = q[:, :nq].contiguous(), do[:, :nq].contiguous()
        o_s, lse_s = fa.flash_attention_fwd_lse(qs, k, v, scale=scale, out_dtype=dtype)
        dq_s = fa.flash_attention_bwd_dq(qs, k, v, dos, lse[:, :nq].contiguous(),
                                         delta[:, :nq].contiguous(), scale=scale)
        torch.cuda.synchronize()
        assert torch.equal(o_s, o[:, :nq]) and torch.equal(lse_s, lse[:, :nq]), nq
        assert torch.equal(dq_s, dq[:, :nq]), nq


# Heads of 640-1024 channels: the forwards on a cluster of two CTAs, the
# backward on clusters of five to eight; the bounds of the widths below.
WIDE_SHAPES = [(2, 256, 256, 640), (2, 128, 256, 640), (2, 256, 256, 1024),
               (2, 128, 256, 1024)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", WIDE_SHAPES)
def test_every_entry_at_wide_heads_matches_plain(cuda, shape, dtype):
    """The serving and LSE forwards, dK/dV and dQ at (B, nq, nk, C), each
    launched once, against their plain versions (bf16: the forward's rtol
    and atol, the backward's 2^-6 and 1e-2; fp32: relative L2 1e-5, TF32
    off), bit-equal over two runs, and rejecting the designs' own fault:
    one rank's partial left out of the logits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    b, nq, nk, c = shape
    q, do = _qkv((b, nq, c), cuda, seed=c + nq, dtype=dtype, n=2)
    k, v = _qkv((b, nk, c), cuda, seed=c + nk + 1, dtype=dtype, n=2)
    scale = c ** -0.5
    suffix = "_f32" if dtype == torch.float32 else ""
    runs = []
    for _ in range(2):
        before = dict(fa.launches)
        serving = fa.flash_attention_fwd(q, k, v, scale=scale, out_dtype=dtype)
        o, lse = fa.flash_attention_fwd_lse(q, k, v, scale=scale, out_dtype=dtype)
        delta = (do.float() * o.float()).sum(-1)
        dq, dk, dv = _bwd(q, k, v, do, lse, delta, scale)
        torch.cuda.synchronize()
        for name in ("flash_attention_fwd", *KERNELS_TRAINING):
            assert fa.launches[name + suffix] == before[name + suffix] + 1, name
        runs.append((serving, o, lse, dq, dk, dv))
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    serving, o, lse, dq, dk, dv = runs[0]
    assert torch.equal(serving, o)
    ref_o, ref_lse = fa.flash_attention_fwd_lse_reference(q, k, v, scale, dtype)
    assert _rel(lse, ref_lse)[0] <= LSE_MAX_REL
    refs = fa.flash_attention_bwd_reference(q, k, v, do, lse, delta, scale)
    faults = bwd_rank_left_out(q, k, v, do, lse, delta, scale, fa.bwd_cluster_size(c) - 1)
    if dtype == torch.float32:
        for got, ref in zip((o, dq, dk, dv), (ref_o, *refs)):
            assert _rel(got, ref)[1] <= F32_REL_L2
        for fault, ref in zip(faults, refs):
            assert _rel(fault, ref)[1] > F32_REL_L2
        return
    torch.testing.assert_close(o.float(), ref_o.float(), rtol=RTOL, atol=ATOL)
    assert _rel(o, ref_o)[1] <= REL_L2
    for got, ref in zip((dq, dk, dv), refs):
        max_rel, rel_l2 = _rel(got, ref)
        assert max_rel <= GRAD_MAX_REL and rel_l2 <= REL_L2
    for fault, ref in zip(faults, refs):
        max_rel, rel_l2 = _rel(fault, ref)
        assert max_rel > GRAD_MAX_REL or rel_l2 > REL_L2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_autograd_function_at_768_matches_plain_autograd(cuda, dtype):
    """Gradients through flash_attention at (1, 1024, 768) (the LSE forward
    on a cluster of two, the backward on clusters of six) against autograd
    of the plain forward, in bf16 (the bounds of the 512-channel test) and
    fp32 (relative L2 1e-5)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, g = _qkv((1, 1024, 768), cuda, seed=21, dtype=dtype, n=4)
    scale = 768 ** -0.5

    def grads(fn):
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves)
        return (out.detach(), *torch.autograd.grad(out, leaves, g))

    got = grads(lambda a, b, c: fa.flash_attention(a, b, c, scale=scale, out_dtype=dtype))
    want = grads(lambda a, b, c: fa.flash_attention_reference(a, b, c, scale, dtype))
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        max_rel, rel_l2 = _rel(a, b)
        if dtype == torch.float32:
            assert rel_l2 <= F32_REL_L2, (name, rel_l2)
        else:
            assert max_rel <= 2 * GRAD_MAX_REL and rel_l2 <= 2 * REL_L2, (name, max_rel, rel_l2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_heads_past_1024_raise_naming_the_roadmap_item(cuda, dtype):
    """Past 1024 channels every entry raises NotImplementedError naming its
    ROADMAP item, before any launch."""
    q, k, v = _qkv((1, 128, 1152), cuda, dtype=dtype)
    lse = torch.zeros(1, 128, device=cuda)
    before = dict(fa.launches)
    for call in (lambda: fa.flash_attention_fwd(q, k, v, scale=1.0, out_dtype=dtype),
                 lambda: fa.flash_attention_fwd_lse(q, k, v, scale=1.0, out_dtype=dtype),
                 lambda: fa.flash_attention_bwd_dkv(q, k, v, q, lse, lse, scale=1.0),
                 lambda: fa.flash_attention_bwd_dq(q, k, v, q, lse, lse, scale=1.0)):
        with pytest.raises(NotImplementedError, match=fa.WIDE_HEADS):
            call()
    assert fa.launches == before


def test_layouts_are_the_python_mirrors(cuda):
    """Each library's dynamic shared memory a CTA at every width equals the
    Python mirror of its layout (``fwd_smem_bytes``, ``bwd_smem_bytes``)."""
    fa.build_forward()
    fa.build_backward()
    fa.build_backward_f32()
    for lib, fn, mirror in (
            (fa.FWD_LIBRARY, "vcd_flash_attention_fwd_smem",
             lambda c, a: fa.fwd_smem_bytes(c, bool(a))),
            (fa.BWD_LIBRARY, "vcd_flash_attention_bwd_smem",
             lambda c, a: fa.bwd_smem_bytes(c, bool(a))),
            (fa.BWD_F32_LIBRARY, "vcd_flash_attention_bwd_f32_smem",
             lambda c, a: fa.bwd_smem_bytes(c, bool(a), True))):
        f = getattr(_cuda_build.load(lib), fn)
        f.argtypes, f.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
        for c in fa.SUPPORTED_CHANNELS:
            for a in (0, 1):
                assert f(c, a) == mirror(c, a), (fn, c, a)
        assert f(1152, 0) == -1
