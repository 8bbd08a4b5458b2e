"""The port's GroupNorm kernel module against the JAX package's Pallas one,
on the CPU.

Each of the four CUDA kernels' plain versions (what their wrappers run for a
CPU tensor) is held against the Pallas function it replaces, run in
interpret mode as the JAX package's own tests run it; then the two autograd
ops end to end, forward and dx, dgamma, dbeta for the same cotangent, with
and without a tap mask. The same numpy inputs go to both, NHWC to JAX and
NCHW to the port. Tolerances are the JAX tests' own
(tests/test_pallas_group_norm.py): fp32 forward 2e-5, the |z| statistic 1e-5
relative, gradients 5e-4, bf16 IO 2e-2.

Then the split kernels' rules (the splits of each plane for the normalize,
the backward reduce and dx, and the count each wrapper hands its kernel),
numpy models of the split backward reduce and the split dx, and, at the
end, the port's refusals of what it does not run yet, each naming its
ROADMAP item by title.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_channel_dynamics_tpu.ops import pallas_group_norm as jgn
from vae_channel_dynamics_tpu.ops import stats as jstats
from vae_channel_dynamics_tpu_torch.ops import group_norm_kernel as gnk
from vae_channel_dynamics_tpu_torch.ops import stats as tstats
from vae_channel_dynamics_tpu_torch.ops.group_norm import group_norm

FWD_TOL = 2e-5
STATS_RTOL = 1e-5
GRAD_TOL = 5e-4
BF16_TOL = 2e-2

# (B, H, W, C): the issue's (2, 8*16, 128) and (2, 64, 256) as (B, HW, C)
SHAPES = [(2, 8, 16, 128), (2, 8, 8, 256)]


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _inputs(shape, seed):
    b, h, w, c = shape
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2.0 + 0.3).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    a = (0.5 + rng.random((b, c))).astype(np.float32)
    off = (0.3 * rng.standard_normal((b, c))).astype(np.float32)
    return x, g, a, off


def _coeffs(shape, seed):
    b, _h, _w, c = shape
    rng = np.random.default_rng(seed + 100)
    return tuple((rng.standard_normal((b, c)) * s).astype(np.float32)
                 for s in (1.0, 0.01, 0.1))


@pytest.fixture(autouse=True)
def no_kernel_launches():
    """The CPU tensors here must take the plain versions: no kernel runs."""
    before = dict(gnk.launches)
    yield
    assert gnk.launches == before


@pytest.mark.parametrize("shape", SHAPES)
def test_fwd_reduce_matches_channel_sums(shape):
    x, *_ = _inputs(shape, 0)
    b, h, w, c = shape
    js, jq = jgn._channel_sums(jnp.asarray(x.reshape(b, h * w, c)))
    ts, tq = gnk.fwd_reduce(_nchw(x))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js)[:, 0], rtol=STATS_RTOL, atol=1e-3)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq)[:, 0], rtol=STATS_RTOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("fuse_silu", [False, True])
@pytest.mark.parametrize("with_stats", [False, True])
def test_fwd_normalize_matches_apply_normalize(shape, fuse_silu, with_stats):
    x, _g, a, off = _inputs(shape, 1)
    b, h, w, c = shape
    j_out = jgn._apply_normalize(jnp.asarray(x.reshape(b, h * w, c)), jnp.asarray(a),
                                 jnp.asarray(off), fuse_silu, with_abs_stats=with_stats)
    y, abs_sum = gnk.fwd_normalize(_nchw(x), torch.from_numpy(a), torch.from_numpy(off),
                                   fuse_silu, with_stats)
    j_y = j_out[0] if with_stats else j_out
    np.testing.assert_allclose(_nhwc(y), np.asarray(j_y).reshape(shape),
                               rtol=FWD_TOL, atol=FWD_TOL)
    if with_stats:
        np.testing.assert_allclose(abs_sum.numpy(), np.asarray(j_out[1]), rtol=STATS_RTOL)
    else:
        assert abs_sum is None


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("fuse_silu", [False, True])
def test_bwd_reduce_matches_bwd_channel_sums(shape, fuse_silu):
    x, g, a, off = _inputs(shape, 2)
    b, h, w, c = shape
    jg, jgx = jgn._bwd_channel_sums(jnp.asarray(x.reshape(b, h * w, c)),
                                    jnp.asarray(g.reshape(b, h * w, c)),
                                    jnp.asarray(a), jnp.asarray(off), fuse_silu)
    tg, tgx = gnk.bwd_reduce(_nchw(x), _nchw(g), torch.from_numpy(a),
                             torch.from_numpy(off), fuse_silu)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=GRAD_TOL, atol=GRAD_TOL)
    np.testing.assert_allclose(tgx.numpy(), np.asarray(jgx), rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("fuse_silu", [False, True])
def test_bwd_dx_matches_bwd_dx(shape, fuse_silu):
    x, g, a, off = _inputs(shape, 3)
    ca, cb, cc = _coeffs(shape, 3)
    b, h, w, c = shape
    j_dx = jgn._bwd_dx(jnp.asarray(x.reshape(b, h * w, c)), jnp.asarray(g.reshape(b, h * w, c)),
                       jnp.asarray(a), jnp.asarray(off), jnp.asarray(ca), jnp.asarray(cb),
                       jnp.asarray(cc), fuse_silu)
    t_dx = gnk.bwd_dx(_nchw(x), _nchw(g), *(torch.from_numpy(v) for v in (a, off, ca, cb, cc)),
                      fuse_silu)
    np.testing.assert_allclose(_nhwc(t_dx), np.asarray(j_dx).reshape(shape),
                               rtol=FWD_TOL, atol=FWD_TOL)


def _param_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    scale = (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return scale, bias


def _torch_op(fn, x, scale, bias, g, groups, fuse_silu, dtype=torch.float32):
    xt = _nchw(x).to(dtype).requires_grad_(True)
    st = torch.from_numpy(scale).requires_grad_(True)
    bt = torch.from_numpy(bias).requires_grad_(True)
    out = fn(xt, st, bt, groups, 1e-6, fuse_silu)
    y = out[0] if isinstance(out, tuple) else out
    y.backward(_nchw(g).to(dtype))
    return out, xt.grad, st.grad, bt.grad


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("fuse_silu", [False, True])
def test_group_norm_silu_matches_jax(shape, fuse_silu):
    x, g, *_ = _inputs(shape, 4)
    scale, bias = _param_inputs(shape, 4)
    groups = 32

    def jfn(x_, s_, b_):
        return jgn.group_norm_silu(x_, s_, b_, num_groups=groups, eps=1e-6, fuse_silu=fuse_silu)

    j_y, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    j_dx, j_ds, j_db = vjp(jnp.asarray(g))
    y, dx, ds, db = _torch_op(gnk.group_norm_silu, x, scale, bias, g, groups, fuse_silu)
    np.testing.assert_allclose(_nhwc(y), np.asarray(j_y), rtol=FWD_TOL, atol=FWD_TOL)
    for name, got, want in (("dx", _nhwc(dx), j_dx), ("dgamma", ds.numpy(), j_ds),
                            ("dbeta", db.numpy(), j_db)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)
    assert dx.dtype == torch.float32 and ds.dtype == db.dtype == torch.float32


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("fuse_silu", [False, True])
def test_group_norm_silu_with_stats_matches_jax(masked, fuse_silu):
    """Batch 3; with the mask, its last row is a pad row that the |z|
    statistic must ignore on both sides."""
    shape = (3, 8, 16, 128)
    x, g, *_ = _inputs(shape, 5)
    scale, bias = _param_inputs(shape, 5)
    mask = np.array([1.0, 1.0, 0.0], np.float32) if masked else None

    def jfn(x_, s_, b_):
        return jgn.group_norm_silu_with_stats(x_, s_, b_, num_groups=32, eps=1e-6,
                                              fuse_silu=fuse_silu)

    with jstats.tap_mask(None if mask is None else jnp.asarray(mask)):
        (j_y, j_abs), vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(scale),
                                    jnp.asarray(bias))
    j_dx, j_ds, j_db = vjp((jnp.asarray(g), jnp.zeros_like(j_abs)))
    with tstats.tap_mask(None if mask is None else torch.from_numpy(mask)):
        (y, mean_abs), dx, ds, db = _torch_op(gnk.group_norm_silu_with_stats, x, scale,
                                              bias, g, 32, fuse_silu)
    assert not mean_abs.requires_grad and mean_abs.shape == (128,)
    np.testing.assert_allclose(_nhwc(y), np.asarray(j_y), rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(mean_abs.numpy(), np.asarray(j_abs), rtol=STATS_RTOL)
    for name, got, want in (("dx", _nhwc(dx), j_dx), ("dgamma", ds.numpy(), j_ds),
                            ("dbeta", db.numpy(), j_db)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=name)
    if masked:
        # the pad row carries no weight: the statistic of the two valid rows
        with tstats.tap_mask(None):
            _y, valid = gnk.group_norm_silu_with_stats(
                _nchw(x[:2]), torch.from_numpy(scale), torch.from_numpy(bias), 32, 1e-6,
                fuse_silu)
        np.testing.assert_allclose(mean_abs.numpy(), valid.numpy(), rtol=STATS_RTOL)


def test_group_norm_silu_bf16_io_matches_jax():
    shape = (2, 8, 16, 128)
    x, *_ = _inputs(shape, 6)
    scale, bias = _param_inputs(shape, 6)
    j_y = jgn.group_norm_silu(jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale),
                              jnp.asarray(bias), num_groups=32, fuse_silu=True)
    y = gnk.group_norm_silu(_nchw(x).to(torch.bfloat16), torch.from_numpy(scale),
                            torch.from_numpy(bias), 32, 1e-6, True)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(_nhwc(y), np.asarray(j_y, np.float32), rtol=BF16_TOL,
                               atol=BF16_TOL)


@pytest.mark.parametrize("shape", [(2, 8, 8, 64), (2, 8, 8, 128), (2, 5, 5, 128),
                                   (2, 4, 4, 256), (1, 3, 8, 96)])
@pytest.mark.parametrize("groups", [32, 24])
def test_eligibility_matches_jax(shape, groups):
    x = np.zeros(shape, np.float32)
    assert gnk.eligible(_nchw(x), groups) == jgn.eligible(jnp.asarray(x), groups, "pallas")


def test_pallas_impl_refuses_what_jax_refuses():
    """At C = 64 both packages refuse impl='pallas'."""
    x = np.random.default_rng(7).standard_normal((2, 8, 8, 64)).astype(np.float32)
    scale, bias = np.ones(64, np.float32), np.zeros(64, np.float32)
    from vae_channel_dynamics_tpu.ops.group_norm import group_norm as jax_group_norm

    with pytest.raises(RuntimeError):
        jax_group_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 32,
                       impl="pallas")
    with pytest.raises(RuntimeError, match="ineligible"):
        group_norm(_nchw(x), torch.from_numpy(scale), torch.from_numpy(bias), 32,
                   impl="pallas")


# gn_fwd_normalize's split of each plane over several blocks, where B x C is
# too small to fill the card: every GroupNorm input shape of the SDXL VAE's
# 1024px batch-1 step, the 256px batch-16 step's largest and smallest, and
# ragged planes (the last split shorter, or one split only).
NORM_SPLIT_SHAPES = [
    (1, 128, 1024, 1024), (1, 256, 1024, 1024), (1, 128, 512, 512), (1, 256, 512, 512),
    (1, 512, 512, 512), (1, 256, 256, 256), (1, 512, 256, 256), (1, 512, 128, 128),
    (16, 128, 256, 256), (16, 512, 32, 32), (1, 256, 24, 40), (1, 128, 56, 311),
]


# each split rule, its function and the 16-byte loads a thread its least
# split holds: gn_fwd_normalize one round of NORM_LOADS, gn_bwd_reduce
# REDUCE_ROUNDS rounds of one (32 KB of x and of g), gn_bwd_dx one round of
# DX_LOADS loads of x and of g
SPLIT_RULES = {"normalize": (gnk.normalize_splits, gnk.NORM_LOADS),
               "reduce": (gnk.reduce_splits, gnk.REDUCE_ROUNDS),
               "dx": (gnk.dx_splits, gnk.DX_LOADS)}


@pytest.mark.parametrize("element_size", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", NORM_SPLIT_SHAPES, ids=[str(s) for s in NORM_SPLIT_SHAPES])
@pytest.mark.parametrize("rule", list(SPLIT_RULES))
def test_splits_cover_every_element_once(rule, shape, element_size):
    """Each rule's splits of a plane: a power of two, contiguous, in order,
    16-byte aligned, none empty, covering the plane; one split wherever the
    planes alone fill the card (the one-block-a-plane grid), never more than
    the smallest power of two reaching NORM_TARGET_BLOCKS, and each split at
    least the rule's least split where there are several. The reduce's
    never exceed the normalize's, and at (1, 512, 128, 128) in bf16, 16 KB
    a split, its plane stays one block."""
    splits_of, loads = SPLIT_RULES[rule]
    b, c, h, w = shape
    planes, hw = b * c, h * w
    splits = splits_of(planes, hw, element_size)
    assert splits >= 1 and splits & (splits - 1) == 0  # a power of two
    chunk = gnk.split_chunk(hw, splits)
    assert chunk % 8 == 0  # every split starts 16-byte aligned
    ranges = [(min(k * chunk, hw), min((k + 1) * chunk, hw)) for k in range(splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == hw
    assert all(e0 == b1 for (_b0, e0), (b1, _e1) in zip(ranges, ranges[1:]))
    assert all(e > s for s, e in ranges)
    target = gnk.NORM_TARGET_BLOCKS
    if planes >= target:
        assert splits == 1
    else:
        assert planes * splits < 2 * target
    if splits > 1:
        assert chunk >= gnk.THREADS * (16 // element_size) * loads
    if rule == "reduce":
        assert splits <= gnk.normalize_splits(planes, hw, element_size)
        if splits > 1:
            assert chunk * element_size >= gnk.THREADS * 16 * gnk.REDUCE_ROUNDS == 32768
        if element_size == 2 and shape == (1, 512, 128, 128):
            assert splits == 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("shape", [(1, 128, 56, 311), (2, 128, 8, 16)])
def test_fwd_normalize_hands_the_kernel_its_split_count(monkeypatch, shape, with_stats, dtype):
    """The wrapper's kernel branch (taken here on CPU tensors, the launch
    recorded instead of made) passes the helper's split count, and for the
    tap's partials a (planes, splits) scratch with its per-plane count; no
    scratch where there is no tap or one split."""
    b, c, h, w = shape
    x = torch.zeros(shape, dtype=dtype)
    a, off = torch.ones(b, c), torch.zeros(b, c)
    calls = []
    monkeypatch.setattr(gnk, "_on_cpu", lambda x, name: False)
    monkeypatch.setattr(gnk, "_launch", lambda name, x, *args: calls.append((name, args)))
    y, abs_sum = gnk.fwd_normalize(x, a, off, True, with_stats)
    (name, args), = calls
    assert name == "gn_fwd_normalize" and len(args) == len(gnk._SIGNATURES[name]) - 1
    part_ptr, planes, hw, dt, silu, splits, parts = args[5:]
    assert (planes, hw, dt, silu) == (b * c, h * w, gnk._DTYPE_CODES[dtype], 1)
    assert splits == gnk.normalize_splits(b * c, h * w, x.element_size())
    assert y.shape == x.shape and (abs_sum is not None) == with_stats
    if with_stats and splits > 1:
        assert part_ptr is not None and parts == splits
    else:
        assert part_ptr is None and parts == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1, 128, 1024, 1024), (1, 512, 128, 128), (16, 128, 256, 256),
                                   (1, 128, 56, 311)])
def test_bwd_reduce_hands_the_kernel_its_split_count(monkeypatch, shape, dtype):
    """``bwd_reduce``'s kernel branch (taken here on CPU tensors, the launch
    recorded instead of made) passes the helper's split count and, where it
    is above 1, a (planes, splits, 2) scratch for the per-split pairs of
    partials with its per-plane count; no scratch where a plane is one
    split (16 and 1 splits in bf16 at the 1024px step's shapes, 1 at the
    256px batch-16 one). The inputs are expanded zeros: no memory for the
    1M-element planes."""
    b, c, h, w = shape
    x = torch.zeros((), dtype=dtype).expand(shape)
    a, off = torch.ones(b, c), torch.zeros(b, c)
    calls = []
    monkeypatch.setattr(gnk, "_on_cpu", lambda x, name: False)
    monkeypatch.setattr(gnk, "_check_layout", lambda name, t, what: None)
    monkeypatch.setattr(gnk, "_launch", lambda name, x, *args: calls.append((name, args)))
    made = []
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *s, **kw: made.append(s) or empty(*s, **kw))
    gsum, gxsum = gnk.bwd_reduce(x, x, a, off, True)
    (name, args), = calls
    assert name == "gn_bwd_reduce" and len(args) == len(gnk._SIGNATURES[name]) - 1
    part_ptr, planes, hw, dt, silu, splits, parts = args[6:]
    assert (planes, hw, dt, silu) == (b * c, h * w, gnk._DTYPE_CODES[dtype], 1)
    assert splits == gnk.reduce_splits(b * c, h * w, x.element_size())
    assert gsum.shape == gxsum.shape == (b, c)
    if splits > 1:
        assert part_ptr is not None and parts == splits
        assert ((planes, splits, 2),) in made
    else:
        assert part_ptr is None and parts == 0
    if dtype == torch.bfloat16 and shape[0] == 1 and shape[2] in (1024, 128):
        assert splits == (16 if shape[2] == 1024 else 1)
    if shape[0] == 16:
        assert splits == 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(1, 128, 1024, 1024), (1, 512, 128, 128), (16, 128, 256, 256),
                                   (1, 128, 56, 311)])
def test_bwd_dx_hands_the_kernel_its_split_count(monkeypatch, shape, dtype):
    """``bwd_dx``'s kernel branch (taken here on CPU tensors, the launch
    recorded instead of made) passes the helper's split count: 16 at the
    1024px step's full-resolution norm, 1 at the 256px batch-16 one (the
    one-block-a-plane grid). dx needs no scratch: nothing but dx is made.
    The inputs are expanded zeros: no memory for the 1M-element planes."""
    b, c, h, w = shape
    x = torch.zeros((), dtype=dtype).expand(shape)
    v = torch.zeros(b, c)
    calls = []
    monkeypatch.setattr(gnk, "_on_cpu", lambda x, name: False)
    monkeypatch.setattr(gnk, "_check_layout", lambda name, t, what: None)
    monkeypatch.setattr(gnk, "_launch", lambda name, x, *args: calls.append((name, args)))
    made = []
    empty_like = torch.empty_like
    monkeypatch.setattr(torch, "empty_like", lambda t, **kw: made.append(t.shape)
                        or empty_like(t, **kw))
    dx = gnk.bwd_dx(x, x, v, v, v, v, v, True)
    (name, args), = calls
    assert name == "gn_bwd_dx" and len(args) == len(gnk._SIGNATURES[name]) - 1
    planes, hw, dt, silu, splits = args[8:]
    assert (planes, hw, dt, silu) == (b * c, h * w, gnk._DTYPE_CODES[dtype], 1)
    assert splits == gnk.dx_splits(b * c, h * w, x.element_size())
    assert dx.shape == shape and made == [shape]
    if shape[0] == 1 and shape[2] == 1024:
        assert splits == 16
    if shape[0] == 16:
        assert splits == 1


def _np_dx(x, g, a, off, ca, cb, cc):
    """The kernel's per-element dx in fp32 numpy, on (planes, n) arrays:
    z = x a + off and x cb as rounded products and sums, g_eff = g s (1 +
    z (1 - s)) with s the sigmoid, dx = g_eff ca + x cb + cc. numpy's fp32
    exp gives each element the same bits wherever it lies in the array."""
    z = x * a + off
    s = np.float32(1.0) / (np.float32(1.0) + np.exp(-z))
    ge = g * (s * (np.float32(1.0) + z * (np.float32(1.0) - s)))
    return ge * ca + x * cb + cc


def _emulate_split_dx(x, g, a, off, ca, cb, cc, splits, element_size, skip_last_split=False):
    """A numpy model of the split ``gn_bwd_dx`` on (planes, hw) fp32 arrays:
    block b is split b % S of plane b // S over [min(k chunk, hw),
    min((k + 1) chunk, hw)); its thread t takes, in rounds of DX_LOADS, the
    16-byte vectors at begin + t N + (r DX_LOADS + u) THREADS N (N elements
    a vector) up to the split's end, and computes each element alone.
    Returns dx and how many times each element was written."""
    planes, hw = x.shape
    n = 16 // element_size
    step = gnk.THREADS * n
    chunk = gnk.split_chunk(hw, splits)
    dx = np.full_like(x, np.nan)
    writes = np.zeros(x.shape, np.int64)
    for k in range(splits - 1 if skip_last_split else splits):
        begin, end = min(k * chunk, hw), min((k + 1) * chunk, hw)
        # the vector starts of every thread's every round and load
        t = np.arange(gnk.THREADS)[:, None, None] * n
        r = np.arange(-(-(end - begin) // (gnk.DX_LOADS * step)))[None, :, None]
        u = np.arange(gnk.DX_LOADS)[None, None, :]
        starts = (begin + t + (r * gnk.DX_LOADS + u) * step).ravel()
        starts = starts[starts < end]
        cols = (starts[:, None] + np.arange(n)[None, :]).ravel()
        sl = (slice(None), cols)
        dx[sl] = _np_dx(x[sl], g[sl], a, off, ca, cb, cc)
        writes[sl] += 1
    return dx, writes


@pytest.mark.parametrize("element_size", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", [(1, 128, 128, 128), (1, 128, 56, 311), (1, 128, 40, 871),
                                   (2, 128, 8, 16)])
def test_split_bwd_dx_matches_plain_and_jax(shape, element_size):
    """The split ``gn_bwd_dx`` modelled block by block over ``split_chunk``
    ranges, with its threads' rounds of DX_LOADS loads: every element is
    written once, and dx is the same per-element function over the whole
    plane bit for bit (it does not depend on S), within fp32 rounding of
    ``bwd_dx_reference`` (torch's exp against numpy's, 1e-6 of max|plain|)
    and, at (1, 128, 128, 128), of the JAX ``_bwd_dx`` in interpret mode
    (FWD_TOL). The last split left unwritten is caught wherever S > 1."""
    b, c, h, w = shape
    planes, hw = b * c, h * w
    splits = gnk.dx_splits(planes, hw, element_size)
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal((planes, hw)) * 2.0 + 0.5).astype(np.float32)
    g = rng.standard_normal((planes, hw)).astype(np.float32)
    a, off, ca, cb, cc = ((s * rng.standard_normal((planes, 1)) + m).astype(np.float32)
                          for s, m in ((0.1, 1.0), (0.1, 0.0), (1.0, 0.0), (0.01, 0.0),
                                       (0.1, 0.0)))
    dx, writes = _emulate_split_dx(x, g, a, off, ca, cb, cc, splits, element_size)
    assert (writes == 1).all()
    np.testing.assert_array_equal(dx, _np_dx(x, g, a, off, ca, cb, cc))
    vec = [torch.from_numpy(v.reshape(b, c)) for v in (a, off, ca, cb, cc)]
    ref = gnk.bwd_dx_reference(torch.from_numpy(x.reshape(shape)),
                               torch.from_numpy(g.reshape(shape)), *vec, True)
    ref = ref.numpy().reshape(planes, hw)
    assert np.abs(dx - ref).max() <= 1e-6 * np.abs(ref).max()
    if shape == (1, 128, 128, 128):
        def nhwc(arr):
            return jnp.asarray(arr.reshape(b, c, hw).transpose(0, 2, 1))

        j_dx = jgn._bwd_dx(nhwc(x), nhwc(g), *(jnp.asarray(v.reshape(b, c))
                                               for v in (a, off, ca, cb, cc)), True)
        np.testing.assert_allclose(nhwc(dx), np.asarray(j_dx), rtol=FWD_TOL, atol=FWD_TOL)
    if splits > 1:
        faulty, writes = _emulate_split_dx(x, g, a, off, ca, cb, cc, splits, element_size,
                                           skip_last_split=True)
        assert (writes == 0).any() and np.isnan(faulty).any()
    expected = {(1, 128, 128, 128): (4, 8), (1, 128, 56, 311): (4, 8),
                (1, 128, 40, 871): (8, 16), (2, 128, 8, 16): (1, 1)}[shape]
    assert splits == expected[element_size == 4]


@pytest.mark.parametrize("element_size", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", [(1, 128, 128, 256), (1, 512, 64, 64), (1, 128, 40, 871),
                                   (2, 128, 8, 16)])
def test_split_bwd_partials_added_in_order_match_plain(shape, element_size):
    """A numpy model of the split ``gn_bwd_reduce``: each of a plane's S
    splits sums g_eff and g_eff*x over its chunk in fp32, the partials land
    at [plane, split] of the (planes, S, 2) scratch, and the second pass
    adds them in split order. Every element is summed once, and the result
    is ``bwd_reduce_reference``'s within fp32 summation-order error (1e-5
    of max|plain|). S = 2, 1, 2 (the last split 8 elements short) and 1 at
    these shapes in bf16."""
    b, c, h, w = shape
    planes, hw = b * c, h * w
    splits = gnk.reduce_splits(planes, hw, element_size)
    chunk = gnk.split_chunk(hw, splits)
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * 2.0 + 0.5).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    a = (1.0 + 0.1 * rng.standard_normal((b, c))).astype(np.float32)
    off = (0.1 * rng.standard_normal((b, c))).astype(np.float32)
    ge = _nchw_grad_eff(x, g, a, off)
    xf, gef = x.reshape(planes, hw), ge.reshape(planes, hw)
    part = np.zeros((planes, splits, 2), np.float32)
    seen = np.zeros((planes, hw), np.int64)
    for blk in range(planes * splits):
        plane, k = divmod(blk, splits)
        lo, hi = min(k * chunk, hw), min((k + 1) * chunk, hw)
        seen[plane, lo:hi] += 1
        part[plane, k] = (gef[plane, lo:hi].sum(dtype=np.float32),
                          (gef[plane, lo:hi] * xf[plane, lo:hi]).sum(dtype=np.float32))
    assert (seen == 1).all()
    gsum = np.zeros(planes, np.float32)
    gxsum = np.zeros(planes, np.float32)
    for k in range(splits):  # sum_splits2_kernel: in order of the split
        gsum += part[:, k, 0]
        gxsum += part[:, k, 1]
    rg, rgx = gnk.bwd_reduce_reference(torch.from_numpy(x), torch.from_numpy(g),
                                       torch.from_numpy(a), torch.from_numpy(off), True)
    for got, ref in ((gsum, rg), (gxsum, rgx)):
        ref = ref.numpy().reshape(planes)
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    if element_size == 2:
        assert splits == {(1, 128, 128, 256): 2, (1, 512, 64, 64): 1, (1, 128, 40, 871): 2,
                          (2, 128, 8, 16): 1}[shape]


def _nchw_grad_eff(x, g, a, off):
    """g times SiLU'(z), z = x a + off, on NCHW numpy arrays in fp32."""
    z = x * a[:, :, None, None] + off[:, :, None, None]
    s = 1.0 / (1.0 + np.exp(-z))
    return (g * (s * (1.0 + z * (1.0 - s)))).astype(np.float32)


# --------------------------------------------------------------------------- #
# The port's refusals name the ROADMAP item they wait for by its title, which
# a renumbering of the queue leaves true
# --------------------------------------------------------------------------- #
def _refusals():
    from vae_channel_dynamics_tpu_torch.models.vae import remat_mode
    from vae_channel_dynamics_tpu_torch.training import loop

    return {
        "parallel slices": (lambda: loop._refuse_unported({"parallel": {"slices": 2}}),
                            "Q1", "Do not port"),
        "remat offload": (lambda: remat_mode("offload"), "Q1", "Do not port"),
        "flash past 1024 channels": (_flash_past_1024, "Q2",
                                     "#6-#8 at heads wider than 1024 channels"),
    }


def _flash_past_1024():
    """The model's explicit flash at a 1152-channel head, which the JAX
    kernels take and the CUDA kernels do not."""
    from vae_channel_dynamics_tpu_torch.models.vae import AttentionBlock

    block = AttentionBlock(1152, 32, 1e-6, attn_impl="flash", device="cpu")
    with torch.no_grad():
        block(torch.zeros(1, 1152, 16, 16))


REFUSALS = ["parallel slices", "remat offload", "flash past 1024 channels"]


@pytest.mark.parametrize("case", REFUSALS)
def test_refusal_names_its_roadmap_item_by_title(case):
    """Each refusal says "ROADMAP <queue>, <title>", and ROADMAP.md has an
    item of that title in that queue; no message names an item by number."""
    call, queue, title = _refusals()[case]
    with pytest.raises((NotImplementedError, ValueError)) as info:
        call()
    message = str(info.value)
    assert f"ROADMAP {queue}, {title}" in message, message
    assert re.search(r"item \d", message) is None, message
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "ROADMAP.md")) as f:
        roadmap = f.read()
    section = re.search(rf"^### {queue} .*?(?=^### |^## )", roadmap, re.M | re.S)
    assert section is not None and f"**{title}" in section.group(0), (queue, title)
