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
"""

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


@pytest.mark.parametrize("element_size", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", NORM_SPLIT_SHAPES, ids=[str(s) for s in NORM_SPLIT_SHAPES])
def test_normalize_splits_cover_every_element_once(shape, element_size):
    b, c, h, w = shape
    planes, hw = b * c, h * w
    splits = gnk.normalize_splits(planes, hw, element_size)
    assert splits >= 1 and splits & (splits - 1) == 0  # a power of two
    chunk = gnk.split_chunk(hw, splits)
    assert chunk % 8 == 0  # every split starts 16-byte aligned
    ranges = [(min(k * chunk, hw), min((k + 1) * chunk, hw)) for k in range(splits)]
    # contiguous, in order, from the first element to the last, none empty
    assert ranges[0][0] == 0 and ranges[-1][1] == hw
    assert all(e0 == b1 for (_b0, e0), (b1, _e1) in zip(ranges, ranges[1:]))
    assert all(e > s for s, e in ranges)
    target = gnk.NORM_TARGET_BLOCKS
    if planes >= target:
        assert splits == 1  # the one-block-a-plane grid
    else:
        assert planes * splits < 2 * target  # never more than the smallest power reaching it
    if splits > 1:
        # each split keeps at least one round of loads by every thread
        assert chunk >= gnk.THREADS * (16 // element_size) * gnk.NORM_LOADS


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
