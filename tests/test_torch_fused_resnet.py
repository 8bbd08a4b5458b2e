"""The port's fused GroupNorm+SiLU+conv3x3 op (``ops/fused_resnet.py``)
against the JAX package's ``ops/pallas_resnet.py``, on the CPU.

The same inputs, made with numpy from a seed, go through the JAX functions
(their Pallas kernels in interpret mode, jitted, as tests/test_pallas_resnet.py
runs them) and through the port's wrappers, which on a CPU tensor run their
plain versions: at (N, H, W, C) = (2, 8, 16, 128), fp32 and bf16, NHWC and
the (3, 3Cin, Cout) weight on the JAX side, NCHW and OIHW on the port's.

- kernel #9: ``fused_fwd`` against ``_fused_conv_fwd``, with and without the
  residual, the |z| tap and the moments, and 128 -> 256 channels;
- kernel #10: ``conv3x3`` against ``_plain_conv``, and with the flipped,
  channel-swapped weight against ``_conv_bwd_input``;
- kernel #11: ``conv_dw`` against ``_conv_bwd_weights``;
- the autograd op's y and its x, gamma, beta, w, b and residual gradients
  against ``jax.grad`` of ``gn_silu_conv3x3``;
- ``eligible`` and the row-tile rule against JAX's on a grid of shapes.

Tolerances. fp32: both sides compute the same function in fp32 and differ by
the order of additions: rtol 1e-4, atol 1e-5 for outputs and sums, and the
JAX tests' own 5e-4 of the largest entry for gradients (a gradient passes
through the GroupNorm backward's cancellations). bf16: both round s, w and y
to bf16 at the same points, so the outputs differ where an fp32 sum taken in
another order rounds to the neighbouring bf16 value: at most 2 bf16 ulps of
the largest output; the fp32 sums (tap, moments, dW) 1e-4 of their largest
entry.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_channel_dynamics_tpu.ops import pallas_resnet as jpr
from vae_channel_dynamics_tpu_torch.ops import fused_resnet as fr

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

N, H, W, CIN, GROUPS, EPS = 2, 8, 16, 128, 8, 1e-6
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}

_jit_fwd = jax.jit(jpr._fused_conv_fwd, static_argnums=(6, 7))
_jit_plain = jax.jit(jpr._plain_conv)
_jit_bwd_input = jax.jit(jpr._conv_bwd_input, static_argnums=(2,))
_jit_dw = jax.jit(jpr._conv_bwd_weights)


def _inputs(cout=128, dtype="fp32", seed=0):
    """numpy arrays, NHWC and HWIO: x, a, o, w, bias, residual, dy; x, w,
    residual and dy already rounded to the dtype."""
    rng = np.random.default_rng(seed)
    jdt = DTYPES[dtype][0]

    def rounded(arr):
        return np.asarray(jnp.asarray(arr, jdt).astype(jnp.float32))

    x = rounded(rng.standard_normal((N, H, W, CIN)) * 2.0 + 0.5)
    a = rng.uniform(0.3, 0.8, (N, CIN)).astype(np.float32)
    o = rng.uniform(-0.5, 0.3, (N, CIN)).astype(np.float32)
    w = rounded(rng.standard_normal((3, 3, CIN, cout)) / np.sqrt(9 * CIN))
    bias = rng.uniform(-0.1, 0.1, cout).astype(np.float32)
    res = rounded(rng.standard_normal((N, H, W, cout)))
    dy = rounded(rng.standard_normal((N, H, W, cout)))
    return x, a, o, w, bias, res, dy


def _jx(arr, dtype):
    return jnp.asarray(arr, DTYPES[dtype][0])


def _tx(arr, dtype):
    """NHWC numpy -> NCHW torch in the dtype."""
    return torch.from_numpy(np.ascontiguousarray(arr.transpose(0, 3, 1, 2))).to(
        DTYPES[dtype][1])


def _oihw(w, dtype):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))).to(DTYPES[dtype][1])


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


def _assert_out(got, want, dtype):
    """An activation output: fp32 to rtol/atol, bf16 to 2 ulps of max|want|."""
    want = np.asarray(want, np.float32)
    if dtype == "fp32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        return
    top = np.abs(want).max()
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
    assert np.abs(got - want).max() <= 2 * ulp, (np.abs(got - want).max(), ulp)


def _assert_sums(got, want):
    want = np.asarray(want, np.float32)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("cout,with_residual,side_outputs", [
    (128, False, False),
    (128, True, True),
    (256, True, True),   # 128 -> 256 channels
])
def test_fused_forward_matches_jax(dtype, cout, with_residual, side_outputs):
    x, a, o, w, bias, res, _dy = _inputs(cout, dtype)
    residual = res if with_residual else None
    jy, jtap, jmom = _jit_fwd(
        _jx(x, dtype), jnp.asarray(a), jnp.asarray(o),
        _jx(w, dtype).reshape(3, 3 * CIN, cout), jnp.asarray(bias),
        None if residual is None else _jx(residual, dtype), side_outputs, side_outputs)
    before = dict(fr.launches)
    y, tap, mom = fr.fused_fwd(
        _tx(x, dtype), torch.from_numpy(a), torch.from_numpy(o), _oihw(w, dtype),
        torch.from_numpy(bias), None if residual is None else _tx(residual, dtype),
        side_outputs, side_outputs)
    assert fr.launches == before  # a CPU tensor runs the plain version
    assert y.dtype == DTYPES[dtype][1] and y.shape == (N, cout, H, W)
    _assert_out(_nhwc(y), jy, dtype)
    if not side_outputs:
        assert tap is None and mom is None and jtap is None and jmom is None
        return
    _assert_sums(tap.numpy(), jtap)
    _assert_sums(mom[0].numpy(), jmom[0])
    _assert_sums(mom[1].numpy(), jmom[1])


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_conv3x3_matches_jax(dtype):
    x, _a, _o, w, bias, _res, dy = _inputs(256, dtype, seed=1)
    # the forward direction with a bias: _plain_conv
    jy = _jit_plain(_jx(x, dtype), _jx(w, dtype).reshape(3, 3 * CIN, 256), jnp.asarray(bias))
    y = fr.conv3x3(_tx(x, dtype), _oihw(w, dtype), torch.from_numpy(bias))
    _assert_out(_nhwc(y), jy, dtype)
    # the backward's use: dy (256 channels) back to 128 through the flipped,
    # channel-swapped weight
    jds = _jit_bwd_input(_jx(dy, dtype), _jx(w, dtype).reshape(3, 3 * CIN, 256), CIN)
    ds = fr.conv3x3(_tx(dy, dtype), fr.flipped_weight(_oihw(w, dtype)))
    assert ds.shape == (N, CIN, H, W)
    _assert_out(_nhwc(ds), jds, dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_conv_dw_matches_jax(dtype):
    x, a, o, _w, _bias, _res, dy = _inputs(256, dtype, seed=2)
    jdw = _jit_dw(_jx(x, dtype), jnp.asarray(a), jnp.asarray(o), _jx(dy, dtype))
    dw = fr.conv_dw(_tx(x, dtype), torch.from_numpy(a), torch.from_numpy(o), _tx(dy, dtype))
    assert dw.dtype == torch.float32 and dw.shape == (256, CIN, 3, 3)
    # JAX's (3, 3Cin, Cout) is HWIO flattened
    want = np.asarray(jdw).reshape(3, 3, CIN, 256).transpose(3, 2, 0, 1)
    _assert_sums(dw.numpy(), want)


@pytest.mark.parametrize("with_residual", [False, True])
def test_autograd_op_matches_jax_grad(with_residual):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((N, H, W, CIN)) * 2.0 + 0.5).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, CIN).astype(np.float32)
    beta = rng.uniform(-0.2, 0.2, CIN).astype(np.float32)
    w = (rng.standard_normal((3, 3, CIN, 128)) / np.sqrt(9 * CIN)).astype(np.float32)
    bias = rng.uniform(-0.1, 0.1, 128).astype(np.float32)
    res = rng.standard_normal((N, H, W, 128)).astype(np.float32) if with_residual else None

    def jloss(x_, g_, b_, w_, bi_, r_):
        y, _, _ = jpr.gn_silu_conv3x3(x_, g_, b_, w_, bi_, num_groups=GROUPS, eps=EPS,
                                      residual=r_, emit_tap=True, emit_moments=True)
        return jnp.sum(jnp.sin(y)), y

    argnums = (0, 1, 2, 3, 4) + ((5,) if with_residual else ())
    jgrads, jy = jax.jit(jax.grad(jloss, argnums=argnums, has_aux=True))(
        x, gamma, beta, w, bias, res)

    leaves = [torch.from_numpy(_a.copy()).requires_grad_(True)
              for _a in (x.transpose(0, 3, 1, 2), gamma, beta, w.transpose(3, 2, 0, 1), bias)]
    tres = (torch.from_numpy(res.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
            if with_residual else None)
    y, tap, mom = fr.gn_silu_conv3x3(*leaves, num_groups=GROUPS, eps=EPS, residual=tres,
                                     emit_tap=True, emit_moments=True)
    assert not tap.requires_grad and not mom[0].requires_grad and not mom[1].requires_grad
    np.testing.assert_allclose(_nhwc(y.detach()), np.asarray(jy), rtol=2e-4, atol=2e-4)
    grads = torch.autograd.grad(torch.sin(y).sum(), leaves + ([tres] if with_residual else []))
    layouts = [lambda g: g.permute(0, 2, 3, 1), None, None, lambda g: g.permute(2, 3, 1, 0),
               None, lambda g: g.permute(0, 2, 3, 1)]
    for name, got, want, to_jax in zip(("x", "gamma", "beta", "w", "bias", "residual"),
                                       grads, jgrads, layouts):
        got = (to_jax(got) if to_jax else got).numpy()
        want = np.asarray(want)
        scale = max(np.abs(want).max(), 1e-6)
        np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=5e-4, err_msg=name)


def _grid():
    for h in (2, 7, 8, 12, 16, 32, 64, 128):
        for w in (16, 24, 32, 64, 256):
            for cin, cout in ((96, 128), (128, 128), (128, 256), (256, 512), (512, 512),
                              (128, 768), (256, 640)):
                yield h, w, cin, cout


def test_eligible_matches_jax_on_a_grid():
    seen = set()
    for h, w, cin, cout in _grid():
        assert fr._pick_tile_h(h, w, cin, cout) == jpr._pick_tile_h(h, w, cin, cout)
        for groups in (32, 48):
            want = jpr.eligible(jax.ShapeDtypeStruct((2, h, w, cin), jnp.bfloat16), cout, groups)
            assert fr.eligible((2, cin, h, w), cout, groups) == want, (h, w, cin, cout, groups)
            assert fr.eligible(torch.empty(2, cin, h, w, device="meta"), cout, groups) == want
            seen.add(want)
    assert seen == {True, False}
    assert not fr.eligible((2, 128, 16), 128, 32)


def test_eligible_checks_backward_direction():
    """A shape whose forward tiles but whose backward input-gradient conv
    (channels swapped) does not is refused, in both packages alike."""
    found = False
    for cin, cout in ((128, 768), (128, 1024), (256, 640), (256, 768)):
        h, w = 2, 256
        fwd, bwd = fr._pick_tile_h(h, w, cin, cout), fr._pick_tile_h(h, w, cout, cin)
        if fwd is not None and bwd is None:
            found = True
            assert not fr.eligible((1, cin, h, w), cout, 8)
            assert not jpr.eligible(jnp.zeros((1, h, w, cin), jnp.bfloat16), cout, 8)
    assert found


def test_dw_splits_cover_every_tile_once():
    for n, cin, cout, h, w in ((16, 512, 512, 32, 32), (1, 128, 256, 12, 32),
                               (16, 256, 512, 64, 64), (2, 128, 128, 8, 16)):
        tiles = fr.dw_units(n, h, w)
        splits = fr.dw_splits(n, cin, cout, h, w)
        assert 1 <= splits <= tiles
        bounds = [k * tiles // splits for k in range(splits + 1)]
        assert bounds[0] == 0 and bounds[-1] == tiles
        assert all(b1 > b0 for b0, b1 in zip(bounds, bounds[1:]))


@pytest.mark.parametrize("w", [16, 32, 48, 64, 96, 128, 256])
def test_dw_unit_is_the_widest_dividing_column_count(w):
    rows, cols = fr.dw_unit(w)
    assert rows * cols == fr.DW_UNIT_PIXELS and w % cols == 0
    assert all(w % wider for wider in (16, 32, 64) if wider > cols)


@pytest.mark.parametrize("n,h,w", [(2, 12, 32), (1, 6, 48), (3, 32, 32), (1, 9, 128)])
def test_dw_units_cover_every_pixel_once(n, h, w):
    rows, cols = fr.dw_unit(w)
    units = fr.dw_units(n, h, w)
    per_image = units // n
    seen = torch.zeros(n, h, w, dtype=torch.int32)
    for g in range(units):
        nn, u = divmod(g, per_image)
        r0, c0 = (u // (w // cols)) * rows, (u % (w // cols)) * cols
        seen[nn, r0:r0 + rows, c0:c0 + cols] += 1
    assert torch.equal(seen, torch.ones_like(seen))


def test_weight_hwio_is_the_permuted_weight():
    """#9's weight: OIHW (Cout, Cin, 3, 3) as the contiguous HWIO (3, 3, Cin,
    Cout) that kernel #12's loop reads."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((256, 128, 3, 3)).astype(np.float32))
    w = w.to(torch.bfloat16)
    hwio = fr.weight_hwio(w)
    assert hwio.shape == (3, 3, 128, 256) and hwio.is_contiguous()
    assert hwio.dtype == w.dtype
    assert torch.equal(hwio, w.permute(2, 3, 1, 0))
    assert torch.equal(hwio[1, 2, 5, 7], w[7, 5, 1, 2])  # tap (dy, dx), in, out


@pytest.mark.parametrize("shape,cout", [((2, 256, 8, 16), 128), ((1, 128, 12, 48), 256)])
def test_conv3x3_hands_the_kernel_the_flipped_hwio_weight(monkeypatch, shape, cout):
    """The backward's ds = conv3x3(dy, flipped_weight(w)): the wrapper's
    kernel branch (taken here on CPU tensors, the launch recorded instead of
    made) hands #10 the flipped, channel-swapped weight as the contiguous
    HWIO (3, 3, C_dy, C_ds), element [kh, kw, c_dy, c_ds] = w[c_dy, c_ds, 2 -
    kh, 2 - kw], beside dy's NHWC scratch and #9's pixel-rectangle width."""
    n, c_dy, h, wd = shape
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.standard_normal((c_dy, cout, 3, 3)).astype(np.float32))
    w = w.to(torch.bfloat16)  # the forward's OIHW weight, cout -> c_dy channels
    dy = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)
    handed, calls = [], []
    hwio = fr.weight_hwio
    monkeypatch.setattr(fr, "weight_hwio", lambda t: handed.append(hwio(t)) or handed[-1])
    monkeypatch.setattr(fr, "_on_cpu", lambda x, name: False)
    monkeypatch.setattr(fr, "_launch", lambda name, x, *args: calls.append((name, args)))
    fr.conv3x3(dy, fr.flipped_weight(w))
    (name, args), = calls
    assert name == "conv3x3" and len(args) == len(fr._SIGNATURES["conv3x3"]) - 1
    w_ptr, n_, cin, co, h_, wd_, cols = args[1], *args[5:]
    assert (n_, cin, co, h_, wd_) == (n, c_dy, cout, h, wd)
    assert cols == fr.pixel_tile(h, wd)[1]
    (got,) = handed
    assert w_ptr == got.data_ptr() and got.is_contiguous()
    assert got.shape == (3, 3, c_dy, cout)
    assert torch.equal(got, fr.weight_hwio(fr.flipped_weight(w)))
    assert torch.equal(got, w.flip(2, 3).permute(2, 3, 0, 1))
    assert torch.equal(got[0, 2, 5, 7], w[5, 7, 2, 0])


@pytest.mark.parametrize("h,w", [(32, 32), (64, 64), (20, 16), (6, 48), (9, 128)])
def test_tap_chunks_cover_every_pixel_once(h, w):
    """#9's pre-pass writes its |z| partials over chunks of 64 flattened
    pixels of each image: together they hold every pixel once."""
    chunks = fr.tap_chunks(h, w)
    seen = torch.zeros(h * w, dtype=torch.int32)
    for k in range(chunks):
        seen[k * fr.SILU_PIXELS:min((k + 1) * fr.SILU_PIXELS, h * w)] += 1
    assert torch.equal(seen, torch.ones_like(seen))
    assert (chunks - 1) * fr.SILU_PIXELS < h * w  # no chunk wholly outside the image


@pytest.mark.parametrize("h,w", [(32, 32), (64, 64), (20, 16), (6, 48), (9, 128)])
def test_fused_tiles_cover_every_pixel_once(h, w):
    """#9's moment partials: one a pixel rectangle of conv_nhwc.pixel_tile,
    in the kernel's grid order; the rectangles cover the image once (their
    parts outside it are masked)."""
    rows, cols = fr.pixel_tile(h, w)
    tiles_w = -(-w // cols)
    seen = torch.zeros(-(-h // rows) * rows, tiles_w * cols, dtype=torch.int32)
    for t in range(fr.fused_tiles(h, w)):
        r0, c0 = (t // tiles_w) * rows, (t % tiles_w) * cols
        seen[r0:r0 + rows, c0:c0 + cols] += 1
    assert torch.equal(seen, torch.ones_like(seen))
    assert rows * cols == 128 and cols >= fr.W_MULTIPLE


@pytest.mark.parametrize("n,cin,cout,h,w,splits", [
    (16, 512, 512, 32, 32, 2),   # the 256px step's fused shape: 128 blocks
    (16, 256, 512, 64, 64, 4),   # 128 blocks
    (1, 128, 256, 16, 16, 2),    # capped by its two units
    (4, 128, 128, 64, 64, 8),    # capped by one cluster's 8 blocks
])
def test_dw_splits_fill_the_card(n, cin, cout, h, w, splits):
    assert fr.dw_splits(n, cin, cout, h, w) == splits


def test_dw_splits_follow_the_clusters_a_card_holds():
    # a card whose GPCs hold only 30 clusters of 4 (not 33): 4 splits would
    # run the 32 channel blocks of 256 -> 512 in two waves, 8 splits in two
    # waves of half the units each
    held = {1: 132, 2: 66, 3: 44, 4: 30, 5: 24, 6: 22, 7: 18, 8: 16}
    assert fr.dw_splits(16, 256, 512, 64, 64) == 4
    assert fr.dw_splits(16, 256, 512, 64, 64, held.__getitem__) == 8
    # a card that holds no cluster of more than 2 blocks
    assert fr.dw_splits(16, 256, 512, 64, 64, lambda s: 66 if s <= 2 else 0) == 2


def test_wrappers_refuse_other_devices():
    x = torch.empty(1, 128, 8, 16, device="meta")
    w = torch.empty(128, 128, 3, 3, device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        fr.conv3x3(x, w)
