"""The arithmetic of the fp32 fused resnet kernels (3xTF32), emulated on the
CPU and held to the JAX Pallas kernels at fp32.

At fp32 the three kernels of ``csrc/fused_resnet.cu`` take every product
x*w as three TF32 products on ``wgmma``: hi = tf32(v) and lo = tf32(v - hi),
rounded to nearest with ties away from zero, and x*w as lo_x hi_w + hi_x lo_w
+ hi_x hi_w, each k-step of 8 products added to the fp32 accumulator and
truncated (the model of ``tests/test_torch_flash_tf32x3.py``, whose
``wgmma_tf32`` is used here). The order of the sums is the kernels':

- #9 and #10 (``conv3x3_tf32x3``, ``csrc/sm90_conv3x3.cuh``): K = 9 taps x
  Cin, in chunks of 32 channels; each group of two chunks (one tap's 64
  channels, 8 k-steps) goes into a fresh accumulator that is added to the
  running sum in fp32, tap by tap, 64 channels by 64; then + bias, then +
  residual, in fp32;
- #11 (``conv3x3_dw_f32_kernel``, ``csrc/fused_resnet.cu``): K = pixels, in
  units of 64 (``fused_resnet.dw_unit(w, f32=True)``: 2 rows of 32 columns
  or 4 of 16) taken in order of (sample, unit row, unit column); a
  warpgroup runs its kernel row's three taps one after the other through
  one fresh accumulator, so each tap's 8 k-steps of a unit go into a fresh
  accumulator added to that tap's sum of the split in fp32, and the splits'
  partials (``dw_splits(..., f32=True)``) are added in order of the split.
  Its hi and lo come from integer rounding, which is ``rna_tf32``.

The JAX side runs its Pallas kernels in interpret mode at fp32, as
``tests/test_pallas_resnet.py`` does. The bound is the kernels' own on the
card (``tests/test_torch_fused_resnet_cuda.py``, ``chip_smoke.py``):
relative L2 1e-5. It rejects hi alone (1xTF32: about 3e-4 here) and one
accumulator over the whole K: the truncations cost about 1e-5 at K = 9 x 128
(just inside the bound), 2e-5 at 9 x 256 and more at the model's 9 x 512, so
the conv fault runs at 256 channels of K; #11's at 2048 pixels in one split.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_flash_tf32x3 import rna_tf32, wgmma_tf32

from vae_channel_dynamics_tpu.ops import pallas_resnet as jpr
from vae_channel_dynamics_tpu_torch.ops import fused_resnet as fr

REL_L2 = 1e-5
GROUP = 64  # the channels of one fresh accumulation of #9 and #10
SHAPE = (2, 128, 8, 16)  # (N, Cin, H, W)

_jit_fwd = jax.jit(jpr._fused_conv_fwd, static_argnums=(6, 7))
_jit_bwd_input = jax.jit(jpr._conv_bwd_input, static_argnums=(2,))
_jit_dw = jax.jit(jpr._conv_bwd_weights)


@pytest.fixture(autouse=True)
def one_thread():
    """The emulation runs thousands of small ops: on one intra-op thread
    they do not contend with the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def emulated_conv(s: torch.Tensor, w: torch.Tensor, terms: int = 3,
                  fresh: bool = True) -> torch.Tensor:
    """conv3x3(s, w) (NCHW fp32, OIHW fp32) as ``conv3x3_tf32x3`` sums it:
    per tap, per 64 input channels, a fresh accumulator (``fresh``) added to
    the sum in fp32, or (``fresh=False``) one accumulator over all of K."""
    n, cin, h, wd = s.shape
    sp = F.pad(s, (1, 1, 1, 1))
    total = torch.zeros(n * h * wd, w.shape[0])
    for tap in range(9):
        ky, kx = divmod(tap, 3)
        a = sp[:, :, ky:ky + h, kx:kx + wd].permute(0, 2, 3, 1).reshape(-1, cin)
        b = w[:, :, ky, kx].t()
        for c0 in range(0, cin, GROUP):
            part = (a[:, c0:c0 + GROUP], b[c0:c0 + GROUP])
            if fresh:
                total = total + wgmma_tf32(torch.zeros_like(total), *part, terms)
            else:
                total = wgmma_tf32(total, *part, terms)
    return total.reshape(n, h, wd, -1).permute(0, 3, 1, 2)


def emulated_dw(s: torch.Tensor, dy: torch.Tensor, terms: int = 3, fresh: bool = True,
                splits: int = 0) -> torch.Tensor:
    """dW (Cout, Cin, 3, 3) of conv3x3 at input s and output gradient dy
    (NCHW fp32) as ``conv3x3_dw_f32_kernel`` sums it: per tap, per split (its
    own count, or ``splits``), per 64-pixel unit a fresh accumulator added to
    the tap's sum of the split in fp32 (``fresh``; else one accumulator over
    the split's units), then the splits added in order. The kernel takes a
    unit's taps one after the other through one fresh accumulator; each
    tap's sums stay apart, so the order of the taps does not enter. Unit
    rows below H add exact zeros, which leave a truncating accumulator as it
    is: they are cut."""
    n, cin, h, w = s.shape
    cout = dy.shape[1]
    rows, cols = fr.dw_unit(w, f32=True)
    units = fr.dw_units(n, h, w, f32=True)
    splits = splits or fr.dw_splits(n, cin, cout, h, w, f32=True)
    per_image, units_w = units // n, w // cols
    sp = F.pad(s, (1, 1, 1, 1))
    out = torch.zeros(cout, cin, 3, 3)
    for tap in range(9):
        ky, kx = divmod(tap, 3)
        total = None
        for k in range(splits):
            acc = torch.zeros(cin, cout)
            for g in range(k * units // splits, (k + 1) * units // splits):
                nn, u = divmod(g, per_image)
                r0, c0 = (u // units_w) * rows, (u % units_w) * cols
                r1 = min(r0 + rows, h)
                a = sp[nn, :, r0 + ky:r1 + ky, c0 + kx:c0 + kx + cols].reshape(cin, -1)
                b = dy[nn, :, r0:r1, c0:c0 + cols].reshape(cout, -1).t()
                if fresh:
                    acc = acc + wgmma_tf32(torch.zeros(cin, cout), a, b, terms)
                else:
                    acc = wgmma_tf32(acc, a, b, terms)
            total = acc if total is None else total + acc
        out[:, :, ky, kx] = total.t()
    return out


def _inputs(shape, cout, seed=0):
    """numpy NCHW x, the affine a, o, OIHW w, bias, residual and dy, fp32."""
    rng = np.random.default_rng(seed)
    n, cin, h, w = shape
    x = (rng.standard_normal(shape) * 2.0 + 0.5).astype(np.float32)
    a = rng.uniform(0.3, 0.8, (n, cin)).astype(np.float32)
    o = rng.uniform(-0.5, 0.3, (n, cin)).astype(np.float32)
    wt = (rng.standard_normal((cout, cin, 3, 3)) / np.sqrt(9 * cin)).astype(np.float32)
    bias = rng.uniform(-0.1, 0.1, cout).astype(np.float32)
    res = rng.standard_normal((n, cout, h, w)).astype(np.float32)
    dy = rng.standard_normal((n, cout, h, w)).astype(np.float32)
    return x, a, o, wt, bias, res, dy


def _silu(x, a, o):
    """s = silu(a*x + o) in fp32, unrounded: the pre-passes' s at fp32."""
    z = torch.from_numpy(x) * torch.from_numpy(a)[:, :, None, None] + torch.from_numpy(o)[
        :, :, None, None]
    return z * torch.sigmoid(z)


def _nhwc(arr):
    return np.ascontiguousarray(np.asarray(arr).transpose(0, 2, 3, 1))


def _rel(out, ref) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(out - ref) / np.linalg.norm(ref))


@functools.lru_cache(maxsize=None)
def _case(kernel: str, cout: int, terms: int = 3):
    """(emulated, JAX) of one kernel at SHAPE -> cout, both NCHW (dW OIHW)
    numpy; cached, as the fault tests reuse the emulation and JAX's."""
    x, a, o, wt, bias, res, dy = _inputs(SHAPE, cout, seed=cout)
    w3 = jnp.asarray(wt.transpose(2, 3, 1, 0).reshape(3, 3 * SHAPE[1], cout))
    if kernel == "fused":
        out = emulated_conv(_silu(x, a, o), torch.from_numpy(wt), terms)
        out = (out + torch.from_numpy(bias)[None, :, None, None]) + torch.from_numpy(res)
        ref = _jit_fwd(jnp.asarray(_nhwc(x)), jnp.asarray(a), jnp.asarray(o), w3,
                       jnp.asarray(bias), jnp.asarray(_nhwc(res)), False, False)[0]
        return out.numpy(), np.asarray(ref).transpose(0, 3, 1, 2)
    if kernel == "conv":
        # the backward's ds = conv3x3(dy, w flipped and channel-swapped)
        out = emulated_conv(torch.from_numpy(dy), fr.flipped_weight(torch.from_numpy(wt)), terms)
        ref = _jit_bwd_input(jnp.asarray(_nhwc(dy)), w3, SHAPE[1])
        return out.numpy(), np.asarray(ref).transpose(0, 3, 1, 2)
    out = emulated_dw(_silu(x, a, o), torch.from_numpy(dy), terms)
    ref = _jit_dw(jnp.asarray(_nhwc(x)), jnp.asarray(a), jnp.asarray(o), jnp.asarray(_nhwc(dy)))
    ref = np.asarray(ref).reshape(3, 3, SHAPE[1], cout).transpose(3, 2, 0, 1)
    return out.numpy(), ref


# #10 runs the backward's way, from dy's Cout channels back to 128: at 256
# its K is 9 x 256
CASES = [("fused", 128), ("fused", 256), ("conv", 256), ("dw", 128)]


@pytest.mark.parametrize("kernel,cout", CASES)
def test_emulated_kernel_matches_jax(kernel, cout):
    out, ref = _case(kernel, cout)
    assert out.shape == ref.shape and np.isfinite(out).all()
    assert _rel(out, ref) <= REL_L2


@pytest.mark.parametrize("kernel,cout", CASES[1:])
def test_one_tf32_product_is_rejected(kernel, cout):
    """hi alone (1xTF32): the bound the kernels are held to rejects it."""
    three, ref = _case(kernel, cout)
    one, _ = _case(kernel, cout, terms=1)
    assert _rel(three, ref) <= REL_L2 < _rel(one, ref)


@pytest.mark.parametrize("kernel,shape,cout", [
    ("fused", (2, 256, 8, 16), 128),  # K = 9 x 256
    ("conv", (2, 128, 8, 16), 256),   # ds from dy's 256 channels: K = 9 x 256
    ("dw", (2, 64, 32, 32), 32),      # K = 2048 pixels in one split
])
def test_long_accumulation_is_rejected(kernel, shape, cout):
    """One truncating accumulator over the whole K exceeds the bound; the
    kernels' fresh accumulators do not."""
    x, a, o, wt, _bias, _res, dy = _inputs(shape, cout, seed=7)
    s, w = _silu(x, a, o), torch.from_numpy(wt)
    dy = torch.from_numpy(dy)
    if kernel == "dw":
        ref = torch.nn.grad.conv2d_weight(s, tuple(w.shape), dy, padding=1)
        fresh, long = (emulated_dw(s, dy, splits=1, fresh=f) for f in (True, False))
    else:
        s, w = (s, w) if kernel == "fused" else (dy, fr.flipped_weight(w))
        ref = F.conv2d(s, w, padding=1)
        fresh, long = (emulated_conv(s, w, fresh=f) for f in (True, False))
    assert _rel(fresh, ref) <= REL_L2 < _rel(long, ref)


def test_wrapper_split_is_the_kernels_rounding():
    """``fused_resnet.tf32_split``, which splits the fp32 weight for #9 and
    #10, rounds as ``cvt.rna.tf32.f32`` (the emulation's ``rna_tf32``), and
    hi + lo keeps fp32's value to 2^-21."""
    v = torch.from_numpy(np.random.default_rng(3).standard_normal(4096).astype(np.float32))
    hi, lo = fr.tf32_split(v)
    assert torch.equal(hi, rna_tf32(v)) and torch.equal(lo, rna_tf32(v - hi))
    assert ((v.double() - hi.double() - lo.double()).abs()
            <= v.double().abs() * 2.0 ** -21).all()
