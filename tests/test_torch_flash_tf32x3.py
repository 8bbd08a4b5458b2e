"""The arithmetic of the fp32 flash forward kernel (3xTF32), emulated on the
CPU and held to the JAX Pallas kernel.

``flash_fwd_f32_kernel`` (``csrc/flash_attention_fwd.cu``) takes every fp32
product x*y as three TF32 products: hi = tf32(x) and lo = tf32(x - hi), both
rounded to nearest with ties away from zero (``cvt.rna.tf32.f32``), and x*y
as hi_x hi_y + hi_x lo_y + lo_x hi_y on ``wgmma``. A product of two TF32
values has at most 22 significant bits, so it is exact in fp32; the tensor
cores add each k-step of 8 such products to their fp32 accumulator and
truncate the sum (round toward zero), so a long accumulation drifts low.
The helpers below round by bit operations on fp32 and model each k-step as
the exact sum of its products added to the accumulator and truncated to
fp32. The kernel keeps every accumulation short: each warpgroup's partial S
is two sums of a quarter of the channels, and each key tile's P V goes into
fresh accumulators that are added to O in fp32 (rounded to nearest).

The bounds are those of the kernel on the card (``tests/test_torch_flash_
kernel_cuda.py``, ``chip_smoke.py``): relative L2 1e-5 against the fp32
reference, 1e-4 on large logits. With hi alone (1xTF32, what the kernel
would give without its lo products) the error is about 2^-11 of each
product, which the 1e-5 bound rejects: the CPU twin of ``chip_smoke.py``'s
planted fault. So is O held in one accumulator over all key tiles: at 32
tiles its truncations cost about 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_channel_dynamics_tpu.ops.pallas_attention import flash_attention as jax_flash
from vae_channel_dynamics_tpu_torch.ops import flash_attention as fa

HIGHEST = jax.lax.Precision.HIGHEST
REL_L2 = 1e-5
LARGE_LOGIT_REL_L2 = 1e-4
KEY_TILE = 64  # the kernel's keys per tile
K_STEP = 8     # tf32 products a wgmma k-step adds to its accumulator


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 (10 mantissa bits), to nearest, ties away
    from zero: add half of TF32's last place to the magnitude's bits, then
    clear the 13 bits TF32 drops."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    """(hi, lo) of fp32 ``x``: the kernel's ``tf32_hi`` and ``tf32_lo``
    (``flash_attention_fwd.cu:350-356``, on ``to_tf32``, ``sm90_wgmma.cuh:230``)."""
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def to_fp32_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """fp64 ``x`` to fp32, rounded toward zero."""
    f = x.to(torch.float32)
    away = f.double().abs() > x.abs()
    return torch.where(away, torch.nextafter(f, torch.zeros_like(f)), f)


def wgmma_tf32(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               terms: int = 3) -> torch.Tensor:
    """acc + a @ b as the kernel's wgmma takes it: per k-step of 8, the
    products lo hi, hi lo, hi hi (``terms`` 3) or hi hi alone (1), each
    k-step's exact sum added to the fp32 accumulator and truncated. The
    order is that of the ``wgmma_tf32`` calls of an S unit
    (``flash_attention_fwd.cu:461-463``) and of a P V unit (``:573-575``)."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    pairs = ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)) if terms == 3 else ((a_hi, b_hi),)
    steps = a.shape[-1] // K_STEP
    # every k-step's sum of each product term at once: (terms, steps, ..., M, N)
    sums = torch.stack([
        torch.einsum("...msk,...skn->s...mn",
                     x.double().unflatten(-1, (steps, K_STEP)),
                     y.double().unflatten(-2, (steps, K_STEP)))
        for x, y in pairs])
    for step in range(steps):
        for term in range(len(pairs)):
            acc = to_fp32_toward_zero(acc.double() + sums[term, step])
    return acc


def emulated_flash_f32(q, k, v, scale: float, terms: int = 3,
                       fresh: bool = True) -> torch.Tensor:
    """The kernel's forward on fp32 (B, N, C), step by step as
    ``flash_fwd_f32_kernel`` (``csrc/flash_attention_fwd.cu``) takes it.
    Per 64-key tile (the loop at ``:471``):

    - S = Q K^T in four sums of C/4 channels, each in an accumulator of its
      own (``sacc`` and ``sacc2`` of each warpgroup, ``:474-476``), added in
      fp32 as (q0 + q1) + (q2 + q3): a warpgroup's two parts at ``:482``,
      then the two warpgroups' through shared memory at ``:484-492``, where
      the sum is scaled; fp32 addition commutes, so both hold the same S;
    - the online softmax with fp32 m and l (``:494-517``);
    - P split into hi and lo as any operand (``:518-536``);
    - O = O * corr + P V, P V taken in fresh accumulators (``fresh``,
      ``tacc`` zeroed at ``:544``, added to O at ``:584``) or, as a long
      accumulation, in O's own;

    and O / l at the end."""
    b, n, c = q.shape
    m = torch.full((b, n, 1), -1e30)
    l = torch.zeros((b, n, 1))
    o = torch.zeros((b, n, c))
    quarter = c // 4
    for t in range(0, n, KEY_TILE):
        kt, vt = k[:, t:t + KEY_TILE].transpose(1, 2), v[:, t:t + KEY_TILE]
        parts = [wgmma_tf32(torch.zeros((b, n, KEY_TILE)), q[..., j:j + quarter],
                            kt[:, j:j + quarter], terms) for j in range(0, c, quarter)]
        s = ((parts[0] + parts[1]) + (parts[2] + parts[3])) * scale
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        if fresh:
            o = o * corr + wgmma_tf32(torch.zeros_like(o), p, vt, terms)
        else:
            o = wgmma_tf32(o * corr, p, vt, terms)
        m = m_new
    return o / l


@pytest.fixture(autouse=True)
def one_thread():
    """The accumulator model runs thousands of small ops: on one intra-op
    thread they do not contend with the other test workers' threads (the
    long accumulation took over 500 s of a Tier-1 run multithreaded)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                 for _ in range(3))


def _rel(out, ref) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(out - ref) / np.linalg.norm(ref))


def test_rna_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10  # TF32's last place at 1
    below, tie, above = 1 + ulp * 0.499, 1 + ulp * 0.5, 1 + ulp * 0.501
    x = torch.tensor([below, tie, above, -tie, 1.0], dtype=torch.float32)
    assert rna_tf32(x).tolist() == [1.0, 1 + ulp, 1 + ulp, -(1 + ulp), 1.0]
    # hi keeps 11 significant bits and lo the next 11: x - hi - lo is below
    # 2^-21 of x
    xs = _inputs((4096,), seed=0)[0]
    hi, lo = split(xs)
    assert torch.equal(rna_tf32(hi), hi) and torch.equal(rna_tf32(lo), lo)
    assert ((xs.double() - hi.double() - lo.double()).abs() <= xs.double().abs() * 2.0 ** -21).all()


def test_truncated_accumulation_drifts_low():
    """The accumulator model: 1536 k-steps of positive sums lose about half
    an fp32 ulp each, always downwards; the same sum in 24-step pieces added
    in fp32 does not."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.uniform(0.5, 1.0, (1536, 256)).astype(np.float32))
    exact = x.double().sum(dim=0)
    acc = torch.zeros(256)
    for row in x:
        acc = to_fp32_toward_zero(acc.double() + row.double())
    pieces = torch.zeros(256)
    for i in range(0, 1536, 24):
        piece = torch.zeros(256)
        for row in x[i:i + 24]:
            piece = to_fp32_toward_zero(piece.double() + row.double())
        pieces = pieces + piece
    long_rel = ((acc.double() - exact) / exact).mean().item()
    short_rel = ((pieces.double() - exact) / exact).abs().mean().item()
    assert long_rel < -1e-5 and short_rel < 2e-6


@pytest.mark.parametrize("shape", [(1, 128, 128), (2, 256, 128), (1, 256, 512)])
def test_emulated_kernel_matches_jax_flash(shape):
    q, k, v = _inputs(shape, seed=sum(shape))
    scale = shape[-1] ** -0.5
    ref = jax_flash(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
                    scale=scale, out_dtype=jnp.float32, precision=HIGHEST)
    out = emulated_flash_f32(q, k, v, scale)
    assert out.dtype == torch.float32 and tuple(out.shape) == shape
    assert _rel(out.numpy(), np.asarray(ref)) <= REL_L2


def test_emulated_kernel_handles_large_logits():
    """The inputs of the card test ``test_fp32_kernel_handles_large_logits``
    (q and k times 8, scale 1: logits in the hundreds), made with numpy."""
    q, k, v = _inputs((2, 256, 128), seed=1)
    q, k = q * 8, k * 8
    out = emulated_flash_f32(q, k, v, 1.0)
    ref = jax_flash(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
                    scale=1.0, out_dtype=jnp.float32, precision=HIGHEST)
    assert torch.isfinite(out).all()
    assert _rel(out.numpy(), np.asarray(ref)) <= LARGE_LOGIT_REL_L2


@pytest.mark.parametrize("shape", [(1, 128, 128), (1, 256, 512)])
def test_one_tf32_product_is_rejected(shape):
    """hi alone (1xTF32): the bound the kernel is held to rejects it."""
    q, k, v = _inputs(shape, seed=sum(shape))
    scale = shape[-1] ** -0.5
    ref = fa.flash_attention_reference(q, k, v, scale, torch.float32)
    three = _rel(emulated_flash_f32(q, k, v, scale).numpy(), ref.numpy())
    one = _rel(emulated_flash_f32(q, k, v, scale, terms=1).numpy(), ref.numpy())
    assert three <= REL_L2 < one


def test_long_accumulation_is_rejected():
    """O held in one wgmma accumulator over all 32 key tiles exceeds the
    bound; the kernel's fresh accumulator a tile does not."""
    q, k, v = _inputs((1, 2048, 128), seed=2)
    scale = 128 ** -0.5
    ref = fa.flash_attention_reference(q, k, v, scale, torch.float32)
    fresh = _rel(emulated_flash_f32(q, k, v, scale).numpy(), ref.numpy())
    long = _rel(emulated_flash_f32(q, k, v, scale, fresh=False).numpy(), ref.numpy())
    assert fresh <= REL_L2 < long
