"""The order of operations of the bf16 flash forward kernel, emulated on the
CPU and held to the JAX Pallas kernel.

``flash_fwd_kernel`` (``csrc/flash_attention_fwd.cu``, the serving forward
and, with its ``lse`` pointer set, the training one) runs a CTA a block of
64 query rows. Two warpgroups each own half of the channels: per 64-key
tile each forms its partial S over its half in fp32, and both add the two
partials (S_0 + S_1, the same bits either way round), scale the sum and
take the online softmax's step; P = exp(S - m), in the input's dtype, goes
to P V, and O is kept in fp32 across the tiles. The loop is pipelined by a
tile: tile t - 1's P V is added to O before O is rescaled by tile t's
correction, and the last tile's P V is issued after the loop.
:func:`emulated_fwd` takes those steps in that order. K and V come in units
of one 64-key x 64-channel box of each half, in the order the loop consumes
them (:func:`stream_unit`, the producer's order).

Past 512 channels both forwards (bf16 and fp32) split the channels over a
thread-block cluster of two CTAs (``FwdSplit``; ``fa.fwd_cluster_size``):
rank r owns the slice [r CS, (r + 1) CS) of CS = ``fa.fwd_slice(C)``
channels, zero past C (640 and 896), each CTA's partial S is the sum of its
two warpgroups', and the two partials are added (T_0 + T_1, the same bits in
both CTAs). :func:`emulated_fwd` takes that split too, and a fault: one
rank's partial left out of S.

Bounds. In fp32 (P kept in fp32, as JAX with fp32 inputs at
``Precision.HIGHEST``), the emulation and JAX ``_flash_forward`` in Pallas
interpret mode differ only by the order of fp32 sums and the tile on which
each row's running max moves: relative L2 at most 1e-5 for O and
max|lse - ref| at most 1e-5 max|ref|, the card's LSE bound (measured here:
5e-7 to 8e-7, and 7e-8). In bf16, those of the kernel on the card
(``tests/test_torch_flash_kernel_cuda.py``): rtol 1.6e-2 with atol 1e-2 and
relative L2 1e-2 for O. The two faults the kernel's new mechanisms could
make leave those bounds: one warpgroup's partial S left out of the sum, and
the last tile's P V, issued after the loop, left out of O.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_channel_dynamics_tpu.ops import pallas_attention as jflash
from vae_channel_dynamics_tpu_torch.ops import flash_attention as fa

ROWS = 64           # query rows of a CTA
TILE = 64           # keys of a tile
F32_REL_L2 = 1e-5
LSE_MAX_REL = 1e-5
RTOL, ATOL, REL_L2 = 1.6e-2, 1e-2, 1e-2
SHAPES = [(2, 256, 128), (1, 384, 256), (1, 256, 384), (1, 384, 512)]
# past 512 channels: a cluster of two, with padding (640) and without (1024)
WIDE_SHAPES = [(1, 256, 640), (1, 256, 1024)]


def stream_unit(k: int, nt: int, nch: int):
    """Unit k of the kernel's K/V stream (its producer's loop): (is V, tile, chunk)."""
    grp, chunk = divmod(k, nch)
    is_v = grp == 2 * nt - 1 or (grp > 0 and grp % 2 == 0)
    tile = nt - 1 if grp == 2 * nt - 1 else (grp // 2 - 1 if is_v else (grp + 1) // 2)
    return is_v, tile, chunk


def partial_logits(qf, kf, c: int, drop_half=None, drop_rank=None):
    """Q K^T (unscaled, fp32) as the forwards sum it at width c: each CTA of
    the cluster (``fa.fwd_cluster_size``) over its slice of
    ``fa.fwd_slice(c)`` channels, zero-filled past c, its two warpgroups'
    halves added; then the CTAs' partials added. ``drop_half`` leaves that
    warpgroup's partial out of every CTA's sum, ``drop_rank`` that CTA's."""
    ranks, cs = fa.fwd_cluster_size(c), fa.fwd_slice(c)
    pad = ranks * cs - c
    if pad:
        qf = torch.nn.functional.pad(qf, (0, pad))
        kf = torch.nn.functional.pad(kf, (0, pad))
    total = None
    for r in range(ranks):
        halves = [torch.matmul(qf[..., r * cs + g * cs // 2:r * cs + (g + 1) * cs // 2],
                               kf[..., r * cs + g * cs // 2:r * cs + (g + 1) * cs // 2]
                               .transpose(-1, -2))
                  for g in range(2) if g != drop_half]
        part = halves[0] + halves[1] if len(halves) == 2 else halves[0]
        if r != drop_rank:
            total = part if total is None else total + part
    return total


def emulated_fwd(q, k, v, scale: float, drop_half=None, skip_last_pv=False, drop_rank=None):
    """(o, lse) as the kernel forms them, on (B, N, C) q, k, v: o in q's
    dtype, lse fp32 (B, N). ``drop_half`` leaves that warpgroup's partial S
    out, ``drop_rank`` that CTA's (past 512 channels); ``skip_last_pv``
    leaves the last tile's P V out of O."""
    bsz, n, c = q.shape
    qf, kf, vf = (t.float() for t in (q, k, v))
    o = torch.zeros(bsz, n, c)
    lse = torch.zeros(bsz, n)
    for blk in range(n // ROWS):
        rows = slice(blk * ROWS, (blk + 1) * ROWS)
        nt = n // TILE
        m = torch.full((bsz, ROWS, 1), -1e30)
        l = torch.zeros(bsz, ROWS, 1)
        acc = torch.zeros(bsz, ROWS, c)
        p_prev = None
        for t in range(nt):
            keys = slice(t * TILE, (t + 1) * TILE)
            s = partial_logits(qf[:, rows], kf[:, keys], c, drop_half, drop_rank) * scale
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            m = m_new
            if p_prev is not None:  # tile t - 1's P V, then the rescale
                acc = acc + torch.matmul(p_prev, vf[:, slice((t - 1) * TILE, t * TILE)])
            acc = acc * corr
            p_prev = p.to(q.dtype).float()
        if not skip_last_pv:  # issued after the loop
            acc = acc + torch.matmul(p_prev, vf[:, slice((nt - 1) * TILE, nt * TILE)])
        o[:, rows] = acc / l
        lse[:, rows] = (m + torch.log(l))[..., 0]
    return o.to(q.dtype), lse


def _inputs(shape, seed, dtype):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)
                 for _ in range(3))


def _jax_fwd(q, k, v, scale, dtype):
    """JAX ``_flash_forward`` with its LSE (Pallas, interpret mode on the
    CPU): (o fp32, lse (B, N))."""
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jd) for t in (q, k, v))
    o, lse = jflash._flash_forward(jq, jk, jv, scale, jnp.float32, jax.lax.Precision.HIGHEST,
                                   with_lse=True)
    return np.array(o, np.float32), np.array(lse, np.float32)[..., 0]


def _rel_l2(out, ref) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(out - ref) / np.linalg.norm(ref))


def _within_bf16(out, ref) -> bool:
    out, ref = out.float(), ref.float()
    close = torch.allclose(out, ref, rtol=RTOL, atol=ATOL)
    return close and _rel_l2(out.numpy(), ref.numpy()) <= REL_L2


@pytest.mark.parametrize("nch", [1, 2, 3, 4])
@pytest.mark.parametrize("nt", [1, 2, 3, 6])
def test_stream_order_is_the_consumers_order(nt, nch):
    """The stream is K_0, then K_t and V_(t-1) for t >= 1, then V_(nt-1),
    nch units each: the order the consumers wait on them."""
    want = [(False, 0)]
    for t in range(1, nt):
        want += [(False, t), (True, t - 1)]
    want.append((True, nt - 1))
    got = [stream_unit(k, nt, nch) for k in range(2 * nt * nch)]
    assert got == [(is_v, t, ch) for is_v, t in want for ch in range(nch)]


@pytest.mark.parametrize("n", [128, 384, 4096, 16384])
def test_every_eligible_token_count_streams_each_unit_once(n):
    """At the token counts eligible() takes, the N / 64 key tiles are whole,
    and the stream at C = 512 (4 units of K and of V a tile) holds each unit
    of K and of V once, tile t's K before its V."""
    assert fa.eligible(n, 512) and n % TILE == 0 and n % ROWS == 0
    nt, nch = n // TILE, 4
    order = [stream_unit(k, nt, nch) for k in range(2 * nt * nch)]
    assert sorted(order) == [(is_v, t, ch) for is_v in (False, True) for t in range(nt)
                             for ch in range(nch)]
    assert all(order.index((False, t, 0)) < order.index((True, t, 0)) for t in range(nt))

@pytest.mark.parametrize("shape", SHAPES)
def test_fp32_emulation_matches_jax(shape):
    q, k, v = _inputs(shape, sum(shape), torch.float32)
    scale = shape[-1] ** -0.5
    o, lse = emulated_fwd(q, k, v, scale)
    jo, jlse = _jax_fwd(q, k, v, scale, torch.float32)
    assert _rel_l2(o.numpy(), jo) <= F32_REL_L2
    assert np.abs(lse.numpy() - jlse).max() <= LSE_MAX_REL * np.abs(jlse).max()


@pytest.mark.parametrize("c", [640, 768, 896, 1024])
def test_cluster_slices_cover_the_channels_once(c):
    """Past 512 channels two CTAs of fa.fwd_slice(c) channels (a multiple of
    128, at most 512: one CTA's kernel at C = 384 or 512) cover the C
    channels, the padding less than one slice's 128-channel chunk, and the
    shared memory a CTA (the Python mirror of Layout and F32Units) fits."""
    cs = fa.fwd_slice(c)
    assert fa.fwd_cluster_size(c) == 2 and cs % 128 == 0 and cs <= 512
    assert c <= 2 * cs < c + 256
    for f32 in (False, True):
        assert fa.fwd_smem_bytes(c, f32) <= fa.SMEM_CTA


@pytest.mark.parametrize("shape", WIDE_SHAPES)
def test_cluster_emulation_matches_jax_and_rejects_a_rank_left_out(shape):
    """The cluster's order at 640 (padded) and 1024 channels: fp32 within
    the fp32 bounds of JAX ``_flash_forward`` (interpret mode), bf16 within
    the card's bounds of it and of the plain version; one rank's partial
    left out of S is rejected."""
    scale = shape[-1] ** -0.5
    q, k, v = _inputs(shape, sum(shape) + 2, torch.float32)
    o, lse = emulated_fwd(q, k, v, scale)
    jo, jlse = _jax_fwd(q, k, v, scale, torch.float32)
    assert _rel_l2(o.numpy(), jo) <= F32_REL_L2
    assert np.abs(lse.numpy() - jlse).max() <= LSE_MAX_REL * np.abs(jlse).max()
    dropped, _ = emulated_fwd(q, k, v, scale, drop_rank=1)
    assert _rel_l2(dropped.numpy(), jo) > F32_REL_L2
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    ob, _ = emulated_fwd(qb, kb, vb, scale)
    ref, _ = fa.flash_attention_fwd_lse_reference(qb, kb, vb, scale, torch.bfloat16)
    jb, _ = _jax_fwd(qb, kb, vb, scale, torch.bfloat16)
    assert _within_bf16(ob, ref)
    assert _within_bf16(ob, torch.from_numpy(jb).to(torch.bfloat16))
    for rank in (0, 1):
        dropped, _ = emulated_fwd(qb, kb, vb, scale, drop_rank=rank)
        assert not _within_bf16(dropped, ref)


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_emulation_within_the_card_bounds_and_faults_outside(shape):
    q, k, v = _inputs(shape, sum(shape) + 1, torch.bfloat16)
    scale = shape[-1] ** -0.5
    o, lse = emulated_fwd(q, k, v, scale)
    ref, ref_lse = fa.flash_attention_fwd_lse_reference(q, k, v, scale, torch.bfloat16)
    jo, _jlse = _jax_fwd(q, k, v, scale, torch.bfloat16)
    assert _within_bf16(o, ref)
    assert _within_bf16(o, torch.from_numpy(jo).to(torch.bfloat16))
    assert (lse - ref_lse).abs().max() <= LSE_MAX_REL * ref_lse.abs().max()
    dropped, _ = emulated_fwd(q, k, v, scale, drop_half=1)
    assert not _within_bf16(dropped, ref)
    skipped, _ = emulated_fwd(q, k, v, scale, skip_last_pv=True)
    assert not _within_bf16(skipped, ref)
