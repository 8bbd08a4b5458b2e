"""The order of operations of the flash backward kernels, whose channels are
split over a thread-block cluster, emulated on the CPU and held to the JAX
Pallas kernels.

``flash_bwd_dkv_kernel`` and ``flash_bwd_dq_kernel``
(``csrc/flash_attention_bwd.cu``) run as clusters of R = C / 128 CTAs (1 to
8): CTA r owns channels [128 r, 128 r + 128) of a block of 64 rows (keys for
dK/dV, queries for dQ). Per streamed tile (64 queries for dK/dV, 32 at R =
7; 32 keys for dQ)
it forms its partial S and dP over its own channels, in fp32; the cluster
adds the R partials in rank order (((S_0 + S_1) + S_2) + S_3), the sum is
scaled, P = exp(S - lse) and dS = P (dP - delta) scale are rounded to bf16,
and each CTA adds the tile's P^T dO and dS^T Q (or dS K) over its own
channels into fp32 accumulators, which are written in bf16 at the end.
:func:`emulated_bwd` takes those steps in that order. Each pair of a
thread's logits belongs to one rank, which forms its P and dS for every
rank: :func:`owner` is the rule and :func:`first` the runs of the kernel's
``Split``, and :func:`pair_element` its accumulator layout. Each CTA's
exchange buffer holds its R slots of the pairs it owns and its outbox of
the others' pairs, sized for the rank that owns the most;
``fa.bwd_smem_bytes`` mirrors the kernels' ``Layout`` and is held to the
shared memory a CTA may have at every width.

Bounds: those of the kernels on the card (``tests/test_torch_flash_kernel_
cuda.py``, ``chip_smoke.py``): max|out - ref| <= 2^-6 max|ref| and relative
L2 <= 1e-2, against the JAX ``_flash_backward`` in Pallas interpret mode and
against ``flash_attention_bwd_reference``. A cluster that left one rank's
partial out of the logits' sum is rejected by them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_channel_dynamics_tpu.ops import pallas_attention as jflash
from vae_channel_dynamics_tpu_torch.ops import flash_attention as fa

GRAD_MAX_REL = 2.0 ** -6
REL_L2 = 1e-2
SLICE = 128     # channels a CTA owns
ROWS = 64       # the CTA's keys (dK/dV) or queries (dQ)
DKV_TILE = 64   # queries a streamed tile of the dK/dV kernel
DQ_TILE = 32    # keys a streamed tile of the dQ kernel
SHAPES = [(2, 256, 128), (1, 384, 256), (1, 256, 384), (1, 512, 512), (1, 256, 640),
          (1, 256, 1024)]


def owner(p: int, r: int, pairs: int) -> int:
    """The rank that owns pair p of ``pairs`` in a cluster of r: floor(p r /
    pairs), the rule ``Split``'s runs follow."""
    return p * r // pairs


def first(rank: int, r: int, pairs: int) -> int:
    """The first pair rank owns (``Split::first``): ceil(pairs rank / r)."""
    return (pairs * rank + r - 1) // r


def pair_element(warp: int, lane: int, p: int, e: int):
    """(row, column) of element e of pair p of the thread (warp, lane) of a
    warpgroup in a 64 x 64 wgmma accumulator: accumulator 2p + e."""
    i = 2 * p + e
    return 16 * warp + lane // 4 + 8 * ((i // 2) % 2), 8 * (i // 4) + 2 * (lane % 4) + i % 2


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _logits(a, b, ranks: int, drop=None) -> torch.Tensor:
    """a b^T over all channels as the cluster forms it: each rank's partial
    over its 128 channels in fp32, added in rank order; ``drop`` leaves one
    rank's partial out."""
    total = None
    for r in range(ranks):
        if r == drop:
            continue
        part = torch.matmul(a[..., r * SLICE:(r + 1) * SLICE],
                            b[..., r * SLICE:(r + 1) * SLICE].transpose(-1, -2))
        total = part if total is None else total + part
    return total if total is not None else torch.zeros(a.shape[:-1] + b.shape[-2:-1])


def emulated_bwd(q, k, v, do, lse, delta, scale: float, drop=None):
    """(dq, dk, dv) in bf16 as the kernels take them, on bf16 (B, N, C)
    q, k, v, do and fp32 (B, N) lse, delta."""
    bsz, n, c = q.shape
    ranks = c // SLICE
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    s = _logits(qf, kf, ranks, drop)          # (B, queries, keys), fp32
    dp = _logits(dof, vf, ranks, drop)
    p = torch.exp(s * scale - lse[..., None])
    ds = p * (dp - delta[..., None]) * scale
    p, ds = _bf16(p), _bf16(ds)
    dq = torch.zeros(bsz, n, c)
    dk = torch.zeros(bsz, n, c)
    dv = torch.zeros(bsz, n, c)
    # every block of 64 rows accumulates its streamed tiles in order, in fp32
    dkv_tile = fa.bwd_tile(c, dkv=True)
    for t in range(0, n, dkv_tile):
        rows = slice(t, t + dkv_tile)
        dv = dv + torch.matmul(p[:, rows].transpose(1, 2), dof[:, rows])
        dk = dk + torch.matmul(ds[:, rows].transpose(1, 2), qf[:, rows])
    for t in range(0, n, DQ_TILE):
        keys = slice(t, t + DQ_TILE)
        dq = dq + torch.matmul(ds[:, :, keys], kf[:, keys])
    return tuple(x.to(torch.bfloat16) for x in (dq, dk, dv))


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                   .to(torch.bfloat16) for _ in range(4))
    scale = shape[-1] ** -0.5
    o, lse = fa.flash_attention_fwd_lse_reference(q, k, v, scale, torch.bfloat16)
    delta = (do.float() * o.float()).sum(-1)
    return q, k, v, do, lse, delta, scale


def _jax_bwd(q, k, v, do, lse, delta, scale):
    """JAX ``_flash_backward`` (Pallas, interpret mode on the CPU) on the
    same bf16 operands, lse and delta."""
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v, do))
    lane = lambda x: jnp.broadcast_to(jnp.asarray(x.numpy())[..., None],  # noqa: E731
                                      (*x.shape, jflash.LANE))
    grads = jflash._flash_backward(jq, jk, jv, jdo, lane(lse), lane(delta), scale,
                                   jax.lax.Precision.DEFAULT)
    return tuple(np.asarray(g, np.float32) for g in grads)


def _errors(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    d = out - ref
    return np.abs(d).max() / np.abs(ref).max(), np.linalg.norm(d) / np.linalg.norm(ref)


def _within(out, ref) -> bool:
    max_rel, rel_l2 = _errors(out, ref)
    return max_rel <= GRAD_MAX_REL and rel_l2 <= REL_L2


@pytest.mark.parametrize("tile", [DKV_TILE, DQ_TILE])
@pytest.mark.parametrize("ranks", [1, 2, 3, 4, 5, 6, 7, 8])
def test_pairs_have_one_owner_and_cover_the_tile(ranks, tile):
    """Split: each rank owns a contiguous run of pairs, each pair one rank,
    at most ceil(pairs / R) a rank; the pairs of the 128 threads cover the
    64 x tile logits once, and pairs 4kk .. 4kk + 3 of a thread are its
    columns of k-step kk (wgmma's register A)."""
    pairs = tile // 4
    owners = [owner(p, ranks, pairs) for p in range(pairs)]
    for r in range(ranks):
        run = [p for p in range(pairs) if owners[p] == r]
        assert run == list(range(first(r, ranks, pairs), first(r + 1, ranks, pairs)))
        assert 0 < len(run) <= -(-pairs // ranks)
    seen = np.zeros((ROWS, tile), int)
    for warp in range(4):
        for lane in range(32):
            for p in range(pairs):
                cols = set()
                for e in range(2):
                    row, col = pair_element(warp, lane, p, e)
                    seen[row, col] += 1
                    cols.add(col)
                assert all(16 * (p // 4) <= col < 16 * (p // 4 + 1) for col in cols)
    assert (seen == 1).all()


@pytest.mark.parametrize("c", range(128, 1025, 128))
def test_layout_fits_the_shared_memory_at_every_width(c):
    """The kernels' Layout (``fa.bwd_smem_bytes``, which chip_smoke.py holds
    to the built library's own): dK/dV one CTA an SM, at most 232,448
    bytes; dQ two CTAs an SM, at most 115,712 each; the exchange buffer is
    what the rank that owns the most pairs needs, R slots of its own pairs
    and the other ranks' pairs. The fp32 kernels (``flash_attention_bwd_f32
    .cu``, one CTA an SM) as well."""
    ranks = fa.bwd_cluster_size(c)
    assert ranks == c // SLICE and 1 <= ranks <= 8
    assert fa.bwd_smem_bytes(c, dkv=True) <= fa.SMEM_CTA
    assert fa.bwd_smem_bytes(c, dkv=False) <= fa.SMEM_HALF_SM
    for dkv in (True, False):
        assert fa.bwd_smem_bytes(c, dkv, f32=True) <= fa.SMEM_CTA
        pairs = fa.bwd_tile(c, dkv) // 4
        owned = [[owner(p, ranks, pairs) for p in range(pairs)].count(r) for r in range(ranks)]
        held = max(ranks * o + pairs - o for o in owned)
        assert held == (ranks - 1) * -(-pairs // ranks) + pairs
    # dK/dV streams 64 queries a tile but at R = 7, whose buffer would not fit
    assert fa.bwd_tile(c, dkv=True) == (32 if ranks == 7 else 64)


@pytest.mark.parametrize("shape", SHAPES)
def test_emulation_matches_jax_and_plain(shape):
    q, k, v, do, lse, delta, scale = _inputs(shape, seed=sum(shape))
    out = emulated_bwd(q, k, v, do, lse, delta, scale)
    refs = fa.flash_attention_bwd_reference(q, k, v, do, lse, delta, scale)
    jax_grads = _jax_bwd(q, k, v, do, lse, delta, scale)
    for name, g, r, j in zip(("dq", "dk", "dv"), out, refs, jax_grads):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == shape
        assert _within(g.float().numpy(), r.float().numpy()), (name, _errors(g.float(), r.float()))
        assert _within(g.float().numpy(), j), (name, _errors(g.float().numpy(), j))


@pytest.mark.parametrize("shape", SHAPES)
def test_one_rank_left_out_is_rejected(shape):
    """The cluster without the last rank's partial in the logits' sum (at
    C = 128, the only one; at 1024, one of eight): dQ, dK and dV all leave
    the bounds."""
    q, k, v, do, lse, delta, scale = _inputs(shape, seed=sum(shape) + 1)
    ranks = shape[-1] // SLICE
    refs = fa.flash_attention_bwd_reference(q, k, v, do, lse, delta, scale)
    faulty = emulated_bwd(q, k, v, do, lse, delta, scale, drop=ranks - 1)
    for name, g, r in zip(("dq", "dk", "dv"), faulty, refs):
        assert not _within(g.float().numpy(), r.float().numpy()), name
