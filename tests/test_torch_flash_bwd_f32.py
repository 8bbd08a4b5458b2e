"""fp32 training through flash attention, emulated on the CPU and held to the
JAX package at fp32 (``Precision.HIGHEST``, Pallas in interpret mode).

The fp32 backward (``flash_bwd_f32_kernel``, ``csrc/flash_attention_bwd_f32.cu``)
runs as a cluster of R = C / 128 CTAs, CTA r owning channels [128 r, 128 r +
128) of a block of 64 rows (keys for dK/dV, queries for dQ). Per streamed
tile of 32 rows each CTA forms its partial logits over its own channels:
S by FFMA, one chain of the 128 channels in order a logit (plain's order:
fp32 FMA commutes, so the dK/dV kernel's S^T is the dQ kernel's S
transposed, bit for bit), and dP as three TF32 products on ``wgmma``
(``tests/test_torch_flash_tf32x3.py``'s model: hi and lo rounded to
nearest, every k-step of 8 added to the accumulator and truncated, the
terms lo hi, hi lo, hi hi with A first) in four fresh accumulators of 32
channels added as (d0 + d1) + (d2 + d3), the resident operand as A: dP^T =
V dO^T in the dK/dV kernel, dP = dO V^T in the dQ kernel (the two differ in
their last bits). The cluster adds the R partials in fp32 in rank order
(((S_0 + S_1) + S_2) + S_3), P = exp(S scale - lse) and dS = P (dP -
delta) scale stay fp32 until split, and the outputs are taken transposed on
3xTF32, the streamed operand as A: dK^T = Q^T dS, dV^T = dO^T P over tiles
of 32 queries and dQ^T = K^T dS^T over tiles of 32 keys, each tile into
fresh accumulators added to the sums in fp32. :func:`emulated_bwd_f32`
takes those steps in that order. The planted faults are one TF32 product
(hi alone), one accumulator carried over all tiles, one rank's partial left
out of the logits, and, at logits of several hundred, S and dP on the
tensor cores in one accumulator each (``s_chain`` False, ``dp_parts`` 1).

The fp32 LSE forward is the 3xTF32 forward (``flash_fwd_f32_kernel``) with
its lse pointer set: :func:`emulated_lse_f32` follows its S (four sums of
C/4 channels) and its online m and l, lse = m + log l.

Bounds, those of the kernels on the card (``tests/test_torch_flash_kernel_
cuda.py``, ``chip_smoke.py``): relative L2 1e-5 for o, dQ, dK and dV; lse
within 1e-5 of max|lse|.

Then the slice: three fp32 training steps with ``attention_impl: flash`` of
``FLASH_SHAPED`` (``tests/test_torch_models.py``; its mid block has N = 256
and C = 128), the port's step against the JAX step from the same weights
(carried across by ``models/io.py``), batches and noise: per-step loss and
grad norm within 1e-5 relative (about 3e-6 at step 3), and the final
parameter deltas, all parameters as one vector, within 1e-5 relative L2
(about 1.6e-6). Each parameter's own delta is held to 1e-4 relative L2
(6.9e-6 at worst, a GroupNorm bias): every step stores the parameter in
fp32, whose ulp is already 2e-5 of a 3-step delta on a bias near 0.5, and
naive attention on both sides differs as much.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_flash_tf32x3 import wgmma_tf32
from test_torch_models import FLASH_SHAPED

from vae_channel_dynamics_tpu.models.io import abstract_params, flatten_params, unflatten_params
from vae_channel_dynamics_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from vae_channel_dynamics_tpu.models.vae import VAEConfig as JaxConfig
from vae_channel_dynamics_tpu.ops import pallas_attention as jflash
from vae_channel_dynamics_tpu.training import TrainState as JaxTrainState
from vae_channel_dynamics_tpu.training import build_optimizer as jax_build_optimizer
from vae_channel_dynamics_tpu.training import make_train_step as jax_make_train_step
from vae_channel_dynamics_tpu_torch.models import AutoencoderKL, VAEConfig
from vae_channel_dynamics_tpu_torch.ops import flash_attention as fa
from vae_channel_dynamics_tpu_torch.training import TrainState, build_optimizer, make_train_step

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

HIGHEST = jax.lax.Precision.HIGHEST
REL_L2 = 1e-5
LSE_MAX_REL = 1e-5
SLICE = 128   # channels a CTA owns
TILE = 32     # streamed rows a tile, both kernels
KEY_TILE = 64  # the forward's keys a tile
SHAPES = [(1, 256, 128), (2, 256, 256), (1, 384, 512)]
# the backward alone at a cluster of five, where one rank owns no k-step
BWD_SHAPES = SHAPES + [(1, 256, 640)]
KSTEPS = TILE // 8  # k-steps of a tile's products: two logit pairs each


def fma_chain(a, b) -> torch.Tensor:
    """a b^T in fp32 as one FMA chain a logit over the channels in order:
    each step's exact product added and rounded once (the product of two
    fp32 values is exact in fp64)."""
    acc = torch.zeros(a.shape[:-1] + b.shape[-2:-1], dtype=torch.float64)
    for c in range(a.shape[-1]):
        acc = (acc + a[..., c, None].double() * b[..., None, :, c].double()).float().double()
    return acc.float()


def _logits(a, b, ranks: int, drop=None, terms: int = 3, chain: bool = False,
            parts: int = 1) -> torch.Tensor:
    """a b^T as the cluster forms it: each rank's partial over its 128
    channels by FFMA (``chain``, :func:`fma_chain`) or on the tensor-core
    model (a the register A, b the K-major B) in ``parts`` fresh
    accumulators of 128 / ``parts`` channels added pairwise, added in fp32
    in rank order; ``drop`` leaves one rank's partial out."""
    total = torch.zeros(a.shape[:-1] + b.shape[-2:-1])
    for r in range(ranks):
        if r == drop:
            continue
        sa, sb = (x[..., r * SLICE:(r + 1) * SLICE] for x in (a, b))
        if chain:
            part = fma_chain(sa, sb)
        else:
            width = SLICE // parts
            sums = [wgmma_tf32(torch.zeros_like(total), sa[..., i:i + width],
                               sb[..., i:i + width].transpose(-1, -2), terms)
                    for i in range(0, SLICE, width)]
            while len(sums) > 1:
                sums = [sums[i] + sums[i + 1] for i in range(0, len(sums), 2)]
            part = sums[0]
        total = part if r == 0 else total + part
    return total


def _softmax_grads(s, dp, lse, delta, scale: float):
    """P = exp(S scale - lse) and dS = P (dP - delta) scale in fp32, on
    (B, queries, keys) logits."""
    p = torch.exp(s * scale - lse[..., None])
    return p, p * (dp - delta[..., None]) * scale


def _accumulate(acc, a, b, terms: int, fresh: bool):
    """acc + a b over one tile on the tensor-core model: into fresh
    accumulators added to acc in fp32 (the kernel), or (``fresh`` False) in
    acc's own accumulator carried over all tiles."""
    if fresh:
        return acc + wgmma_tf32(torch.zeros_like(acc), a, b, terms)
    return wgmma_tf32(acc, a, b, terms)


def emulated_bwd_f32(q, k, v, do, lse, delta, scale: float, drop=None, terms: int = 3,
                     fresh: bool = True, s_chain: bool = True, dp_parts: int = 4):
    """(dq, dk, dv) in fp32 as the kernels take them, on fp32 (B, N, C) q, k,
    v, do and (B, N) lse, delta: S by FFMA (``s_chain``; else on the tensor
    cores as dP), dP in ``dp_parts`` accumulators, 3xTF32 (``terms`` 3) or
    1xTF32 (1), fresh accumulators a tile or one over all tiles."""
    ranks = q.shape[-1] // SLICE
    kw = dict(ranks=ranks, drop=drop, terms=terms)
    # S: the dK/dV kernel's S^T = K Q^T (keys the rows) and the dQ kernel's S
    # = Q K^T, the same bits by FFMA
    s = _logits(q, k, chain=s_chain, parts=dp_parts, **kw)
    s_t = s.transpose(1, 2) if s_chain else _logits(k, q, parts=dp_parts, **kw)
    # the dK/dV kernel: dP^T = V dO^T
    p, ds = _softmax_grads(s_t.transpose(1, 2),
                           _logits(v, do, parts=dp_parts, **kw).transpose(1, 2), lse, delta,
                           scale)
    # the dQ kernel: dP = dO V^T (queries the rows)
    _p, ds_q = _softmax_grads(s, _logits(do, v, parts=dp_parts, **kw), lse, delta, scale)
    return emulated_sums(q, k, do, p, ds, ds_q, terms, fresh)


def emulated_sums(q, k, do, p, ds, ds_q=None, terms: int = 3, fresh: bool = True):
    """dQ, dK, dV as the kernels add them over 32-row tiles, transposed with
    the streamed operand as A: dV^T = dO^T P and dK^T = Q^T dS over tiles of
    32 queries (the dK/dV kernel's P and dS), dQ^T = K^T dS^T over tiles of
    32 keys (the dQ kernel's ``ds_q``, by default ``ds``); all (B, queries,
    keys). ``terms`` and ``fresh`` as :func:`emulated_bwd_f32`'s."""
    ds_q = ds if ds_q is None else ds_q
    dq_t, dk_t, dv_t = (torch.zeros_like(q.transpose(1, 2)) for _ in range(3))
    for t in range(0, q.shape[1], TILE):
        rows = slice(t, t + TILE)
        dv_t = _accumulate(dv_t, do[:, rows].transpose(1, 2), p[:, rows], terms, fresh)
        dk_t = _accumulate(dk_t, q[:, rows].transpose(1, 2), ds[:, rows], terms, fresh)
        dq_t = _accumulate(dq_t, k[:, rows].transpose(1, 2), ds_q[:, :, rows].transpose(1, 2),
                           terms, fresh)
    return tuple(g.transpose(1, 2).contiguous() for g in (dq_t, dk_t, dv_t))


def emulated_lse_f32(q, k, scale: float) -> torch.Tensor:
    """The fp32 forward's lse, step by step as ``flash_fwd_f32_kernel``:
    per 64-key tile S in four sums of C/4 channels on 3xTF32, added as (q0 +
    q1) + (q2 + q3) and scaled, the online max m and denominator l in fp32;
    lse = m + log l."""
    b, n, c = q.shape
    m = torch.full((b, n, 1), -1e30)
    l = torch.zeros((b, n, 1))
    quarter = c // 4
    for t in range(0, n, KEY_TILE):
        kt = k[:, t:t + KEY_TILE].transpose(1, 2)
        parts = [wgmma_tf32(torch.zeros((b, n, KEY_TILE)), q[..., j:j + quarter],
                            kt[:, j:j + quarter]) for j in range(0, c, quarter)]
        s = ((parts[0] + parts[1]) + (parts[2] + parts[3])) * scale
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        l = l * torch.exp(m - m_new) + torch.exp(s - m_new).sum(dim=-1, keepdim=True)
        m = m_new
    return (m + torch.log(l))[..., 0]


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                   for _ in range(4))
    scale = shape[-1] ** -0.5
    o, lse = fa.flash_attention_fwd_lse_reference(q, k, v, scale, torch.float32)
    return q, k, v, do, lse, (do * o).sum(-1), scale


def _lane(x):
    return jnp.broadcast_to(jnp.asarray(x.numpy())[..., None], (*x.shape, jflash.LANE))


def _jax_bwd(q, k, v, do, lse, delta, scale):
    """JAX ``_flash_backward`` at fp32, HIGHEST (Pallas, interpret mode on
    the CPU), on the same operands, lse and delta."""
    jq, jk, jv, jdo = (jnp.asarray(t.numpy()) for t in (q, k, v, do))
    grads = jflash._flash_backward(jq, jk, jv, jdo, _lane(lse), _lane(delta), scale, HIGHEST)
    return tuple(np.asarray(g, np.float32) for g in grads)


def _rel(out, ref) -> float:
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(out - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("ranks", range(1, 9))
def test_ksteps_have_one_owner_and_the_outbox_fits(ranks):
    """The fp32 kernels' Split: k-step j of a tile (pairs 2j, 2j + 1)
    belongs to rank floor(j R / 4), contiguous runs [ceil(4r / R), ceil(4(r
    + 1) / R)); from R = 5 some ranks own none and each owner's run of
    partials, 4 KB a k-step, sits in that owner's k-steps of the B tiles (8
    KB a k-step for dK/dV, 4 KB for dQ) instead of an outbox."""
    owners = [j * ranks // KSTEPS for j in range(KSTEPS)]
    for r in range(ranks):
        run = [j for j in range(KSTEPS) if owners[j] == r]
        first = -(-KSTEPS * r // ranks)
        assert run == list(range(first, -(-KSTEPS * (r + 1) // ranks)))
    assert owners == sorted(owners) and all(0 <= o < ranks for o in owners)
    assert (len(set(owners)) < ranks) == (ranks > KSTEPS)
    run_bytes = 2 * 128 * 16                # a k-step's two pairs, a float4 a thread
    for nb in (4, 2):                       # B tiles: P hi, lo, dS hi, lo (dQ: dS)
        assert run_bytes <= nb * 2 * 1024
    for dkv in (True, False):
        assert fa.bwd_smem_bytes(128 * ranks, dkv, f32=True) <= fa.SMEM_CTA


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_emulation_matches_jax_and_plain(shape, one_thread):
    """The kernels' order on 3xTF32: within 1e-5 of the JAX kernels and of
    the plain version."""
    q, k, v, do, lse, delta, scale = _inputs(shape, seed=sum(shape))
    out = emulated_bwd_f32(q, k, v, do, lse, delta, scale)
    refs = fa.flash_attention_bwd_reference(q, k, v, do, lse, delta, scale)
    jax_grads = _jax_bwd(q, k, v, do, lse, delta, scale)
    for name, g, r, j in zip(("dq", "dk", "dv"), out, refs, jax_grads):
        assert g.dtype == torch.float32 and tuple(g.shape) == shape
        assert _rel(g.numpy(), r.numpy()) <= REL_L2, (name, _rel(g.numpy(), r.numpy()))
        assert _rel(g.numpy(), j) <= REL_L2, (name, _rel(g.numpy(), j))


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_one_rank_left_out_is_rejected(shape, one_thread):
    """The cluster without the last rank's partial in the logits' sums (at
    C = 128, the only one): dQ, dK and dV all leave the bound."""
    q, k, v, do, lse, delta, scale = _inputs(shape, seed=sum(shape) + 1)
    refs = fa.flash_attention_bwd_reference(q, k, v, do, lse, delta, scale)
    faulty = emulated_bwd_f32(q, k, v, do, lse, delta, scale, drop=shape[-1] // SLICE - 1)
    for name, g, r in zip(("dq", "dk", "dv"), faulty, refs):
        assert _rel(g.numpy(), r.numpy()) > REL_L2, name


@pytest.fixture
def one_thread():
    """The tensor-core model runs thousands of small ops: one intra-op thread
    keeps them from contending with the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_one_tf32_product_is_rejected(one_thread):
    """hi alone (1xTF32) in every product: each gradient leaves the bound,
    which 3xTF32 in the same order keeps."""
    q, k, v, do, lse, delta, scale = _inputs((1, 256, 128), seed=3)
    refs = fa.flash_attention_bwd_reference(q, k, v, do, lse, delta, scale)
    three = emulated_bwd_f32(q, k, v, do, lse, delta, scale)
    one = emulated_bwd_f32(q, k, v, do, lse, delta, scale, terms=1)
    for name, g3, g1, r in zip(("dq", "dk", "dv"), three, one, refs):
        assert _rel(g3.numpy(), r.numpy()) <= REL_L2 < _rel(g1.numpy(), r.numpy()), name


def test_one_accumulator_over_all_tiles_is_rejected(one_thread):
    """The sums over 2048 rows held in one truncating accumulator (3xTF32):
    dQ, dK and dV drift low past the bound (about 1.9e-5), which fresh
    accumulators a tile keep (about 5e-7). P and dS are the plain fp32 ones,
    and the sums are taken over the first 32 channels only: the fault is in
    the sums, whose drift grows with the rows and not with the channels."""
    q, k, v, do, lse, delta, scale = _inputs((1, 2048, 128), seed=4)
    refs = [g[..., :32] for g in fa.flash_attention_bwd_reference(q, k, v, do, lse, delta,
                                                                  scale)]
    p = torch.exp(torch.matmul(q, k.transpose(1, 2)) * scale - lse[..., None])
    ds = p * (torch.matmul(do, v.transpose(1, 2)) - delta[..., None]) * scale
    q, k, do = (t[..., :32].contiguous() for t in (q, k, do))
    fresh = emulated_sums(q, k, do, p, ds)
    long = emulated_sums(q, k, do, p, ds, fresh=False)
    for name, gf, gl, r in zip(("dq", "dk", "dv"), fresh, long, refs):
        assert _rel(gf.numpy(), r.numpy()) <= REL_L2 < _rel(gl.numpy(), r.numpy()), name


# The card test's bound at logits of several hundred
# (tests/test_torch_flash_kernel_cuda.py::test_fp32_training_handles_large_logits)
LARGE_LOGITS_REL_L2 = 1e-4


def _plain_order_grads(q, k, do, s, dp, lse, delta, scale):
    """(dq, dk, dv) from fp32 logits s and dp, P and dS in fp32, the
    products summed in fp64."""
    p, ds = _softmax_grads(s, dp, lse, delta, scale)
    p, ds = p.double(), ds.double()
    return (ds @ k.double(), ds.transpose(1, 2) @ q.double(), p.transpose(1, 2) @ do.double())


def test_large_logits_need_plain_order(one_thread):
    """Logits near 700 (q and k x 8, scale 1, as the card test): P = exp(S -
    lse) is never renormalised, so an absolute error in S is a relative one
    in P. Against plain in plain's own order (one FMA chain a logit, which
    the FFMA kernel took and passed with on the card), the kernels' order
    (S by that chain, dP in four fresh accumulators) keeps the card test's
    1e-4; S and dP on the tensor cores in one accumulator each (the first
    3xTF32 design, about 1.5e-3), and even S summed exactly (plain's own
    rounding is that far from exact), do not."""
    rng = np.random.default_rng(14)
    shape = (2, 256, 128)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                   for _ in range(4))
    q, k = q * 8, k * 8
    o, lse = fa.flash_attention_fwd_lse_reference(q, k, v, 1.0, torch.float32)
    delta = (do * o).sum(-1)
    dp = fma_chain(do, v)
    refs = _plain_order_grads(q, k, do, fma_chain(q, k), dp, lse, delta, 1.0)
    kernels = emulated_bwd_f32(q, k, v, do, lse, delta, 1.0)
    first_cut = emulated_bwd_f32(q, k, v, do, lse, delta, 1.0, s_chain=False, dp_parts=1)
    exact_s = _plain_order_grads(q, k, do, torch.matmul(q.double(), k.double().transpose(1, 2))
                                 .float(), dp, lse, delta, 1.0)
    for name, g, f, e, r in zip(("dq", "dk", "dv"), kernels, first_cut, exact_s, refs):
        assert _rel(g.numpy(), r.numpy()) <= LARGE_LOGITS_REL_L2, (name, _rel(g.numpy(), r.numpy()))
        assert _rel(f.numpy(), r.numpy()) > LARGE_LOGITS_REL_L2, name
        assert _rel(e.numpy(), r.numpy()) > LARGE_LOGITS_REL_L2, name


@pytest.mark.parametrize("shape", SHAPES)
def test_lse_forward_matches_jax(shape, one_thread):
    """The fp32 LSE forward's lse against JAX ``_flash_forward(with_lse=True)``
    at HIGHEST; the row max m in place of lse is rejected."""
    q, k, v, _do, _lse, _delta, scale = _inputs(shape, seed=sum(shape) + 2)
    lse = emulated_lse_f32(q, k, scale)
    _jo, jlse = jflash._flash_forward(*(jnp.asarray(t.numpy()) for t in (q, k, v)), scale,
                                     jnp.float32, HIGHEST, with_lse=True)
    jlse = np.asarray(jlse)[..., 0]
    _o, plse = fa.flash_attention_fwd_lse_reference(q, k, v, scale, torch.float32)
    top = np.abs(jlse).max()
    assert np.abs(lse.numpy() - jlse).max() <= LSE_MAX_REL * top
    assert np.abs(plse.numpy() - jlse).max() <= LSE_MAX_REL * top
    row_max = (torch.matmul(q, k.transpose(1, 2)) * scale).amax(dim=-1)
    assert np.abs(row_max.numpy() - jlse).max() > LSE_MAX_REL * top


# --------------------------------------------------------------------------- #
# The slice: three fp32 training steps through flash, port against JAX
# --------------------------------------------------------------------------- #
N_STEPS, BATCH, RES = 3, 2, 32
# Adam's epsilon at 1 keeps its update linear in a small gradient: at 1e-8
# it divides a near-zero gradient by its own magnitude, so a last-bit
# difference becomes a different update (naive attention on both sides
# shows 1.8e-3 of a conv weight's delta that way)
LR, WARMUP, MAX_STEPS, KL_WEIGHT, ADAM_EPS = 1.0, 1, 10, 1e-6, 1.0


@pytest.fixture(scope="module")
def trajectories():
    cfg = dict(FLASH_SHAPED)
    model = AutoencoderKL(VAEConfig(**cfg), attn_impl="flash")
    model.init_weights(torch.Generator().manual_seed(21))
    initial = {k: v.detach().clone() for k, v in model.state_dict().items()}
    params = unflatten_params(abstract_params(JaxConfig(**cfg)),
                              {k: v.numpy() for k, v in initial.items()})
    rng = np.random.default_rng(22)
    batches = [rng.integers(0, 256, (BATCH, RES, RES, 3), dtype=np.uint8) for _ in range(N_STEPS)]
    mask = np.ones(BATCH, np.float32)
    base_rng = jax.random.PRNGKey(23)
    latent = (BATCH, RES // 2, RES // 2, cfg["latent_channels"])
    noises = [np.array(jax.random.normal(jax.random.fold_in(base_rng, t), latent, jnp.float32))
              for t in range(N_STEPS)]

    before = dict(fa.launches)
    calls = {"flash": 0}
    flash = fa.flash_attention_fwd_lse

    def counted(*args, **kwargs):
        calls["flash"] += 1
        return flash(*args, **kwargs)

    fa.flash_attention_fwd_lse = counted
    try:
        tx, _ = build_optimizer(LR, WARMUP, MAX_STEPS, adam_epsilon=ADAM_EPS)
        state = TrainState.create(model, tx)
        step = make_train_step(model, tx, KL_WEIGHT)
        t_metrics = []
        for t in range(N_STEPS):
            state, metrics, _ = step(state, {"pixel_values": batches[t]}, mask, noise=noises[t])
            t_metrics.append({k: float(v) for k, v in metrics.items()})
    finally:
        fa.flash_attention_fwd_lse = flash

    jmodule = JaxAutoencoderKL(config=JaxConfig(**cfg), dtype=jnp.float32, attn_impl="flash")
    jtx, _ = jax_build_optimizer(LR, WARMUP, MAX_STEPS, adam_epsilon=ADAM_EPS)
    jstate = JaxTrainState.create(params, jtx)
    jstep = jax_make_train_step(jmodule, jtx, KL_WEIGHT, donate=False)
    j_metrics = []
    for t in range(N_STEPS):
        jstate, metrics, _ = jstep(jstate, {"pixel_values": batches[t]}, mask, base_rng)
        j_metrics.append({k: float(v) for k, v in metrics.items()})
    return {"initial": initial, "port": (t_metrics, state), "jax": (j_metrics, jstate),
            "flash_calls": calls["flash"], "launches": {k: fa.launches[k] - before[k]
                                                         for k in fa.launches}}


def test_slice_runs_flash_at_fp32(trajectories):
    """Both attention blocks go through the flash op each step (the plain
    versions on the CPU: no kernel launches here)."""
    assert trajectories["flash_calls"] == 2 * N_STEPS
    assert not any(trajectories["launches"].values())


def test_slice_losses_and_grad_norms_match_jax(trajectories):
    t_metrics, _ = trajectories["port"]
    j_metrics, _ = trajectories["jax"]
    for t, (tm, jm) in enumerate(zip(t_metrics, j_metrics)):
        for key in ("train_loss_step", "grad_norm"):
            assert abs(tm[key] - jm[key]) <= 1e-5 * abs(jm[key]), (key, t, tm[key], jm[key])
    assert len({m["train_loss_step"] for m in t_metrics}) == N_STEPS


def test_slice_parameter_deltas_match_jax(trajectories):
    initial = trajectories["initial"]
    _, state = trajectories["port"]
    _, jstate = trajectories["jax"]
    j_final = flatten_params(jstate.params)
    t_final = {k: v.detach() for k, v in state.model.state_dict().items()}
    assert set(j_final) == set(t_final)
    diff = total = 0.0
    moved = 0
    for name, want in j_final.items():
        if name.endswith("to_k.bias"):
            # its gradient is zero by symmetry (softmax ignores a per-row
            # shift): the roundoff no two implementations share
            # (tests/test_train_trajectory_torch_parity.py)
            continue
        jd = want.astype(np.float64) - initial[name].double().numpy()
        td = (t_final[name].double() - initial[name].double()).numpy()
        assert _rel(td, jd) <= 1e-4, (name, _rel(td, jd))
        diff += float(((td - jd) ** 2).sum())
        total += float((jd ** 2).sum())
        moved += int(np.abs(jd).max() > 0)
    assert moved > 30
    assert (diff / total) ** 0.5 <= 1e-5
