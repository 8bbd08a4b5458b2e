"""fp32 training through flash attention, emulated on the CPU and held to the
JAX package at fp32 (``Precision.HIGHEST``, Pallas in interpret mode).

The fp32 backward (``flash_bwd_f32_kernel``, ``csrc/flash_attention_bwd_f32.cu``)
runs as a cluster of R = C / 128 CTAs, CTA r owning channels [128 r, 128 r +
128) of a block of 64 rows (keys for dK/dV, queries for dQ). Per streamed
tile of 32 rows it forms its partial S and dP over its own channels with
fp32 FMAs, the cluster adds the R partials in rank order (((S_0 + S_1) +
S_2) + S_3) in every CTA, P = exp(S scale - lse) and dS = P (dP - delta)
scale stay fp32, and each CTA adds the tile's P^T dO and dS^T Q (or dS K)
over its channels into fresh accumulators that it then adds to its sums.
:func:`emulated_bwd_f32` takes those steps in that order; its products are
fp32 matmuls, rounded to nearest as FFMA chains are.

The kernel uses no tensor cores, so it has no TF32 split and no truncating
accumulator of its own. The bound must still reject what a tensor-core
shortcut would give: :func:`emulated_bwd_f32` with ``mma`` models the same
order on 3xTF32 ``wgmma`` (``tests/test_torch_flash_tf32x3.py``'s model:
hi and lo rounded to nearest, every k-step of 8 added to the accumulator and
truncated), and the planted faults are one TF32 product (hi alone), one
accumulator carried over all tiles, and one rank's partial left out of the
logits.

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


def _logits(a, b, ranks: int, drop=None, mma=None) -> torch.Tensor:
    """a b^T as the cluster forms it: each rank's partial over its 128
    channels (fp32, or ``mma``'s tensor-core model in a fresh accumulator),
    added in rank order; ``drop`` leaves one rank's partial out."""
    total = torch.zeros(a.shape[:-1] + b.shape[-2:-1])
    for r in range(ranks):
        if r == drop:
            continue
        sa, sb = (x[..., r * SLICE:(r + 1) * SLICE] for x in (a, b))
        part = (torch.matmul(sa, sb.transpose(-1, -2)) if mma is None else
                wgmma_tf32(torch.zeros_like(total), sa, sb.transpose(-1, -2), mma[0]))
        total = part if r == 0 else total + part
    return total


def _accumulate(acc, a, b, mma):
    """acc + a b over one tile: fp32 into fresh accumulators added to acc
    (the kernel), or the tensor-core model: fresh (mma[1]) or in acc's own
    accumulator carried over all tiles."""
    if mma is None:
        return acc + torch.matmul(a, b)
    if mma[1]:
        return acc + wgmma_tf32(torch.zeros_like(acc), a, b, mma[0])
    return wgmma_tf32(acc, a, b, mma[0])


def emulated_bwd_f32(q, k, v, do, lse, delta, scale: float, drop=None, mma=None):
    """(dq, dk, dv) in fp32 as the kernels take them, on fp32 (B, N, C) q, k,
    v, do and (B, N) lse, delta. ``mma`` = (terms, fresh) models the same
    order on 3xTF32 (terms 3) or 1xTF32 (terms 1) tensor cores."""
    ranks = q.shape[-1] // SLICE
    s = _logits(q, k, ranks, drop, mma)        # (B, queries, keys)
    dp = _logits(do, v, ranks, drop, mma)
    p = torch.exp(s * scale - lse[..., None])
    ds = p * (dp - delta[..., None]) * scale
    return emulated_sums(q, k, do, p, ds, mma)


def emulated_sums(q, k, do, p, ds, mma=None):
    """dQ = dS K, dK = dS^T Q, dV = P^T dO as the kernels add them over
    32-row tiles, from the tile's (B, queries, keys) P and dS; ``mma`` as
    :func:`emulated_bwd_f32`'s."""
    dq, dk, dv = (torch.zeros_like(q) for _ in range(3))
    for t in range(0, q.shape[1], TILE):
        rows = slice(t, t + TILE)
        # dK/dV: tiles of 32 queries; dQ: tiles of 32 keys
        dv = _accumulate(dv, p[:, rows].transpose(1, 2), do[:, rows], mma)
        dk = _accumulate(dk, ds[:, rows].transpose(1, 2), q[:, rows], mma)
        dq = _accumulate(dq, ds[:, :, rows], k[:, rows], mma)
    return dq, dk, dv


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


@pytest.mark.parametrize("shape", SHAPES)
def test_emulation_matches_jax_and_plain(shape):
    q, k, v, do, lse, delta, scale = _inputs(shape, seed=sum(shape))
    out = emulated_bwd_f32(q, k, v, do, lse, delta, scale)
    refs = fa.flash_attention_bwd_reference(q, k, v, do, lse, delta, scale)
    jax_grads = _jax_bwd(q, k, v, do, lse, delta, scale)
    for name, g, r, j in zip(("dq", "dk", "dv"), out, refs, jax_grads):
        assert g.dtype == torch.float32 and tuple(g.shape) == shape
        assert _rel(g.numpy(), r.numpy()) <= REL_L2, (name, _rel(g.numpy(), r.numpy()))
        assert _rel(g.numpy(), j) <= REL_L2, (name, _rel(g.numpy(), j))


@pytest.mark.parametrize("shape", SHAPES)
def test_one_rank_left_out_is_rejected(shape):
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
    three = emulated_bwd_f32(q, k, v, do, lse, delta, scale, mma=(3, True))
    one = emulated_bwd_f32(q, k, v, do, lse, delta, scale, mma=(1, True))
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
    fresh = emulated_sums(q, k, do, p, ds, mma=(3, True))
    long = emulated_sums(q, k, do, p, ds, mma=(3, False))
    for name, gf, gl, r in zip(("dq", "dk", "dv"), fresh, long, refs):
        assert _rel(gf.numpy(), r.numpy()) <= REL_L2 < _rel(gl.numpy(), r.numpy()), name


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
