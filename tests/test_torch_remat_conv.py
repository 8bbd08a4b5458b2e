"""``remat: conv`` in the port, on the CPU (JAX ``_resnet_remat_cls("conv")``:
``save_only_these_names("conv_out")``).

Each ``ResnetBlock2D`` keeps its conv outputs and leaves each conv's input,
a GroupNorm+SiLU output, out of the saved tensors: the backward computes it
again from the norm's input, and runs no conv twice. It must change nothing
but memory: the loss, the gradients and the taps
equal ``remat: none``'s bit for bit (the same float operations in the same
order), and at fp32 the gradients equal the JAX model's under ``remat:
conv`` (fp32, TF32 off; 1e-4 of each tensor's largest entry). Counted
through a dispatch mode: as many convolutions as ``none``, as many norm
forwards as ``full``; the norms' outputs are not held between the forward
and the backward. Under ``kernel_impl: fused`` the fused op keeps what its
backward reads, so its forward runs once a block, as under ``none`` (JAX
``tests/test_pallas_resnet.py::test_block_fused_remat_conv_saves_fused_outputs``).
"""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fused_block import _nchw, _port_block, _x
from test_torch_remat import _run
from test_torch_taps import NARROW, seeded_pair
from test_torch_trainer import _losses, _resume_cfg
from torch.utils._python_dispatch import TorchDispatchMode

from vae_channel_dynamics_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from vae_channel_dynamics_tpu.models.vae import VAEConfig as JaxConfig
from vae_channel_dynamics_tpu_torch.models import AutoencoderKL, VAEConfig
from vae_channel_dynamics_tpu_torch.models import vae as tvae
from vae_channel_dynamics_tpu_torch.ops import fused_resnet as fr
from vae_channel_dynamics_tpu_torch.ops import group_norm_kernel as gnk
from vae_channel_dynamics_tpu_torch.training.loop import Trainer, resolve_model

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(autouse=True)
def _one_thread():
    """The Trainer runs and the small models issue thousands of small ops: one
    intra-op thread keeps them from contending with the other test workers'
    threads (tests/test_torch_flash_bwd_f32.py's ``one_thread``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_conv_remat_matches_no_remat(impl):
    loss0, grads0, stats0, _ = _run("none", impl)
    loss1, grads1, stats1, leftover = _run("conv", impl)
    assert torch.equal(loss0, loss1)
    assert grads0.keys() == grads1.keys()
    for name in grads0:
        torch.testing.assert_close(grads1[name], grads0[name], rtol=0, atol=0, msg=name)
    # the taps: the same values, emitted once (the recompute reports nothing)
    assert stats0.keys() == stats1.keys() and len(stats0) == 5
    for key in stats0:
        torch.testing.assert_close(stats1[key], stats0[key], rtol=0, atol=0, msg=key)
    assert leftover == {}


def _loss_port(model, x):
    out = model(x, sample_posterior=False)
    return out["reconstruction"].square().mean() + 1e-6 * out["latent_dist"].kl().mean()


def test_conv_remat_gradients_match_jax_conv_remat():
    model, params = seeded_pair(4, impl="auto")
    model.set_remat("conv")
    x = np.random.default_rng(2).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    _loss_port(model, torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).backward()
    port = {n: p.grad.numpy() for n, p in model.named_parameters()}

    jmodule = JaxAutoencoderKL(config=JaxConfig(**NARROW), dtype=jnp.float32, remat="conv")

    def loss(p):
        out = jmodule.apply({"params": p}, jnp.asarray(x), sample_posterior=False)
        return (jnp.mean(out["reconstruction"] ** 2)
                + 1e-6 * jnp.mean(out["latent_dist"].kl()))

    from vae_channel_dynamics_tpu.models.io import flatten_params

    jgrads = flatten_params(jax.jit(jax.grad(loss))(params))
    assert set(jgrads) == set(port)
    for name, want in jgrads.items():
        want = np.asarray(want)
        scale = np.abs(want).max()
        if name.endswith("to_k.bias") or scale < 1e-12:
            continue  # zero by symmetry: only roundoff is left
        err = np.abs(port[name] - want).max()
        assert err <= 1e-4 * scale, f"{name}: {err:.3e} of {scale:.3e}"


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func] = self.ops.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def _step_counts(remat, impl, monkeypatch):
    """Convolutions (dispatcher ops) and norm forwards in one forward and
    backward of the narrow model: ``aten.rsqrt`` once a plain norm, the
    kernel path's ``fwd_reduce`` once a norm."""
    calls = {"fwd_reduce": 0}
    real = gnk.fwd_reduce

    def counting(x):
        calls["fwd_reduce"] += 1
        return real(x)

    monkeypatch.setattr(gnk, "fwd_reduce", counting)
    model = AutoencoderKL(VAEConfig(**NARROW), impl=impl, remat=remat)
    model.init_weights(torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, (2, 3, 16, 16))
                         .astype(np.float32))
    with _Count() as count:
        _loss_port(model, x).backward()
    norms = calls["fwd_reduce"] if impl == "pallas" else count.ops.get(torch.ops.aten.rsqrt.default)
    return count.ops.get(torch.ops.aten.convolution.default), norms


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_conv_remat_recomputes_norms_and_no_conv(impl, monkeypatch):
    convs = {}
    norms = {}
    for remat in ("none", "full", "conv"):
        convs[remat], norms[remat] = _step_counts(remat, impl, monkeypatch)
    # 14 norms a forward: 5 in the encoder's and decoder's resnets are
    # rematerialised twice each, so full and conv run 10 more
    assert convs["conv"] == convs["none"] < convs["full"]
    assert norms["conv"] == norms["full"] > norms["none"]


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_conv_remat_holds_no_norm_output(impl):
    """Between the forward and the backward the graph holds the norms'
    outputs under ``none`` (each conv saves its input) and not under
    ``conv``; the backward then gives ``none``'s gradients."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 128, 8, 8))
                         .astype(np.float32))
    grads = {}
    for remat, held in (("none", True), ("conv", False)):
        blk = tvae.ResnetBlock2D(128, 128, 32, 1e-6)
        gen = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for m in blk.modules():
                if isinstance(m, (tvae.Conv2d, tvae.GroupNorm)):
                    m.init_weights(gen)
                    m.impl = impl
        blk.impl, blk.remat = impl, remat
        outputs = []
        for norm in (blk.norm1, blk.norm2):
            norm.register_forward_hook(lambda _m, _i, out: outputs.append(weakref.ref(out)))
        xr = x.clone().requires_grad_(True)
        y = blk(xr)
        gc.collect()
        assert len(outputs) == 2
        assert [ref() is not None for ref in outputs] == [held, held], remat
        y.square().mean().backward()
        grads[remat] = [xr.grad] + [p.grad for p in blk.parameters()]
    assert all(torch.equal(a, b) for a, b in zip(grads["conv"], grads["none"]))


def test_fused_block_under_conv_runs_the_fused_forward_once(monkeypatch):
    calls = {"fused_fwd": 0}
    real = fr.fused_fwd

    def counting(*args, **kwargs):
        calls["fused_fwd"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(fr, "fused_fwd", counting)
    x = _nchw(_x(seed=5))
    runs = {}
    for remat in ("none", "conv", "full"):
        holder = _port_block(128, 256, seed=3)
        holder.blk.remat = remat
        calls["fused_fwd"] = 0
        before = dict(tvae.fused_blocks)
        xr = x.clone().requires_grad_(True)
        torch.mean(torch.square(holder.blk(xr).float())).backward()
        assert tvae.fused_blocks["fused"] == before["fused"] + 1
        runs[remat] = (calls["fused_fwd"], xr.grad,
                       {n: p.grad for n, p in holder.blk.named_parameters()})
    assert runs["none"][0] == runs["conv"][0] == 2 and runs["full"][0] == 4
    assert torch.equal(runs["conv"][1], runs["none"][1])
    assert all(torch.equal(runs["conv"][2][n], runs["none"][2][n]) for n in runs["none"][2])


def test_set_remat_conv_and_resolve_model():
    model = AutoencoderKL(VAEConfig.tiny(), remat="conv")
    modes = {m.remat for m in model.modules() if isinstance(m, tvae.ResnetBlock2D)}
    assert modes == {"conv"}
    built = resolve_model({"architecture": "tiny", "pretrained_vae_name": None,
                           "remat": "conv"}, torch.float32, "cpu")
    assert {m.remat for m in built.modules() if isinstance(m, tvae.ResnetBlock2D)} == {"conv"}


def test_trainer_with_conv_remat_repeats_the_no_remat_losses(tmp_path):
    runs = {}
    for remat in ("none", "conv"):
        cfg = _resume_cfg(tmp_path, f"remat_{remat}", stop_after=3)
        cfg.setdefault("model", {})["remat"] = remat
        assert Trainer(cfg, device="cpu").train()["global_step"] == 3
        runs[remat] = _losses(tmp_path / f"remat_{remat}")
    assert len(runs["none"]) == 3 and runs["conv"] == runs["none"]
