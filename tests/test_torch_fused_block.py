"""The fused ``ResnetBlock2D`` path (``model.kernel_impl: fused``) against the
JAX model's, on the CPU.

The JAX side runs ``ops/pallas_resnet.py`` in interpret mode, jitted, as
tests/test_pallas_resnet.py and tests/test_fused_train_step.py do; the port's
wrappers run their plain versions on CPU tensors. Inputs and weights come
from a numpy or torch seed and go to both sides.

- One 128 -> 256 block (conv_shortcut), bf16 compute: the output, every tap
  the fused path serves (the kernel's |z| tap of norm1 and norm2 outputs, the
  materialised norm1/norm2 inputs, conv1 output, shortcut output), with a
  batch-validity mask and without, and every parameter gradient.
- The gate: a capture the fused path cannot serve, fp32 compute, channels
  off the 128 lane and H*W above 32x32 send the block to the unfused path,
  as JAX's ``_fused_ok`` does, and the block counts it.
- ``remat: full`` equals ``none`` bit for bit, taps included.
- One ``make_train_step`` of tests/test_fused_train_step.py's 128-channel
  model with ``impl="fused"`` against the JAX fused step: loss, accumulated
  taps and parameter updates.
- The Trainer takes ``kernel_impl: fused``.

Tolerances (bf16 on both sides; the two round at the same points but sum
fp32 in other orders, and the unfused convs add their bias in bf16 in JAX
and inside the conv's fp32 sum in torch): block output 4 bf16 ulps of its
largest entry; taps rtol 2e-3; the fused pairs' parameter gradients 1e-2
of their largest entry, the shortcut's (a plain bf16 conv whose bias
gradient is a bf16 sum) JAX's own fused-vs-XLA 5e-2. The
train step: loss rtol 2e-3, taps rtol 1e-2 / atol 1e-4, parameter updates
5e-2 of their largest entry, JAX's own fused-vs-XLA bound
(tests/test_fused_train_step.py).
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from test_torch_train_step import KL_WEIGHT

from vae_channel_dynamics_tpu.models.io import abstract_params, unflatten_params
from vae_channel_dynamics_tpu.models.io import flatten_params
from vae_channel_dynamics_tpu.models.vae import AutoencoderKL as JaxAutoencoderKL
from vae_channel_dynamics_tpu.models.vae import ResnetBlock2D as JaxResnetBlock2D
from vae_channel_dynamics_tpu.models.vae import VAEConfig as JaxConfig
from vae_channel_dynamics_tpu.models.vae import flatten_stats
from vae_channel_dynamics_tpu.ops import stats as jstats
from vae_channel_dynamics_tpu.tracking import ActivityMonitor as JaxMonitor
from vae_channel_dynamics_tpu.training import TrainState as JaxTrainState
from vae_channel_dynamics_tpu.training import build_optimizer as jax_build_optimizer
from vae_channel_dynamics_tpu.training import make_train_step as jax_make_train_step
from vae_channel_dynamics_tpu_torch import train as train_cli
from vae_channel_dynamics_tpu_torch.models import AutoencoderKL, VAEConfig
from vae_channel_dynamics_tpu_torch.models import io as model_io
from vae_channel_dynamics_tpu_torch.models import vae as tvae
from vae_channel_dynamics_tpu_torch.ops import stats as tstats
from vae_channel_dynamics_tpu_torch.tracking import ActivityMonitor
from vae_channel_dynamics_tpu_torch.training import TrainState, build_optimizer, make_train_step

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

GROUPS = 8
MEAN_ABS = "mean_abs_activation_per_channel"
BLOCK_CAPTURE = (
    ("blk.norm1", "output", (MEAN_ABS,)),
    ("blk.norm2", "output", (MEAN_ABS,)),
    ("blk.norm1", "input", (MEAN_ABS, "mean_activation")),
    ("blk.norm2", "input", (MEAN_ABS,)),
    ("blk.conv1", "output", ("std_activation",)),
    ("blk.conv_shortcut", "output", (MEAN_ABS,)),
)


class _Holder(torch.nn.Module):
    """A port block at the path ``blk``, its taps installed by the model's
    own ``set_capture``."""

    def __init__(self, blk, capture):
        super().__init__()
        self.blk = blk
        self._stats = {}
        AutoencoderKL.set_capture(self, capture)


def _port_block(in_ch, out_ch, capture=(), seed=0, dtype=torch.bfloat16, impl="fused"):
    blk = tvae.ResnetBlock2D(in_ch, out_ch, GROUPS, 1e-6)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in blk.modules():
            if hasattr(m, "init_weights"):
                m.init_weights(gen)
        for norm in (blk.norm1, blk.norm2):
            norm.weight.add_(0.2 * torch.randn(norm.weight.shape, generator=gen))
            norm.bias.add_(0.1 * torch.randn(norm.bias.shape, generator=gen))
    for m in blk.modules():
        if isinstance(m, tvae.Conv2d):
            m.compute_dtype = dtype
    blk.impl = impl
    for norm in (blk.norm1, blk.norm2):
        norm.impl = impl
    return _Holder(blk, capture)


def _jax_params(blk):
    """The JAX block's params tree from the port block's parameters."""
    def conv(c):
        return {"kernel": jnp.asarray(c.weight.detach().numpy().transpose(2, 3, 1, 0)),
                "bias": jnp.asarray(c.bias.detach().numpy())}

    def norm(n):
        return {"scale": jnp.asarray(n.weight.detach().numpy()),
                "bias": jnp.asarray(n.bias.detach().numpy())}

    p = {"norm1": norm(blk.norm1), "conv1": conv(blk.conv1), "norm2": norm(blk.norm2),
         "conv2": conv(blk.conv2)}
    if blk.conv_shortcut is not None:
        p["conv_shortcut"] = conv(blk.conv_shortcut)
    return p


def _jax_block(in_ch, out_ch, capture=(), dtype=jnp.bfloat16, impl="fused"):
    return JaxResnetBlock2D(in_channels=in_ch, out_channels=out_ch, num_groups=GROUPS,
                            dtype=dtype, impl=impl, full_name="blk", capture=capture)


def _x(shape=(2, 8, 16, 128), seed=0):
    """NHWC bf16-representable numpy input."""
    x = np.random.default_rng(seed).standard_normal(shape) * 1.5 + 0.3
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).to(torch.bfloat16)


def _bf16_ulp(top):
    return 2.0 ** (math.floor(math.log2(top)) - 7)


@pytest.fixture(scope="module")
def block_pair():
    """The 128 -> 256 block on both sides, masked and unmasked: outputs,
    stats and parameter gradients of mean(y^2)."""
    holder = _port_block(128, 256, BLOCK_CAPTURE)
    blk = holder.blk
    jblk = _jax_block(128, 256, BLOCK_CAPTURE)
    params = _jax_params(blk)
    x = _x()
    mask = np.array([1.0, 0.0], np.float32)

    @jax.jit
    def jrun(p, x_, m):
        def loss(p_):
            with jstats.tap_mask(m):
                y, aux = jblk.apply({"params": p_}, x_.astype(jnp.bfloat16), mutable=["stats"])
            return jnp.mean(jnp.square(y.astype(jnp.float32))), (y, aux["stats"])
        (_l, (y, st)), g = jax.value_and_grad(loss, has_aux=True)(p)
        return y, st, g

    out = {}
    for masked in (False, True):
        m = jnp.asarray(mask) if masked else None
        jy, jst, jg = jrun(params, jnp.asarray(x), m)
        before = dict(tvae.fused_blocks)
        blk.zero_grad(set_to_none=True)
        holder._stats.clear()
        with tstats.tap_mask(torch.from_numpy(mask) if masked else None):
            y = blk(_nchw(x))
            torch.mean(torch.square(y.float())).backward()
        counted = {k: tvae.fused_blocks[k] - before[k] for k in before}
        out[masked] = dict(jy=np.asarray(jy, np.float32), jstats=flatten_stats(jst),
                           jgrads=jg, y=y.detach().float().numpy().transpose(0, 2, 3, 1),
                           stats=dict(holder._stats), counted=counted,
                           grads={n: p.grad.clone() for n, p in blk.named_parameters()})
    return out


@pytest.mark.parametrize("masked", [False, True])
def test_block_forward_matches_jax(block_pair, masked):
    r = block_pair[masked]
    assert r["counted"] == {"fused": 1, "unfused": 0}
    top = np.abs(r["jy"]).max()
    assert np.abs(r["y"] - r["jy"]).max() <= 4 * _bf16_ulp(top)


@pytest.mark.parametrize("masked", [False, True])
def test_block_taps_match_jax(block_pair, masked):
    r = block_pair[masked]
    want = {f"{n}.{p}.{m}" for n, p, ms in BLOCK_CAPTURE for m in ms}
    assert set(r["stats"]) == set(r["jstats"]) == want
    for key, jv in r["jstats"].items():
        np.testing.assert_allclose(r["stats"][key].float().numpy(), np.asarray(jv, np.float32),
                                   rtol=2e-3, atol=1e-5, err_msg=key)
    if masked:
        # the pad row carries no weight: sample 0 alone gives the same tap
        unmasked = block_pair[False]["stats"]
        key = f"blk.norm1.output.{MEAN_ABS}"
        assert not np.allclose(r["stats"][key].numpy(), unmasked[key].numpy())


def test_block_gradients_match_jax(block_pair):
    r = block_pair[False]
    jflat = {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v, np.float32)
             for path, v in jax.tree_util.tree_leaves_with_path(r["jgrads"])}
    names = {"weight": "kernel"}
    assert len(r["grads"]) == len(jflat) == 10
    for name, g in r["grads"].items():
        sub, leaf = name.rsplit(".", 1)
        jkey = f"{sub}.{names.get(leaf, leaf)}" if "conv" in sub else (
            f"{sub}.{'scale' if leaf == 'weight' else 'bias'}")
        want = jflat[jkey]
        got = g.float().numpy()
        if got.ndim == 4:
            got = got.transpose(2, 3, 1, 0)
        scale = max(np.abs(want).max(), 1e-8)
        # the shortcut is the plain bf16 conv on both sides, its bias
        # gradient a bf16 sum taken in other orders
        bound = 5e-2 if sub == "conv_shortcut" else 1e-2
        assert np.abs(got - want).max() <= bound * scale, name


def test_gate_falls_back_like_jax():
    """The port's gate decides as JAX's ``_fused_ok`` on the same block,
    input and capture table, and an unfused block is counted."""
    x = _x()
    cases = [
        (128, 256, BLOCK_CAPTURE, jnp.bfloat16, x, True),
        (128, 128, (("blk.conv1", "input", (MEAN_ABS,)),), jnp.bfloat16, x, False),
        (128, 128, (("blk.norm1", "output", ("full_activation_map",)),), jnp.bfloat16, x, False),
        (128, 128, (("blk.conv2", "output", (MEAN_ABS,)),), jnp.bfloat16, x, False),
        (128, 128, (("blk.norm2", "output", (MEAN_ABS, "std_activation")),), jnp.bfloat16, x,
         False),
        (128, 128, (), jnp.float32, x, False),  # fp32 compute
        (96, 96, (), jnp.bfloat16, np.zeros((2, 8, 16, 96), np.float32), False),  # channels
        (128, 128, (), jnp.bfloat16, np.zeros((1, 64, 32, 128), np.float32), False),  # H*W
        (128, 128, (("other.conv1", "input", (MEAN_ABS,)),), jnp.bfloat16, x, True),
    ]
    for in_ch, out_ch, capture, jdt, xx, want in cases:
        tdt = torch.bfloat16 if jdt == jnp.bfloat16 else torch.float32
        holder = _port_block(in_ch, out_ch, capture, dtype=tdt)
        assert _jax_block(in_ch, out_ch, capture, dtype=jdt)._fused_ok(jnp.asarray(xx)) == want
        xt = _nchw(xx).to(tdt)
        assert holder.blk._fused_ok(xt) == want, (in_ch, capture, jdt)
        before = dict(tvae.fused_blocks)
        with torch.no_grad():
            y = holder.blk(xt)
        assert tvae.fused_blocks["fused" if want else "unfused"] == (
            before["fused" if want else "unfused"] + 1)
        if not want:
            # the unfused path is the plain block
            holder.blk.impl = "xla"
            with torch.no_grad():
                assert torch.equal(holder.blk(xt), y)


def test_remat_full_equals_none_bit_for_bit():
    x = _nchw(_x(seed=5))
    runs = {}
    for remat in ("none", "full"):
        holder = _port_block(128, 256, BLOCK_CAPTURE, seed=3)
        holder.blk.remat = remat
        before = dict(tvae.fused_blocks)
        xr = x.clone().requires_grad_(True)
        y = holder.blk(xr)
        stats = dict(holder._stats)
        torch.mean(torch.square(y.float())).backward()
        # the recompute emits no tap and is not counted again
        assert dict(holder._stats) == stats
        assert tvae.fused_blocks["fused"] == before["fused"] + 1
        runs[remat] = (y.detach(), stats, xr.grad,
                       {n: p.grad for n, p in holder.blk.named_parameters()})
    (y0, s0, gx0, g0), (y1, s1, gx1, g1) = runs["none"], runs["full"]
    assert torch.equal(y0, y1) and torch.equal(gx0, gx1)
    assert s0.keys() == s1.keys() and all(torch.equal(s0[k], s1[k]) for k in s0)
    assert all(torch.equal(g0[n], g1[n]) for n in g0)


# --------------------------------------------------------------------------- #
# One train step of the 128-channel model, port fused vs JAX fused
# --------------------------------------------------------------------------- #
CFG = dict(block_out_channels=(128,), layers_per_block=1, norm_num_groups=32, sample_size=16)
RES, BATCH = 16, 2
TRACKING = {
    "enabled": True, "track_interval": 1,
    "target_layers": [
        {"name": "vae.encoder.down_blocks.0.resnets.0.norm1", "capture_point": "output",
         "metrics": [MEAN_ABS]},
        {"name": "vae.decoder.mid_block.resnets.1.norm2", "capture_point": "output",
         "metrics": [MEAN_ABS]},
    ],
}


def _seeded_model(seed=0):
    model = AutoencoderKL(VAEConfig(**CFG), impl="fused", dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(seed)
    model.init_weights(gen)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 1 and "norm" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return model


def test_fused_train_step_matches_jax():
    model = _seeded_model()
    initial = {k: v.detach().clone() for k, v in model.state_dict().items()}
    params = unflatten_params(abstract_params(JaxConfig(**CFG)),
                              {k: v.numpy() for k, v in initial.items()})
    pixels = np.random.default_rng(3).uniform(-1, 1, (BATCH, RES, RES, 3)).astype(np.float32)
    mask = np.ones(BATCH, np.float32)
    rng = jax.random.PRNGKey(9)
    noise = np.asarray(jax.random.normal(jax.random.fold_in(rng, 0), (BATCH, RES, RES, 4),
                                         jnp.float32))

    monitor = ActivityMonitor(dict(TRACKING))
    model.set_capture(monitor.scalar_capture_table)
    tx, _ = build_optimizer(1e-3, 2, 100)
    state = TrainState.create(model, tx, stats_acc=monitor.init_acc(model))
    before = dict(tvae.fused_blocks)
    state, metrics, _ = make_train_step(model, tx, KL_WEIGHT,
                                        stats_accumulate=ActivityMonitor.accumulate)(
        state, {"pixel_values": pixels}, mask, noise=noise)
    # every resnet of this model is at 16x16 with 128 channels: all 7 fuse
    assert {k: tvae.fused_blocks[k] - before[k] for k in before} == {"fused": 7, "unfused": 0}

    jmonitor = JaxMonitor(dict(TRACKING))
    jmodule = JaxAutoencoderKL(config=JaxConfig(**CFG), dtype=jnp.bfloat16, impl="fused",
                               capture=jmonitor.scalar_capture_table)
    jtx, _ = jax_build_optimizer(1e-3, 2, 100)
    jstate = JaxTrainState.create(params, jtx, stats_acc=jmonitor.init_acc(
        jmodule, params, (BATCH, RES, RES, 3)))
    jstep = jax_make_train_step(jmodule, jtx, KL_WEIGHT, donate=False,
                                stats_accumulate=JaxMonitor.accumulate)
    jstate, jmetrics, _ = jstep(jstate, {"pixel_values": pixels}, mask, rng)

    np.testing.assert_allclose(float(metrics["train_loss_step"]),
                               float(jmetrics["train_loss_step"]), rtol=2e-3)
    assert set(state.stats_acc) == set(jstate.stats_acc) and len(state.stats_acc) == 2
    for key, want in jstate.stats_acc.items():
        np.testing.assert_allclose(state.stats_acc[key].numpy(), np.asarray(want),
                                   rtol=1e-2, atol=1e-4, err_msg=key)
    j_final = flatten_params(jstate.params)
    t_final = {k: v.detach() for k, v in state.model.state_dict().items()}
    for name, want in j_final.items():
        jd = want.astype(np.float64) - initial[name].double().numpy()
        td = (t_final[name].double() - initial[name].double()).numpy()
        scale = max(np.abs(jd).max(), 1e-12)
        assert np.abs(jd - td).max() <= 5e-2 * scale, name


def test_trainer_takes_kernel_impl_fused(tmp_path):
    model_dir = str(tmp_path / "narrow")
    model = _seeded_model(seed=2)
    model_io.save_model_dir(model_dir, model.config, model.state_dict())
    cfg = {
        "run_name": "fused", "output_dir": str(tmp_path), "seed": 5,
        "model": {"pretrained_vae_name": model_dir, "kernel_impl": "fused", "remat": "full"},
        "data": {"dataset_name": "synthetic://shapes?num_samples=4", "resolution": RES,
                 "batch_size": BATCH, "do_validation": False},
        "training": {"num_train_epochs": 1, "learning_rate": 1e-4, "lr_warmup_steps": 1,
                     "mixed_precision": "bf16"},
        "logging": {"log_interval": 1, "report_to": "jsonl"},
        "saving": {"save_interval_steps": 1000},
        "tracking": dict(TRACKING, track_interval=2),
    }
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    before = dict(tvae.fused_blocks)
    assert train_cli.main(["--config_path", str(path), "--device", "cpu"]) == 0
    # 2 steps of 7 fused resnets; remat's recompute is not counted
    assert {k: tvae.fused_blocks[k] - before[k] for k in before} == {"fused": 14, "unfused": 0}
    assert os.path.exists(tmp_path / "fused" / "final_model" / "vae" / "config.json")
    assert os.path.exists(tmp_path / "fused" / "tracked_activation_stats.csv")
