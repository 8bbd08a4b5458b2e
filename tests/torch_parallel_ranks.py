"""Rank programs for the gloo tests of ``tests/test_torch_parallel_*.py``,
and the launcher that runs them.

:func:`run_ranks` starts ``world`` processes of this file, each with the
environment torchrun would give it (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT`` on a port the OS picked),
on one intra-op thread, and kills them all and fails when they outlive
``timeout`` seconds. Each rank joins the group with
``initialize_distributed`` (gloo on the CPU; NCCL where the arguments say
``"device": "cuda"``, one card a rank) and runs one scenario of
:data:`SCENARIOS` on the arguments in a JSON file; rank 0 writes what the
tests compare. This file imports torch and the port only, never JAX.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(scenario: str, args: dict, tmp_dir: str, world: int = 2,
              timeout: float = 120.0) -> None:
    """Run ``scenario`` on ``world`` ranks; raise with the ranks' logs when
    one fails or the group outlives ``timeout``."""
    os.makedirs(tmp_dir, exist_ok=True)
    args_path = os.path.join(tmp_dir, f"{scenario}_args.json")
    with open(args_path, "w") as f:
        json.dump(args, f)
    port = free_port()
    procs, logs = [], []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        log = open(os.path.join(tmp_dir, f"{scenario}_rank{rank}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), scenario, args_path],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{scenario}: the ranks outlived {timeout} s")
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.1)
        # a rank that failed leaves the others waiting on a collective
        time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    rcs = [p.returncode for p in procs]
    if any(rcs):
        tails = []
        for rank in range(world):
            with open(os.path.join(tmp_dir, f"{scenario}_rank{rank}.log")) as f:
                tails.append(f"--- rank {rank} (rc {rcs[rank]}) ---\n" + f.read()[-4000:])
        raise RuntimeError(f"{scenario} failed:\n" + "\n".join(tails))


# --------------------------------------------------------------------------- #
# scenarios, run inside a rank
# --------------------------------------------------------------------------- #
def _narrow_model(state_path: str, capture=()):
    import torch

    from vae_channel_dynamics_tpu_torch.models.vae import AutoencoderKL, VAEConfig

    saved = np.load(state_path)
    model = AutoencoderKL(VAEConfig(block_out_channels=(128, 128), layers_per_block=1,
                                    norm_num_groups=32), impl="auto", capture=capture)
    model.load_state_dict({k: torch.from_numpy(saved[k]) for k in saved.files}, strict=True)
    return model


def _kept_allowance(whole, world: int, params_whole: bool) -> int:
    """The bytes a rank may keep whole under the ZeRO flags: the parameters
    when they stay whole (ZeRO-1), every leaf of a parameter that
    ``zero_axis`` leaves whole, and Adafactor's factored moments (a mean
    over the sliced axis is whole)."""
    from vae_channel_dynamics_tpu_torch.parallel.zero import zero_axis

    def nbytes(t):
        return 0 if t is None else t.numel() * t.element_size()

    names = list(whole["params"])
    opt = whole["opt"]
    total = 0
    for i, name in enumerate(names):
        p = whole["params"][name]
        lone = zero_axis(tuple(p.shape), world) is None
        if params_whole or lone:
            total += nbytes(p)
        for field in ("mu", "nu", "v", "acc_grads"):
            if lone and opt.get(field) is not None:
                total += nbytes(opt[field][i])
        for field in ("v_row", "v_col"):
            if opt.get(field) is not None:
                total += nbytes(opt[field][i])
        if lone and whole["ema_params"] is not None:
            total += nbytes(whole["ema_params"][name])
    return total


def scenario_step(axis, args) -> None:
    """Two micro-steps of the data-parallel train step for each variant (an
    optimizer, its ZeRO flags and its gradient accumulation) on this rank's
    block of the global batch and of the JAX step's noise; rank 0 writes
    the metrics, the stats, the whole parameters and EMA, and every rank
    its state bytes and what it may keep whole. With ``spatial`` S > 1 the
    ranks form spatial groups of S: each takes its data rank's block, and
    the step its rows. A variant's ``tensor`` T > 1 forms tensor groups of
    T: the model keeps its channel blocks (``shard_tensor_``), and each
    rank writes whether its parameters, moments and EMA hold the blocks
    the layout names, and the gradient norm of a planted gradient that only
    a leaf the tensor axis leaves whole carries."""
    import torch

    from vae_channel_dynamics_tpu_torch.ops.tensor_parallel import TensorGroup, whole_taps
    from vae_channel_dynamics_tpu_torch.parallel import local_block
    from vae_channel_dynamics_tpu_torch.parallel.mesh import with_layout
    from vae_channel_dynamics_tpu_torch.parallel.zero import (
        ZeroLayout, fully_shard_model, replicate_leaf, state_bytes)
    from vae_channel_dynamics_tpu_torch.tracking import ActivityMonitor
    from vae_channel_dynamics_tpu_torch.training import TrainState, build_optimizer
    from vae_channel_dynamics_tpu_torch.training.checkpoint import state_dict_of
    from vae_channel_dynamics_tpu_torch.training.step import make_train_step

    world_axis = axis
    data = np.load(args["data"])
    out = {}
    for variant in args["variants"]:
        tensor = variant.get("tensor", 1)
        axis = with_layout(world_axis, args.get("spatial", 1), tensor)
        monitor = ActivityMonitor(args["tracking"])
        model = _narrow_model(args["state"], monitor.scalar_capture_table)
        if tensor > 1:
            model.shard_tensor_(TensorGroup.of(axis))
        flags = variant["flags"]
        tx, _ = build_optimizer(args["lr"], args["warmup"], args["max_steps"],
                                adam_weight_decay=args["wd"], adam_epsilon=args["eps"],
                                max_grad_norm=args["max_grad_norm"],
                                optimizer=variant["optimizer"],
                                gradient_accumulation_steps=variant.get("accum", 1),
                                summed_grads=True)
        if flags.get("shard_params"):
            fully_shard_model(model, axis)
            forward = model
        else:
            forward = torch.nn.parallel.DistributedDataParallel(
                model, process_group=axis.replica_group)
        layout = (ZeroLayout(axis, model, bool(flags.get("shard_optimizer")),
                             bool(flags.get("shard_ema")), bool(flags.get("shard_params")))
                  if any(flags.values()) or tensor > 1 else None)
        state = TrainState.create(model, tx, stats_acc=monitor.init_acc(model),
                                  ema=True, layout=layout)
        step = make_train_step(model, tx, args["kl_weight"],
                               stats_accumulate=ActivityMonitor.accumulate,
                               ema_decay=args["ema_decay"], axis=axis,
                               forward_module=forward)
        metrics = []
        for t in range(args["steps"]):
            batch = local_block(data[f"pixels{t}"], axis.data_rank, axis.data_world)
            mask = local_block(data["mask"], axis.data_rank, axis.data_world)
            noise = local_block(data[f"noise{t}"], axis.data_rank, axis.data_world)
            state, m, _ = step(state, {"pixel_values": batch}, mask, noise=noise)
            metrics.append([float(m[k]) for k in ("train_loss_step", "rec_loss", "kl_loss",
                                                  "grad_norm")])
        whole = state_dict_of(state)
        sliced, kept = state_bytes(state)
        name = variant["name"]
        out[f"{name}/metrics"] = np.array(metrics)
        for k, v in whole["params"].items():
            out[f"{name}/param/{k}"] = v.numpy()
        for k, v in whole["ema_params"].items():
            out[f"{name}/ema/{k}"] = v.numpy()
        for k, v in whole_taps(state.stats_acc, model).items():
            out[f"{name}/stats/{k}"] = v.numpy()
        allowance = _kept_allowance(whole, axis.data_world, not flags.get("shard_params"))
        out[f"{name}/bytes"] = np.array([sliced, kept])
        # the ranks' parameters after the step are the same bits
        gathered = [replicate_leaf(p).reshape(-1) for p in model.parameters()]
        flat = torch.cat(gathered)
        parts = [torch.empty_like(flat) for _ in range(axis.world)]
        torch.distributed.all_gather(parts, flat)
        out[f"{name}/ranks_equal"] = np.array(all(torch.equal(parts[0], q) for q in parts))
        all_bytes = [None] * axis.world
        torch.distributed.all_gather_object(all_bytes, [sliced, kept, allowance])
        out[f"{name}/rank_bytes"] = np.array(all_bytes)
        if tensor > 1:
            blocks = [None] * axis.world
            torch.distributed.all_gather_object(blocks, _tensor_blocks_held(state, whole))
            out[f"{name}/tensor_blocks"] = np.array(json.dumps(blocks))
            out[f"{name}/planted_norm"] = np.array(_planted_norm(state))
    if axis.is_main:
        np.savez(args["out"], **out)


def _tensor_blocks_held(state, whole) -> list:
    """[parameters the tensor axis cuts, those of them whose parameter,
    moments or EMA on this rank hold other than their share of the whole
    leaf (1/T, and the rank's ``torch.chunk`` block along a data-sliced
    axis)]."""
    import math

    from vae_channel_dynamics_tpu_torch.parallel.zero import chunk_span

    layout = state.layout
    cut, wrong = 0, []
    for i, (name, p) in enumerate(state.model.named_parameters()):
        if layout.t_axes[i] is None:
            continue
        cut += 1
        t_axis = layout.t_axes[i]
        assert whole["params"][name].shape[t_axis] == layout.tp.size * layout.full_shapes[i][t_axis]

        def share(field):
            shape = list(layout.full_shapes[i])
            a = layout.leaf_axis(field, i)
            if a is not None:
                shape[a] = chunk_span(shape[a], layout.rank, layout.world)[1]
            return math.prod(shape)

        local = p.to_local() if hasattr(p, "to_local") else p
        ok = (local.numel() == share("param")
              and state.opt_state.mu[i].numel() == share("mu")
              and state.opt_state.nu[i].numel() == share("nu")
              and list(state.ema_params.values())[i].numel() == share("ema"))
        if not ok:
            wrong.append(name)
    return [cut, wrong]


def _planted_norm(state) -> float:
    """The global gradient norm the layout gives a gradient that is zero
    but for the decoder's conv_out bias, (3, 4, 0) on every rank: 5 when
    that leaf, which no tensor axis cuts, is counted once."""
    import torch

    layout = state.layout
    grads = [torch.zeros_like(g) for g in layout.opt_grads(state.model).values()]
    names = [n for n, _ in state.model.named_parameters()]
    i = names.index("decoder.conv_out.bias")
    grads[i].copy_(layout.scatter("mu", i, torch.tensor([3.0, 4.0, 0.0])))
    return float(layout.global_norm(grads))


def scenario_runs(axis, args) -> None:
    """Trainer runs and evaluation CLI calls, in order. After each Trainer
    run every rank's whole parameters go to ``<out>_<i>_rank<r>.npz`` and
    rank 0's summary to ``<out>_<i>.json``."""
    import torch

    from vae_channel_dynamics_tpu_torch import evaluate
    from vae_channel_dynamics_tpu_torch.parallel.zero import replicate_leaf
    from vae_channel_dynamics_tpu_torch.training.loop import Trainer

    for i, run in enumerate(args["runs"]):
        if run["kind"] == "eval":
            if evaluate.main(run["argv"] + ["--device", args.get("device", "cpu")]):
                raise SystemExit(f"evaluation {i} failed")
            torch.distributed.barrier()
            continue
        trainer = Trainer(run["config"], resume_from=run.get("resume_from"),
                          device=args.get("device", "cpu"), axis=axis)
        summary = trainer.train()
        np.savez(f"{args['out']}_{i}_rank{axis.rank}.npz",
                 **{k: replicate_leaf(p).cpu().numpy()
                    for k, p in trainer.model.named_parameters()})
        if axis.is_main:
            with open(f"{args['out']}_{i}.json", "w") as f:
                json.dump({k: v for k, v in summary.items()
                           if isinstance(v, (int, float, str, bool, type(None)))}, f)
        torch.distributed.barrier()


def _gather_rows(t, sp, dim):
    """Every spatial rank's rows of ``t`` along ``dim``, in order."""
    import torch
    import torch.distributed as dist

    parts = [torch.empty_like(t) for _ in range(sp.size)]
    dist.all_gather(parts, t.contiguous(), group=sp.group)
    return torch.cat(parts, dim=dim)


def _summed(t):
    import torch.distributed as dist

    t = t.detach().clone()
    dist.all_reduce(t)
    return t


def scenario_spatial_ops(axis, args) -> None:
    """The row-sharded ops on a spatial group of every rank: each conv
    geometry through ``halo_conv`` (forward, input and weight gradients),
    GroupNorm+SiLU on both routes with the mean |z| tap and the stats taps
    under the mask, and attention (naive, chunked, flash's plain versions)
    on local queries against gathered keys and values (forward, dQ, dK, dV).
    Rank 0 writes the whole-image results: rows gathered, partial sums
    (weight, scale and bias gradients, tap shares) summed."""
    import torch
    import torch.nn.functional as F

    from vae_channel_dynamics_tpu_torch.ops import attention, flash_attention, stats
    from vae_channel_dynamics_tpu_torch.ops.group_norm import group_norm
    from vae_channel_dynamics_tpu_torch.ops.group_norm_kernel import (
        group_norm_silu_with_stats)
    from vae_channel_dynamics_tpu_torch.ops.spatial_conv import (
        SpatialGroup, gather_rows, halo_conv, row_block, spatial_conv_scope)
    from vae_channel_dynamics_tpu_torch.parallel.mesh import with_layout

    axis = with_layout(axis, axis.world)
    sp = SpatialGroup.of(axis)
    data = np.load(args["data"])
    out = {}

    def t(name):
        return torch.from_numpy(data[name])

    # (a) the conv geometries: NCHW rows of x and of the output's cotangent
    for geo in args["geometries"]:
        name = geo["id"]
        x = row_block(t(f"{name}/x"), sp).clone().requires_grad_(True)
        w = t(f"{name}/w").clone().requires_grad_(True)
        g = row_block(t(f"{name}/g"), sp)
        inp = F.interpolate(x, scale_factor=2.0, mode="nearest") if geo["up"] else x
        y = halo_conv(inp, w, None, geo["stride"], tuple(geo["pad"]), sp)
        (y * g).sum().backward()
        out[f"{name}/y"] = _gather_rows(y.detach(), sp, 2).numpy()
        out[f"{name}/dx"] = _gather_rows(x.grad, sp, 2).numpy()
        out[f"{name}/dw"] = _summed(w.grad).numpy()

    # (b) GroupNorm+SiLU on both routes, with the |z| tap, under the mask
    mask = t("gn/mask")
    count = mask.sum()
    for impl in ("auto", "pallas"):
        x = row_block(t("gn/x"), sp).clone().requires_grad_(True)
        scale = t("gn/scale").clone().requires_grad_(True)
        bias = t("gn/bias").clone().requires_grad_(True)
        with spatial_conv_scope(sp), stats.tap_mask(mask, count=count, reduce=True):
            if impl == "pallas":
                y, tap = group_norm_silu_with_stats(x, scale, bias, args["groups"], 1e-6,
                                                    fuse_silu=True)
            else:
                z = group_norm(x, scale, bias, args["groups"], 1e-6, impl=impl)
                tap = stats.mean_abs_activation_per_channel(z)
                y = z * torch.sigmoid(z)
            (y * row_block(t("gn/g"), sp)).sum().backward()
        out[f"gn_{impl}/y"] = _gather_rows(y.detach(), sp, 2).numpy()
        out[f"gn_{impl}/dx"] = _gather_rows(x.grad, sp, 2).numpy()
        out[f"gn_{impl}/dscale"] = _summed(scale.grad).numpy()
        out[f"gn_{impl}/dbias"] = _summed(bias.grad).numpy()
        out[f"gn_{impl}/tap"] = _summed(tap).numpy()
    # the stats taps of a 4-D and a (B, N, C) activation: the linear ones'
    # shares summed over the ranks, the std and the map whole on each rank
    for name in ("act4", "act3"):
        a = row_block(t(f"stats/{name}"), sp, dim=2 if name == "act4" else 1)
        with spatial_conv_scope(sp), stats.tap_mask(mask, count=count, reduce=True):
            got = stats.channel_stats(a, tuple(stats.METRIC_FNS))
        for metric, value in got.items():
            if metric in stats.SUMMED_METRICS:
                value = _summed(value)
            out[f"stats_{name}/{metric}"] = value.numpy()

    # (c) attention: this rank's queries against every rank's keys and values
    scale = args["attn_scale"]
    fns = {
        "naive": lambda q, k, v: attention.naive_attention(q, k, v, scale=scale,
                                                           out_dtype=q.dtype),
        "chunked": lambda q, k, v: attention.chunked_attention(
            q, k, v, scale=scale, out_dtype=q.dtype, chunk=args["chunk"]),
        "flash": lambda q, k, v: flash_attention.flash_attention(q, k, v, scale=scale,
                                                                 out_dtype=q.dtype),
    }
    for impl, fn in fns.items():
        q, k, v = (row_block(t(f"attn/{n}"), sp, dim=1).clone().requires_grad_(True)
                   for n in "qkv")
        o = fn(q, gather_rows(k, 1, sp), gather_rows(v, 1, sp))
        (o * row_block(t("attn/g"), sp, dim=1)).sum().backward()
        out[f"attn_{impl}/o"] = _gather_rows(o.detach(), sp, 1).numpy()
        for n, leaf in zip("qkv", (q, k, v)):
            out[f"attn_{impl}/d{n}"] = _gather_rows(leaf.grad, sp, 1).numpy()
    # the flash kernels' plain versions at nq < nk, through their wrappers
    q, k, v, g = (row_block(t(f"attn/{n}"), sp, dim=1) for n in "qkvg")
    k, v = _gather_rows(k, sp, 1), _gather_rows(v, sp, 1)
    o, lse = flash_attention.flash_attention_fwd_lse(q, k, v, scale=scale, out_dtype=q.dtype)
    delta = (g * o).sum(-1)
    dk, dv = flash_attention.flash_attention_bwd_dkv(q, k, v, g, lse, delta, scale=scale)
    dq = flash_attention.flash_attention_bwd_dq(q, k, v, g, lse, delta, scale=scale)
    out["kernels/o"] = _gather_rows(o, sp, 1).numpy()
    out["kernels/serving"] = _gather_rows(flash_attention.flash_attention_fwd(
        q, k, v, scale=scale, out_dtype=q.dtype), sp, 1).numpy()
    out["kernels/lse"] = _gather_rows(lse, sp, 1).numpy()
    out["kernels/dq"] = _gather_rows(dq, sp, 1).numpy()
    out["kernels/dk"] = _summed(dk).numpy()
    out["kernels/dv"] = _summed(dv).numpy()
    out["kernels/nq_nk"] = np.array([q.shape[1], k.shape[1]])
    if axis.is_main:
        np.savez(args["out"], **out)


def saved_activation_bytes(model, x, noise, tp=None):
    """(bytes the forward leaves allocated for the backward, peak bytes of
    the forward and backward) of one training forward of ``model`` on the
    card, under ``tp``'s tensor scope."""
    import torch

    from vae_channel_dynamics_tpu_torch.ops.tensor_parallel import tensor_scope

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    with tensor_scope(tp):
        out = model(x, noise=noise)
        loss = out["reconstruction"].float().square().mean() + out["latent_dist"].kl().mean()
        torch.cuda.synchronize()
        saved = torch.cuda.memory_allocated() - before
        loss.backward()
    torch.cuda.synchronize()
    return saved, torch.cuda.max_memory_allocated() - before


def scenario_tensor_memory(axis, args) -> None:
    """One training forward and backward (``dtype`` bf16 or fp32) of the
    seeded SDXL VAE with its channels over every rank (a tensor group of the
    world): rank 0 writes each rank's bytes saved for the backward and peak
    bytes."""
    import torch

    from vae_channel_dynamics_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from vae_channel_dynamics_tpu_torch.ops.tensor_parallel import TensorGroup
    from vae_channel_dynamics_tpu_torch.parallel.mesh import with_layout

    axis = with_layout(axis, 1, axis.world)
    model = AutoencoderKL(VAEConfig.sdxl(), device=axis.device, impl="pallas",
                          dtype=getattr(torch, args["dtype"]))
    model.init_weights(torch.Generator(device=axis.device).manual_seed(0))
    model.shard_tensor_(TensorGroup.of(axis))
    gen = torch.Generator(device=axis.device).manual_seed(1)
    res, batch = args["resolution"], args["batch"]
    x = torch.randn(batch, 3, res, res, generator=gen, device=axis.device)
    noise = torch.randn(batch, 4, res // 8, res // 8, generator=gen, device=axis.device)
    got = [None] * axis.world
    torch.distributed.all_gather_object(
        got, list(saved_activation_bytes(model, x, noise, TensorGroup.of(axis))))
    if axis.is_main:
        with open(args["out"], "w") as f:
            json.dump(got, f)


SCENARIOS = {"step": scenario_step, "runs": scenario_runs, "spatial_ops": scenario_spatial_ops,
             "tensor_memory": scenario_tensor_memory}


def _main() -> None:
    scenario, args_path = sys.argv[1], sys.argv[2]
    sys.path.insert(0, REPO)
    import torch

    torch.set_num_threads(1)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from vae_channel_dynamics_tpu_torch.parallel.mesh import initialize_distributed, shutdown

    with open(args_path) as f:
        args = json.load(f)
    axis = initialize_distributed(args.get("device", "cpu"))
    SCENARIOS[scenario](axis, args)
    shutdown(axis)


if __name__ == "__main__":
    _main()
